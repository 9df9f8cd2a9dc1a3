"""Conv and pool layers of the paper's CNV model (port of
``repro/nn/conv.py``), NHWC in and out as in the reference.

A conv in every mode is im2col plus the switchable linear backend, so the
BiKA conv, the binarized conv and the int8 conv share one implementation
and reach the same kernels as the linear layers. ``extract_patches`` gives
``jax.lax.conv_general_dilated_patches``' feature order, (C, kh, kw), and
its SAME padding."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .linear import LinearSpec, linear_apply, linear_init

__all__ = ["conv2d_init", "conv2d_apply", "extract_patches", "im2col_apply", "maxpool2d"]


def _same_pads(size: int, window: int, stride: int):
    """XLA's SAME rule: ceil(size / stride) outputs, the padding they need
    split with the smaller half first."""
    total = max((-(-size // stride) - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pad_nchw(xc: torch.Tensor, kh: int, kw: int, stride: int, padding: str,
              value: float = 0.0) -> torch.Tensor:
    if padding == "VALID":
        return xc
    if padding != "SAME":
        raise ValueError(f"unknown padding {padding!r}; known: SAME, VALID")
    top, bottom = _same_pads(xc.shape[2], kh, stride)
    left, right = _same_pads(xc.shape[3], kw, stride)
    if top == bottom == left == right == 0:
        return xc
    return F.pad(xc, (left, right, top, bottom), value=value)


def extract_patches(x: torch.Tensor, kh: int = 3, kw: int = 3, stride: int = 1,
                    padding: str = "SAME") -> torch.Tensor:
    """x (B, H, W, C) -> (B, H', W', C * kh * kw) patches, feature order
    (C, kh, kw)."""
    xc = _pad_nchw(x.permute(0, 3, 1, 2), kh, kw, stride, padding)
    ho = (xc.shape[2] - kh) // stride + 1
    wo = (xc.shape[3] - kw) // stride + 1
    cols = F.unfold(xc, (kh, kw), stride=stride)  # (B, C*kh*kw, H'*W')
    return cols.transpose(1, 2).reshape(x.shape[0], ho, wo, -1)


def conv2d_init(gen: torch.Generator, c_in: int, c_out: int, spec: LinearSpec, *,
                kh: int = 3, kw: int = 3, phase: str = "train", device=None):
    """A (C_in * kh * kw -> C_out) projection's parameters in ``phase`` form."""
    return linear_init(gen, c_in * kh * kw, c_out, spec, phase=phase, device=device)


def im2col_apply(project, x: torch.Tensor, *, kh: int = 3, kw: int = 3, stride: int = 1,
                 padding: str = "SAME") -> torch.Tensor:
    """The conv of every mode: x (B, H, W, C) -> (B, H', W', N), the
    projection ``project`` ((rows, C * kh * kw) -> (rows, N)) applied to
    every patch."""
    patches = extract_patches(x, kh, kw, stride, padding)
    b, ho, wo, kdim = patches.shape
    return project(patches.reshape(b * ho * wo, kdim)).reshape(b, ho, wo, -1)


def conv2d_apply(params, x: torch.Tensor, spec: LinearSpec, *, kh: int = 3, kw: int = 3,
                 stride: int = 1, padding: str = "SAME", phase: str = "train") -> torch.Tensor:
    """x (B, H, W, C) -> (B, H', W', C_out): im2col, then the linear backend."""
    return im2col_apply(lambda rows: linear_apply(params, rows, spec, phase=phase), x,
                        kh=kh, kw=kw, stride=stride, padding=padding)


def maxpool2d(x: torch.Tensor, window: int = 2, stride: int = 2,
              padding: str = "SAME") -> torch.Tensor:
    """Max over window x window patches of a floating (B, H, W, C) x, NHWC
    out. SAME pads a ragged edge with -inf, as the reference's
    ``reduce_window`` does."""
    if not x.dtype.is_floating_point:
        raise TypeError(f"maxpool2d takes a floating tensor; got {x.dtype}")
    xc = _pad_nchw(x.permute(0, 3, 1, 2), window, window, stride, padding, float("-inf"))
    return F.max_pool2d(xc, window, stride).permute(0, 2, 3, 1)
