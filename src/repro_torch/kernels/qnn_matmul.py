"""The int8 matmul kernel's wrapper and its plain version (kernel 10).

The kernel (``csrc/qnn_matmul.cu``) replaces the reference's Pallas
``qnn_matmul_kernel_call`` (``repro/kernels/qnn_matmul.py``):
``y = float32(x_int @ w_int) * (w_scale * x_scale)`` with an exact int32
accumulator and the scale product rounded to float32 first. It masks its
own ragged edges, so nothing is padded (the reference pads M, K and N to
block multiples). The source says what bounds it.

``qnn_matmul_kernel_call`` checks device, dtype, shape and contiguity,
launches on PyTorch's current stream, raises on a CPU tensor or a failed
launch, and adds one to ``.launches`` per launch. ``qnn_matmul_plain``
computes the same function in plain PyTorch (``ref.qnn_matmul_ref``).
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref
from .cac_matmul import _on_card

__all__ = ["qnn_matmul_kernel_call", "qnn_matmul_plain"]


def _check(x_int: torch.Tensor, w_int: torch.Tensor, w_scale: torch.Tensor) -> None:
    if x_int.dim() != 2 or w_int.dim() != 2:
        raise ValueError("the int8 matmul wants x_int (M, K) and w_int (K, N)")
    if x_int.dtype != torch.int8 or w_int.dtype != torch.int8:
        raise TypeError(f"the int8 matmul takes int8 operands; got {x_int.dtype}, {w_int.dtype}")
    if w_scale.dtype != torch.float32:
        raise TypeError(f"the int8 matmul takes a float32 w_scale; got {w_scale.dtype}")
    if x_int.shape[1] != w_int.shape[0] or w_scale.numel() != w_int.shape[1]:
        raise ValueError(f"shape mismatch: x_int {tuple(x_int.shape)}, w_int "
                         f"{tuple(w_int.shape)}, w_scale {tuple(w_scale.shape)}")


def qnn_matmul_plain(x_int: torch.Tensor, w_int: torch.Tensor, w_scale: torch.Tensor,
                     x_scale: float) -> torch.Tensor:
    """Plain PyTorch kernel 10: ``ref.qnn_matmul_ref``, exact integer sums."""
    _check(x_int, w_int, w_scale)
    return ref.qnn_matmul_ref(x_int, w_int, x_scale, w_scale)


def _lib():
    fn = build.load("qnn_matmul").qnn_matmul_launch
    if fn.argtypes is None:  # declare once: pointers must not pass as 32-bit ints
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr, ptr, ptr, ctypes.c_float, ptr, ptr, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
    return fn


def qnn_matmul_kernel_call(x_int: torch.Tensor, w_int: torch.Tensor, w_scale: torch.Tensor,
                           x_scale: float) -> torch.Tensor:
    """Launch kernel 10: x_int int8 (M, K), w_int int8 (K, N), w_scale
    float32 (N,) or (1, N), x_scale a float (taken as float32) -> (M, N)
    float32. Adds one to ``qnn_matmul_kernel_call.launches`` per launch."""
    _check(x_int, w_int, w_scale)
    x_int, w_int, w_scale = _on_card("qnn_matmul_kernel_call", x_int, w_int, w_scale)
    m, k = x_int.shape
    n = w_int.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x_int.device)
    if m == 0 or n == 0:
        return y
    if k == 0:
        return y.zero_()
    # split-K sums and per-tile counters (the kernel zeroes what it uses)
    n_ws = m * n + -(-m // 16) * -(-n // 64)
    ws = torch.empty((n_ws,), dtype=torch.int32, device=x_int.device)
    stream = torch.cuda.current_stream(x_int.device).cuda_stream
    err = _lib()(x_int.data_ptr(), w_int.data_ptr(), w_scale.data_ptr(), float(x_scale),
                 y.data_ptr(), ws.data_ptr(), n_ws, m, n, k, stream)
    if err != 0:
        raise RuntimeError(f"qnn_matmul kernel launch failed: CUDA error {err}")
    qnn_matmul_kernel_call.launches += 1
    return y


qnn_matmul_kernel_call.launches = 0
