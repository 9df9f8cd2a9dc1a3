"""BiKA math (port of ``repro/core/bika.py``): the training forms
``bika_matmul`` (fused broadcast or K-chunked) and ``bika_matmul_cvjp``
(custom backward saving only (x, w, beta)), the (w, beta) -> (tau, s)
export, threshold quantization, the m-axis fold and the plain comparator
contraction ``bika_matmul_hw``.

The training forms are plain PyTorch. They are the plain versions behind
the ``cac_train`` kernel route (``kernels/ops.py:cac_train_matmul``), which
every bika training projection takes (``core/backend.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .ste import sign, sign_ste

__all__ = [
    "ACC_LO",
    "ACC_HI",
    "bika_matmul",
    "bika_matmul_cvjp",
    "bika_matmul_hw",
    "fold_m_axis",
    "tile_m_axis",
    "to_hardware",
    "quantize_thresholds",
]

ACC_LO, ACC_HI = -128, 127  # the 8-bit PE accumulator range

_W_EPS = 1e-8
_ALWAYS_FIRE = -1e9  # tau for degenerate w == 0 edges: Sign(beta) regardless of x


def _edge_sum(x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """sum_k SignSTE(x[..., k] * w[k, n] + beta[k, n]), fused broadcast form."""
    return sign_ste(x[..., :, None] * w + beta).sum(dim=-2)


def bika_matmul(x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor, *,
                chunk: Optional[int] = None) -> torch.Tensor:
    """Training-form BiKA contraction. x: (..., K); w, beta: (K, N) -> (..., N).
    ``chunk`` sums K in slices of that many rows (bounded live memory); a
    ragged last slice is padded with w = 0, beta = +1, so each padded edge
    adds a constant +1, subtracted after the loop (the reference's scheme)."""
    k = x.shape[-1]
    if w.shape[0] != k or beta.shape != w.shape:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"beta {tuple(beta.shape)}")
    if chunk is None or chunk >= k:
        return _edge_sum(x, w, beta)
    n_chunks = -(-k // chunk)
    pad = n_chunks * chunk - k
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
        w = torch.cat([w, w.new_zeros((pad,) + w.shape[1:])], dim=0)
        beta = torch.cat([beta, beta.new_ones((pad,) + beta.shape[1:])], dim=0)
    acc = x.new_zeros(x.shape[:-1] + (w.shape[-1],))
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        acc = acc + _edge_sum(x[..., sl], w[sl], beta[sl])
    return acc - pad if pad else acc


def _bwd_fused(x, w, beta, g):
    """The STE backward of ``bika_matmul`` from (x, w, beta): the hard-tanh
    mask recomputed once for (dx, dw, dbeta). x (M, K), g (M, N)."""
    mask = ((x[:, :, None] * w[None] + beta[None]).abs() <= 1.0).to(g.dtype)
    gm = g[:, None, :] * mask
    dx = (gm * w[None].to(g.dtype)).sum(dim=2)
    dw = (gm * x[:, :, None].to(g.dtype)).sum(dim=0)
    dbeta = gm.sum(dim=0)
    return dx, dw, dbeta


class _BikaCvjp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w, beta):
        ctx.save_for_backward(x2, w, beta)
        return sign(x2[:, :, None] * w + beta).sum(dim=-2)

    @staticmethod
    def backward(ctx, g):
        x, w, beta = ctx.saved_tensors
        dx, dw, dbeta = _bwd_fused(x, w, beta, g.to(torch.float32))
        return dx.to(x.dtype), dw.to(w.dtype), dbeta.to(beta.dtype)


def bika_matmul_cvjp(x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Training-form BiKA whose backward keeps only (x, w, beta) and
    recomputes the mask (``_bwd_fused``); the same function as
    ``bika_matmul``. x: (..., K) -> (..., N)."""
    lead = x.shape[:-1]
    y = _BikaCvjp.apply(x.reshape(-1, x.shape[-1]), w, beta)
    return y.reshape(lead + (w.shape[-1],)).to(x.dtype)


def bika_matmul_hw(
    x: torch.Tensor,
    tau: torch.Tensor,
    s: torch.Tensor,
    *,
    clamp: bool = True,
    acc_dtype: torch.dtype = torch.int32,
) -> torch.Tensor:
    """Plain hardware-form CAC: y[b,n] = sum_k s[k,n] * Sign(x[b,k] - tau[k,n]),
    as a comparator (``x >= tau``) over an (..., K, N) broadcast. ``clamp``
    applies the 8-bit range to the final sum; the LM path passes False."""
    one = torch.ones((), dtype=acc_dtype, device=x.device)
    cmp = torch.where(x[..., :, None] >= tau, one, -one)
    acc = (cmp * s.to(acc_dtype)).sum(dim=-2, dtype=acc_dtype)
    return acc.clamp(ACC_LO, ACC_HI) if clamp else acc


def fold_m_axis(w: torch.Tensor, beta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, K, N) edge params -> (m*K, N), row block j = threshold set j."""
    m, k, n = w.shape
    return w.reshape(m * k, n), beta.reshape(m * k, n)


def tile_m_axis(x: torch.Tensor, m: int) -> torch.Tensor:
    """Repeat the trailing K axis m times: (..., K) -> (..., m*K), matching
    the row order of ``fold_m_axis``."""
    if m == 1:
        return x
    return x.repeat(*([1] * (x.dim() - 1)), m)


def to_hardware(w: torch.Tensor, beta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w, beta) -> (tau, s) with Sign(w*x + beta) == s * Sign(x - tau) (Eq. 8).

    w > 0: tau = -beta/w, s = +1. w < 0: s = -1 and the threshold is nudged
    one ulp up so the boundary point (w*x + beta == 0 -> +1) survives float
    comparison. |w| < 1e-8: tau = -1e9 (always fires), s = Sign(beta)."""
    one = torch.ones((), dtype=w.dtype, device=w.device)
    degenerate = w.abs() < _W_EPS
    safe_w = torch.where(degenerate, one, w)
    tau_raw = -beta / safe_w
    tau_neg = torch.nextafter(
        tau_raw.float(), torch.full((), float("inf"), device=w.device)
    ).to(tau_raw.dtype)
    tau = torch.where(w > 0, tau_raw, tau_neg)
    s = torch.where(w > 0, one, -one)
    tau = torch.where(degenerate, torch.full((), _ALWAYS_FIRE, dtype=w.dtype, device=w.device), tau)
    s = torch.where(degenerate, sign(beta), s).to(w.dtype)
    return tau.to(w.dtype), s


def quantize_thresholds(
    tau: torch.Tensor, x_scale: float, bits: int = 8
) -> Tuple[torch.Tensor, float]:
    """Round float thresholds onto the int grid of the activations
    (half-to-even, clamped to int{bits}). Returns (tau_int int8, x_scale)."""
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    # a same-device 0-dim divisor keeps the division a true IEEE divide on
    # every device (a CPU-scalar divisor may become a reciprocal multiply)
    scale = torch.full((), x_scale, dtype=tau.dtype, device=tau.device)
    tau_int = torch.clamp(torch.round(tau / scale), lo, hi).to(torch.int8)
    return tau_int, x_scale
