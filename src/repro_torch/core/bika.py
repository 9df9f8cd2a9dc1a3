"""BiKA math (port of ``repro/core/bika.py``): the training forms
``bika_matmul`` (fused broadcast or K-chunked) and ``bika_matmul_cvjp``
(custom backward saving only (x, w, beta)), the (w, beta) -> (tau, s)
export, threshold quantization, the m-axis fold, the plain comparator
contraction ``bika_matmul_hw`` with the 8-bit PE's saturating accumulator
(``hw_exact``), and the reference's layer names ``bika_linear_*`` and
``bika_conv2d_*`` under a ``BikaConfig``, over the port's one bika
projection (``core/backend.py``) and one conv (``nn/conv.py``).

The training forms are plain PyTorch. They are the plain versions behind
the ``cac_train`` kernel route (``kernels/ops.py:cac_train_matmul``), which
every bika training projection takes (``core/backend.py``). The reference's
``tiled`` forms are an XLA memory schedule; here they are the same values
computed a slice of rows at a time."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .ste import sign, sign_ste

__all__ = [
    "ACC_LO",
    "ACC_HI",
    "BikaConfig",
    "bika_conv2d_apply",
    "bika_conv2d_init",
    "bika_linear_apply",
    "bika_linear_init",
    "bika_matmul",
    "bika_matmul_cvjp",
    "bika_matmul_hw",
    "bika_matmul_hw_tiled",
    "fold_m_axis",
    "tile_m_axis",
    "to_hardware",
    "quantize_thresholds",
    "saturating_accumulate",
]

ACC_LO, ACC_HI = -128, 127  # the 8-bit PE accumulator range


@dataclasses.dataclass(frozen=True)
class BikaConfig:
    """Per-layer BiKA options (the reference's fields and defaults).

    m: thresholds per edge (1 = BiKA). chunk: K slice of the chunked sum
    (None = one broadcast). out_scale: 'none' (raw integer sums, the
    paper's networks) or 'rsqrt_k' (y / sqrt(m K)). hw_exact: the 8-bit
    saturating accumulator in the forward. fold_m: one contraction over
    K' = m K instead of an m-term sum (ignored by ``hw_exact``, whose per-m
    saturating sums depend on the order)."""

    m: int = 1
    chunk: Optional[int] = None
    out_scale: str = "none"
    hw_exact: bool = False
    fold_m: bool = True


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


class _BikaCvjp(torch.autograd.Function):
    """The training CAC with its STE backward from (x, w, beta) alone, a
    slice of rows at a time: the plain versions of the training CAC
    kernels (``cac_train_fwd_plain``, ``cac_train_bwd_fused_plain``), in
    float32, whose (rows, K, N) intermediates stay bounded."""

    @staticmethod
    def forward(ctx, x2, w, beta):
        from repro_torch.kernels.cac_matmul import cac_train_fwd_plain

        ctx.save_for_backward(x2, w, beta)
        return cac_train_fwd_plain(x2.float(), w.float(), beta.float()).to(x2.dtype)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.cac_matmul import cac_train_bwd_fused_plain

        x, w, beta = ctx.saved_tensors
        dx, dw, dbeta = cac_train_bwd_fused_plain(x.float(), w.float(), beta.float(),
                                                  g.float().contiguous())
        return dx.to(x.dtype), dw.to(w.dtype), dbeta.to(beta.dtype)


def bika_matmul_cvjp(x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor, *,
                     tiled: bool = False) -> torch.Tensor:
    """Training-form BiKA whose backward keeps only (x, w, beta) and
    recomputes the mask; the same function as ``bika_matmul``, a slice of
    rows at a time. ``tiled`` is the reference's switch to its bounded-memory
    (mc, kc) schedule; this form is bounded already, so both values take
    the one route. x: (..., K) -> (..., N)."""
    del tiled
    lead = x.shape[:-1]
    y = _BikaCvjp.apply(x.reshape(-1, x.shape[-1]), w, beta)
    return y.reshape(lead + (w.shape[-1],)).to(x.dtype)


def saturating_accumulate(terms: torch.Tensor, lo: int = ACC_LO, hi: int = ACC_HI) -> torch.Tensor:
    """The 8-bit PE's running sum ("sum limitation"): terms (K, ...) summed
    over axis 0, saturating at [lo, hi] after every term."""
    acc = torch.zeros(terms.shape[1:], dtype=terms.dtype, device=terms.device)
    for t in terms:
        acc = torch.clamp(acc + t, lo, hi)
    return acc


def bika_matmul_hw(
    x: torch.Tensor,
    tau: torch.Tensor,
    s: torch.Tensor,
    *,
    hw_exact: bool = False,
    clamp: bool = True,
    acc_dtype: torch.dtype = torch.int32,
) -> torch.Tensor:
    """Plain hardware-form CAC: y[b,n] = sum_k s[k,n] * Sign(x[b,k] - tau[k,n]),
    as a comparator (``x >= tau``) over an (..., K, N) broadcast.
    ``hw_exact`` saturates the sum at the int8 bounds after every input,
    bit for bit the FPGA PE; otherwise the sum is wide and ``clamp``
    applies the 8-bit range to the final sum (the LM path passes False)."""
    one = torch.ones((), dtype=acc_dtype, device=x.device)
    cmp = torch.where(x[..., :, None] >= tau, one, -one)
    terms = cmp * s.to(acc_dtype)
    if hw_exact:
        return saturating_accumulate(torch.movedim(terms, -2, 0))
    acc = terms.sum(dim=-2, dtype=acc_dtype)
    return acc.clamp(ACC_LO, ACC_HI) if clamp else acc


def bika_matmul_hw_tiled(x: torch.Tensor, tau: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``bika_matmul_hw`` unclamped, summed in float32, a slice of rows at a
    time (the training kernels' plain slices) so the (rows, K, N)
    intermediate stays bounded. x (..., K) -> (..., N) float32."""
    from repro_torch.kernels.cac_matmul import _row_chunks

    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    k, n = tau.shape
    tau, s = tau.to(torch.float32), s.to(torch.float32)
    y = x2.new_empty((x2.shape[0], n))
    for a, b in _row_chunks(x2.shape[0], k, n):
        y[a:b] = bika_matmul_hw(x2[a:b], tau, s, clamp=False, acc_dtype=torch.float32)
    return y.reshape(lead + (n,))


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


# ---------------------------------------------------------------------------
# Layer init / apply (training form, m thresholds per edge)
# ---------------------------------------------------------------------------


def bika_linear_init(gen: torch.Generator, k: int, n: int, m: int = 1,
                     dtype: torch.dtype = torch.float32, *, device=None):
    """PyTorch-Linear-style uniform init of (w, beta), each (m, K, N) in
    [-1/sqrt(K), 1/sqrt(K)), drawn from ``gen`` (as the bika backend draws
    its training parameters)."""
    from .backend import _uniform

    bound = 1.0 / (k ** 0.5)
    return {"w": _uniform(gen, (m, k, n), dtype, bound, device),
            "beta": _uniform(gen, (m, k, n), dtype, bound, device)}


def _spec(cfg: BikaConfig):
    from .backend import LinearSpec

    return LinearSpec(mode="bika", m=cfg.m, fold_m=cfg.fold_m, chunk=cfg.chunk,
                      out_scale=cfg.out_scale)


def bika_linear_apply(params, x: torch.Tensor, cfg: BikaConfig = BikaConfig()) -> torch.Tensor:
    """The reference's BiKA layer over the port's one bika projection:
    ``BikaBackend.apply_train`` (the training CAC route) with gamma = 1.
    ``chunk`` and ``fold_m`` change only the order of a sum of +-1 terms,
    which is exact in any order, so they change no value. With
    ``hw_exact`` the forward is the PE's: (tau, s) and one saturating int8
    accumulator per threshold set j, never folded."""
    from .backend import _out_scale, get_backend

    w, beta = params["w"], params["beta"]
    m, k, n = w.shape
    if not cfg.hw_exact:
        one = torch.ones((n,), dtype=w.dtype, device=w.device)
        return get_backend("bika").apply_train(dict(params, gamma=one), x, _spec(cfg))
    tau, s = to_hardware(w, beta)
    y = sum(bika_matmul_hw(x, tau[j], s[j], hw_exact=True) for j in range(m)).to(x.dtype)
    return _out_scale(y, m * k, _spec(cfg))


def bika_conv2d_init(gen: torch.Generator, c_in: int, c_out: int, kh: int = 3, kw: int = 3,
                     m: int = 1, dtype: torch.dtype = torch.float32, *, device=None):
    return bika_linear_init(gen, c_in * kh * kw, c_out, m, dtype, device=device)


def bika_conv2d_apply(params, x: torch.Tensor, *, kh: int = 3, kw: int = 3, stride: int = 1,
                      padding: str = "SAME", cfg: BikaConfig = BikaConfig()) -> torch.Tensor:
    """BiKAConv2d: x (B, H, W, C) -> (B, H', W', C_out), the port's one
    conv (``nn/conv.im2col_apply``) over ``bika_linear_apply``. Each patch
    element has its own threshold, the conv form of the per-edge bias."""
    from repro_torch.nn.conv import im2col_apply

    return im2col_apply(lambda rows: bika_linear_apply(params, rows, cfg), x,
                        kh=kh, kw=kw, stride=stride, padding=padding)
