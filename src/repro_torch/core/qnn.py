"""8-bit QNN layers (FINN-R style), the paper's second hardware baseline
(port of ``repro/core/qnn.py``).

Training: symmetric per-output-channel weight fake-quant and PACT-style
learnable activation clipping, both with round-STE.

Serving: integer matmul with int32 accumulation, then requantization. Any
monotone activation + quantizer is expressible as 2^n - 1 threshold
comparisons on the accumulator (FINN-R); both that threshold form and the
arithmetic round/clip form are here, and equal.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .ste import clip_ste, round_ste

__all__ = [
    "QMAX_A",
    "QMAX_W",
    "quantize_weights",
    "fake_quant_weights",
    "fake_quant_activations",
    "qnn_linear_init",
    "qnn_linear_apply",
    "requant_scale",
    "requant_arith",
    "requant_thresholds",
    "requant_threshold_form",
]

QMAX_W = 127  # int8 symmetric weights
QMAX_A = 255  # uint8 activations


def _channel_scale(w: torch.Tensor) -> torch.Tensor:
    """max |w| over K (axis -2) / QMAX_W, floored at 1e-12."""
    scale = w.abs().amax(dim=-2, keepdim=True) / QMAX_W
    return torch.clamp_min(scale, 1e-12)


def quantize_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantization -> (w_int, scale).

    w: (..., K, N); the max runs over K (axis -2), so stacked (L, K, N)
    layer leaves quantize per layer and per channel. Round half to even."""
    scale = _channel_scale(w)
    w_int = torch.clamp(torch.round(w / scale), -QMAX_W, QMAX_W).to(torch.int8)
    return w_int, scale


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``clip`` as a max then a min, so that an element ON a bound gets half
    the gradient, as ``jnp.clip`` gives it (``torch.clamp`` gives all of it).
    The per-channel max weight lands exactly on +-QMAX_W."""
    lo_t = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi_t = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def fake_quant_weights(w: torch.Tensor) -> torch.Tensor:
    """Weights onto their int8 grid and back; the scale carries no gradient."""
    scale = _channel_scale(w.detach())
    return round_ste(_clip(w / scale, -QMAX_W, QMAX_W)) * scale


def fake_quant_activations(x: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """uint8 fake-quant of ReLU-clipped activations (PACT): x in [0, amax]."""
    amax = torch.clamp_min(amax, 1e-6)
    scale = amax / QMAX_A
    x = clip_ste(x, 0.0, 1.0 * 10**9)  # ReLU with STE
    x = torch.minimum(x, amax)  # clip at the learnable ceiling (grad flows to amax)
    return round_ste(x / scale) * scale


def qnn_linear_init(gen: torch.Generator, k: int, n: int, dtype=torch.float32, *, device=None):
    bound = 1.0 / (k**0.5)

    def uniform(shape):
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
        return ((u * 2.0 - 1.0) * bound).to(dtype)

    return {
        "w": uniform((k, n)),
        "b": uniform((n,)),
        "amax": torch.full((), 6.0, dtype=dtype, device=device),  # PACT clip ceiling
    }


def qnn_linear_apply(params, x: torch.Tensor, *, quant_input: bool = True,
                     activation: bool = True) -> torch.Tensor:
    """Fake-quant training path. activation=False -> raw float pre-activation."""
    if quant_input:
        x = fake_quant_activations(x, params["amax"])
    w = fake_quant_weights(params["w"])
    pre = x @ w + params["b"]
    if not activation:
        return pre
    return fake_quant_activations(pre, params["amax"])


# ---------------------------------------------------------------------------
# Integer inference path with FINN-R threshold requantization
# ---------------------------------------------------------------------------


def requant_scale(s_in: torch.Tensor, s_w: torch.Tensor, s_out: torch.Tensor) -> torch.Tensor:
    """Combined requant multiplier M = s_in*s_w/s_out (per output channel)."""
    return s_in * s_w / s_out


def requant_arith(acc: torch.Tensor, mscale, bits: int = 8) -> torch.Tensor:
    """Arithmetic requantization: clip(floor(acc * M + 0.5), 0, 2^bits - 1).

    Hardware requantizers (and the threshold form below) round half up,
    floor(x + 0.5), not IEEE half to even: ``torch.round`` would disagree
    exactly on the .5 grid (M = 0.5 puts every odd accumulator there)."""
    qmax = 2**bits - 1
    return torch.clamp(torch.floor(acc * mscale + 0.5), 0, qmax).to(torch.int32)


def requant_thresholds(mscale: float, bits: int = 8) -> torch.Tensor:
    """FINN-R thresholds T_j, j = 1..2^bits - 1, with
    ``requant_arith(acc) == sum_j [acc >= T_j]``: on an integer accumulator
    and a non-negative M, T_j = ceil((j - 0.5) / M)."""
    j = torch.arange(1, 2**bits, dtype=torch.float32)
    return torch.ceil((j - 0.5) / mscale).to(torch.int32)


def requant_threshold_form(acc: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """Serial-comparator requantization: the count of passed thresholds."""
    return (acc[..., None] >= thresholds).sum(dim=-1).to(torch.int32)
