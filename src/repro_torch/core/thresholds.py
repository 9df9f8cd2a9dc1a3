"""Exact conversion between piecewise-constant functions and
weighted-threshold sums (Eq. 1-7 of the paper), and the integer
m-threshold approximation (port of ``repro/core/thresholds.py``).

A piecewise-constant function on t slots ``[s_i, s_{i+1})`` with outputs
``O_i`` is exactly

    f(x) = sum_i alpha_i * Thres_{s_i}(x),   Thres_s(x) = +1 if x >= s else -1

with the closed form (Eq. 7):

    alpha_0 = (O_0 + O_{t-1}) / 2
    alpha_i = (O_i - O_{i-1}) / 2          (1 <= i <= t-1)

on x in [s_0, s_t). Quantizing the alphas to integers of total weight
m = sum |alpha_i| and expanding each weighted threshold into |alpha_i| unit
thresholds (Fig. 4-5) gives the m-threshold approximation; m = 1 is BiKA.
The integer budget and the expansion run in numpy, as in the reference.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from .ste import sign

__all__ = [
    "pwc_to_alphas",
    "alphas_to_pwc",
    "threshold_sum",
    "eval_pwc",
    "sample_to_pwc",
    "quantize_alphas",
    "expand_unit_thresholds",
    "approximate_function",
]


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def pwc_to_alphas(outputs) -> torch.Tensor:
    """Eq. 7: slot outputs ``O_i`` (t,) -> threshold weights ``alpha_i`` (t,)."""
    o = _tensor(outputs)
    a0 = (o[0] + o[-1]) / 2.0
    return torch.cat([a0[None], (o[1:] - o[:-1]) / 2.0])


def alphas_to_pwc(alphas) -> torch.Tensor:
    """Inverse of Eq. 7: ``O_i = 2 * cumsum(alpha)_i - sum(alpha)``."""
    a = _tensor(alphas)
    return 2.0 * torch.cumsum(a, dim=0) - a.sum()


def threshold_sum(x, thresholds, alphas) -> torch.Tensor:
    """f'(x) = sum_i alpha_i * Sign(x - s_i) (Eq. 3), broadcast over x."""
    x = _tensor(x)
    return (_tensor(alphas) * sign(x[..., None] - _tensor(thresholds))).sum(dim=-1)


def eval_pwc(x, boundaries, outputs) -> torch.Tensor:
    """The piecewise-constant f itself (Eq. 1): ``boundaries`` are the slot
    left ends s_0..s_{t-1}; x must lie in [s_0, s_t)."""
    x, outputs = _tensor(x), _tensor(outputs)
    idx = (x[..., None] >= _tensor(boundaries)).sum(dim=-1) - 1
    return outputs[idx.clamp(0, outputs.shape[0] - 1)]


def sample_to_pwc(fn: Callable[[torch.Tensor], torch.Tensor], lo: float, hi: float,
                  t: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """t slots on [lo, hi) (Eq. 1): (left ends s_0..s_{t-1}, outputs
    O_0..O_{t-1}), each O_i the function at the slot's midpoint."""
    edges = torch.linspace(lo, hi, t + 1, dtype=torch.float32)
    return edges[:-1], fn((edges[:-1] + edges[1:]) / 2.0)


def quantize_alphas(alphas, m: int) -> torch.Tensor:
    """Integer threshold weights of total weight sum |a_int| == m (Fig. 5-6):
    truncate alpha * m / sum|alpha|, then hand the deficit out by largest
    remainder."""
    a_t = _tensor(alphas)
    a = a_t.detach().cpu().numpy().astype(np.float64)
    total = np.abs(a).sum()
    if total == 0:
        return torch.zeros_like(a_t)
    scaled = a * (m / total)
    base = np.trunc(scaled)
    deficit = int(m - np.abs(base).sum())
    if deficit > 0:
        frac = np.abs(scaled) - np.abs(base)
        for j in np.argsort(-frac)[:deficit]:
            base[j] += np.sign(scaled[j]) if scaled[j] != 0 else 1.0
    return torch.as_tensor(base, dtype=a_t.dtype, device=a_t.device)


def expand_unit_thresholds(thresholds, int_alphas) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fig. 4: each weighted threshold (s_i, alpha_i) -> |alpha_i| unit
    thresholds. Returns float32 (taus, signs), sum |alpha_i| of each (the
    order does not change the sum); (0, 0) for an all-zero function."""
    t = _tensor(thresholds).detach().cpu().numpy()
    a = _tensor(int_alphas).detach().cpu().numpy().astype(np.int64)
    taus, signs = [], []
    for ti, ai in zip(t, a):
        taus += [float(ti)] * abs(int(ai))
        signs += [1.0 if ai > 0 else -1.0] * abs(int(ai))
    if not taus:
        taus, signs = [0.0], [0.0]
    return torch.tensor(taus, dtype=torch.float32), torch.tensor(signs, dtype=torch.float32)


def approximate_function(fn: Callable[[torch.Tensor], torch.Tensor], lo: float, hi: float,
                         t: int, m: int) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """Continuous fn -> t-slot PWC -> Eq. 7 alphas -> integer budget m ->
    unit thresholds. Returns (taus, signs, scale) with
    fn(x) ~ scale * sum_k signs_k * Sign(x - taus_k); ``scale`` restores the
    magnitude the integer quantization removed."""
    boundaries, outputs = sample_to_pwc(fn, lo, hi, t)
    alphas = pwc_to_alphas(outputs)
    total = float(alphas.abs().sum())
    if total == 0.0:
        return torch.zeros((1,)), torch.zeros((1,)), 0.0
    taus, signs = expand_unit_thresholds(boundaries, quantize_alphas(alphas, m))
    return taus, signs, total / m
