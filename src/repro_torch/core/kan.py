"""B-spline KAN layer (port of ``repro/core/kan.py``): the accuracy
baseline of Table II (the pykan functional form: each edge's function is
base weight * silu(x) + a B-spline), and the source side of the paper's
conversion (``core/convert.py:kan_layer_to_thresholds``). Plain PyTorch;
the reference has no kernel for it."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["bspline_basis", "kan_linear_init", "kan_linear_apply", "kan_edge_fn"]


def _extended_grid(lo: float, hi: float, grid: int, k: int, device) -> torch.Tensor:
    h = (hi - lo) / grid
    return torch.arange(-k, grid + k + 1, dtype=torch.float32, device=device) * h + lo


def bspline_basis(x: torch.Tensor, lo: float, hi: float, grid: int, order: int) -> torch.Tensor:
    """Cox-de Boor: x (...,) -> (..., grid + order) basis values."""
    k = order
    t = _extended_grid(lo, hi, grid, k, x.device).to(x.dtype)
    x = x[..., None]
    b = ((x >= t[:-1]) & (x < t[1:])).to(x.dtype)  # degree 0: the knot interval
    for d in range(1, k + 1):
        left_den = t[d:-1] - t[:-(d + 1)]
        right_den = t[d + 1:] - t[1:-d]
        left = torch.where(left_den > 0, (x - t[:-(d + 1)]) / left_den, 0.0) * b[..., :-1]
        right = torch.where(right_den > 0, (t[d + 1:] - x) / right_den, 0.0) * b[..., 1:]
        b = left + right
    return b


def kan_linear_init(gen: torch.Generator, k_in: int, n_out: int, *, grid: int = 5,
                    order: int = 3, dtype: torch.dtype = torch.float32, device=None):
    """{"coef": (K, N, grid + order) N(0, 0.01), "w_base": (K, N) N(0, 1/K)}."""
    coef = torch.randn((k_in, n_out, grid + order), generator=gen, dtype=dtype,
                       device=device) * 0.1
    w_base = torch.randn((k_in, n_out), generator=gen, dtype=dtype, device=device) / k_in ** 0.5
    return {"coef": coef, "w_base": w_base}


def kan_linear_apply(params, x: torch.Tensor, *, grid: int = 5, order: int = 3,
                     lo: float = -1.0, hi: float = 1.0) -> torch.Tensor:
    """y[..., n] = sum_k w_base[k, n] silu(x_k) + sum_g coef[k, n, g] B_g(x_k)."""
    basis = bspline_basis(x, lo, hi, grid, order)  # (..., K, G + k)
    spline = torch.einsum("...kg,kng->...n", basis, params["coef"])
    return F.silu(x) @ params["w_base"] + spline


def kan_edge_fn(params, k_idx: int, n_idx: int, *, grid: int = 5, order: int = 3,
                lo: float = -1.0, hi: float = 1.0):
    """The scalar edge function phi_{k, n}(x), for conversion and plots."""
    coef = params["coef"][k_idx, n_idx]
    wb = params["w_base"][k_idx, n_idx]

    def fn(x: torch.Tensor) -> torch.Tensor:
        return wb * F.silu(x) + bspline_basis(x, lo, hi, grid, order) @ coef

    return fn
