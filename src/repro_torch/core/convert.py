"""Conversions between network families (port of ``repro/core/convert.py``):

* KAN edge functions -> m unit thresholds each (``kan_layer_to_thresholds``,
  Fig. 3-6): sample each B-spline edge to a t-slot piecewise-constant
  function, take the Eq. 7 closed form, quantize the weights to the integer
  budget m and expand them into unit thresholds; m = 1 is the BiKA edge.
* BiKA training form (w, beta) -> the CAC array's int8 thresholds and
  1-bit signs (``bika_params_to_hw_int8``).
* Whole-model train -> serve conversion (``params_to_serve`` /
  ``tree_to_serve``) through the backend registry.

``from_reference`` brings a JAX-package parameter tree (nested dicts of
numpy arrays) into the port with the same layouts."""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from . import kan as kan_mod
from . import thresholds as thr
from .backend import get_backend
from .bika import quantize_thresholds, to_hardware
from .ste import sign

__all__ = [
    "approximation_error",
    "bika_params_to_hw_int8",
    "from_reference",
    "kan_layer_to_thresholds",
    "params_to_serve",
    "threshold_layer_apply",
    "tree_to_serve",
]


def kan_layer_to_thresholds(kan_params: Dict, *, t_slots: int = 16, m: int = 4, grid: int = 5,
                            order: int = 3, lo: float = -1.0, hi: float = 1.0) -> Dict:
    """Every KAN edge function -> exactly m unit thresholds:
    {"tau": (m, K, N), "s": (m, K, N), "scale": (K, N)}, float32 on the
    CPU, with

        phi_{k,n}(x) ~ scale[k,n] * sum_j s[j,k,n] * Sign(x - tau[j,k,n]).

    ``scale`` is the per-edge magnitude the integer quantization removed,
    kept explicit so the approximation error can be measured (Fig. 5-6)."""
    w_base = kan_params["w_base"].detach().cpu()
    coef = kan_params["coef"].detach().cpu()
    k_in, n_out = w_base.shape
    taus = np.zeros((m, k_in, n_out), np.float32)
    signs = np.zeros((m, k_in, n_out), np.float32)
    scales = np.zeros((k_in, n_out), np.float32)
    # every edge sampled at the slot midpoints at once
    edges = torch.linspace(lo, hi, t_slots + 1, dtype=torch.float32)
    mids = (edges[:-1] + edges[1:]) / 2.0
    basis = kan_mod.bspline_basis(mids, lo, hi, grid, order)  # (t, G + k)
    spline = torch.einsum("tg,kng->tkn", basis, coef)
    outputs = spline + torch.nn.functional.silu(mids)[:, None, None] * w_base[None]
    for ki in range(k_in):
        for ni in range(n_out):
            alphas = thr.pwc_to_alphas(outputs[:, ki, ni])
            total = float(alphas.abs().sum())
            if total == 0.0:
                continue
            tau_e, s_e = thr.expand_unit_thresholds(edges[:-1], thr.quantize_alphas(alphas, m))
            cnt = min(m, tau_e.shape[0])
            taus[:cnt, ki, ni] = tau_e.numpy()[:cnt]
            signs[:cnt, ki, ni] = s_e.numpy()[:cnt]
            scales[ki, ni] = total / m
    return {"tau": torch.from_numpy(taus), "s": torch.from_numpy(signs),
            "scale": torch.from_numpy(scales)}


def threshold_layer_apply(tparams: Dict, x: torch.Tensor) -> torch.Tensor:
    """The converted layer: y[..., n] = sum_k scale * sum_j s * Sign(x - tau)."""
    tau, s, scale = tparams["tau"], tparams["s"], tparams["scale"]
    cmp = sign(x[..., None, :, None] - tau)  # (..., m, K, N)
    return ((s * cmp).sum(dim=-3) * scale).sum(dim=-2)


def bika_params_to_hw_int8(params: Dict, x_scale: float
                           ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """BiKA (w, beta) -> (int8 thresholds, int8 +-1 signs, x_scale) for the
    CAC array."""
    tau, s = to_hardware(params["w"], params["beta"])
    tau_int, _ = quantize_thresholds(tau, x_scale)
    return tau_int, s.to(torch.int8), x_scale


def approximation_error(fn, tau: torch.Tensor, s: torch.Tensor, scale: float, lo: float,
                        hi: float, n: int = 2048) -> float:
    """RMS error of the threshold approximation of a scalar function on n
    points of [lo, hi)."""
    x = lo + torch.arange(n, dtype=torch.float32) * ((hi - lo) / n)
    approx = scale * thr.threshold_sum(x, tau, s)
    return float(((fn(x) - approx) ** 2).mean().sqrt())


def params_to_serve(params: Dict, spec) -> Dict:
    """One linear layer's trained params -> hardware serve form."""
    return get_backend(spec.mode).to_serve(params, spec)


def _is_tensor(v) -> bool:
    return isinstance(v, torch.Tensor)


def tree_to_serve(tree, spec):
    """Convert every linear leaf of a trained model tree to serve form.

    A linear leaf is a dict whose keys match the backend's
    ``train_param_keys(spec)`` (required <= keys <= required | optional) with
    tensor values. Stacked ``(L, ...)`` leaves convert in one shot (every
    ``to_serve`` is elementwise over leading dims); everything else passes
    through untouched."""
    be = get_backend(spec.mode)
    req, opt = be.train_param_keys(spec)

    def walk(node):
        if isinstance(node, dict):
            keys = frozenset(node)
            if req <= keys <= (req | opt) and all(_is_tensor(v) for v in node.values()):
                return be.to_serve(node, spec)
            return {k2: walk(v) for k2, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(tree)


def from_reference(tree, device: Optional[Union[str, torch.device]] = "cpu"):
    """Reference parameter tree (train or serve form, stacked ``(L, ...)``
    layer leaves, already unboxed, leaves numpy arrays) -> the port's tree.
    Layouts are kept as they are: ``(K, N)`` / ``(m, K, N)``, never
    transposed to torch's ``(N, K)``."""

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        # a C-ordered copy that keeps a 0-dim leaf 0-dim (a qnn8 layer's amax),
        # which np.ascontiguousarray would make (1,)
        return torch.from_numpy(np.array(node, order="C")).to(device)

    return walk(tree)
