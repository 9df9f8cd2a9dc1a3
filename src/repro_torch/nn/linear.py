"""Backend-switchable linear projection — a thin registry dispatcher (port
of ``repro/nn/linear.py``). No per-mode branching lives here."""
from __future__ import annotations

import torch

from repro_torch.core import backend as _backend
from repro_torch.core.backend import LinearSpec, pack_signs, unpack_signs

__all__ = ["LinearSpec", "linear_axes", "linear_init", "linear_apply", "linear_to_serve",
           "pack_signs", "unpack_signs"]


def linear_init(gen: torch.Generator, k: int, n: int, spec: LinearSpec, *,
                phase: str = "serve", device=None):
    """Parameter dict of one (K -> N) projection in ``phase`` form."""
    be = _backend.get_backend(spec.mode)
    if phase == "serve":
        return be.init_serve(gen, k, n, spec, device=device)
    return be.init_train(gen, k, n, spec, device=device)


def linear_apply(params, x: torch.Tensor, spec: LinearSpec, *,
                 phase: str = "serve") -> torch.Tensor:
    """x: (..., K) -> (..., N) in ``phase`` form ("serve" or "train")."""
    be = _backend.get_backend(spec.mode)
    x = x.to(spec.cdtype)
    if phase == "serve":
        return be.apply_serve(params, x, spec)
    if phase == "train":
        return be.apply_train(params, x, spec)
    raise ValueError(f"unknown phase {phase!r}")


def linear_axes(params, axes, prefix=()):
    """The logical axes of each leaf of one projection's dict, in any mode
    and phase, as the reference's backends box them: a weight-shaped leaf
    (w, beta, tau, s, wb, w_int) ``(None,) * (its extra dims) + (in, out)``,
    a per-column one (gamma, b) ``(out,)``, w_scale ``(None, out)``, amax
    ``()``; each after ``prefix``, the names of stacked leading dims
    (("layers",) for a model's stacked layers)."""
    in_ax, out_ax = axes
    out = {}
    for name, leaf in params.items():
        if name in ("gamma", "b"):
            out[name] = prefix + (out_ax,)
        elif name == "w_scale":
            out[name] = prefix + (None, out_ax)
        elif name == "amax":
            out[name] = prefix
        else:
            out[name] = prefix + (None,) * (leaf.dim() - len(prefix) - 2) + (in_ax, out_ax)
    return out


def linear_to_serve(params, spec: LinearSpec):
    """Convert trained float params to the hardware serve form."""
    return _backend.get_backend(spec.mode).to_serve(params, spec)
