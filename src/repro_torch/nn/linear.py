"""Backend-switchable linear projection — a thin registry dispatcher (port
of ``repro/nn/linear.py``). No per-mode branching lives here."""
from __future__ import annotations

import torch

from repro_torch.core import backend as _backend
from repro_torch.core.backend import LinearSpec, pack_signs, unpack_signs

__all__ = ["LinearSpec", "linear_init", "linear_apply", "linear_to_serve",
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


def linear_to_serve(params, spec: LinearSpec):
    """Convert trained float params to the hardware serve form."""
    return _backend.get_backend(spec.mode).to_serve(params, spec)
