"""Feed-forward blocks over the switchable linear layer (port of
``repro/nn/mlp.py``): SwiGLU (llama family), gated and ungated variants,
squared ReLU (nemotron). ``"gelu"`` is the tanh approximation, which is
``jax.nn.gelu``'s default (grok-1)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import comm
from .linear import LinearSpec, linear_apply, linear_axes, linear_init

__all__ = ["mlp_axes", "mlp_init", "mlp_apply"]


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu2":  # squared ReLU (nemotron-4)
        r = F.relu(x)
        return r * r
    raise ValueError(name)


def mlp_init(gen, d_model: int, d_ff: int, spec: LinearSpec, *, gated: bool = True,
             phase: str = "serve", device=None):
    p = {
        "up": linear_init(gen, d_model, d_ff, spec, phase=phase, device=device),
        "down": linear_init(gen, d_ff, d_model, spec, phase=phase, device=device),
    }
    if gated:
        p["gate"] = linear_init(gen, d_model, d_ff, spec, phase=phase, device=device)
    return p


def mlp_axes(params, prefix=()):
    """Logical axes: gate/up ("embed", "ffn"), down ("ffn", "embed")."""
    return {name: linear_axes(p, ("ffn", "embed") if name == "down" else ("embed", "ffn"),
                              prefix)
            for name, p in params.items()}


def mlp_apply(params, x: torch.Tensor, spec: LinearSpec, *, activation: str = "silu",
              phase: str = "serve", d_ff: Optional[int] = None) -> torch.Tensor:
    """down(act(gate(x)) * up(x)), or down(act(up(x))) ungated. Under an
    active tensor-parallel group with ``d_ff`` given, gate/up hold the
    rank's ffn columns: h is gathered to all ``d_ff`` before down, whose
    rank's d_model columns are gathered into the output (x's width)."""
    up = linear_apply(params["up"], x, spec, phase=phase)
    if "gate" in params:
        h = _act(activation, linear_apply(params["gate"], x, spec, phase=phase)) * up
    else:
        h = _act(activation, up)
    if d_ff is None:
        return linear_apply(params["down"], h, spec, phase=phase)
    y = linear_apply(params["down"], comm.gather_cols(h, d_ff), spec, phase=phase)
    return comm.gather_cols(y, x.shape[-1])
