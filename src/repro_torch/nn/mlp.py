"""Feed-forward blocks over the switchable linear layer (port of
``repro/nn/mlp.py``): SwiGLU (llama family), gated and ungated variants,
squared ReLU (nemotron). ``"gelu"`` is the tanh approximation, which is
``jax.nn.gelu``'s default (grok-1)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .linear import LinearSpec, linear_apply, linear_init

__all__ = ["mlp_init", "mlp_apply"]


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


def mlp_apply(params, x: torch.Tensor, spec: LinearSpec, *, activation: str = "silu",
              phase: str = "serve") -> torch.Tensor:
    up = linear_apply(params["up"], x, spec, phase=phase)
    if "gate" in params:
        h = _act(activation, linear_apply(params["gate"], x, spec, phase=phase)) * up
    else:
        h = _act(activation, up)
    return linear_apply(params["down"], h, spec, phase=phase)
