"""Normalization layers in float32 (port of ``repro/nn/norms.py``):
RMSNorm and LayerNorm."""
from __future__ import annotations

import torch

__all__ = ["layernorm_apply", "layernorm_init", "norm_axes", "rmsnorm_apply", "rmsnorm_init"]


def norm_axes(params, prefix=()):
    """Logical axes of a norm's leaves: ("embed",) after ``prefix``."""
    return {name: prefix + ("embed",) for name in params}


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(dt)


def layernorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_apply(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32) + params["bias"].to(torch.float32)).to(dt)
