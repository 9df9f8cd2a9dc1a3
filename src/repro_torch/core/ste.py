"""Hardware Sign and the straight-through estimators of training (port of
``repro/core/ste.py``).

The paper (§II-B) replaces the backward of ``Sign`` with the derivative of
hard-tanh: ``d Sign(x)/dx := 1[|x| <= 1]`` (the window is inclusive).
``sign_ste``, ``round_ste`` and ``clip_ste`` are ``torch.autograd.Function``s
with the reference's forwards and custom VJPs.
"""
from __future__ import annotations

import torch

__all__ = ["sign", "sign_ste", "round_ste", "clip_ste"]


def sign(x: torch.Tensor) -> torch.Tensor:
    """+1 if x >= 0 else -1 (paper Eq. 8: Sign(0) = +1), in x's dtype."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x >= 0, one, -one)


class _SignSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return sign(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        # hard-tanh derivative: pass-through inside [-1, 1], zero outside
        return g * (x.abs() <= 1.0).to(g.dtype)


class _RoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)  # half to even, as jnp.round

    @staticmethod
    def backward(ctx, g):
        return g


class _ClipSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo: float, hi: float):
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        mask = ((x >= ctx.lo) & (x <= ctx.hi)).to(g.dtype)
        return g * mask, None, None


def sign_ste(x: torch.Tensor) -> torch.Tensor:
    """Sign forward, hard-tanh window ``1[|x| <= 1]`` backward."""
    return _SignSTE.apply(x)


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """Round with identity gradient (the standard fake-quant STE)."""
    return _RoundSTE.apply(x)


def clip_ste(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Clip whose gradient is identity inside ``[lo, hi]``, zero outside."""
    return _ClipSTE.apply(x, lo, hi)
