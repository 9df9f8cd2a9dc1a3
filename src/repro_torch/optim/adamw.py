"""AdamW and SGD over parameter trees (port of ``repro/optim/adamw.py``),
with global-norm clipping.

The reference's update order is kept: clip the gradients to the global
norm, then update the moments, bias-correct them, and apply the step with
decoupled weight decay. Unlike the functional reference, ``update`` writes
the parameters and the moments IN PLACE (the trees passed in are updated
and returned), so a step holds no second copy of either; the gradients are
not modified.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

__all__ = ["OptimizerSpec", "adamw", "sgd", "global_norm", "clip_by_global_norm",
           "make_optimizer", "tree_leaves"]


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    name: str = "adamw"
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    momentum: float = 0.9  # sgd


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict/list tree in a fixed order (dict keys
    sorted, as jax.tree_util orders them)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like_tree(v) for v in tree)
    return torch.zeros_like(tree, dtype=torch.float32)


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(leaf.to(torch.float32).square().sum() for leaf in leaves))


def _clipped(tree, max_norm: float) -> Tuple[Iterator[torch.Tensor], torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return ((leaf * scale).to(leaf.dtype) for leaf in tree_leaves(tree)), norm


def clip_by_global_norm(tree, max_norm: float) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(the leaves scaled so their global norm is at most ``max_norm``, the
    norm before scaling). New tensors; ``tree`` is not modified."""
    leaves, norm = _clipped(tree, max_norm)
    return list(leaves), norm


def _grads(spec: OptimizerSpec, grads):
    """(the gradient leaves, each clipped only as the update reaches it, so
    that a step never holds a second, clipped copy of the whole gradient
    tree; the global norm)."""
    if spec.clip_norm is not None:
        return _clipped(grads, spec.clip_norm)
    return tree_leaves(grads), global_norm(grads)


def adamw(spec: OptimizerSpec, lr_fn: Callable):
    """Returns (init, update). update(grads, state, params) -> (params,
    state, stats), params and state updated in place."""

    def init(params) -> Dict:
        return {"m": _zeros_like_tree(params), "v": _zeros_like_tree(params), "step": 0}

    @torch.no_grad()
    def update(grads, state, params):
        flat_g, gnorm = _grads(spec, grads)
        step = state["step"] + 1
        lr = lr_fn(step)
        t = torch.tensor(float(step), dtype=torch.float32)
        bc1 = float(1.0 - torch.tensor(spec.b1, dtype=torch.float32) ** t)
        bc2 = float(1.0 - torch.tensor(spec.b2, dtype=torch.float32) ** t)
        for p, g, m, v in zip(tree_leaves(params), flat_g, tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            g32 = g.to(torch.float32)
            m.mul_(spec.b1).add_(g32, alpha=1 - spec.b1)
            v.mul_(spec.b2).add_(g32 * g32, alpha=1 - spec.b2)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + spec.eps)
            delta.add_(p.to(torch.float32), alpha=spec.weight_decay)
            p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
        state["step"] = step
        return params, state, {"lr": lr, "grad_norm": gnorm}

    return init, update


def sgd(spec: OptimizerSpec, lr_fn: Callable):
    """SGD with momentum; update in place like ``adamw``."""

    def init(params) -> Dict:
        return {"mu": _zeros_like_tree(params), "step": 0}

    @torch.no_grad()
    def update(grads, state, params):
        flat_g, gnorm = _grads(spec, grads)
        step = state["step"] + 1
        lr = lr_fn(step)
        for p, g, mu in zip(tree_leaves(params), flat_g, tree_leaves(state["mu"])):
            mu.mul_(spec.momentum).add_(g.to(torch.float32))
            p.copy_((p.to(torch.float32) - lr * mu).to(p.dtype))
        state["step"] = step
        return params, state, {"lr": lr, "grad_norm": gnorm}

    return init, update


def make_optimizer(spec: OptimizerSpec):
    from .schedule import cosine_warmup

    lr_fn = cosine_warmup(spec.peak_lr, spec.warmup, spec.total_steps)
    if spec.name == "adamw":
        return adamw(spec, lr_fn)
    if spec.name == "sgd":
        return sgd(spec, lr_fn)
    raise ValueError(spec.name)
