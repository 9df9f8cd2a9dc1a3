"""Parameter-tree sizes (port of ``repro/nn/module.py``: ``count_params``
and ``param_bytes``) and ``stack_trees``. The port's parameters are plain
tensors in nested dicts and lists, with no logical-axis boxes, so the
reference's ``P``, ``unbox`` and ``boxed_like`` have no counterpart; a
tree of the same structure holds each leaf's logical axes instead
(``ModelAPI.param_axes``, the reference's ``axes_of`` of a boxed tree),
read by ``distributed.sharding``."""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import tree_leaves

__all__ = ["count_params", "param_bytes", "stack_trees"]


def _tensors(tree):
    return [leaf for leaf in tree_leaves(tree) if isinstance(leaf, torch.Tensor)]


def count_params(tree) -> int:
    """Number of elements over every tensor of ``tree``."""
    return sum(leaf.numel() for leaf in _tensors(tree))


def param_bytes(tree) -> int:
    """Bytes over every tensor of ``tree`` (elements x element size)."""
    return sum(leaf.numel() * leaf.element_size() for leaf in _tensors(tree))


def stack_trees(trees):
    """Stack same-shaped dict trees leaf by leaf on a new leading axis (the
    reference's ``vmap``-ed inits: experts, layers), dropping each leaf
    from the source trees once it is stacked, so that the peak is the trees
    plus one stacked leaf, not twice the trees (a full-width expert layer's
    train form is ~20 GB)."""
    first = trees[0]
    if not isinstance(first, dict):
        return torch.stack(trees)
    out = {}
    for k in list(first):
        out[k] = stack_trees([t[k] for t in trees])
        for t in trees:
            del t[k]
    return out
