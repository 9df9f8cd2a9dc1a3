"""Parameter-tree sizes (port of ``repro/nn/module.py``: ``count_params``
and ``param_bytes``). The port's parameters are plain tensors in nested
dicts and lists, with no logical-axis boxes, so the reference's ``P``,
``unbox``, ``axes_of`` and ``boxed_like`` have no counterpart."""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import tree_leaves

__all__ = ["count_params", "param_bytes"]


def _tensors(tree):
    return [leaf for leaf in tree_leaves(tree) if isinstance(leaf, torch.Tensor)]


def count_params(tree) -> int:
    """Number of elements over every tensor of ``tree``."""
    return sum(leaf.numel() for leaf in _tensors(tree))


def param_bytes(tree) -> int:
    """Bytes over every tensor of ``tree`` (elements x element size)."""
    return sum(leaf.numel() * leaf.element_size() for leaf in _tensors(tree))
