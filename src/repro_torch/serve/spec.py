"""Speculative-decoding draft construction (port of ``repro/serve/spec.py``).

The backend registry holds every cheap proxy as another serve form of the
SAME trained weights, which is what a draft model needs.
``build_draft_from_train`` turns one trained float tree into a
``(draft_api, draft_params, draft_arch)`` triple for a preset:

- ``"bnn"`` / ``"qnn8"`` / ``"bika"`` / ``"dense"``: the target's own
  trained weights pushed through that backend's ``to_serve``;
- ``"small"``: a dense draft of the first ``n_layers // 2`` layers (the
  embedding and final norm shared with the target).

Greedy speculative decoding is exact for ANY draft, so the preset moves
only the acceptance rate and the draft's cost, never the output.
"""
from __future__ import annotations

import torch

from repro_torch.core.backend import get_backend
from repro_torch.models.base import ArchConfig

__all__ = ["DRAFT_PRESETS", "build_draft_from_train", "draft_arch"]

DRAFT_PRESETS = ("dense", "bika", "bnn", "qnn8", "small")

# Backends whose training form is a plain (K, N) matmul weight: freely
# inter-convertible draft/target pairs. bika trains an (m, K, N) threshold
# tensor instead, so it pairs only with itself.
_MATMUL_MODES = ("dense", "bnn", "qnn8")


def draft_arch(arch: ArchConfig, preset: str) -> ArchConfig:
    """The draft model's ArchConfig for a preset."""
    if preset not in DRAFT_PRESETS:
        raise ValueError(f"unknown draft preset {preset!r}; want one of {DRAFT_PRESETS}")
    if preset == "small":
        return arch.replace(compute_mode="dense", pack_signs=False,
                            n_layers=max(1, arch.n_layers // 2))
    pack = arch.pack_signs if preset == "bika" else False
    return arch.replace(compute_mode=preset, pack_signs=pack)


def _adapt_train_leaf(leaf, tgt_mode: str, draft_mode: str):
    """A target-backend training leaf -> one the draft backend's ``to_serve``
    accepts. Same mode passes through; across the matmul family the shared
    ``w`` carries over (bnn takes the L2-optimal binarization scale
    ``gamma = mean |w|`` over K, and drops the bias)."""
    if draft_mode == tgt_mode:
        return dict(leaf)
    if tgt_mode not in _MATMUL_MODES or draft_mode not in _MATMUL_MODES:
        raise ValueError(
            f"cannot build a {draft_mode!r} draft from a {tgt_mode!r}-trained tree: bika's "
            f"(m, K, N) threshold form has no matmul weight to share; pair bika with "
            f"itself or use a {_MATMUL_MODES} target"
        )
    out = {"w": leaf["w"]}
    if draft_mode == "bnn":
        out["gamma"] = torch.mean(torch.abs(leaf["w"]), dim=-2)
    elif "b" in leaf:
        out["b"] = leaf["b"]
    return out


def _convert_tree(tree, tgt_mode: str, tgt_spec, draft_mode: str, draft_spec):
    """``convert.tree_to_serve`` with split detection and conversion: linear
    leaves are found by the TARGET backend's ``train_param_keys`` (the tree
    was trained under it) and converted through the DRAFT backend's
    ``to_serve`` after ``_adapt_train_leaf``."""
    req, opt = get_backend(tgt_mode).train_param_keys(tgt_spec)
    draft_be = get_backend(draft_mode)

    def walk(node):
        if isinstance(node, dict):
            keys = frozenset(node)
            if req <= keys <= (req | opt) and all(isinstance(v, torch.Tensor)
                                                  for v in node.values()):
                return draft_be.to_serve(_adapt_train_leaf(node, tgt_mode, draft_mode),
                                         draft_spec)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(tree)


def _first_layers(node, n: int):
    if isinstance(node, dict):
        return {k: _first_layers(v, n) for k, v in node.items()}
    return node[:n]


def build_draft_from_train(train_params, arch: ArchConfig, preset: str):
    """Trained float tree (stacked ``(L, ...)`` layer leaves) ->
    ``(draft_api, draft_params, draft_arch)``. ``"small"`` first slices the
    layer leaves to the draft's depth."""
    from repro_torch.models import build_model

    darch = draft_arch(arch, preset)
    tree = train_params
    if preset == "small":
        tree = dict(train_params)
        tree["layers"] = _first_layers(train_params["layers"], darch.n_layers)
    dapi = build_model(darch, phase="serve")
    dparams = _convert_tree(tree, arch.compute_mode, arch.linear_spec(),
                            darch.compute_mode, darch.linear_spec())
    return dapi, dparams, darch
