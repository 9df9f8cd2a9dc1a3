"""Tensor-parallel serving placement (port-only): which leaves of an lm
serve tree a rank keeps whole and which it keeps a block of, and the
slicing that places a full tree on a rank.

The reference's serve routes are column-parallel (``repro/kernels/ops.py``
``_tp_shard_call``): a weight splits on its output dim N, the activations
stay replicated, and each device runs the unchanged kernel on its N/tp
columns, so no reduction is split and integer outputs are bit-identical to
one device's. The port does the same in explicit SPMD, with the rules of
``sharding`` (a leaf is under tensor parallelism where its spec uses the
"model" axis) and ``constraints.ACT_RULES``:

- q/k/v split on whole heads (rank r holds heads [r H/tp, (r+1) H/tp) of
  q, and of k and v, with its Hkv/tp heads of the KV cache or pool) where
  the KV leaf's spec splits kv_heads (``kv_cache_shardings``: the kv head
  count divides tp); else q/k/v and the cache are replicated, every rank
  computing every head (a 1-kv-head GQA model);
- gate/up split on d_ff, their outputs staying the rank's ffn slice;
- wo and down split on N = d_model, fed the gathered attention output and
  h, their outputs gathered. The rules split these two on K
  (("heads", "embed"), ("ffn", "embed")), which the reference's GSPMD
  reshards to shard_map's N split on each call; the port stores them as
  they are used. A K split (row parallelism) would add a cross-rank sum,
  and qnn8's scaled partial sums would no longer be bit-identical;
- the tied embedding split on vocab rows (a masked lookup plus an
  all-reduce, one nonzero addend an element; logits gathered before the
  argmax);
- norms replicated.

A projection whose N does not divide tp stays whole on every rank and runs
the same kernel on all N columns (the reference falls back to its XLA
oracle there). Serving shards over "model" only: a mesh whose "data" (or
"pod") axis is larger than 1 is refused (data parallelism comes with the
training slice, ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import comm
from .constraints import activation_rules
from .sharding import (KV_CACHE_LOGICAL_AXES, ShardingRules, logical_to_spec, mesh_shape,
                       spec_axes)

__all__ = ["Placement", "placement", "shard_serve_params", "tp_group", "tp_supports"]

TP_AXIS = "model"


def tp_supports(arch) -> bool:
    """Tensor-parallel serving covers the lm family without experts and
    without a sliding window (ROADMAP Queue 1 lists the rest)."""
    return arch.family == "lm" and not arch.n_experts and arch.window is None


def tp_group(mesh, rules: Optional[ShardingRules] = None) -> Optional[comm.TPGroup]:
    """This rank's view of ``mesh``'s "model" axis (None without a mesh).
    Raises for a mesh that also splits data (data parallelism is not
    served)."""
    import torch.distributed as dist

    if mesh is None:
        return None
    shape = mesh_shape(mesh)
    for axis in ("pod", "data"):
        if shape.get(axis, 1) > 1:
            raise ValueError(
                f"serving shards over the '{TP_AXIS}' axis only; the mesh {shape} has "
                f"{axis}={shape[axis]} (data parallelism comes with the training slice: "
                f"ROADMAP Queue 1 item 7)")
    if TP_AXIS not in shape:
        raise ValueError(f"the mesh {shape} has no '{TP_AXIS}' axis")
    group = mesh.get_group(TP_AXIS)
    return comm.TPGroup(mesh=mesh, rules=rules if rules is not None else ShardingRules(),
                        group=group, size=shape[TP_AXIS],
                        rank=int(mesh.get_local_rank(TP_AXIS)),
                        backend=dist.get_backend(group))


@dataclasses.dataclass(frozen=True)
class Placement:
    """Which leaves of an lm serve tree a rank holds a block of."""

    heads: bool  # q/k/v and the KV cache by whole heads
    ffn: bool  # gate/up on d_ff
    wo: bool  # wo on d_model (its output gathered)
    down: bool  # down on d_model (its output gathered)
    vocab: bool  # the tied embedding on vocab rows
    kv_heads: int  # the kv heads this rank's cache holds


def _uses_model(axes, shape, group: comm.TPGroup) -> bool:
    spec = logical_to_spec(axes, group.mesh, group.rules, shape)
    return TP_AXIS in spec_axes(spec)


def _act_split(name: str, group: comm.TPGroup) -> bool:
    return TP_AXIS in activation_rules(name, group.mesh)


def placement(arch, group: Optional[comm.TPGroup]) -> Placement:
    """The placement of ``arch``'s serve tree under ``group`` (None:
    everything whole)."""
    if group is None:
        return Placement(False, False, False, False, False, arch.n_kv_heads)
    d, hd, hq, hkv, ff = arch.d_model, arch.hd, arch.n_heads, arch.n_kv_heads, arch.d_ff
    kv_spec = logical_to_spec(KV_CACHE_LOGICAL_AXES, group.mesh, group.rules,
                              (arch.n_layers, 1, 1, hkv, hd))
    heads = (TP_AXIS in spec_axes(kv_spec) and hq % group.size == 0
             and _uses_model(("embed", "heads"), (d, hq * hd), group)
             and _act_split("heads", group) and _act_split("kv_heads", group))
    ffn = (ff % group.size == 0 and _uses_model(("embed", "ffn"), (d, ff), group)
           and _act_split("ffn", group))
    wo = d % group.size == 0 and _uses_model(("heads", "embed"), (hq * hd, d), group)
    down = d % group.size == 0 and _uses_model(("ffn", "embed"), (ff, d), group)
    vocab = _uses_model(("vocab", "embed"), (arch.padded_vocab, d), group)
    return Placement(heads, ffn, wo, down, vocab, hkv // group.size if heads else hkv)


def _block(t: torch.Tensor, dim: int, full: int, group: comm.TPGroup) -> torch.Tensor:
    """The rank's block of ``t`` along ``dim`` (``full`` entries); a tensor
    already holding a block passes through."""
    if t.shape[dim] != full:
        return t
    per = full // group.size
    return t.narrow(dim, group.rank * per, per).contiguous()


def _columns(proj, full: int, group):
    return {k: _block(v, -1, full, group) if v.dim() and v.shape[-1] == full else v
            for k, v in proj.items()}


def shard_serve_params(params, arch, group: Optional[comm.TPGroup]):
    """The rank's tree of an lm serve tree (stacked leaves or per-layer
    views): every split leaf sliced to the rank's block, a new tensor; the
    rest shared with ``params``. A tree already placed passes through."""
    if group is None:
        return params
    if not tp_supports(arch):
        raise ValueError(
            f"tensor-parallel serving covers the lm family without experts or a sliding "
            f"window; {arch.name} (family={arch.family!r}, n_experts={arch.n_experts}, "
            f"window={arch.window}) is served on one rank (ROADMAP Queue 1)")
    pl = placement(arch, group)
    d, hd = arch.d_model, arch.hd

    def layer(p):
        attn = dict(p["attn"])
        if pl.heads:
            attn["wq"] = _columns(attn["wq"], arch.n_heads * hd, group)
            attn["wk"] = _columns(attn["wk"], arch.n_kv_heads * hd, group)
            attn["wv"] = _columns(attn["wv"], arch.n_kv_heads * hd, group)
        if pl.wo:
            attn["wo"] = _columns(attn["wo"], d, group)
        mlp = dict(p["mlp"])
        if pl.ffn:
            for name in ("up", "gate"):
                if name in mlp:
                    mlp[name] = _columns(mlp[name], arch.d_ff, group)
        if pl.down:
            mlp["down"] = _columns(mlp["down"], d, group)
        return dict(p, attn=attn, mlp=mlp)

    layers = params["layers"]
    out = dict(params, layers=[layer(p) for p in layers] if isinstance(layers, list)
               else layer(layers))
    if pl.vocab:
        out["embed"] = {"table": _block(params["embed"]["table"], 0, arch.padded_vocab, group)}
    return out
