"""Logical-axis -> mesh-axis sharding rules (port of
``repro/distributed/sharding.py``, t5x/MaxText style).

Every parameter leaf has logical axis names, one per dim (the port keeps
them in a tree beside the parameters: ``ModelAPI.param_axes``; the
reference boxes each leaf with ``P``). This module maps those names onto
the axes of a mesh, with

  * late binding: rules name mesh axes; an axis absent from the mesh is
    dropped, so one rule table serves a 1-card run, a (1, 2) test mesh and
    a (16, 8) H100 cluster;
  * the divisibility fallback: a dim whose size does not divide the mapped
    mesh axes' product is replicated instead;
  * one use per mesh axis in a spec (the first dim wins);
  * ZeRO-1: optimizer-state specs extend a parameter's spec by splitting
    its largest still-replicated dim over the data axis.

The functions are pure over (logical axes, mesh shape, leaf shape) and
return a device-free placement: a tuple with one entry per leading dim,
each None, a mesh axis name or a tuple of names, trailing Nones trimmed,
as the reference's ``PartitionSpec`` holds them (``tuple(spec)`` of the
reference's equals the port's). A mesh is anything with ``shape`` (a
mapping axis name -> size: ``meshes.AbstractMesh``) or a
``torch.distributed.device_mesh.DeviceMesh``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

__all__ = [
    "FSDP_RULES",
    "KV_CACHE_LOGICAL_AXES",
    "LOGICAL_RULES",
    "ShardingRules",
    "Spec",
    "batch_sharding",
    "kv_cache_shardings",
    "logical_to_spec",
    "mesh_axis_size",
    "mesh_shape",
    "param_specs",
    "spec_axes",
    "zero1_shardings",
]

Spec = Tuple  # one entry per leading dim: None, an axis name or a tuple of names

# The default tensor-parallel rule table: (logical name, mesh axes) pairs,
# the first match wins. "data"-family axes carry the batch and ZeRO;
# "model" carries tensor parallelism; "pod" is the cross-pod data axis.
LOGICAL_RULES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("batch", ("pod", "data")),
    ("vocab", ("model",)),
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("ffn", ("model",)),
    ("ssm_inner", ("model",)),
    ("expert", ("model",)),
    ("embed", ()),  # replicated under TP; FSDP_RULES shards it
    ("layers", ()),
    ("ssm_heads", ()),
)

# FSDP / ZeRO-3 style: weights also split over "data" along the embed dim.
FSDP_RULES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("embed", ("data",)),
) + tuple((k, v) for k, v in LOGICAL_RULES if k != "embed")

# The logical axes of the KV layout contract (models/base.KVCacheLayout and
# PagedKVLayout), one per rank-5 dim: only kv_heads maps to a mesh axis, so
# a rank owns whole heads for every slot (block) and position.
KV_CACHE_LOGICAL_AXES = ("layers", None, None, "kv_heads", None)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """A rule table; ``with_overrides`` prepends pairs (they win)."""

    rules: Tuple[Tuple[str, Tuple[str, ...]], ...] = LOGICAL_RULES

    def with_overrides(self, *pairs: Tuple[str, Tuple[str, ...]]) -> "ShardingRules":
        return ShardingRules(tuple(pairs) + self.rules)

    def lookup(self, name: Optional[str]) -> Tuple[str, ...]:
        if name is None:
            return ()
        for k, v in self.rules:
            if k == name:
                return v
        return ()


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of an abstract mesh or a DeviceMesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {name: int(mesh.size(i)) for i, name in enumerate(names)}
    return dict(mesh.shape)


def mesh_axis_size(mesh, axes: Sequence[str]) -> int:
    shape = mesh_shape(mesh)
    size = 1
    for a in axes:
        size *= shape[a]
    return size


def _filter_axes(mesh, axes: Tuple[str, ...]) -> Tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in axes if a in shape)


def _entry(axes: Tuple[str, ...]):
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _trim(spec) -> Spec:
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def spec_axes(spec: Spec) -> set:
    """The mesh axes a spec uses."""
    return {a for e in spec if e is not None for a in (e if isinstance(e, tuple) else (e,))}


def logical_to_spec(logical_axes: Optional[Tuple[Optional[str], ...]], mesh,
                    rules: ShardingRules = ShardingRules(),
                    shape: Optional[Tuple[int, ...]] = None) -> Spec:
    """Logical axis names (one per dim) -> the spec on ``mesh``. With
    ``shape``, a dim whose size does not divide its mapped axes' product is
    replicated, and a mesh axis is never used twice (the first dim wins)."""
    if logical_axes is None:
        return ()
    used: set = set()
    out = []
    for i, name in enumerate(logical_axes):
        axes = _filter_axes(mesh, rules.lookup(name))
        axes = tuple(a for a in axes if a not in used)
        if axes and shape is not None and shape[i] % mesh_axis_size(mesh, axes) != 0:
            axes = ()
        used.update(axes)
        out.append(_entry(axes))
    return _trim(out)


def _shape_of(leaf) -> Optional[Tuple[int, ...]]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else None


def _map2(fn, values, axes):
    """``fn(value, axes)`` over two trees of one structure (dicts, lists)."""
    if isinstance(values, dict):
        return {k: _map2(fn, values[k], axes[k]) for k in values}
    if isinstance(values, list):
        return [_map2(fn, v, a) for v, a in zip(values, axes)]
    return fn(values, axes)


def param_specs(mesh, params, axes, rules: ShardingRules = ShardingRules()):
    """The spec of every leaf of ``params`` (tensors, or anything with
    ``shape``) from the same-structured tree ``axes`` of logical names: the
    reference's ``param_shardings``."""
    return _map2(lambda v, a: logical_to_spec(a, mesh, rules, _shape_of(v)), params, axes)


def kv_cache_shardings(mesh, cache, rules: ShardingRules = ShardingRules()):
    """The spec of every leaf of a KV cache or paged pool (the rank-5 layout
    contract): kv_heads over the rules' axes where the head count divides
    them, else the leaf replicated."""
    return {name: logical_to_spec(KV_CACHE_LOGICAL_AXES, mesh, rules, _shape_of(leaf))
            for name, leaf in cache.items()}


def batch_sharding(mesh, ndim: int = 2, batch_dim: int = 0,
                   rules: ShardingRules = ShardingRules()) -> Spec:
    """A host batch's spec: its batch dim over the data axes (untrimmed, as
    the reference builds it)."""
    axes = _filter_axes(mesh, rules.lookup("batch"))
    spec = [None] * ndim
    spec[batch_dim] = _entry(axes)
    return tuple(spec)


def zero1_shardings(mesh, params, axes, rules: ShardingRules = ShardingRules(),
                    opt_axes: Tuple[str, ...] = ("data",)):
    """ZeRO-1: an optimizer moment's spec is its parameter's plus the largest
    still-replicated dim that divides the ``opt_axes`` product split over
    them, where the parameter's spec uses none of them."""
    avail = _filter_axes(mesh, opt_axes)
    size = mesh_axis_size(mesh, avail)

    def one(value, logical):
        shape = _shape_of(value)
        spec = list(logical_to_spec(logical, mesh, rules, shape))
        if avail and shape is not None and not (set(avail) & spec_axes(spec)):
            spec += [None] * (len(shape) - len(spec))
            cands = [(shape[i], i) for i in range(len(shape))
                     if spec[i] is None and shape[i] % size == 0 and shape[i] >= size]
            if cands:
                spec[max(cands)[1]] = _entry(avail)
        return _trim(spec)

    return _map2(one, params, axes)
