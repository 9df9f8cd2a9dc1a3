"""The tensor-parallel group a serve path runs under, and the collectives
it calls (port-only: the reference leaves them to GSPMD).

Explicit SPMD: every rank runs the whole engine, host scheduler included,
on the same requests; the ranks differ only in the columns, heads and
vocab rows they hold (``distributed.tp``). The model code reaches the
group through ``active()``, which ``use(group)`` sets for the calls inside
it, as the reference's ``with mesh:`` does; outside it the model code is
the single-process code.

Two collectives, each counted like the kernel launches
(``collective_counts`` / ``reset_collectives``) so that a drain can report
them a tick:

- ``all_gather``: the ranks' blocks along a dim, concatenated in rank
  order (``gather_cols`` on the last dim);
- ``all_reduce_sum``: in place.

NCCL is the backend on CUDA, one rank a card; gloo on the CPU, and on CUDA
where the caller names it (two ranks on one card, which NCCL refuses).
Gloo takes CUDA tensors for both collectives (it moves them through the
host itself), so the same calls serve both backends, nothing staged here;
``chip_smoke.py``'s tp phase and the card tests run them so. The kernels run on the card either way, and no
error of a collective is caught: a peer that dies makes the group's
timeout raise.

A group of size 1 runs every collective of the path (each a copy), so
that its backend is set up and launched as at tp > 1.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

__all__ = ["TPGroup", "active", "all_gather", "all_reduce_sum", "collective_counts",
           "gather_cols", "is_split", "reset_collectives", "use"]


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """The "model" axis of a mesh as this rank sees it."""

    mesh: Any  # the DeviceMesh
    rules: Any  # sharding.ShardingRules
    group: Any  # the process group of the "model" axis
    size: int
    rank: int  # this rank's index on the "model" axis
    backend: str


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_tp_group", default=None)
_COUNTS: Dict[str, int] = {"all_gather": 0, "all_reduce": 0}


def active() -> Optional[TPGroup]:
    """The group of the innermost ``use``, else None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def use(group: Optional[TPGroup]):
    """Run the enclosed model calls under ``group`` (None: single-process)."""
    token = _ACTIVE.set(group)
    try:
        yield group
    finally:
        _ACTIVE.reset(token)


def collective_counts() -> Dict[str, int]:
    """Collectives called since the last ``reset_collectives``."""
    return dict(_COUNTS)


def reset_collectives() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def all_gather(x: torch.Tensor, dim: int = -1, group: Optional[TPGroup] = None) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all) concatenated along ``dim`` in
    rank order."""
    g = group or active()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(g.size)]
    dist.all_gather(parts, x, group=g.group)
    _COUNTS["all_gather"] += 1
    return torch.cat(parts, dim=dim)


def all_reduce_sum(x: torch.Tensor, group: Optional[TPGroup] = None) -> torch.Tensor:
    """The ranks' ``x`` summed, in place."""
    g = group or active()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=g.group)
    _COUNTS["all_reduce"] += 1
    return x


def is_split(local: int, full: int, group: Optional[TPGroup]) -> bool:
    """Whether a dim of ``local`` entries is this rank's block of ``full``
    under ``group``: smaller than the whole, or any block of a size-1 group
    (so that it runs its collectives)."""
    return group is not None and (local != full or group.size == 1)


def gather_cols(y: torch.Tensor, n: int) -> torch.Tensor:
    """``y`` with all ``n`` columns on the last dim: the ranks' column blocks
    gathered under the active group, or ``y`` itself where it has them (a
    replicated projection's output, or no group)."""
    g = active()
    if not is_split(y.shape[-1], n, g):
        return y
    return all_gather(y, dim=-1, group=g)
