"""Token embedding and the tied output head (port of ``repro/nn/embedding.py``).

Under a tensor-parallel group (``distributed.comm``) whose rank holds a
block of the table's vocab rows (``distributed.tp``), the lookup is a
masked one plus an all-reduce, exactly one nonzero addend an element, and
the head's logits are the rank's vocab columns, gathered."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed import comm

__all__ = ["EMBED_AXES", "embed_init", "embed_apply", "unembed_apply"]

EMBED_AXES = {"table": ("vocab", "embed")}  # the logical axes of the tree


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32, device=None):
    table = torch.randn((vocab, d), generator=gen, dtype=torch.float32, device=device) * 0.02
    return {"table": table.to(dtype)}


def embed_apply(params, tokens: torch.Tensor, compute_dtype=None,
                vocab: Optional[int] = None) -> torch.Tensor:
    """Rows of the table for ``tokens``. ``vocab`` is the whole table's row
    count: under an active group a table of fewer rows is this rank's block
    (rows [rank * n, (rank + 1) * n)), and every other rank's token reads 0
    here before the all-reduce sums the one row that holds it."""
    t = params["table"]
    if compute_dtype is not None:
        t = t.to(compute_dtype)
    g = comm.active()
    if vocab is None or not comm.is_split(t.shape[0], vocab, g):
        return t[tokens.long()]
    rows = t.shape[0]
    local = tokens.long() - g.rank * rows
    mine = (local >= 0) & (local < rows)
    x = t[local.clamp(0, rows - 1)]
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    return comm.all_reduce_sum(x)


def unembed_apply(params, x: torch.Tensor, vocab: Optional[int] = None) -> torch.Tensor:
    """Tied head: logits = x @ table.T in float32. A plain large product
    left to torch.matmul; TF32 stays off (``device.resolve_device``). Under
    an active group with ``vocab`` given, the rank's vocab columns are
    gathered into all ``vocab`` (the same product a column, bit for bit on
    the H100 and the CPU at the served shapes, PERF.md §6)."""
    logits = torch.matmul(x.to(torch.float32), params["table"].to(torch.float32).t())
    return logits if vocab is None else comm.gather_cols(logits, vocab)
