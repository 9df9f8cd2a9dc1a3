"""Assigned input-shape sets (the 4 LM-family shapes; the same sets as
``repro/configs/shapes.py``).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of ``seq_len``), not ``train_step``. ``long_500k`` requires a
sub-quadratic family (DESIGN.md §6): it runs only when the architecture's
``full_attention`` flag is False.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["ShapeSpec", "SHAPES", "applicable_shapes"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg) -> Tuple[str, ...]:
    """The shape cells this architecture actually runs (skips documented in
    DESIGN.md §6: long_500k needs sub-quadratic attention)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if not cfg.full_attention:
        names.append("long_500k")
    return tuple(names)
