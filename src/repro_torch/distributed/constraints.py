"""Activation sharding rules (port of ``repro/distributed/constraints.py``).

The reference pins activations inside the model with
``with_sharding_constraint`` (``constrain``), so that GSPMD does not
replicate a subgraph whose dim does not divide the mesh. The port runs
explicit SPMD: every activation is a local tensor whose shape is what the
rank holds, and a cross-rank move is a collective the model code calls
(``comm``). There is nothing to pin, so ``constrain`` has no counterpart.
What stays is the table of which logical activation dims may stay split
over a mesh axis between two layers: the tensor-parallel placement
(``distributed.tp``) reads it to decide which projections keep their
outputs as the rank's heads or ffn slice ("heads", "kv_heads", "ffn"),
and which must be whole on every rank ("embed": the residual stream).
"""
from __future__ import annotations

from typing import Optional, Tuple

from .sharding import mesh_shape

__all__ = ["ACT_RULES", "activation_rules"]

# logical activation-dim name -> mesh axes (late-bound against the mesh)
ACT_RULES = {
    "batch": ("pod", "data"),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "vocab": ("model",),
    "ssm_inner": ("model",),
    "embed": (),
    "seq": (),
    None: (),
}


def activation_rules(name: Optional[str], mesh) -> Tuple[str, ...]:
    """The mesh axes of ``mesh`` an activation dim named ``name`` may stay
    split over."""
    shape = mesh_shape(mesh)
    return tuple(a for a in ACT_RULES.get(name, ()) if a in shape)
