"""repro_torch.distributed: sharding rules, meshes and tensor-parallel
serving on ``torch.distributed`` (port of ``repro/distributed``).

Layout:
  sharding.py     logical-axis -> mesh-axis rules with divisibility
                  fallbacks; device-free specs for params, KV caches,
                  batches and optimizer state (ZeRO-1).
  constraints.py  ACT_RULES: which activation dims may stay split.
  meshes.py       the process group (FileStore) and DeviceMesh
                  constructors; the production mesh is in
                  repro_torch.launch.mesh.
  comm.py         the active tensor-parallel group and its collectives.
  tp.py           the tensor-parallel placement of an lm serve tree.

The reference's pipeline.py (and optim/compression.py) come with the
training slice (ROADMAP Queue 1 item 7).
"""
from . import sharding
from .sharding import (
    FSDP_RULES,
    LOGICAL_RULES,
    ShardingRules,
    batch_sharding,
    kv_cache_shardings,
    logical_to_spec,
    param_specs,
    zero1_shardings,
)

__all__ = [
    "FSDP_RULES",
    "LOGICAL_RULES",
    "ShardingRules",
    "batch_sharding",
    "kv_cache_shardings",
    "logical_to_spec",
    "param_specs",
    "sharding",
    "zero1_shardings",
]
