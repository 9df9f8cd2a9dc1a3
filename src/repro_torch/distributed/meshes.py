"""Mesh constructors (port of ``repro/distributed/meshes.py``) over
``torch.distributed``: one process (rank) a device, the ranks joined by a
process group that ``init_process`` sets up from a ``FileStore``.

``abstract_mesh`` is device-free (spec tests); ``make_mesh``,
``single_device_mesh`` and ``best_effort_mesh`` build a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
initialised default group, with the axes ("data", "model"). The production
mesh lives in ``repro_torch.launch.mesh``.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, Optional, Tuple

import torch.distributed as dist

__all__ = ["AbstractMesh", "abstract_mesh", "best_effort_mesh", "init_process", "make_mesh",
           "single_device_mesh"]

DEFAULT_TIMEOUT_S = 120.0  # a collective that waits this long on a dead peer raises


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, without devices."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def abstract_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> AbstractMesh:
    """Device-free mesh for spec-level tests and dry runs."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    return AbstractMesh(tuple(int(s) for s in shape), tuple(axes))


def init_process(rank: int, world: int, store_path: str, backend: str, *,
                 timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the default process group as ``rank`` of ``world`` through a
    ``FileStore`` at ``store_path`` (no TCP port). ``backend`` is "nccl"
    (CUDA, one rank a card) or "gloo" (the CPU; CUDA tensors staged through
    the host, ``comm``). Every collective on the group raises after
    ``timeout_s`` seconds of waiting."""
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], backend: Optional[str] = None):
    """A DeviceMesh of ``shape`` over the default group's ranks (which must
    number prod(shape)). ``backend`` is checked against the group's; the
    mesh's device type is "cuda" under NCCL and "cpu" under gloo (the mesh
    only hands out groups: gloo moves CUDA tensors through the host)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group (init_process)")
    have = dist.get_backend()
    if backend is not None and backend != have:
        raise ValueError(f"the default group runs {have!r}, not {backend!r}")
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {n} ranks, the group has {dist.get_world_size()}")
    return init_device_mesh("cuda" if have == "nccl" else "cpu", tuple(shape),
                            mesh_dim_names=tuple(axes))


def single_device_mesh(axes: Tuple[str, ...] = ("data", "model")):
    return make_mesh((1,) * len(axes), axes)


def best_effort_mesh(axes: Tuple[str, ...] = ("data", "model"), prefer_model: int = 1):
    """Every rank of the group: model = ``prefer_model`` where it divides
    the world size (else 1), the rest data."""
    n = dist.get_world_size()
    model = prefer_model if n % prefer_model == 0 else 1
    shape = (n // model, model)
    if len(axes) == 3:
        shape = (1,) + shape
    return make_mesh(shape, axes)
