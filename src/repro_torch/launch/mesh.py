"""Production mesh constructors (port of ``repro/launch/mesh.py``) for
H100 nodes: the 8 cards of a node, joined all to all by NVLink, carry the
"model" axis (tensor parallelism); nodes, joined by the network, carry
"data"; a multi-pod mesh adds "pod" across two clusters. A cluster is 16
nodes, (16, 8) = 128 cards, in place of the reference's v5e pod of (16,
16). Functions, not constants: importing this module starts nothing."""
from __future__ import annotations

__all__ = ["CARDS_PER_NODE", "NODES_PER_POD", "make_production_mesh", "mesh_devices_needed",
           "production_mesh_shape"]

CARDS_PER_NODE = 8
NODES_PER_POD = 16


def production_mesh_shape(*, multi_pod: bool = False):
    """((shape), (axes)) of the production mesh."""
    if multi_pod:
        return (2, NODES_PER_POD, CARDS_PER_NODE), ("pod", "data", "model")
    return (NODES_PER_POD, CARDS_PER_NODE), ("data", "model")


def mesh_devices_needed(multi_pod: bool = False) -> int:
    shape, _ = production_mesh_shape(multi_pod=multi_pod)
    n = 1
    for s in shape:
        n *= s
    return n


def make_production_mesh(*, multi_pod: bool = False):
    """The production DeviceMesh over an initialised NCCL group of
    ``mesh_devices_needed`` ranks, one a card."""
    from repro_torch.distributed.meshes import make_mesh

    shape, axes = production_mesh_shape(multi_pod=multi_pod)
    return make_mesh(shape, axes, backend="nccl")
