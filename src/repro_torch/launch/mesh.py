"""Mesh descriptions and the H100's roofline constants — the port of
``repro/launch/mesh.py``.

A mesh here is a plain description, ``axis_names`` and a ``shape``
mapping each axis to its size: what the sharding rules read
(``launch/sharding.py``) and what the dry run divides argument bytes
by. Nothing here touches ``torch.distributed`` or a device.

Single pod: (data=16, model=16), 256 cards; multi-pod: (pod=2, data=16,
model=16), 512 cards, the ``pod`` axis pure data parallelism. The host
mesh is the local cards, (data=n, model=1), as the reference's ``(n,
1)`` over every local device: the training launcher runs one rank per
card on it (``launch.distributed``), the batch split over ``data`` and
the state replicated, its gradients all-reduced inside each step.
:func:`make_mesh` describes any (data, model) layout of local cards;
:func:`coords` gives a rank's index on each axis (ranks in row-major
order, so the ranks of one data index are consecutive), as the serving
steps' rank program reads them (``launch.model_parallel``).

The rates are NVIDIA's data sheet for one H100 SXM (dense, without
sparsity, at the full 700 W power limit). The roofline is per card; its
collective term (``roofline.analysis``) puts the model axis's bytes on
NVLink while that axis fits in one 8-card node, and everything else on
the node's network links.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 on the tensor cores
PEAK_FLOPS_F32 = 67e12            # FLOP/s, f32 off the tensor cores
HBM_BW = 3.35e12                  # bytes/s
HBM_BYTES = 80e9                  # device memory
# Links, from NVIDIA's H100 data sheet and its DGX H100 system data sheet:
# NVLink 4 carries 900 GB/s per H100 SXM, 450 GB/s each way, between the 8
# cards of one node; the node's eight 400 Gb/s ConnectX-7 ports give each
# card 400 Gb/s = 50 GB/s to other nodes.
NVLINK_BW = 450e9                 # bytes/s one way, per card, in a node
NIC_BW = 50e9                     # bytes/s per card, across nodes
NODE_CARDS = 8                    # cards one NVLink domain joins

DATA_AXIS = "data"
MODEL_AXIS = "model"
POD_AXIS = "pod"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names in order and each axis's size."""
    axis_names: tuple
    shape: Mapping[str, int]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh((POD_AXIS, DATA_AXIS, MODEL_AXIS),
                    {POD_AXIS: 2, DATA_AXIS: 16, MODEL_AXIS: 16})
    return Mesh((DATA_AXIS, MODEL_AXIS), {DATA_AXIS: 16, MODEL_AXIS: 16})


def make_host_mesh(cards: int = 1) -> Mesh:
    """``cards`` local cards as a (data=cards, model=1) mesh; the caller
    counts the cards (``torch.cuda.device_count()``), nothing here
    touches a device."""
    return Mesh((DATA_AXIS, MODEL_AXIS), {DATA_AXIS: cards, MODEL_AXIS: 1})


def make_mesh(data: int = 1, model: int = 1) -> Mesh:
    """``data * model`` local cards as a (data, model) mesh; a pure
    description, as :func:`make_host_mesh`."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data {data}, "
                         f"model {model}")
    return Mesh((DATA_AXIS, MODEL_AXIS), {DATA_AXIS: data, MODEL_AXIS: model})


def coords(mesh, rank: int) -> dict:
    """Rank ``rank``'s index on each axis of ``mesh``, ranks numbered in
    row-major order of ``mesh.axis_names`` (the last axis, ``model``,
    fastest)."""
    n = mesh_num_chips(mesh)
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a mesh of {n} cards")
    out = {}
    for a in reversed(mesh.axis_names):
        rank, out[a] = divmod(rank, mesh.shape[a])
    return {a: out[a] for a in mesh.axis_names}


def mesh_num_chips(mesh) -> int:
    return math.prod(mesh.shape[a] for a in mesh.axis_names)
