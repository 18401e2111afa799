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

The rates are NVIDIA's data sheet for one H100 SXM (dense, without
sparsity, at the full 700 W power limit). The roofline is per card and
counts no collective term.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 on the tensor cores
PEAK_FLOPS_F32 = 67e12            # FLOP/s, f32 off the tensor cores
HBM_BW = 3.35e12                  # bytes/s
HBM_BYTES = 80e9                  # device memory

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


def mesh_num_chips(mesh) -> int:
    return math.prod(mesh.shape[a] for a in mesh.axis_names)
