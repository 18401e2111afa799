"""Model-segment splitting: materialize the quantized device segment at a
partition point (the per-layer parameter trees are fake-quantized at the
plan's bit-widths; the server side keeps the full-precision params)."""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.core.quantizer import fake_quant, payload_bits, round_bits
from repro_torch.core.solver import PartitionPlan
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class DeviceSegment:
    params: list                 # quantized layer params (layers 1..p)
    bits_w: np.ndarray
    bits_x: int
    payload_bits: float          # exact wire size (Eq. 14)


def split_blocks(layer_params: List, plan: PartitionPlan,
                 layer_specs) -> DeviceSegment:
    """Split + quantize a per-layer parameter list (any tree per layer) at
    plan.p. Only the device segment is materialized."""
    p = plan.p
    bits_int = round_bits(plan.bits_w) if p else np.zeros(0, int)
    dev_params = []
    wire = 0.0
    for i in range(p):
        b = int(bits_int[i])
        dev_params.append(tree_map(lambda t, b=b: fake_quant(t, b),
                                   layer_params[i]))
        n = sum(int(v.numel()) for v in tree_leaves(layer_params[i]))
        wire += float(payload_bits(n, b))
    bits_x = int(round_bits(np.array([plan.bits_x]))[0]) if p else 32
    # activation payload counted when the device sends the cut activation
    wire_x = float(payload_bits(int(layer_specs[p - 1].z_x), bits_x)) if p else 0.0
    return DeviceSegment(dev_params, bits_int, bits_x, wire + wire_x)


def split_classifier(params: List[dict], plan: PartitionPlan,
                     layer_specs) -> tuple[DeviceSegment, List[dict]]:
    """Split + quantize a classifier at plan.p. Returns (device, server)."""
    seg = split_blocks(params, plan, layer_specs)
    return seg, list(params[plan.p:])


def segment_memory_bytes(seg: DeviceSegment) -> float:
    """Device memory footprint of the quantized segment (packed codes)."""
    total = 0.0
    for i, lp in enumerate(seg.params):
        n = sum(int(v.numel()) for v in tree_leaves(lp))
        total += n * int(seg.bits_w[i]) / 8.0
    return total


def plan_memory_bytes(plan: PartitionPlan, layer_specs) -> float:
    """Analytic device memory (bytes) a plan's quantized segment occupies
    at the deployed (ceil-rounded) bit-widths."""
    if plan.p == 0:
        return 0.0
    bits = np.clip(np.ceil(np.asarray(plan.bits_w, np.float64)), 2, 16)
    z_w = np.array([sp.z_w for sp in layer_specs[:plan.p]], np.float64)
    return float(np.sum(bits * z_w) / 8.0)
