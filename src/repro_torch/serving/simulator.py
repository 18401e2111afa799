"""Simulation platform (paper §V): executing module + communication module
+ performance module.

The executing module evaluates the two model segments with the device /
server processing profiles (Table II); the communication module prices the
wireless transfer of the quantized segment and the cut activation with the
Shannon-capacity channel (Eq. 13–16); the performance module aggregates
CostBreakdowns. All timing is analytic (the paper's simulator is too) —
the *accuracy* numbers, by contrast, come from really executing the
quantized models in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.cost_model import (Channel, CostBreakdown, DeviceProfile,
                                   ObjectiveWeights, ServerProfile,
                                   cost_breakdown)
from repro_torch.core.solver import PartitionPlan


@dataclasses.dataclass
class InferenceRequest:
    """r = (theta, a) + device/channel context (paper §III-A)."""
    model: str
    accuracy_budget: float              # max acceptable degradation `a`
    device: DeviceProfile
    channel: Channel
    weights: ObjectiveWeights = dataclasses.field(default_factory=ObjectiveWeights)
    batch: int = 1
    # Repeat requester whose device already holds the quantized segment:
    # the weight share of the wire (Eq. 14 Z_w) amortizes to zero and only
    # the cut activation Z_x is priced. This is where partitioning beats
    # p=0 full-offload (the Neurosurgeon regime) — a fresh request always
    # pays for the model shipment and usually prefers p=0.
    #
    # When the request carries a ``device_id`` the fleet engine OWNS this
    # flag: the per-device segment cache decides which candidates ship
    # weights, and the caller's value is ignored (engine/fleet.py).
    segment_cached: bool = False
    # -- continuous-time fields (serving.engine). The one-shot paths
    # (serve / serve_batch / WorkloadBalancer.schedule) ignore them, which
    # is exactly the all-arrivals-at-t=0 degenerate case of the engine.
    arrival_time: float = 0.0           # seconds on the fleet clock
    deadline: Optional[float] = None    # SLO: max end-to-end seconds from
    # arrival; None = best-effort
    device_id: Optional[str] = None     # stable requester identity — keys
    # the engine's segment cache AND fault injection (engine/faults.py)
    attempt_budget: Optional[int] = None  # per-request cap on admission
    # attempts under fault recovery; None = the RetryPolicy default
    max_new_tokens: int = 0             # autoregressive decode stream
    # length (DESIGN.md §11): 0 = one-shot (every pre-decode path —
    # bit-for-bit unchanged); N >= 1 streams N tokens, the first being
    # the prefill's (TTFT), through the serving server's continuous-
    # batching decode lane. Needs a decode-capable backend.


@dataclasses.dataclass
class ServingResult:
    plan: PartitionPlan
    costs: CostBreakdown
    objective: float
    payload_bits: float
    accuracy: Optional[float] = None    # measured, when a test set is given
    accuracy_degradation: Optional[float] = None
    attempt: int = 1                    # which admission attempt produced
    # this result (> 1 after fault-driven re-admissions, engine/retry.py)
    extra: dict = dataclasses.field(default_factory=dict)


def simulate_plan(plan: PartitionPlan, layer_specs, device: DeviceProfile,
                  server: ServerProfile, channel: Channel,
                  weights: ObjectiveWeights,
                  payload_bits: Optional[float] = None) -> ServingResult:
    """Price an arbitrary (p, payload) pattern — shared by QPART and every
    baseline so the comparison is apples-to-apples."""
    o = np.array([sp.o for sp in layer_specs], dtype=np.float64)
    o1 = float(o[:plan.p].sum())
    o2 = float(o[plan.p:].sum())
    pb = plan.payload_bits if payload_bits is None else payload_bits
    costs = cost_breakdown(o1, o2, pb, device, server, channel)
    return ServingResult(plan=plan, costs=costs,
                         objective=costs.objective(weights),
                         payload_bits=pb)
