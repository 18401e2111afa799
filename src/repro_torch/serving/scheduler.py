"""Dynamic workload balancing across concurrent requests (the paper's
title's second half; §VI names global scheduling as the planned extension
— this is the natural instantiation consistent with the paper's own cost
model).

Mechanism: the server is a finite resource (MAC/s). Each admitted plan's
server segment occupies it for ``T_server`` seconds, so later requests in
the scheduling window see a QUEUE DELAY on their server term. The balancer
re-prices every candidate (b, p) pattern per request with the CURRENT
congestion — as the queue grows, Alg. 2's objective naturally shifts work
toward capable devices (larger p), which is exactly the workload balancing
the title promises: no new math, the paper's Eq. 17 objective re-evaluated
under load.

Execution: the zero-load objective of every (request, partition) pair is
precomputed as ONE (R, P+1) matrix (DESIGN.md §5); the sequential
admission loop then only adds the scalar queue term to a row and takes an
argmin — no per-request store scans or Python objective closures. Each
admission yields a ``Deployment`` (plan + priced costs + callable
quantized segment), same as ``serve``/``serve_batch``.

Two policies:
  * fcfs      — requests priced in arrival order, each seeing the queue
                left by its predecessors.
  * balanced  — same, but requests are admitted shortest-server-demand
                first (SJF-flavoured), which provably reduces the mean
                queueing term for the same total work.

Since the event-driven engine landed (serving.engine, DESIGN.md §8) this
module is the COMPATIBILITY SURFACE over it: ``schedule()`` runs the
``FleetEngine`` in its degenerate configuration — one server, arrivals
as given (all t=0 for plain requests) — which reproduces the historical
one-shot behavior plan-for-plan and objective-for-objective. fcfs and
balanced are two of the engine's pluggable ``AdmissionPolicy``
implementations (see engine/policies.py for EDF and least-loaded). The
scalar per-request re-pricing (``_serve_under_load``) stays here as the
executable reference both paths are regression-locked against.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.cost_model import (ServerProfile, cost_breakdown,
                                         delta_coeff, eps_coeff, xi_coeff)
from repro_torch.serving.deployment import Deployment, ReferenceContext
from repro_torch.serving.engine import FleetEngine
from repro_torch.serving.simulator import InferenceRequest, ServingResult


@dataclasses.dataclass
class ScheduledResult:
    request: InferenceRequest
    deployment: Deployment
    queue_delay: float              # server wait this request experienced
    start_order: int

    @property
    def result(self) -> ServingResult:
        """Priced result of the deployment (view)."""
        return self.deployment.result


@dataclasses.dataclass
class WorkloadBalancer:
    """Prices a window of requests against one shared server.
    ``provider`` overrides the cost provider (default: the
    qpart_server's — AnalyticCost unless configured otherwise)."""
    server: ServerProfile
    policy: str = "balanced"        # fcfs | balanced
    provider: Optional[object] = None   # CostProvider

    def schedule(self, qpart_server, requests: Sequence[InferenceRequest],
                 context: Optional[ReferenceContext] = None,
                 ) -> List[ScheduledResult]:
        """The event engine's degenerate configuration: one server, the
        requests' own arrival times (0 by default, i.e. one simultaneous
        window). Records come back in trace order, same as before."""
        if not len(requests):
            return []
        engine = FleetEngine(qpart_server, servers=[self.server],
                             policy=self.policy, provider=self.provider)
        records = engine.run(requests, context=context).records
        return [ScheduledResult(rec.request, rec.deployment,
                                rec.backlog_at_admission, rec.start_order)
                for rec in records]

    # ------------------------------------------------------------------
    # Scalar reference path (kept for the benchmark's before/after and as
    # executable documentation of the per-request Alg. 2 re-pricing).
    def _server_seconds(self, srv, req, queue: float) -> float:
        res = self._serve_under_load(srv, req, queue)
        return res.costs.t_server

    def _serve_under_load(self, srv, req: InferenceRequest, queue: float,
                          context: Optional[ReferenceContext] = None,
                          ) -> ServingResult:
        """Alg. 2 with the queue delay added to the server time term.
        ``context`` must match what ``schedule`` was given for the
        before/after comparison to price against the same plan table."""
        m = srv.models[req.model]
        specs = m.backend.layer_specs(batch=req.batch)
        o = np.array([sp.o for sp in specs])
        o_cum = np.cumsum(o)
        xi = xi_coeff(req.weights, req.device)
        dl = delta_coeff(req.weights, self.server)
        ep = eps_coeff(req.weights, req.device, req.channel)

        def objective(plan):
            o1 = o_cum[plan.p - 1] if plan.p else 0.0
            o2 = float(o_cum[-1] - o1)
            wire = plan.payload_x_bits if req.segment_cached \
                else plan.payload_bits
            base = xi * o1 + dl * o2 + ep * wire
            wait = req.weights.omega * queue if o2 > 0 else 0.0
            return base + wait

        plan = m.store(context).lookup(
            req.accuracy_budget, objective,
            feasible_fn=lambda pl:
                pl.device_memory_bytes <= req.device.memory_bytes)
        wire = plan.payload_x_bits if req.segment_cached else plan.payload_bits
        o1 = float(o_cum[plan.p - 1]) if plan.p else 0.0
        o2 = float(o_cum[-1] - o1)
        costs = cost_breakdown(o1, o2, wire, req.device, self.server,
                               req.channel)
        res = ServingResult(plan=plan, costs=costs,
                            objective=costs.objective(req.weights)
                            + req.weights.omega * (queue if o2 > 0 else 0.0),
                            payload_bits=wire)
        res.extra["queue_delay"] = queue if o2 > 0 else 0.0
        return res


def total_latency(results) -> float:
    """Sum of per-request latency incl. queue delay. Accepts anything
    with a ``.result`` view (``ScheduledResult`` or ``Deployment``) —
    results from ``serve``/``serve_batch`` never saw a queue, so a
    missing ``queue_delay`` reads as 0 instead of raising ``KeyError``."""
    return sum(sr.result.costs.t_total
               + sr.result.extra.get("queue_delay", 0.0) for sr in results)
