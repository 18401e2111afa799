"""The QPART inference-serving server.

Lifecycle (paper Fig. 1–2), model-agnostic via ``ModelBackend``:
  1. ``register``    — name a backend plus its calibration data.
  2. ``calibrate``   — offline noise calibration: per-layer (s_w, s_x,
     rho) probes + Delta(a) table (Alg. 1 steps 7–10).
  3. ``build_store`` — Alg. 1: closed-form bit patterns for 5 accuracy
     levels x all partition points, per ``ReferenceContext``.
  4. ``serve``       — Alg. 2: plan → deploy (a ``Deployment``) →
     execute (``Deployment.execute`` / ``generate``).
  5. ``fleet``       — event-driven fleet serving (``serving.engine``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import noise as noise_lib
from repro_torch.core.cost_model import (AnalyticCost, CalibratedCost,
                                         CalibrationLedger, Channel,
                                         CostProvider, DeviceProfile,
                                         ObjectiveWeights, ServerProfile)
from repro_torch.core.quantizer import round_bits
from repro_torch.core.solver import OfflineStore, build_offline_store
from repro_torch.serving.backends.base import ModelBackend, to_device
from repro_torch.serving.deployment import Deployment, ReferenceContext
from repro_torch.serving.errors import (NotCalibratedError,
                                        PlanInfeasibleError,
                                        StoreMissingError, UnknownModelError)
from repro_torch.serving.pricing import candidate_rows_for, price_window
from repro_torch.serving.simulator import InferenceRequest, ServingResult

DEFAULT_ACCURACY_LEVELS = (0.001, 0.0025, 0.005, 0.01, 0.02)


@dataclasses.dataclass
class ModelState:
    """Per-model serving state: the backend plus everything the offline
    phase derives from it."""
    backend: ModelBackend
    calib_x: torch.Tensor
    calib_y: torch.Tensor
    s_w: np.ndarray = None
    s_x: np.ndarray = None
    rho: np.ndarray = None
    delta_table: dict = None
    base_accuracy: float = None
    stores: Dict[ReferenceContext, OfflineStore] = dataclasses.field(
        default_factory=dict)
    default_context: Optional[ReferenceContext] = None

    def store(self, context: Optional[ReferenceContext] = None) -> OfflineStore:
        """The pattern store for ``context`` (default: the most recently
        built one)."""
        if not self.stores:
            raise NotCalibratedError(
                "no offline store — run calibrate() + build_store() first")
        ctx = self.default_context if context is None else context
        if ctx not in self.stores:
            raise StoreMissingError(
                f"no store built for context {ctx}; "
                f"{len(self.stores)} other context(s) available")
        return self.stores[ctx]


class QPARTServer:
    def __init__(self, server_profile: Optional[ServerProfile] = None,
                 levels: Sequence[float] = DEFAULT_ACCURACY_LEVELS,
                 provider: Optional[CostProvider] = None):
        self.server = server_profile or ServerProfile()
        self.levels = tuple(levels)
        self.models: Dict[str, ModelState] = {}
        # every online decision prices through the provider; AnalyticCost
        # is the bit-exact default
        self.provider: CostProvider = provider or AnalyticCost()
        # measurement ledger closing the predict → measure loop
        self.ledger = CalibrationLedger()

    # ------------------------------------------------------------------
    def register(self, name: str, backend: ModelBackend,
                 calib_x, calib_y) -> None:
        """Register a model backend + its calibration split (moved to the
        backend's device)."""
        self.models[name] = ModelState(
            backend, to_device(calib_x, backend.device),
            to_device(calib_y, backend.device))

    def _model(self, name: str) -> ModelState:
        if name not in self.models:
            raise UnknownModelError(name, self.models)
        return self.models[name]

    # ------------------------------------------------------------------
    # Offline phase (Alg. 1)
    def calibrate(self, name: str, probe_bits: int = noise_lib.PROBE_BITS,
                  vectorized: bool = True) -> None:
        """Noise calibration (Alg. 1 steps 7–10): per-layer (s_w, s_x,
        rho) + the Delta(a) budget table (its noise drawn from a generator
        seeded 0). ``vectorized=False`` forces the scalar reference loop
        (``core.noise.backend_layer_energies``)."""
        m = self._model(name)
        b = m.backend
        x = m.calib_x
        if vectorized:
            e_w, e_x, logits = b.calibrate_probes(x, probe_bits)
        else:
            e_w, e_x, logits = noise_lib.backend_layer_energies(
                b, x, probe_bits)
        e_w = np.asarray(e_w, np.float64)
        e_x = np.asarray(e_x, np.float64)
        adv_mean = float(torch.mean(
            noise_lib.adversarial_noise_energy(logits)))
        n_calib = x.shape[0]
        m.s_w = e_w / n_calib * 4.0 ** probe_bits
        m.s_x = e_x / n_calib * 4.0 ** probe_bits
        # Eq. 22: mean quantization noise / mean adversarial noise
        m.rho = np.maximum((0.5 * (e_w + e_x) / n_calib) / adv_mean, 1e-12)
        m.delta_table, m.base_accuracy = noise_lib.calibrate_delta(
            lambda p, a: b.forward(a, params=p), b.params, x, m.calib_y,
            m.rho, targets=self.levels)

    def build_store(self, name: str, device: DeviceProfile, channel: Channel,
                    weights: ObjectiveWeights) -> ReferenceContext:
        """Alg. 1 proper: precompute {(b_a^p, p)} for one reference
        context; the most recent build becomes the default context."""
        m = self._model(name)
        if m.delta_table is None:
            raise NotCalibratedError(
                f"model {name!r} has no noise calibration — run calibrate() "
                "before build_store()")
        specs = m.backend.layer_specs()
        ctx = ReferenceContext(device, channel, weights)
        oc = self.provider.offline_coeffs(weights, device, channel,
                                          self.server)
        price_bytes = oc["c_dev_bytes"] != 0.0 or oc["c_srv_bytes"] != 0.0
        m.stores[ctx] = build_offline_store(
            levels=self.levels, budgets=m.delta_table,
            layer_z_w=[sp.z_w for sp in specs],
            layer_z_x=[sp.z_x for sp in specs],
            layer_s_w=m.s_w, layer_s_x=m.s_x, layer_rho=m.rho,
            layer_o=[sp.o for sp in specs],
            xi=oc["xi"], delta_cost=oc["delta"], eps=oc["eps"],
            input_z=m.backend.input_elements(),
            c_dev_bytes=oc["c_dev_bytes"], c_srv_bytes=oc["c_srv_bytes"],
            layer_act_bytes=[sp.act_bytes for sp in specs]
            if price_bytes else None,
            layer_w_bytes16=[sp.w_bytes16 for sp in specs]
            if price_bytes else None)
        m.default_context = ctx
        return ctx

    # ------------------------------------------------------------------
    # Online phase (Alg. 2): plan → deploy (execute lives on Deployment)
    def serve(self, req: InferenceRequest,
              context: Optional[ReferenceContext] = None) -> Deployment:
        m = self._model(req.model)
        store = m.store(context)
        provider = self.provider
        rows = candidate_rows_for(
            m.backend, store, store.level_for(req.accuracy_budget),
            req.batch, bool(req.segment_cached), provider.uses_bytes)
        coeff = provider.coeffs_cached(req.weights, req.device, req.channel,
                                       self.server)
        terms = provider.terms(rows)

        def runtime_objective(plan):
            # candidate index == partition point; the generalized
            # obj = sum_k c_k·T_k accumulated in term order, matching the
            # window path float-for-float
            c = plan.p
            obj = coeff[0] * terms[0][c]
            for k in range(1, len(terms)):
                obj = obj + coeff[k] * terms[k][c]
            return obj

        # decode-planned backends additionally hold the device segment's
        # KV cache for the stream's lifetime
        if getattr(m.backend, "kv_page_tokens", None) is not None:
            kv_row = m.backend.kv_bytes_row(
                req.batch, tokens=int(m.backend.seq_len)
                + max(int(req.max_new_tokens), 1))
        else:
            kv_row = m.backend.kv_bytes_row(req.batch)

        def feasible(pl):
            kv = float(kv_row[pl.p]) if kv_row is not None else 0.0
            return pl.device_memory_bytes + kv <= req.device.memory_bytes

        try:
            plan = store.lookup(req.accuracy_budget, runtime_objective,
                                feasible_fn=feasible)
        except ValueError:
            raise PlanInfeasibleError(
                f"no stored pattern fits device memory "
                f"{req.device.memory_bytes:.0f} B for model {req.model!r}")
        wire = float(rows.wire[plan.p])
        o1 = float(rows.o1[plan.p])
        o2 = float(rows.o1[-1] - rows.o1[plan.p])
        dev_b, srv_b = rows.bytes_at(plan.p)
        costs = provider.breakdown(o1, o2, wire, req.device, self.server,
                                   req.channel, dev_bytes=dev_b,
                                   srv_bytes=srv_b)
        result = ServingResult(plan=plan, costs=costs,
                               objective=costs.objective(req.weights),
                               payload_bits=wire)
        result.extra["bits_w"] = round_bits(plan.bits_w) if plan.p else []
        result.extra["bits_x"] = plan.bits_x
        return Deployment(req.model, m.backend, req, plan, result)

    # ------------------------------------------------------------------
    def serve_batch(self, requests: Sequence[InferenceRequest],
                    context: Optional[ReferenceContext] = None,
                    ) -> List[Deployment]:
        """Alg. 2 for a whole request window: price every request against
        the plan table as one objective matrix per model group
        (``serving.pricing``). Result-for-result identical to
        ``[self.serve(r) for r in requests]``."""
        tab = price_window(self.models, self.server, requests,
                           context=context, provider=self.provider)
        choices = tab.argmin_choices()
        bits_cache: Dict[int, np.ndarray] = {}   # windows share few plans
        out: List[Deployment] = []
        for i, r in enumerate(requests):
            c = int(choices[i])
            plan, o1, o2, wire = tab.select(i, c)
            dev_b, srv_b = tab.rows[i].bytes_at(c)
            costs = self.provider.breakdown(o1, o2, wire, r.device,
                                            self.server, r.channel,
                                            dev_bytes=dev_b, srv_bytes=srv_b)
            res = ServingResult(plan=plan, costs=costs,
                                objective=costs.objective(r.weights),
                                payload_bits=wire)
            if plan.p:
                if id(plan) not in bits_cache:
                    bits_cache[id(plan)] = round_bits(plan.bits_w)
                res.extra["bits_w"] = bits_cache[id(plan)].copy()
            else:
                res.extra["bits_w"] = []
            res.extra["bits_x"] = plan.bits_x
            out.append(Deployment(r.model, self.models[r.model].backend,
                                  r, plan, res))
        return out

    # ------------------------------------------------------------------
    def fleet(self, servers=None, policy="fcfs", slo: str = "observe",
              epoch_interval: float = 0.0,
              provider: Optional[CostProvider] = None, **engine_kwargs):
        """Event-driven fleet serving over this server's registered
        models (serving.engine): ``srv.fleet(servers=[...],
        policy="edf").run(requests)`` — continuous-time arrivals,
        multi-server queues, engine-managed device segment caches,
        deadline-aware admission. With the defaults (one server, plain
        requests) it degenerates to the one-shot ``serve_batch``/
        ``WorkloadBalancer`` behavior. Extra kwargs (``retry``,
        ``faults``, and the scale knobs ``journal``/``records``/
        ``admission``/``reprice_cache``) pass through to
        ``FleetEngine``."""
        from repro_torch.serving.engine import FleetEngine
        return FleetEngine(self, servers=servers, policy=policy, slo=slo,
                           epoch_interval=epoch_interval, provider=provider,
                           **engine_kwargs)

    # ------------------------------------------------------------------
    # measurement loop
    def record_execution(self, deployment: Deployment) -> None:
        """Feed one executed deployment's fenced stage timings
        (``Deployment.execute``) into the calibration ledger."""
        self.ledger.record(deployment, self.server)

    def record_decode(self, deployment: Deployment) -> None:
        """Feed one streamed generation's stage timings
        (``Deployment.generate``) into the same ledger."""
        self.ledger.record_decode(deployment, self.server)

    def calibrated_provider(self) -> CalibratedCost:
        """Least-squares fit of the ledger → the measurement-calibrated
        provider."""
        return self.ledger.fit()

    def execute_partitioned(self, name: str, plan, x, y) -> float:
        """Run the two segments of an arbitrary stored plan and return
        its accuracy on (x, y)."""
        logits = self._model(name).backend.execute_plan(plan, x)
        y = to_device(y, logits.device)
        return float(torch.mean((torch.argmax(logits, -1) == y).float()))
