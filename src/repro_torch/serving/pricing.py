"""Shared window pricing: Alg. 2's objective for every (request,
partition point) pair of a request window, as one matrix op per model
group (DESIGN.md §5, generalized by the provider layer of §9):

    obj[r, p] = sum_k  c_k[r] · T_k[p]

with ``c_k`` the provider's per-request coefficients and ``T_k`` the
per-candidate term vectors (``CandidateRows``). The analytic default is
the paper's K=3 instance — xi·O1 + delta·O2 + eps·wire — accumulated in
the same association order as the pre-provider code, so its objective
matrices are bit-identical (locked in tests/test_cost_model.py).

This is the single implementation both batched online paths build on:
``QPARTServer.serve_batch`` (argmin per row → Deployment) and
``WorkloadBalancer``/``FleetEngine`` (adds queue/server terms per
admission step). Partition candidates whose deployed quantized segment
exceeds the request device's ``memory_bytes`` are masked to +inf before
any argmin — the matrix form of the scalar path's ``OfflineStore.lookup``
feasibility filter.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Optional, Sequence

import numpy as np

from repro_torch.core.cost_model import (ANALYTIC, CandidateRows, CostProvider,
                                   ServerProfile, act_bytes_row,
                                   candidate_byte_rows)
from repro_torch.serving.simulator import InferenceRequest

if TYPE_CHECKING:                        # pricing stays JAX-import-free
    from repro_torch.serving.deployment import ReferenceContext


@dataclasses.dataclass
class WindowTable:
    """Zero-load pricing of a request window against the plan table.
    Entry i is a per-request view into its model group's stacked
    matrices, so one window may mix models with different layer counts."""
    obj: List[np.ndarray]           # per request: (P+1,) Eq. 17, no queue
    o1: List[np.ndarray]            # per request: (P+1,) device-side MACs
    wire: List[np.ndarray]          # per request: (P+1,) wire bits
    plans: List[list]               # per request: candidate plan list
    groups: list                    # [(request indices, (G, P+1) obj)]
    # both payload rows per request — the fleet engine re-prices single
    # candidates between them when its device cache holds a segment
    # (wire[i] is the row the request's segment_cached flag selected)
    pb: List[np.ndarray] = dataclasses.field(default_factory=list)
    px: List[np.ndarray] = dataclasses.field(default_factory=list)
    # per-request CandidateRows — the provider term vectors the fleet
    # engine's server corrections / stage estimates / breakdowns consume
    rows: List[CandidateRows] = dataclasses.field(default_factory=list)

    def argmin_choices(self) -> np.ndarray:
        """Best partition point per request — one matrix argmin per
        model group rather than a per-request scan."""
        choices = np.empty(len(self.obj), dtype=int)
        for idxs, obj in self.groups:
            choices[idxs] = np.argmin(obj, axis=1)
        return choices

    def select(self, i: int, c: int):
        """(plan, o1, o2, wire) of candidate c for request i — the one
        place the result-assembly terms derive from the table."""
        plan = self.plans[i][c]
        o1 = float(self.o1[i][c])
        o2 = float(self.o1[i][-1] - o1)
        return plan, o1, o2, float(self.wire[i][c])


def _assemble_rows(specs, store, a_star: float, cached: bool,
                   need_bytes: bool, o1: np.ndarray,
                   ab_cum) -> CandidateRows:
    """THE CandidateRows assembly (single implementation): ``o1`` and
    ``ab_cum`` come precomputed so ``price_window`` can share them
    across keys of one batch size."""
    pb, px = store.level_payload_rows(a_star)
    dev_b = srv_b = None
    if need_bytes:
        dev_b, srv_b = candidate_byte_rows(
            specs, store.level_memory_rows(a_star), ab_cum)
    return CandidateRows(o1=o1, o2=o1[-1] - o1, wire=px if cached else pb,
                         dev_bytes=dev_b, srv_bytes=srv_b)


def candidate_rows_for(backend, store, a_star: float, batch: int,
                       cached: bool, need_bytes: bool) -> CandidateRows:
    """The per-candidate term vectors of one (model, level, batch,
    cached) pricing profile — the scalar ``serve`` path's entry into
    the same ``_assemble_rows`` the window path uses."""
    specs = backend.layer_specs(batch=batch)
    o1 = np.concatenate([[0.0], np.cumsum([sp.o for sp in specs])])
    ab_cum = act_bytes_row(specs) if need_bytes else None
    return _assemble_rows(specs, store, a_star, cached, need_bytes, o1,
                          ab_cum)


def decode_rows_for(backend, store, a_star: float, batch: int,
                    need_bytes: bool) -> CandidateRows:
    """Per-TOKEN candidate term vectors of one decode step (DESIGN.md
    §11): the same assembly as ``candidate_rows_for`` but over the
    backend's decode-mode layer specs, so ``o1``/``o2`` are MACs per
    generated token and the byte rows carry the per-step KV read/write
    traffic. The ``wire`` row is the payload table's shipment row and is
    NOT the per-token wire — callers price the per-step hidden-state hop
    themselves (one activation vector, not a sequence)."""
    specs = backend.decode_layer_specs(batch=batch)
    o1 = np.concatenate([[0.0], np.cumsum([sp.o for sp in specs])])
    ab_cum = act_bytes_row(specs) if need_bytes else None
    return _assemble_rows(specs, store, a_star, False, need_bytes, o1,
                          ab_cum)


def prefill_chunk_rows_for(backend, store, a_star: float, batch: int,
                           chunk_tokens: int,
                           need_bytes: bool) -> CandidateRows:
    """Per-CHUNK candidate term vectors of a chunked prefill (DESIGN.md
    §14): the same assembly as ``candidate_rows_for`` but over layer
    specs at the CHUNK length, so ``o1``/``o2`` are MACs per admitted
    chunk — what one PREFILL_CHUNK round of the fleet's decode lane
    costs. A prompt of n chunks prices as n of these rows instead of
    one monolithic prompt-length row; the dense terms agree exactly
    (linear in sequence length) while the attention term is chunk-local
    — a lower bound that misses cross-chunk attention, which is why the
    fleet's chunk lane splits the calibrated monolithic ``t_server``
    evenly across chunks (sums exactly) and uses these rows only for
    relative per-cut comparisons. ``wire`` stays the shipment row, as
    in ``decode_rows_for``."""
    if int(chunk_tokens) < 2:
        raise ValueError("chunk_tokens must be >= 2 (pipeline contract)")
    specs = backend.layer_specs(batch=batch, seq_len=int(chunk_tokens))
    o1 = np.concatenate([[0.0], np.cumsum([sp.o for sp in specs])])
    ab_cum = act_bytes_row(specs) if need_bytes else None
    return _assemble_rows(specs, store, a_star, False, need_bytes, o1,
                          ab_cum)


def price_window(models, server: ServerProfile,
                 requests: Sequence[InferenceRequest],
                 context: Optional["ReferenceContext"] = None,
                 provider: Optional[CostProvider] = None,
                 cache: Optional[dict] = None) -> WindowTable:
    """``models``: name -> ModelState (raises ``UnknownModelError`` /
    ``NotCalibratedError`` through ``ModelState.store`` when a request
    names an unregistered or un-calibrated model).

    ``cache``: optional caller-owned dict persisting the per-(level,
    batch, cached) row tuples and per-batch layer specs ACROSS calls —
    the fleet engine prices thousands of epochs against the same stores,
    and rebuilding identical ``CandidateRows`` per epoch dominates at
    scale. The caller owns invalidation: drop the dict whenever the
    models, stores, context or provider it was filled under change.
    Rows coming out of a shared cache are the SAME objects every call
    (stable identity), which downstream per-``id(rows)`` caches rely on.
    """
    from repro_torch.serving.errors import UnknownModelError

    provider = ANALYTIC if provider is None else provider
    need_bytes = provider.uses_bytes
    R = len(requests)
    tab = WindowTable(obj=[None] * R, o1=[None] * R, wire=[None] * R,
                      plans=[None] * R, groups=[],
                      pb=[None] * R, px=[None] * R, rows=[None] * R)
    by_model = {}
    for i, r in enumerate(requests):
        by_model.setdefault(r.model, []).append(i)
    for name, idxs in by_model.items():
        if name not in models:
            raise UnknownModelError(name, models)
        m = models[name]
        store = m.store(context)
        group = [requests[i] for i in idxs]
        # per-request coefficient vectors — ONE cached lookup per
        # distinct (weights, device, channel) profile instead of three
        # list-comprehension recomputes per window
        coeff = np.stack([provider.coeffs_cached(r.weights, r.device,
                                                 r.channel, server)
                          for r in group])                   # (G, K)
        # rows cached per (accuracy level, batch, cached) — large windows
        # with few distinct budgets reuse one (terms, plans, payloads,
        # memory) tuple instead of rebuilding identical rows per request
        if cache is not None:
            rows_cache = cache.setdefault((name, "rows"), {})
            by_batch = cache.setdefault((name, "batch"), {})
        else:
            rows_cache = {}
            by_batch = {}      # batch -> (specs, o1 row, ab_cum row)
        plans, mem_rows = [], []
        row_objs, pb_rows, px_rows = [], [], []
        for r in group:
            key = (store.level_for(r.accuracy_budget), r.batch,
                   bool(r.segment_cached))
            if key not in rows_cache:
                a_star, batch, cached = key
                if batch not in by_batch:
                    specs = m.backend.layer_specs(batch=batch)
                    o1_r = np.concatenate(
                        [[0.0], np.cumsum([sp.o for sp in specs])])
                    by_batch[batch] = (specs, o1_r,
                                       act_bytes_row(specs)
                                       if need_bytes else None)
                specs, o1_r, ab_cum = by_batch[batch]
                crow = _assemble_rows(specs, store, a_star, cached,
                                      need_bytes, o1_r, ab_cum)
                pb, px = store.level_payload_rows(a_star)
                rows_cache[key] = (crow, store.level_plans(a_star),
                                   store.level_memory_rows(a_star), pb, px)
            crow, plans_r, mem_r, pb_r, px_r = rows_cache[key]
            row_objs.append(crow)
            plans.append(plans_r)
            mem_rows.append(mem_r)
            pb_rows.append(pb_r)
            px_rows.append(px_r)
        # obj = sum_k c_k[:, None] · T_k — accumulated in term order, so
        # the analytic provider reproduces the historical
        # xi·O1 + delta·O2 + eps·wire float-for-float
        term_stacks = [np.stack(ts) for ts in zip(
            *(provider.terms(cr) for cr in row_objs))]       # K × (G, P+1)
        obj = coeff[:, 0, None] * term_stacks[0]
        for k in range(1, len(term_stacks)):
            obj = obj + coeff[:, k, None] * term_stacks[k]
        # device-memory admission (plan-time): infeasible candidates can
        # never win the argmin. p=0 holds no device weights, so a finite
        # column always remains.
        mem = np.stack(mem_rows)
        # decode-planned backends (decode_max_len set) additionally hold
        # the device segment's KV cache for the stream's lifetime —
        # candidate c's resident footprint is weights + cache (None for
        # classifiers / prefill-only backends: mask unchanged; getattr
        # tolerates spec-only backend stubs in tests). With
        # ``kv_page_tokens`` set the stream is priced at its
        # page-rounded ACTUAL context (prompt + its own new tokens)
        # instead of the max_len worst case — strictly <= the dense
        # reservation, so the mask only ever widens.
        kv_fn = getattr(m.backend, "kv_bytes_row", None)
        paged = kv_fn is not None and \
            getattr(m.backend, "kv_page_tokens", None) is not None
        if paged:
            seq = int(m.backend.seq_len)
            kv_rows = [kv_fn(r.batch,
                             tokens=seq + max(int(r.max_new_tokens), 1))
                       for r in group]
        else:
            kv_rows = [kv_fn(r.batch) if kv_fn else None for r in group]
        if any(k is not None for k in kv_rows):
            zero = np.zeros_like(mem[0])
            mem = mem + np.stack([zero if k is None else k
                                  for k in kv_rows])
        dev_mem = np.array([r.device.memory_bytes for r in group])
        obj = np.where(mem > dev_mem[:, None], np.inf, obj)
        tab.groups.append((idxs, obj))
        for j, i in enumerate(idxs):
            tab.obj[i], tab.o1[i] = obj[j], row_objs[j].o1
            tab.wire[i], tab.plans[i] = row_objs[j].wire, plans[j]
            tab.pb[i], tab.px[i] = pb_rows[j], px_rows[j]
            tab.rows[i] = row_objs[j]
    return tab
