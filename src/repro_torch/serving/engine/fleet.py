"""Event-driven fleet serving engine (DESIGN.md §8, resilience §10,
scale §12).

Runs a discrete-event loop over timestamped ``InferenceRequest`` arrivals
against a MULTI-SERVER fleet: plan → uplink (model shipment) → device
segment → cut-activation transfer → server segment → complete. The
engine generalizes the one-shot ``WorkloadBalancer.schedule`` window
along three axes while keeping its vectorized hot path (every decision
epoch prices all pending requests as ONE ``price_window`` matrix):

  * time      — arrivals carry ``arrival_time``; requests admitted at a
                later epoch see whatever backlog earlier admissions left.
  * fleet     — N servers, each with its own ``ServerProfile``, work
                backlog and wall-clock reservation horizon. The pricing
                row of server s is the reference row plus a per-server
                delta-coefficient correction and its own queue term, so
                heterogeneous fleets cost one vector op per server.
  * state     — per-device segment caches. When a request carries a
                ``device_id`` the ENGINE decides which candidates ship
                weights: a candidate whose quantized segment the device
                already holds is priced at the activation-only payload
                (``segment_cached`` set automatically, not trusted from
                the caller). Shipments install into the cache when their
                downlink completes, not at admission.

Queue semantics: the objective's queue term is the PRICING view — the
chosen server's reserved work backlog at admission (``max(0,
work_until − now)``), exactly the paper's Eq. 17-under-load term the
one-shot scheduler charged. The executed ``StageTimeline`` is the
wall-clock truth: the server segment starts at ``max(server free, cut
activation arrival)`` and servers serve reservations in admission order
(FIFO, non-preemptive). With one server and all arrivals at t = 0 the
two views coincide and the engine reproduces ``WorkloadBalancer
.schedule`` plan-for-plan and objective-for-objective (regression-locked
in tests/test_scheduler.py + tests/test_fleet.py).

Deadline/SLO admission (``slo=``):
  * "observe" — deadlines only tracked in metrics (default).
  * "reject"  — a request whose estimated finish misses ``arrival +
                deadline`` on every (server, candidate) is rejected.
  * "degrade" — same check, but before rejecting, the accuracy budget is
                relaxed level-by-level (cheaper payloads) until some
                candidate meets the deadline; only then reject.

Fault tolerance (DESIGN.md §10): a ``FaultInjector`` merges seeded
DISCONNECT / RECONNECT / DEGRADE events into the queue. A disconnect
CANCELS every in-flight attempt of that device still in its
ship/device/transfer stage — the server reservation is released (the
backlog refund future admissions price against; committed later
timelines never move), a pending CACHE_INSTALL is invalidated, and the
request goes to the ``RetryPolicy`` (capped exponential backoff,
per-request attempt budget, optional accuracy degradation per retry,
terminal dead-letter queue). Arrivals on a down device PARK — no
attempt burned — until reconnect, and park forever becomes the
``disconnect_abandoned`` dead letter when the trace drains. Every event
processed lands in a replayable ``EventJournal``; with no faults
injected the engine is bit-for-bit the sunny-day engine of §8.

Scale (DESIGN.md §12): the hot loop is built for 10⁶-request traces —
arrivals bulk-load through one stable argsort (``ArrivalStream``)
instead of a heappush per request, per-request facts live in a columnar
``RecordStore``, the admission argmin runs as one (servers × candidates)
masked matrix op (``admission="vectorized"``; the historical scalar loop
survives as ``admission="reference"`` and is asserted decision-for-
decision identical), the degrade/retry ladders re-price against cached
one-row tables, and ``journal="light"|"off"`` drop journaling overhead.
Every knob defaults to the bit-for-bit path (vectorized admission IS
bit-for-bit; it's locked, not trusted).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.cost_model import Channel, CostProvider, ServerProfile
from repro_torch.serving.decode.batching import DecodeBatcher, DecodeStream
from repro_torch.serving.decode.cache import PageLedger, paged_kv_ctx
from repro_torch.serving.decode.pipeline import DecodeSession

_chunk_bounds = DecodeSession.chunk_bounds
from repro_torch.serving.deployment import Deployment, ReferenceContext
from repro_torch.serving.engine.events import (ARRIVAL, CACHE_INSTALL, COMPLETE,
                                               DECODE_STEP, EPOCH, FAULT,
                                               PREFILL_CHUNK, RETRY,
                                               ArrivalStream, EventQueue,
                                               StageTimeline)
from repro_torch.serving.engine.faults import (DEGRADE, DISCONNECT, RECONNECT,
                                               FaultInjector)
from repro_torch.serving.engine.journal import (JOURNAL_MODES, EventJournal,
                                                LightJournal)
from repro_torch.serving.engine.metrics import FleetMetrics
from repro_torch.serving.engine.policies import AdmissionPolicy, get_policy
from repro_torch.serving.engine.records import (DROP_CODES, LazyRecords,
                                                RecordStore)
from repro_torch.serving.engine.retry import (REASON_ABANDONED, REASON_EXHAUSTED,
                                              REASON_SLO, DeadLetter, RetryPolicy)
from repro_torch.serving.errors import ServingError
from repro_torch.serving.pricing import decode_rows_for, price_window
from repro_torch.serving.simulator import InferenceRequest, ServingResult

SLO_MODES = ("observe", "reject", "degrade")
RECORD_MODES = ("full", "light")
ADMISSION_MODES = ("vectorized", "reference")


@dataclasses.dataclass
class ServerState:
    """One fleet member: profile + the two queue views + the active
    reservation ledger (token -> committed finish time) that fault
    cancellation rolls back."""
    profile: ServerProfile
    work_until: float = 0.0     # pricing backlog: committed server seconds
    free: float = 0.0           # wall clock: last reservation's finish
    busy: float = 0.0           # total reserved work (utilization)
    reservations: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Pending:
    index: int                  # position in the submitted trace
    request: InferenceRequest
    arrival: float


@dataclasses.dataclass
class _Flight:
    """One in-flight admission attempt (between commit and COMPLETE)."""
    token: tuple                # (request index, attempt) — unique
    device_id: Optional[str]
    server: int
    t_server: float             # reserved server seconds (the refund)
    timeline: StageTimeline


class FleetEngine:
    """Discrete-event serving over a fleet of QPART servers.

    ``qpart_server`` supplies the registered models and offline stores;
    ``servers`` the fleet profiles (default: the qpart_server's own
    profile, a fleet of one); ``policy`` an ``AdmissionPolicy`` or its
    name; ``epoch_interval`` batches arrivals into decision epochs (0 =
    admit at each arrival instant; simultaneous arrivals always share
    one epoch/window); ``retry`` the fault-recovery ``RetryPolicy``
    (default ``RetryPolicy()`` — inert without faults); ``faults`` a
    ``FaultInjector`` or plain ``FaultEvent`` sequence.

    Scale knobs (DESIGN.md §12) — every default is the full-fidelity
    path, and every non-default is decision-for-decision identical
    (only cheaper bookkeeping):

    ``journal``   — "full" (replayable ``EventJournal``), "light"
                    (columnar time/kind tape), "off" (no journal object;
                    ``metrics.journal`` is None).
    ``records``   — "full" keeps per-request ``Deployment`` objects;
                    "light" skips result assembly (views carry
                    ``deployment=None``; stage math identical).
    ``admission`` — "vectorized" (one masked (servers × candidates)
                    argmin per admission), "reference" (the historical
                    per-server scalar loop, kept as the equivalence
                    oracle).
    ``reprice_cache`` — memoize the degrade/retry ladders' one-row
                    ``price_window`` tables per (model, level, batch,
                    device, effective channel, weights, cached) for the
                    run; False re-prices fresh per rung (the oracle).
    """

    def __init__(self, qpart_server, servers: Optional[Sequence[ServerProfile]] = None,
                 policy="fcfs", slo: str = "observe",
                 epoch_interval: float = 0.0,
                 provider: Optional[CostProvider] = None,
                 retry: Optional[RetryPolicy] = None,
                 faults: Optional[FaultInjector] = None,
                 journal: str = "full", records: str = "full",
                 admission: str = "vectorized",
                 reprice_cache: bool = True,
                 draft_tokens: int = 0,
                 accept_rate: Optional[float] = None,
                 prefill_chunk_tokens: Optional[int] = None):
        if slo not in SLO_MODES:
            raise ValueError(f"slo must be one of {SLO_MODES}, got {slo!r}")
        if journal not in JOURNAL_MODES:
            raise ValueError(f"journal must be one of {JOURNAL_MODES}, "
                             f"got {journal!r}")
        if records not in RECORD_MODES:
            raise ValueError(f"records must be one of {RECORD_MODES}, "
                             f"got {records!r}")
        if admission not in ADMISSION_MODES:
            raise ValueError(f"admission must be one of {ADMISSION_MODES}, "
                             f"got {admission!r}")
        self.qs = qpart_server
        profiles = list(servers) if servers is not None \
            else [qpart_server.server]
        if not profiles:
            raise ValueError("fleet needs at least one server")
        self._profiles = profiles
        self.servers = [ServerState(p) for p in profiles]
        self.policy: AdmissionPolicy = get_policy(policy)
        self.slo = slo
        self.epoch_interval = float(epoch_interval)
        self.context: Optional[ReferenceContext] = None
        self.journal_mode = journal
        self.records_mode = records
        self.admission_mode = admission
        self._reprice_enabled = bool(reprice_cache)
        self._choose = self._choose_vectorized \
            if admission == "vectorized" else self._choose_reference
        # CostModel v2: pricing, SLO finish estimates, reservations and
        # breakdowns all run through the provider (default: the
        # qpart_server's — AnalyticCost unless overridden, e.g. with a
        # CalibratedCost to re-price reservations from measured rates)
        if provider is None:
            provider = getattr(qpart_server, "provider", None)
        if provider is None:
            from repro_torch.core.cost_model import ANALYTIC
            provider = ANALYTIC
        self.provider: CostProvider = provider
        self.retry: RetryPolicy = retry if retry is not None else RetryPolicy()
        if faults is None:
            faults = FaultInjector()
        elif not isinstance(faults, FaultInjector):
            faults = FaultInjector(faults)
        self.faults: FaultInjector = faults
        # device_id -> set of (model, accuracy level, p) the device holds
        self.caches: dict = {}
        self.dead_letters: List[DeadLetter] = []
        self.kv_ledger = PageLedger()
        self._kv_streams: dict = {}
        # serving-shape knobs (DESIGN.md §14), default-off: the zero-knob
        # engine is bit-for-bit the knob-free engine (journal header included —
        # the keys below only exist when a knob is enabled)
        self.draft_tokens = int(draft_tokens)
        if self.draft_tokens < 0:
            raise ValueError("draft_tokens must be >= 0")
        if accept_rate is None and self.draft_tokens:
            # measured rate from a calibrated provider's ledger when one
            # exists (CalibratedCost.mean_accept_rate), else the neutral
            # prior — resolved ONCE so the journal header pins the value
            # replay reuses
            measured = getattr(self.provider, "mean_accept_rate", None)
            accept_rate = float(measured) if measured is not None else 0.5
        self.accept_rate = None if accept_rate is None \
            else float(accept_rate)
        if self.accept_rate is not None \
                and not 0.0 <= self.accept_rate <= 1.0:
            raise ValueError("accept_rate must be within [0, 1]")
        self.prefill_chunk_tokens = None if prefill_chunk_tokens is None \
            else int(prefill_chunk_tokens)
        if self.prefill_chunk_tokens is not None \
                and self.prefill_chunk_tokens < 2:
            raise ValueError("prefill_chunk_tokens must be >= 2")
        self._chunk_state: dict = {}
        # server -> {index: (requeue_time, chunk_s)} of deferred chunks:
        # _push_decode holds the lane for the earliest one so saturated
        # decode lanes (step_lag == 0) cannot starve a queued prompt
        self._chunk_wait: dict = {}

    # ------------------------------------------------------------------
    def run(self, requests: Sequence[InferenceRequest],
            context: Optional[ReferenceContext] = None) -> FleetMetrics:
        """Run the trace to completion and return the fleet metrics
        (``.records`` is in trace order, one entry per request). Each
        run is an independent simulation: server queues, device caches
        and fault state start empty (the engine is re-runnable, not
        resumable). Every request ends terminal: completed, rejected,
        or dead-lettered with a reason."""
        self.context = context
        self.servers = [ServerState(p) for p in self._profiles]
        self.caches = {}
        st = RecordStore(requests, full=self.records_mode == "full")
        self._st = st
        self._queue = EventQueue()
        self._pending: List[_Pending] = []
        self._epochs = set()
        self._admit_rank = 0
        self._in_flight = 0
        # queue-depth samples as growing columns (one per commit/finish)
        self._s_t = np.empty(256, dtype=np.float64)
        self._s_d = np.empty(256, dtype=np.int64)
        self._s_len = 0
        self._horizon = 0.0
        # fault-tolerance state (all per-run)
        self._down: set = set()              # disconnected device_ids
        self._parked: dict = {}              # device_id -> [indices]
        self._channel_factor: dict = {}      # device_id -> capacity factor
        self._eff_channels: dict = {}        # (channel, factor) -> Channel
        self._inflight: dict = {}            # index -> _Flight
        self._live: set = set()              # valid admission tokens
        # decode lane (DESIGN.md §11): one continuous batcher per server,
        # per-(model, level, batch) per-token term rows
        self._batchers = [DecodeBatcher() for _ in self.servers]
        self._decode_rows_cache: dict = {}
        # block-granular device-KV residency: streams of a backend
        # with ``kv_page_tokens`` set are tracked at page granularity —
        # open at prefill, grown as the ring fills, closed on finish or
        # severance. Empty (zero-overhead) for legacy dense backends.
        self.kv_ledger = PageLedger()
        self._kv_streams: dict = {}          # index -> (backend, batch, cut)
        self.dead_letters = []
        # per-run pricing caches (§12). All keyed through the shared
        # ``_price_cache``'s stable CandidateRows identities — dropping
        # the whole set at run start is the invalidation story.
        self._price_cache: dict = {}         # price_window row/spec cache
        self._reprice_tables: dict = {}      # ladder one-row WindowTables
        self._corr_cache: dict = {}          # (id(rows), weights, profile)
        self._tsrv_cache: dict = {}          # (id(rows), profile)
        self._tsrv_stacks: dict = {}         # id(rows) -> (S, C) matrix
        self._corr_stacks: dict = {}         # (id(rows), weights) -> matrix
        self._tdev_cache: dict = {}          # (id(rows), device)
        self._order_cache = None             # least-loaded server order
        self._stores: dict = {}              # model name -> OfflineStore
        # the fleet's heterogeneity layout is fixed for the run: which
        # servers price off the reference row directly (profile IS the
        # reference object) vs through a delta correction
        ref = self.servers[0].profile
        self._nonref_idx = np.array(
            [s for s in range(len(self.servers))
             if self.servers[s].profile is not ref], dtype=np.intp)
        self._homogeneous = self._nonref_idx.size == 0
        self._chunk_state = {}
        self._chunk_wait = {}
        header = {
            "policy": self.policy.name, "slo": self.slo,
            "epoch_interval": self.epoch_interval,
            "servers": len(self.servers),
            "retry": dataclasses.asdict(self.retry),
            "requests": st.n, "faults": len(self.faults)}
        # keys exist ONLY when a serving-shape knob is on, so a zero-knob
        # run's header (and hence journal) is byte-identical to a knob-free run's
        if self.draft_tokens:
            header["draft_tokens"] = self.draft_tokens
            header["accept_rate"] = self.accept_rate
        if self.prefill_chunk_tokens is not None:
            header["prefill_chunk_tokens"] = self.prefill_chunk_tokens
        if self.journal_mode == "full":
            self._journal = EventJournal(header=header)
        elif self.journal_mode == "light":
            self._journal = LightJournal(header=header)
        else:
            self._journal = None
        for f in self.faults.events:
            self._queue.push(float(f.time), FAULT, f)
        arrivals = ArrivalStream(st.arrival)
        queue = self._queue
        # sorted-merge dispatch: the arrival cursor races the heap on
        # (time, kind) — no ARRIVAL is ever IN the heap, so strict
        # lexicographic comparison reproduces the historical all-heap
        # order exactly (FAULT=0 still preempts same-time arrivals)
        while True:
            if arrivals.pos < arrivals.n:
                key = queue.peek_key()
                if key is None or (arrivals.times[arrivals.pos], ARRIVAL) \
                        < key:
                    t, i = arrivals.pop()
                    self._on_arrival(t, i)
                    continue
            elif not queue:
                break
            t, kind, payload = queue.pop()
            if kind == COMPLETE:
                self._on_complete(t, payload)
            elif kind == EPOCH:
                self._on_epoch(t)
            elif kind == CACHE_INSTALL:
                dev_id, key, token = payload
                applied = token in self._live
                if applied:
                    self.caches.setdefault(dev_id, set()).add(key)
                if self._journal is not None:
                    self._journal.record(t, CACHE_INSTALL, device=dev_id,
                                         model=key[0], level=key[1],
                                         p=key[2], applied=applied)
            elif kind == DECODE_STEP:
                self._on_decode(t, payload)
            elif kind == PREFILL_CHUNK:
                self._on_prefill_chunk(t, payload)
            elif kind == RETRY:
                self._on_retry(t, payload)
            elif kind == FAULT:
                self._on_fault(t, payload)
        # trace drained: whoever is still parked never saw a reconnect
        for dev in sorted(self._parked):
            for i in self._parked[dev]:
                self._dead_letter(i, REASON_ABANDONED, self._horizon)
        self._parked = {}
        samples = np.stack([self._s_t[:self._s_len],
                            self._s_d[:self._s_len].astype(np.float64)],
                           axis=1)
        return FleetMetrics(records=LazyRecords(st),
                            server_busy=[s.busy for s in self.servers],
                            queue_samples=samples,
                            horizon=self._horizon,
                            dead_letters=list(self.dead_letters),
                            journal=self._journal,
                            store=st)

    # ------------------------------------------------------------------
    def _sample(self, t: float) -> None:
        i = self._s_len
        if i == self._s_t.shape[0]:
            self._s_t = np.concatenate([self._s_t, np.empty_like(self._s_t)])
            self._s_d = np.concatenate([self._s_d, np.empty_like(self._s_d)])
        self._s_t[i] = t
        self._s_d[i] = self._in_flight
        self._s_len = i + 1

    def _schedule_epoch(self, t: float) -> None:
        """Queue the decision epoch covering instant ``t``. Epoch
        bucketing is EXACT: the smallest k with k·interval >= t, decided
        by comparing actual float products — ``ceil(t / interval)``
        alone drifts for non-dyadic intervals (an on-boundary arrival
        lands in the NEXT epoch, or a just-past-boundary arrival gets an
        epoch scheduled in its past; locked in tests/test_faults.py)."""
        if self.epoch_interval > 0:
            iv = self.epoch_interval
            k = math.ceil(t / iv)
            while (k - 1) * iv >= t:
                k -= 1
            while k * iv < t:
                k += 1
            t = k * iv
        if t not in self._epochs:
            self._epochs.add(t)
            self._queue.push(t, EPOCH, None)

    def _on_arrival(self, t: float, i: int) -> None:
        req = self._st.requests[i]
        parked = req.device_id is not None and req.device_id in self._down
        if parked:
            self._parked.setdefault(req.device_id, []).append(i)
            self._st.parked[i] += 1
        else:
            self._pending.append(_Pending(i, req, t))
            self._schedule_epoch(t)
        if self._journal is not None:
            self._journal.record(t, ARRIVAL, index=i, parked=parked)

    def _on_retry(self, t: float, payload) -> None:
        i, attempt = payload
        req = self._st.requests[i]
        parked = req.device_id is not None and req.device_id in self._down
        if parked:
            self._parked.setdefault(req.device_id, []).append(i)
            self._st.parked[i] += 1
        else:
            # deadline stays absolute: the pending entry keeps the
            # ORIGINAL arrival, so EDF/SLO see arrival + deadline
            self._pending.append(_Pending(i, req, req.arrival_time))
            self._schedule_epoch(t)
        if self._journal is not None:
            self._journal.record(t, RETRY, index=i, attempt=attempt,
                                 parked=parked)

    def _on_complete(self, t: float, payload) -> None:
        i, token = payload
        if token not in self._live:
            # a fault cancelled this attempt after its COMPLETE was
            # queued — a non-event, but journaled so replay sees it
            if self._journal is not None:
                self._journal.record(t, COMPLETE, index=i, stale=True)
            return
        self._live.discard(token)
        fl = self._inflight.pop(i)
        self.servers[fl.server].reservations.pop(token, None)
        self._in_flight -= 1
        self._sample(t)
        if t > self._horizon:
            self._horizon = t
        if self._journal is not None:
            self._journal.record(t, COMPLETE, index=i, stale=False)

    # -- decode lane (DESIGN.md §11) -----------------------------------
    def _decode_rows(self, req: InferenceRequest, a_star: float):
        """Per-token candidate term rows of the request's model at its
        resolved accuracy level — cached per (model, level, batch)."""
        key = (req.model, a_star, req.batch)
        rows = self._decode_rows_cache.get(key)
        if rows is None:
            m = self.qs.models[req.model]
            rows = decode_rows_for(m.backend, m.store(self.context),
                                   a_star, req.batch,
                                   self.provider.uses_bytes)
            self._decode_rows_cache[key] = rows
        return rows

    def _push_decode(self, s: int) -> None:
        """Queue a DECODE_STEP at server ``s``'s next round time. Called
        after EVERY batcher mutation; previously queued events whose time
        no longer matches are detected as stale at fire time. A waiting
        prefill chunk HOLDS the lane (DESIGN.md §14): the next round is
        pushed past that chunk's slot, so back-to-back rounds (step_lag
        = 0 full-offload streams) cannot starve a queued prompt — the
        two event kinds alternate fairly on the shared timeline."""
        t_next = self._batchers[s].next_time()
        if t_next is not None:
            wait = self._chunk_wait.get(s)
            if wait:
                tc, dt_c = min(wait.values())
                if tc <= t_next:
                    t_next = max(t_next, tc + dt_c)
            self._queue.push(t_next, DECODE_STEP, s)

    def _start_stream(self, finish: float, i: int, req: InferenceRequest,
                      plan, a_star: float, s: int, token: tuple,
                      n_tok: int) -> None:
        """Register an admitted request's decode stream with its server's
        batcher. The prefill delivers token 1 at ``finish`` (TTFT); each
        later token costs one device-segment step + one hidden-state hop
        (``step_lag``) before it can join a server round."""
        rows = self._decode_rows(req, a_star)
        c = plan.p
        dev_b, srv_b = rows.bytes_at(c)
        dt_dev = self.provider.device_seconds(req.device, float(rows.o1[c]),
                                              dev_b)
        # speculation needs a device segment to draft through AND a round
        # trip to amortize — full offload (p == 0) streams plainly
        draft_k = min(self.draft_tokens, n_tok - 2) if plan.p else 0
        if plan.p:
            backend = self.qs.models[req.model].backend
            if draft_k > 0:
                # one speculative round: k+1 device decode steps, then
                # (k+1) quantized cut hiddens + k draft ids uplink and
                # up to k+1 verified ids downlink — ONE channel latency
                # amortized over E[1 + alpha*k] emitted tokens
                hid = plan.bits_x * backend.cfg.d_model * req.batch
                wire_rnd = ((draft_k + 1) * hid
                            + 32.0 * draft_k * req.batch
                            + 32.0 * (draft_k + 1) * req.batch)
                step_lag = float((draft_k + 1) * dt_dev
                                 + wire_rnd / req.channel.capacity())
            else:
                wire_tok = (plan.bits_x * backend.cfg.d_model * req.batch
                            + 32.0 * req.batch)
                step_lag = float(dt_dev + wire_tok / req.channel.capacity())
        else:
            # full offload: the server feeds its own sample back — no
            # device hop on the decode path
            step_lag = 0.0
        stream = DecodeStream(
            index=i, token=token, device_id=req.device_id,
            remaining=n_tok - 1, ready_at=finish + step_lag,
            o2_tok=float(rows.o2[c]), srv_bytes_tok=srv_b,
            step_lag=step_lag)
        if draft_k > 0:
            stream.draft_k = draft_k
            stream.alpha = self.accept_rate
        self._batchers[s].add(stream)
        backend = self.qs.models[req.model].backend
        if plan.p and getattr(backend, "kv_page_tokens", None) is not None \
                and backend.decode_max_len is not None:
            self._kv_open(i, backend, req.batch, c)
        self._push_decode(s)

    # -- page-granular KV residency -------------------------------------
    def _kv_resident(self, backend, batch: int, cut: int, tokens: int):
        """(bytes, context pages) a ``tokens``-token stream holds at cut
        ``cut`` under paged allocation — ``kv_bytes_row`` at the
        page-rounded context (cached per (batch, ctx) on the backend, so
        per-round lookups are dict hits)."""
        row = backend.kv_bytes_row(batch, tokens=tokens)
        ctx = paged_kv_ctx(tokens, backend.kv_page_tokens,
                           backend.decode_max_len)
        return float(row[cut]), ctx // backend.kv_page_tokens

    def _kv_open(self, i: int, backend, batch: int, cut: int) -> None:
        tokens = int(backend.seq_len) + 1
        nbytes, pages = self._kv_resident(backend, batch, cut, tokens)
        self.kv_ledger.open(i, nbytes, pages)
        self._kv_streams[i] = (backend, batch, cut)

    def _kv_grow(self, i: int) -> None:
        info = self._kv_streams.get(i)
        if info is None:
            return
        backend, batch, cut = info
        tokens = int(backend.seq_len) + int(self._st.tokens_emitted[i]) + 1
        self.kv_ledger.grow(i, *self._kv_resident(backend, batch, cut,
                                                  tokens))

    def _kv_close(self, i: int) -> None:
        if self._kv_streams.pop(i, None) is not None:
            self.kv_ledger.close(i)

    def _on_decode(self, t: float, s: int) -> None:
        """One continuous-batching round at server ``s``: every stream
        whose next input has arrived joins, the round is priced once for
        the batch (MAC terms add, the tail weight-stream term amortizes
        — ``server_seconds(Σ o2_tok, max srv_bytes_tok)``)."""
        batcher = self._batchers[s]
        t_next = batcher.next_time()
        if t_next is None or t < t_next:
            # the batcher mutated since this event was queued — a fresh
            # event exists at the re-derived time; this one is a no-op
            if self._journal is not None:
                self._journal.record(t, DECODE_STEP, server=s, stale=True)
            return
        st, srv = self._st, self.servers[s]
        due = batcher.due(t)
        if self.draft_tokens:
            # a speculative stream's round verifies k+1 rows in one tail
            # forward — its MAC term scales; the weight-stream byte term
            # is still read once for the whole round
            dt = float(self.provider.server_seconds(
                srv.profile,
                sum(stm.o2_tok * (stm.draft_k + 1) for stm in due),
                max(stm.srv_bytes_tok for stm in due)))
        else:
            dt = float(self.provider.server_seconds(
                srv.profile, sum(stm.o2_tok for stm in due),
                max(stm.srv_bytes_tok for stm in due)))
        t_end = t + dt
        srv.work_until = max(srv.work_until, t) + dt
        srv.busy += dt
        self._order_cache = None
        batcher.busy_until = t_end
        active, finished, emitted = [], [], []
        for stm in due:
            if stm.draft_k > 0:
                # deterministic stand-in for the measured acceptance: the
                # fractional accumulator floor((j+1)·α·k) − floor(j·α·k)
                # emits exactly E[1 + α·k] tokens per round on average
                # with no RNG, so journals replay bit-for-bit
                j = stm.rounds_done
                ak = stm.alpha * stm.draft_k
                acc = int(math.floor((j + 1) * ak) - math.floor(j * ak))
                m = min(1 + acc, stm.remaining)
                stm.rounds_done = j + 1
            else:
                m = 1
            emitted.append(m)
            stm.remaining -= m
            st.tokens_emitted[stm.index] += m
            if stm.remaining <= 0:
                batcher.remove(stm.index)
                self._kv_close(stm.index)
                st.decode_done[stm.index] = t_end
                finished.append(stm.index)
                self._queue.push(t_end, COMPLETE, (stm.index, stm.token))
            else:
                batcher.rearm(stm.index, t_end + stm.step_lag)
                self._kv_grow(stm.index)
                active.append(stm.index)
        if self._journal is not None:
            if self.draft_tokens:
                self._journal.record(t, DECODE_STEP, server=s, stale=False,
                                     round_s=dt, batch=len(due),
                                     active=active, finished=finished,
                                     emitted=emitted)
            else:
                self._journal.record(t, DECODE_STEP, server=s, stale=False,
                                     round_s=dt, batch=len(due),
                                     active=active, finished=finished)
        self._push_decode(s)

    # -- chunked prefill lane (DESIGN.md §14) ---------------------------
    def _on_prefill_chunk(self, t: float, payload) -> None:
        """One prompt chunk lands on the server's decode lane: it runs
        for ``t_server / n`` seconds on the batcher's shared
        ``busy_until`` timeline (decode rounds in progress defer it;
        it defers decode rounds symmetrically), and the LAST chunk ends
        the prefill — TTFT, stream start, COMPLETE scheduling."""
        i, token, j = payload
        cs = self._chunk_state.get(i)
        if token not in self._live or cs is None or cs["token"] != token:
            # a fault cancelled this attempt; chunk events of the dead
            # attempt are journaled non-events, like stale COMPLETEs
            if self._journal is not None:
                self._journal.record(t, PREFILL_CHUNK, index=i, chunk=j,
                                     stale=True)
            return
        s = cs["s"]
        batcher = self._batchers[s]
        if t < batcher.busy_until:
            # a decode round holds the lane — re-queue at its end (the
            # round that extended busy_until fired after this chunk was
            # queued, the same lazy-staleness dance DECODE_STEP does)
            self._queue.push(batcher.busy_until, PREFILL_CHUNK, payload)
            self._chunk_wait.setdefault(s, {})[i] = (batcher.busy_until,
                                                     cs["dt_c"])
            if self._journal is not None:
                self._journal.record(t, PREFILL_CHUNK, index=i, chunk=j,
                                     deferred=True)
            return
        srv = self.servers[s]
        self._chunk_wait.get(s, {}).pop(i, None)
        dt_c = cs["dt_c"]
        t_end = t + dt_c
        srv.work_until = max(srv.work_until, t) + dt_c
        srv.busy += dt_c
        self._order_cache = None
        batcher.busy_until = t_end
        if cs["started"] is None:
            cs["started"] = t
        last = j == cs["n"] - 1
        if self._journal is not None:
            self._journal.record(t, PREFILL_CHUNK, index=i, chunk=j,
                                 stale=False, chunk_s=dt_c, last=last)
        if not last:
            self._queue.push(max(cs["arrivals"][j + 1], t_end),
                             PREFILL_CHUNK, (i, token, j + 1))
            self._push_decode(s)
            return
        # final chunk — the prefill is done; the executed lane times
        # replace the provisional timeline committed at admission
        del self._chunk_state[i]
        st = self._st
        st.tl[i, 4] = cs["started"]
        st.tl[i, 5] = t_end
        fl = self._inflight.get(i)
        if fl is not None:
            fl.timeline.server_start = cs["started"]
            fl.timeline.finish = t_end
        n_tok = cs["n_tok"]
        req = cs["req"]
        if n_tok > 1 and req.device_id is not None \
                and req.device_id in self._down:
            # the device died while its chunks were already at the
            # server: the prefill completes as committed work, but the
            # decode stream can never be fed — sever exactly like
            # _cancel_device's mid-stream branch and retry
            self._live.discard(token)
            del self._inflight[i]
            self._in_flight -= 1
            self._sample(t_end)
            st.reset_attempt(i)
            st.faults[i] += 1
            self._retry_or_dead_letter(i, t_end)
            self._push_decode(s)
            return
        if n_tok > 1:
            self._start_stream(t_end, i, req, cs["plan"], cs["a_star"],
                               s, token, n_tok)
        else:
            if n_tok == 1:
                st.decode_done[i] = t_end
            self._queue.push(t_end, COMPLETE, (i, token))
        self._push_decode(s)

    # -- faults --------------------------------------------------------
    def _on_fault(self, t: float, f) -> None:
        if f.kind == DEGRADE:
            if f.factor == 1.0:
                self._channel_factor.pop(f.device_id, None)
            else:
                self._channel_factor[f.device_id] = f.factor
            if self._journal is not None:
                self._journal.record(t, FAULT, fault=DEGRADE,
                                     device=f.device_id, factor=f.factor)
        elif f.kind == DISCONNECT:
            self._down.add(f.device_id)
            cancelled = self._cancel_device(f.device_id, t)
            if self._journal is not None:
                self._journal.record(t, FAULT, fault=DISCONNECT,
                                     device=f.device_id, cancelled=cancelled)
        elif f.kind == RECONNECT:
            self._down.discard(f.device_id)
            released = self._parked.pop(f.device_id, [])
            for i in released:
                self._pending.append(
                    _Pending(i, self._st.requests[i],
                             self._st.requests[i].arrival_time))
            if released:
                self._schedule_epoch(t)
            if self._journal is not None:
                self._journal.record(t, FAULT, fault=RECONNECT,
                                     device=f.device_id,
                                     released=list(released))

    def _cancel_device(self, dev: str, t: float) -> list:
        """Cancel every in-flight attempt of ``dev`` still in its
        ship/device/transfer stage (an attempt whose cut activation
        already reached the server — t >= transfer_done — completes
        server-side as committed). Cancellation releases the server
        reservation and hands the request to the retry policy.

        Decode streams extend the window: a stream whose device is still
        feeding the batcher (tokens remaining) is severed even AFTER its
        prefill reached the server — the next hidden-state hop can never
        arrive. The prefill's server work stays billed (committed), only
        the reservation ledger entry is dropped, and the whole attempt
        retries from scratch. A stream that already emitted its last
        token (out of the batcher, COMPLETE queued) lands as committed."""
        cancelled = []
        st = self._st
        for i in sorted(self._inflight):
            fl = self._inflight[i]
            if fl.device_id != dev:
                continue
            stream = self._batchers[fl.server].remove(i)
            if t >= fl.timeline.transfer_done and stream is None:
                continue
            if stream is not None:
                self._kv_close(i)
                self._push_decode(fl.server)
            del self._inflight[i]
            self._live.discard(fl.token)
            cs = self._chunk_state.pop(i, None)  # queued chunks go stale
            if cs is not None:
                self._chunk_wait.get(cs["s"], {}).pop(i, None)
            if t < fl.timeline.transfer_done:
                self._release(fl)
            else:
                # mid-stream severance: no backlog refund, just drop the
                # reservation ledger entry (mirrors _release sans refund)
                srv = self.servers[fl.server]
                if srv.reservations.pop(fl.token, None) is not None:
                    srv.free = max(srv.reservations.values(), default=0.0)
            self._in_flight -= 1
            self._sample(t)
            # the failed attempt's deployment is void — reset the
            # per-attempt fields; a successful retry repopulates them
            st.reset_attempt(i)
            st.faults[i] += 1
            cancelled.append(i)
            self._retry_or_dead_letter(i, t)
        return cancelled

    def _release(self, fl: _Flight) -> None:
        """Roll back a cancelled attempt's server commitment: refund the
        pricing backlog (``work_until``/``busy``) and, if this was the
        tail reservation, the wall-clock ``free`` horizon. Committed
        LATER timelines never move (reservations are immutable): a
        mid-ledger hole is idle time, deliberately non-work-conserving."""
        srv = self.servers[fl.server]
        if srv.reservations.pop(fl.token, None) is not None:
            srv.free = max(srv.reservations.values(), default=0.0)
        srv.work_until -= fl.t_server
        srv.busy -= fl.t_server
        self._order_cache = None

    def _retry_or_dead_letter(self, i: int, t: float) -> None:
        used = int(self._st.attempts[i])
        if used >= self.retry.budget_for(self._st.requests[i]):
            self._dead_letter(i, REASON_EXHAUSTED, t)
        else:
            self._queue.push(t + self.retry.backoff(used + 1),
                             RETRY, (i, used + 1))

    def _dead_letter(self, i: int, reason: str, t: float) -> None:
        st = self._st
        st.rejected[i] = True
        st.drop_code[i] = DROP_CODES[reason]
        self.dead_letters.append(DeadLetter(i, reason, t,
                                            int(st.attempts[i]),
                                            st.requests[i].device_id))

    # -- pricing views -------------------------------------------------
    def _effective_channel(self, req: InferenceRequest) -> Channel:
        """The request's channel with any active degradation applied
        (memoized per (channel, factor) so provider coefficient caches
        stay hot)."""
        factor = self._channel_factor.get(req.device_id) \
            if req.device_id is not None else None
        if not factor or factor == 1.0:
            return req.channel
        key = (req.channel, factor)
        ch = self._eff_channels.get(key)
        if ch is None:
            ch = Channel(bandwidth_hz=req.channel.bandwidth_hz,
                         capacity_bps=req.channel.capacity() * factor)
            self._eff_channels[key] = ch
        return ch

    def _effective_request(self, req: InferenceRequest) -> InferenceRequest:
        """The request as admission sees it: degraded channel applied,
        caller's cache flag preserved (identity when no fault state —
        the zero-fault path stays bit-for-bit)."""
        ch = self._effective_channel(req)
        if ch is req.channel:
            return req
        return dataclasses.replace(req, channel=ch)

    def _pricing_request(self, req: InferenceRequest) -> InferenceRequest:
        """Engine-owned cache state: a request with a ``device_id`` is
        priced from the full-payload row and the cached candidates are
        re-priced individually; the caller's flag only survives for
        anonymous requests (the one-shot degenerate case). Channel
        degradation folds in here too."""
        eff = self._effective_request(req)
        if req.device_id is not None and req.segment_cached:
            eff = dataclasses.replace(eff, segment_cached=False)
        return eff

    def _on_epoch(self, t: float) -> None:
        self._epochs.discard(t)
        pending, self._pending = self._pending, []
        # a device that went down between arrival and epoch parks here
        parked = []
        if self._down:
            keep = []
            for p in pending:
                dev = p.request.device_id
                if dev is not None and dev in self._down:
                    self._parked.setdefault(dev, []).append(p.index)
                    self._st.parked[p.index] += 1
                    parked.append(p.index)
                else:
                    keep.append(p)
            pending = keep
        if not pending:
            if parked and self._journal is not None:
                self._journal.record(t, EPOCH, admitted=[], parked=parked)
            return
        pricing = [self._pricing_request(p.request) for p in pending]
        tab = price_window(self.qs.models, self.servers[0].profile, pricing,
                           context=self.context, provider=self.provider,
                           cache=self._price_cache)
        ref = self.servers[0].profile
        t_server_rows = [self._tsrv(rows, ref) for rows in tab.rows]
        order = self.policy.order(pending, tab, t_server_rows)
        if self._journal is not None:
            admitted = [self._admit(t, pending[j], tab, j) for j in order]
            self._journal.record(t, EPOCH, admitted=admitted, parked=parked)
        else:
            for j in order:
                self._admit(t, pending[j], tab, j)

    # ------------------------------------------------------------------
    def _cached_candidates(self, req: InferenceRequest,
                           a_star: float) -> np.ndarray:
        if req.device_id is None:
            return np.zeros(0, dtype=int)
        held = self.caches.get(req.device_id, ())
        return np.array(sorted(p for (m, lv, p) in held
                               if m == req.model and lv == a_star),
                        dtype=int)

    def _candidate_rows(self, req: InferenceRequest, tab, j, a_star: float):
        """(base objective row, wire vector) with the device segment
        cache applied: a cached candidate drops the weight-shipment share
        of its wire term (Eq. 14 Z_w amortized to zero)."""
        row = tab.obj[j]
        wire = tab.wire[j]
        cached = self._cached_candidates(req, a_star)
        cached = cached[cached < len(wire)]
        if len(cached):
            ep = self.provider.wire_coeff(req.weights, req.device,
                                          req.channel)
            pb, px = tab.pb[j], tab.px[j]
            adj = np.zeros_like(row)
            adj[cached] = ep * (pb[cached] - px[cached])
            row = row - adj
            wire = wire.copy()
            wire[cached] = px[cached]
        return row, wire

    # -- per-run row-keyed caches (§12). Keys lean on the stable
    # CandidateRows identities the shared price-window cache guarantees
    # (the rows objects live in self._price_cache for the whole run, so
    # id() cannot be recycled). ------------------------------------------
    def _tsrv(self, rows, profile: ServerProfile) -> np.ndarray:
        """server_seconds(profile, o2, srv_bytes) — cached per
        (rows identity, profile)."""
        key = (id(rows), profile)
        vec = self._tsrv_cache.get(key)
        if vec is None:
            vec = self.provider.server_seconds(profile, rows.o2,
                                               rows.srv_bytes)
            self._tsrv_cache[key] = vec
        return vec

    def _tdev(self, rows, device) -> np.ndarray:
        """device_seconds(device, o1, dev_bytes) — cached per
        (rows identity, device)."""
        key = (id(rows), device)
        vec = self._tdev_cache.get(key)
        if vec is None:
            vec = self.provider.device_seconds(device, rows.o1,
                                               rows.dev_bytes)
            self._tdev_cache[key] = vec
        return vec

    def _correction(self, req: InferenceRequest, profile: ServerProfile,
                    rows) -> np.ndarray:
        """server_correction(weights, ref, profile, rows) — cached per
        (rows identity, weights, profile); the reference profile is
        fixed for the run."""
        key = (id(rows), req.weights, profile)
        vec = self._corr_cache.get(key)
        if vec is None:
            vec = self.provider.server_correction(
                req.weights, self.servers[0].profile, profile, rows)
            self._corr_cache[key] = vec
        return vec

    def _server_order(self) -> list:
        """least_loaded's server ordering, hoisted: backlogs only change
        at commit/release/decode-round, so the sort is computed once per
        backlog change instead of once per pending request."""
        order = self._order_cache
        if order is None:
            order = sorted(range(len(self.servers)),
                           key=lambda s: (self.servers[s].work_until, s))
            self._order_cache = order
        return order

    def _finish_vec(self, req: InferenceRequest, t: float, rows, wire_vec,
                    px_row, srv: ServerState) -> np.ndarray:
        """Estimated wall-clock completion per candidate on ``srv`` under
        the reservation semantics (exact: reservations never move). Stage
        durations come from the provider, so a calibrated/roofline
        provider's SLO admission sees its own clock."""
        r_cap = req.channel.capacity()
        ship = np.maximum(wire_vec - px_row, 0.0)
        o2 = rows.o2
        ready = (t + ship / r_cap
                 + self.provider.device_seconds(req.device, rows.o1,
                                                rows.dev_bytes)
                 + px_row / r_cap)
        start = np.where(o2 > 0, np.maximum(ready, srv.free), ready)
        return start + self.provider.server_seconds(srv.profile, o2,
                                                    rows.srv_bytes)

    def _ready_vec(self, req: InferenceRequest, t: float, rows, wire_vec,
                   px_row) -> np.ndarray:
        """The server-independent prefix of ``_finish_vec`` (uplink +
        device segment + cut-activation transfer), computed once per
        admission instead of once per server — same accumulation order,
        so the floats are identical."""
        r_cap = req.channel.capacity()
        ship = np.maximum(wire_vec - px_row, 0.0)
        return (t + ship / r_cap
                + self._tdev(rows, req.device)
                + px_row / r_cap)

    # ------------------------------------------------------------------
    def _choose_vectorized(self, t: float, req: InferenceRequest,
                           arrival: float, tab, j: int, a_star: float,
                           enforce_slo: bool):
        """Best (server, candidate) under the policy's server rule as ONE
        masked (servers × candidates) argmin; None when ``enforce_slo``
        and no pair meets the deadline. Decision-for-decision identical
        to ``_choose_reference`` (locked in tests/test_fleet_scale.py):
        row construction preserves the scalar path's float-association
        order, and the flattened row-major argmin reproduces its
        tie-break (first server, then first candidate, strict <)."""
        row0, wire_vec = self._candidate_rows(req, tab, j, a_star)
        rows = tab.rows[j]
        uses_server = rows.o2 > 0
        servers = self.servers
        ref = servers[0].profile
        omega = req.weights.omega
        if self.policy.server_rule == "least_loaded":
            # load order; under an SLO the later servers are the
            # fallback, so a request is only rejected when EVERY
            # (server, candidate) pair misses the deadline
            order = self._server_order()
            if not enforce_slo:
                order = order[:1]
            ready = self._ready_vec(req, t, rows, wire_vec, tab.px[j]) \
                if enforce_slo else None
            for s in order:
                srv = servers[s]
                row = row0 if srv.profile is ref \
                    else row0 + self._correction(req, srv.profile, rows)
                queue = max(0.0, srv.work_until - t)
                row = row + omega * queue * uses_server
                if enforce_slo:
                    start = np.where(uses_server,
                                     np.maximum(ready, srv.free), ready)
                    finish = start + self._tsrv(rows, srv.profile)
                    row = np.where(
                        finish <= arrival + req.deadline + 1e-12,
                        row, np.inf)
                    if not np.isfinite(row).any():
                        continue
                c = int(np.argmin(row))
                # first feasible server in load order wins outright
                return (float(row[c]), s, c, queue, wire_vec)
            return None
        S, C = len(servers), len(row0)
        queues = np.fromiter((srv.work_until for srv in servers),
                             np.float64, S)
        np.subtract(queues, t, out=queues)
        np.maximum(queues, 0.0, out=queues)
        qterm = (omega * queues)[:, None] * uses_server
        if self._homogeneous:
            # every row is the reference row: one broadcast add computes
            # row0 + qterm[s] per element — bitwise what the scalar loop
            # produced (it never added a correction either; row0 + 0.0
            # would NOT be a no-op when row0 holds -0.0)
            mat = row0[None, :] + qterm
        else:
            base = np.repeat(row0[None, :], S, axis=0)
            ck = (id(rows), req.weights)
            corr = self._corr_stacks.get(ck)
            if corr is None:
                corr = np.stack(
                    [self._correction(req, servers[s].profile, rows)
                     for s in self._nonref_idx])
                self._corr_stacks[ck] = corr
            # in-place add keeps the scalar association (row0 + corr)
            # before the queue term lands
            base[self._nonref_idx] += corr
            mat = base + qterm
        if enforce_slo:
            ready = self._ready_vec(req, t, rows, wire_vec, tab.px[j])
            free = np.fromiter((srv.free for srv in servers),
                               np.float64, S)
            start = np.where(uses_server[None, :],
                             np.maximum(ready[None, :], free[:, None]),
                             ready[None, :])
            tsrv = self._tsrv_stacks.get(id(rows))
            if tsrv is None:
                tsrv = np.stack([self._tsrv(rows, srv.profile)
                                 for srv in servers])
                self._tsrv_stacks[id(rows)] = tsrv
            finish = start + tsrv
            mat = np.where(finish <= arrival + req.deadline + 1e-12,
                           mat, np.inf)
            if not np.isfinite(mat).any():
                return None
        k = int(np.argmin(mat))
        s, c = divmod(k, C)
        return (float(mat[s, c]), s, c, float(queues[s]), wire_vec)

    def _choose_reference(self, t: float, req: InferenceRequest,
                          arrival: float, tab, j: int, a_star: float,
                          enforce_slo: bool):
        """The historical per-server scalar loop — the equivalence
        oracle ``admission="reference"`` selects; kept verbatim."""
        row0, wire_vec = self._candidate_rows(req, tab, j, a_star)
        rows = tab.rows[j]
        o2_vec = rows.o2
        uses_server = o2_vec > 0
        ref = self.servers[0].profile
        least_loaded = self.policy.server_rule == "least_loaded"
        if least_loaded:
            order = sorted(range(len(self.servers)),
                           key=lambda s: (self.servers[s].work_until, s))
            if not enforce_slo:
                order = order[:1]
        else:
            order = range(len(self.servers))
        best = None
        for s in order:
            srv = self.servers[s]
            row = row0
            if srv.profile is not ref:
                row = row + self.provider.server_correction(
                    req.weights, ref, srv.profile, rows)
            queue = max(0.0, srv.work_until - t)
            row = row + req.weights.omega * queue * uses_server
            if enforce_slo:
                finish = self._finish_vec(req, t, rows, wire_vec,
                                          tab.px[j], srv)
                row = np.where(finish <= arrival + req.deadline + 1e-12,
                               row, np.inf)
                if not np.isfinite(row).any():
                    continue
            c = int(np.argmin(row))
            if least_loaded:
                # first feasible server in load order wins outright
                return (row[c], s, c, queue, wire_vec)
            if best is None or row[c] < best[0]:
                best = (row[c], s, c, queue, wire_vec)
        return best

    def _reprice_single(self, req: InferenceRequest, level: float):
        """One-row window at a relaxed accuracy level — the degrade
        ladder's re-pricing step (SLO degrade and retry degrade share
        it). ``req`` must be the ORIGINAL request: ``_pricing_request``
        applies the degraded channel itself (applying it to an already
        effective request would compound the factor).

        Tables are memoized per (model, level, batch, device, effective
        channel, weights, effective cached flag) — everything the table
        depends on — so ladders walk cached rows instead of calling
        ``price_window`` once per rung per request. ``reprice_cache=
        False`` disables the memo (the oracle the cache is locked
        against in tests/test_fleet.py)."""
        if self._reprice_enabled:
            eff_cached = req.segment_cached if req.device_id is None \
                else False
            key = (req.model, level, req.batch, req.device,
                   self._effective_channel(req), req.weights, eff_cached)
            tab = self._reprice_tables.get(key)
            if tab is None:
                relaxed = dataclasses.replace(self._pricing_request(req),
                                              accuracy_budget=level)
                tab = price_window(self.qs.models, self.servers[0].profile,
                                   [relaxed], context=self.context,
                                   provider=self.provider,
                                   cache=self._price_cache)
                self._reprice_tables[key] = tab
            return tab
        relaxed = dataclasses.replace(self._pricing_request(req),
                                      accuracy_budget=level)
        return price_window(self.qs.models, self.servers[0].profile,
                            [relaxed], context=self.context,
                            provider=self.provider,
                            cache=self._price_cache)

    # ------------------------------------------------------------------
    def _admit(self, t: float, pnd: _Pending, tab, j: int) -> list:
        """Admit (or drop) one pending request; returns the journal's
        ``[index, server]`` outcome pair (server -1 = dropped)."""
        st = self._st
        req = self._effective_request(pnd.request)
        store = self._stores.get(req.model)
        if store is None:
            store = self.qs.models[req.model].store(self.context)
            self._stores[req.model] = store
        a_star = store.level_for(req.accuracy_budget)
        attempt = int(st.attempts[pnd.index]) + 1
        degraded = None
        if attempt > 1 and self.retry.degrade_on_retry:
            # retry-with-degraded-budget: coarsen one store level per
            # retry (same ladder SLO degrade walks), floor at coarsest
            ladder = sorted(store.levels)
            k = min(ladder.index(a_star) + attempt - 1, len(ladder) - 1)
            if ladder[k] != a_star:
                a_star = ladder[k]
                tab, j = self._reprice_single(pnd.request, a_star), 0
                degraded = a_star
        enforce = req.deadline is not None and self.slo != "observe"
        choice = self._choose(t, req, pnd.arrival, tab, j, a_star, enforce)
        if choice is None and self.slo == "degrade":
            for lv in sorted(store.levels):
                if lv <= a_star:
                    continue
                tab_lv = self._reprice_single(pnd.request, lv)
                choice = self._choose(t, req, pnd.arrival, tab_lv, 0, lv,
                                      True)
                if choice is not None:
                    degraded, tab, j, a_star = lv, tab_lv, 0, lv
                    break
        if choice is None:
            st.rejected[pnd.index] = True
            st.drop_code[pnd.index] = DROP_CODES[REASON_SLO]
            # attempts stays attempt - 1: the reject consumed none
            return [pnd.index, -1]
        _, s, c, queue, wire_vec = choice
        self._commit(t, pnd, tab, j, s, c, queue, float(wire_vec[c]),
                     a_star, degraded, attempt, req)
        return [pnd.index, s]

    def _commit(self, t: float, pnd: _Pending, tab, j: int, s: int, c: int,
                queue: float, wire: float, a_star: float,
                degraded: Optional[float], attempt: int,
                req: InferenceRequest) -> None:
        st = self._st
        srv = self.servers[s]
        plan, o1, o2, _ = tab.select(j, c)
        dev_b, srv_b = tab.rows[j].bytes_at(c)
        backend = self.qs.models[req.model].backend
        if st.full:
            costs = self.provider.breakdown(o1, o2, wire, req.device,
                                            srv.profile, req.channel,
                                            dev_bytes=dev_b, srv_bytes=srv_b)
            res = ServingResult(plan=plan, costs=costs,
                                objective=costs.objective(req.weights)
                                + req.weights.omega
                                * (queue if o2 > 0 else 0.0),
                                payload_bits=wire, attempt=attempt)
            res.extra["queue_delay"] = queue if o2 > 0 else 0.0
            res.extra["server"] = s
            if degraded is not None:
                res.extra["degraded_to"] = degraded
            st.deployments[pnd.index] = Deployment(req.model, backend, req,
                                                   plan, res)
            t_local, t_server = costs.t_local, costs.t_server
        else:
            # light records: no Deployment/ServingResult objects. The
            # provider's stage clocks ARE breakdown's t_local/t_server
            # (base breakdown delegates to them; AnalyticCost's is the
            # same closed form) — locked in tests/test_fleet_scale.py
            t_local = float(self.provider.device_seconds(req.device, o1,
                                                         dev_b))
            t_server = float(self.provider.server_seconds(srv.profile, o2,
                                                          srv_b))

        # stage timeline (events.py): ship → device segment → transfer →
        # server segment, reserved FIFO on the chosen server
        r_cap = req.channel.capacity()
        ship = max(wire - plan.payload_x_bits, 0.0)
        x_share = wire - ship
        ship_done = t + ship / r_cap
        # the executed device stage is the provider's t_local — identical
        # to o1·gamma/f under the analytic default, memory-/measurement-
        # aware under the roofline/calibrated providers
        device_done = ship_done + t_local
        transfer_done = device_done + x_share / r_cap
        token = (pnd.index, attempt)
        # chunked prefill (DESIGN.md §14): the server prefill lands as
        # n PREFILL_CHUNK rounds on the decode lane's busy timeline
        # instead of one monolithic reservation, so live decode rounds
        # and later admissions interleave between chunks
        n_chunks = 0
        if self.prefill_chunk_tokens is not None and o2 > 0 \
                and t_server > 0.0:
            seq = int(getattr(backend, "seq_len", 0) or 0)
            if seq > self.prefill_chunk_tokens:
                n_chunks = len(_chunk_bounds(seq,
                                             self.prefill_chunk_tokens))
        if n_chunks >= 2:
            # provisional timeline — the last chunk overwrites
            # server_start/finish with the executed lane times
            server_start = transfer_done
            finish = transfer_done + t_server
        elif o2 > 0:
            server_start = max(srv.free, transfer_done)
            finish = server_start + t_server
            srv.free = finish
            srv.reservations[token] = finish
        else:
            server_start = transfer_done
            finish = server_start
        if n_chunks >= 2:
            pass      # chunk rounds accrue work_until/busy as they fire
        else:
            srv.work_until = max(srv.work_until, t) + t_server
            srv.busy += t_server
            self._order_cache = None
        tl = StageTimeline(t, ship_done, device_done, transfer_done,
                           server_start, finish)

        i = pnd.index
        st.tl[i, 0] = t
        st.tl[i, 1] = ship_done
        st.tl[i, 2] = device_done
        st.tl[i, 3] = transfer_done
        st.tl[i, 4] = server_start
        st.tl[i, 5] = finish
        st.server[i] = s
        st.start_order[i] = self._admit_rank
        st.backlog[i] = queue
        st.queue_delay[i] = queue if o2 > 0 else 0.0
        st.degraded_to[i] = np.nan if degraded is None else degraded
        st.attempts[i] = attempt
        st.payload_bits[i] = wire
        self._admit_rank += 1
        self._live.add(token)
        # a chunked flight's server work accrues chunk by chunk at fire
        # time, so severance has nothing to refund (t_server = 0)
        self._inflight[i] = _Flight(token, req.device_id, s,
                                    0.0 if n_chunks >= 2 else t_server, tl)

        if (req.device_id is not None and plan.p and ship > 0):
            self._queue.push(ship_done, CACHE_INSTALL,
                             (req.device_id,
                              (req.model, a_star, plan.p), token))
        self._in_flight += 1
        self._sample(t)
        # decode streams (DESIGN.md §11): the prefill's finish is token 1
        # (TTFT); the remaining tokens run through the server's
        # continuous-batching lane and COMPLETE moves to the last round
        n_tok = int(req.max_new_tokens)
        if n_tok > 0:
            if not getattr(backend, "supports_decode", False):
                raise ServingError(
                    f"request {i} asks for {n_tok} decode tokens "
                    f"but backend {type(backend).__name__!r} of model "
                    f"{req.model!r} has no autoregressive decode path")
            st.decode_tokens[i] = n_tok
            st.tokens_emitted[i] = 1
        if n_chunks >= 2:
            # stream start / COMPLETE move to the LAST chunk's end — the
            # device computes + uplinks chunks back-to-back, so chunk j
            # can land no earlier than its share of the device+transfer
            # pipeline (the last arrival IS the analytic transfer_done)
            if n_tok > 1:
                st.decode_done[i] = np.nan
            per = (t_local + x_share / r_cap) / n_chunks
            self._chunk_state[i] = {
                "token": token, "req": req, "plan": plan,
                "a_star": a_star, "s": s, "n_tok": n_tok,
                "n": n_chunks, "dt_c": t_server / n_chunks,
                "arrivals": [ship_done + (j + 1) * per
                             for j in range(n_chunks)],
                "started": None}
            self._queue.push(self._chunk_state[i]["arrivals"][0],
                             PREFILL_CHUNK, (i, token, 0))
        elif n_tok > 1:
            st.decode_done[i] = np.nan
            self._start_stream(finish, i, req, plan, a_star, s, token,
                               n_tok)
        else:
            if n_tok == 1:
                st.decode_done[i] = finish
            self._queue.push(finish, COMPLETE, (i, token))
