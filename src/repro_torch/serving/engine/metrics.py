"""Fleet-level serving metrics.

The engine accounts one record per request (admitted, rejected, or
dead-lettered); ``FleetMetrics`` owns the records plus the engine's
queue-depth samples, per-server busy totals, dead-letter queue and event
journal, and aggregates the numbers a serving system is judged by:
p50/p99 end-to-end latency, deadline-miss rate, server utilization,
time-weighted queue depth, payload on the radio link — and, under fault
injection, goodput, retry rate, and per-reason drop counts. Terminal
accounting is an invariant, not a hope: ``assert_terminal()`` checks
every request either completed or carries a structured drop reason.

Since the columnar rework (DESIGN.md §12) the engine keeps per-request
facts in a ``RecordStore`` (engine/records.py) and hands it to
``FleetMetrics`` as ``store``; every aggregate then reduces whole
columns. ``records`` stays a sequence of ``FleetRecord`` dataclass
views, materialized lazily. When ``store`` is None (hand-built metrics,
and the reference path the equivalence tests in
tests/test_fleet_scale.py compare against) each aggregate falls back to
the historical per-record loop — both paths produce bit-identical
numbers.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serving.engine.events import StageTimeline
from repro_torch.serving.engine.records import (CODE_REASONS, TL_DEVICE,
                                                TL_FINISH, TL_SHIP, TL_START,
                                                TL_TRANSFER)
from repro_torch.serving.engine.retry import DeadLetter
from repro_torch.serving.simulator import InferenceRequest


@dataclasses.dataclass
class FleetRecord:
    """Everything the engine decided and observed for one request."""
    index: int                          # arrival-order position in the trace
    request: InferenceRequest
    deployment: object = None           # serving.Deployment; None = dropped
    timeline: Optional[StageTimeline] = None
    server: int = -1                    # fleet index of the serving server
    start_order: int = -1               # global admission rank
    # pricing-side queue view (what entered the objective; the paper's
    # Eq. 17 queue term = reference-server work backlog at admission)
    backlog_at_admission: float = 0.0
    queue_delay: float = 0.0            # backlog, zeroed when p = L (no
    # server segment) — mirrors result.extra["queue_delay"]
    degraded_to: Optional[float] = None  # accuracy level after SLO degrade
    # or retry-with-degraded-budget (engine/retry.py)
    rejected: bool = False              # True for EVERY non-completed
    # terminal state; drop_reason says WHY (retry.DROP_REASONS)
    drop_reason: Optional[str] = None
    attempts: int = 0                   # admission attempts consumed
    # (0 = never admitted; > 1 = fault-driven re-admissions)
    faults: int = 0                     # in-flight cancellations suffered
    parked: int = 0                     # times held for a down device
    # -- decode streams (DESIGN.md §11) --------------------------------
    decode_tokens: int = 0              # tokens the request streams
    # (0 = one-shot request; == request.max_new_tokens when admitted)
    tokens_emitted: int = 0             # tokens the decode lane delivered
    decode_done: Optional[float] = None  # last-token time (streams only)

    @property
    def arrival(self) -> float:
        return self.request.arrival_time

    @property
    def completed(self) -> bool:
        return not self.rejected

    @property
    def dead_lettered(self) -> bool:
        """Terminally failed under fault recovery (as opposed to an SLO
        admission reject)."""
        from repro_torch.serving.engine.retry import REASON_SLO
        return self.rejected and self.drop_reason is not None \
            and self.drop_reason != REASON_SLO

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (arrival → prefill finish). For one-shot
        requests this IS the end-to-end latency."""
        if self.timeline is None:
            return None
        return self.timeline.latency_from(self.arrival)

    @property
    def latency(self) -> Optional[float]:
        """End-to-end: last decode token for streams (``decode_done``),
        the prefill/one-shot finish otherwise."""
        if self.decode_tokens > 1 and self.decode_done is not None:
            return self.decode_done - self.arrival
        if self.timeline is None:
            return None
        return self.timeline.latency_from(self.arrival)

    @property
    def deadline_missed(self) -> Optional[bool]:
        """None when the request has no deadline; a dropped request with
        a deadline counts as missed. For decode streams the SLO is on
        TTFT (the interactive metric) — the stream's tail pace is priced,
        not promised."""
        if self.request.deadline is None:
            return None
        if self.rejected:
            return True
        lat = self.ttft if self.decode_tokens > 1 else self.latency
        return lat > self.request.deadline + 1e-12


@dataclasses.dataclass
class FleetMetrics:
    records: Sequence[FleetRecord]
    server_busy: List[float]            # per-server reserved work seconds
    queue_samples: Sequence            # (time, total in-flight) pairs —
    # an (M, 2) float column block from the engine, a list of tuples
    # when hand-built
    horizon: float                      # last completion time
    dead_letters: List[DeadLetter] = dataclasses.field(default_factory=list)
    journal: object = None              # EventJournal | LightJournal | None
    store: object = None                # engine RecordStore (columnar path)

    # -- columnar helpers ----------------------------------------------
    def _lat_cols(self):
        """(latency, ttft) columns over ALL rows — NaN where the row has
        no committed timeline (exactly the rows whose dataclass view has
        ``latency``/``ttft`` None)."""
        st = self.store
        ttft = st.tl[:, TL_FINISH] - st.arrival
        lat = np.where((st.decode_tokens > 1) & ~np.isnan(st.decode_done),
                       st.decode_done - st.arrival, ttft)
        return lat, ttft

    def _miss_cols(self):
        """(has-deadline mask, missed flags over ALL rows): rejected
        rows count as missed; streams are judged on TTFT."""
        st = self.store
        lat, ttft = self._lat_cols()
        eff = np.where(st.decode_tokens > 1, ttft, lat)
        miss = np.where(st.rejected, True, eff > st.deadline + 1e-12)
        return ~np.isnan(st.deadline), miss

    # ------------------------------------------------------------------
    def completed(self) -> List[FleetRecord]:
        if self.store is not None:
            recs = self.records
            return [recs[int(i)]
                    for i in np.flatnonzero(~self.store.rejected)]
        return [r for r in self.records if not r.rejected]

    def latencies(self) -> np.ndarray:
        if self.store is not None:
            lat, _ = self._lat_cols()
            return lat[~self.store.rejected]
        return np.array([r.latency for r in self.completed()], np.float64)

    def deadline_miss_rate(self) -> Optional[float]:
        """Missed / carrying-a-deadline (drops count as misses); None
        when the trace has no deadlines at all."""
        if self.store is not None:
            has, miss = self._miss_cols()
            if not has.any():
                return None
            return float(np.mean(miss[has]))
        flags = [r.deadline_missed for r in self.records
                 if r.deadline_missed is not None]
        if not flags:
            return None
        return float(np.mean(flags))

    def utilization(self) -> List[float]:
        if self.horizon <= 0:
            return [0.0] * len(self.server_busy)
        return [min(b / self.horizon, 1.0) for b in self.server_busy]

    def mean_queue_depth(self) -> float:
        """Time-weighted mean of in-flight requests over the horizon."""
        if len(self.queue_samples) < 2:
            return 0.0
        if isinstance(self.queue_samples, np.ndarray):
            t = self.queue_samples[:, 0]
            d = self.queue_samples[:, 1]
        else:
            t = np.array([s[0] for s in self.queue_samples])
            d = np.array([s[1] for s in self.queue_samples], np.float64)
        dt = np.diff(t)
        span = t[-1] - t[0]
        if span <= 0:
            return float(d.mean())
        return float(np.sum(d[:-1] * dt) / span)

    def _stage_cols(self, done_mask=None):
        """Per-stage duration columns over completed rows, in trace
        order — same key order and the same subtractions as
        ``StageTimeline.stage_seconds``."""
        tl = self.store.tl[~self.store.rejected if done_mask is None
                           else done_mask]
        return {"ship": tl[:, TL_SHIP] - tl[:, 0],
                "device": tl[:, TL_DEVICE] - tl[:, TL_SHIP],
                "transfer": tl[:, TL_TRANSFER] - tl[:, TL_DEVICE],
                "server_wait": tl[:, TL_START] - tl[:, TL_TRANSFER],
                "server": tl[:, TL_FINISH] - tl[:, TL_START]}

    def mean_stage_seconds(self) -> dict:
        """Mean per-stage seconds over completed requests (the priced
        ``StageTimeline`` view) — where fleet time actually goes."""
        if self.store is not None:
            cols = self._stage_cols()
            n = cols["ship"].shape[0]
            if not n:
                return {}
            # sequential Python sum, exactly the historical per-record
            # accumulation order (np.sum's pairwise reduction would
            # drift in the last ulps)
            return {k: sum(col.tolist(), 0.0) / n for k, col in cols.items()}
        done = self.completed()
        if not done:
            return {}
        acc: dict = {}
        for r in done:
            for k, v in r.timeline.stage_seconds.items():
                acc[k] = acc.get(k, 0.0) + v
        return {k: v / len(done) for k, v in acc.items()}

    # -- resilience aggregates (DESIGN.md §10) -------------------------
    def drop_reasons(self) -> dict:
        """Structured drop-reason counts — SLO rejects, retry
        exhaustion and disconnect abandonment are distinguishable."""
        counts: dict = {}
        if self.store is not None:
            codes = self.store.drop_code[self.store.rejected]
            for code in codes.tolist():     # record order -> key order
                key = CODE_REASONS.get(code, "unknown")
                counts[key] = counts.get(key, 0) + 1
            return counts
        for r in self.records:
            if r.rejected:
                key = r.drop_reason or "unknown"
                counts[key] = counts.get(key, 0) + 1
        return counts

    def retried(self) -> int:
        """Requests that needed more than one admission attempt."""
        if self.store is not None:
            return int((self.store.attempts > 1).sum())
        return sum(1 for r in self.records if r.attempts > 1)

    def disrupted(self) -> int:
        """Requests a fault touched at all: cancelled in flight or
        parked behind a disconnected device."""
        if self.store is not None:
            return int(((self.store.faults > 0)
                        | (self.store.parked > 0)).sum())
        return sum(1 for r in self.records if r.faults or r.parked)

    def retry_rate(self) -> float:
        if not len(self.records):
            return 0.0
        return self.retried() / len(self.records)

    # -- decode aggregates (DESIGN.md §11) -----------------------------
    def ttfts(self) -> np.ndarray:
        if self.store is not None:
            _, ttft = self._lat_cols()
            return ttft[~self.store.rejected]
        return np.array([r.ttft for r in self.completed()
                         if r.ttft is not None], np.float64)

    def tokens_per_s(self) -> float:
        """Decode-lane throughput: tokens delivered per second of
        horizon (0.0 for one-shot-only traces)."""
        if self.horizon <= 0:
            return 0.0
        if self.store is not None:
            return int(self.store.tokens_emitted.sum()) / self.horizon
        return sum(r.tokens_emitted for r in self.records) / self.horizon

    def goodput_rps(self) -> float:
        """USEFUL completions per second of horizon: completed AND (when
        a deadline was attached) inside it — the number fault tolerance
        is supposed to protect."""
        if self.horizon <= 0:
            return 0.0
        if self.store is not None:
            has, miss = self._miss_cols()
            good = ~self.store.rejected & (~has | ~miss)
            return int(good.sum()) / self.horizon
        good = sum(1 for r in self.completed()
                   if r.deadline_missed is not True)
        return good / self.horizon

    def assert_terminal(self) -> None:
        """Every request is terminally accounted for: completed with a
        timeline, or dropped with a structured reason (no lost
        requests). The chaos acceptance invariant."""
        if self.store is not None:
            st = self.store
            rej = st.rejected
            bad = np.flatnonzero(rej & (st.drop_code == 0))
            assert not bad.size, \
                f"request {bad[0]} dropped without a reason"
            done = ~rej
            bad = np.flatnonzero(done & np.isnan(st.tl[:, 0]))
            assert not bad.size, \
                f"request {bad[0]} neither completed nor dropped"
            if st.full:
                dep_ok = np.fromiter((d is not None for d in st.deployments),
                                     bool, count=st.n)
                bad = np.flatnonzero(done & ~dep_ok)
                assert not bad.size, \
                    f"request {bad[0]} neither completed nor dropped"
                bad = np.flatnonzero(rej & dep_ok)
                assert not bad.size, \
                    f"request {bad[0]} dropped but kept a deployment"
            streams = done & (st.decode_tokens > 0)
            bad = np.flatnonzero(
                streams & (st.tokens_emitted != st.decode_tokens))
            assert not bad.size, \
                (f"request {bad[0] if bad.size else -1} completed with "
                 f"missing decode tokens")
            bad = np.flatnonzero(done & (st.decode_tokens > 1)
                                 & np.isnan(st.decode_done))
            assert not bad.size, \
                f"request {bad[0] if bad.size else -1} stream never finished"
            n_dead = int((rej & (st.drop_code > 1)).sum())
        else:
            for r in self.records:
                if r.rejected:
                    assert r.deployment is None and r.drop_reason, \
                        f"request {r.index} dropped without a reason"
                else:
                    assert r.deployment is not None \
                        and r.timeline is not None, \
                        f"request {r.index} neither completed nor dropped"
                    if r.decode_tokens:
                        # a completed stream delivered EVERY token: no
                        # request may finish with its stream dangling
                        assert r.tokens_emitted == r.decode_tokens, \
                            (f"request {r.index} completed with "
                             f"{r.tokens_emitted}/{r.decode_tokens} tokens")
                        assert r.decode_tokens == 1 \
                            or r.decode_done is not None, \
                            f"request {r.index} stream never finished"
            n_dead = sum(1 for r in self.records if r.dead_lettered)
        assert n_dead == len(self.dead_letters), \
            f"{n_dead} dead-lettered records vs {len(self.dead_letters)} DLQ"

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        lat = self.latencies()
        tt = self.ttfts()
        st = self.store
        if st is not None:
            done_mask = ~st.rejected
            n_done = int(done_mask.sum())
            n = st.n
            n_rejected = int(st.rejected.sum())
            n_degraded = int((~np.isnan(st.degraded_to)).sum())
            queue_delays = self._stage_cols(done_mask)["server_wait"]
            total_payload = float(sum(
                st.payload_bits[done_mask].tolist()))
            max_depth = int(self.queue_samples[:, 1].max()) \
                if len(self.queue_samples) else 0
        else:
            done = self.completed()
            n_done = len(done)
            n = len(self.records)
            n_rejected = sum(r.rejected for r in self.records)
            n_degraded = sum(r.degraded_to is not None
                             for r in self.records)
            queue_delays = [r.timeline.server_wait for r in done]
            total_payload = float(sum(
                r.deployment.payload_bits for r in done))
            max_depth = max((s[1] for s in self.queue_samples), default=0)
        out = {
            "requests": n,
            "completed": n_done,
            "rejected": n_rejected,
            "degraded": n_degraded,
            "dead_lettered": len(self.dead_letters),
            "retried": self.retried(),
            "disrupted": self.disrupted(),
            "drop_reasons": self.drop_reasons(),
            "horizon_s": round(self.horizon, 6),
            "throughput_rps": round(n_done / self.horizon, 3)
            if self.horizon > 0 else 0.0,
            "goodput_rps": round(self.goodput_rps(), 3),
            "p50_latency_s": round(float(np.percentile(lat, 50)), 6)
            if len(lat) else None,
            "p99_latency_s": round(float(np.percentile(lat, 99)), 6)
            if len(lat) else None,
            "mean_latency_s": round(float(lat.mean()), 6)
            if len(lat) else None,
            "deadline_miss_rate": self.deadline_miss_rate(),
            "mean_queue_delay_s": round(float(np.mean(queue_delays)), 6)
            if len(queue_delays) else None,
            "tokens_per_s": round(self.tokens_per_s(), 3),
            "ttft_p50": round(float(np.percentile(tt, 50)), 6)
            if len(tt) else None,
            "ttft_p99": round(float(np.percentile(tt, 99)), 6)
            if len(tt) else None,
            "mean_queue_depth": round(self.mean_queue_depth(), 3),
            "max_queue_depth": max_depth,
            "server_utilization": [round(u, 4) for u in self.utilization()],
            "total_payload_bits": total_payload,
            "mean_stage_s": {k: round(v, 6)
                             for k, v in self.mean_stage_seconds().items()},
        }
        miss = out["deadline_miss_rate"]
        if miss is not None:
            out["deadline_miss_rate"] = round(miss, 4)
        return out
