"""Columnar record core of the fleet engine (DESIGN.md §12).

At 10⁶ requests, one ``FleetRecord`` dataclass per request is the
engine's dominant allocation cost and ``FleetMetrics``'s dominant
aggregation cost. ``RecordStore`` holds the SAME per-request facts as
preallocated NumPy columns: the engine's handlers write scalar slots
(cheap), ``FleetMetrics`` reduces whole columns (one vector op per
aggregate), and ``FleetRecord`` views are materialized lazily — only
for the records a caller actually touches — so the dataclass API stays
intact without 10⁶ up-front allocations.

Two record modes (``FleetEngine(records=...)``):

  "full"   — default. Also keeps the per-request ``Deployment`` object
             (plan + costs + lazily-built quantized device segment) in
             an object column: every ``FleetRecord`` field round-trips.
  "light"  — skips ``Deployment``/``ServingResult`` assembly entirely;
             stage boundaries are computed from the provider's
             ``device_seconds``/``server_seconds`` (identical floats to
             ``breakdown`` — locked in tests/test_fleet_scale.py), and
             materialized views carry ``deployment=None``. The mode for
             scale sweeps where nobody executes the plans.

The timeline lives as an (N, 6) float column block; NaN in the admit
slot means "no committed attempt" (never admitted, SLO-rejected, or the
last attempt was fault-cancelled) — exactly the states where the
dataclass engine kept ``timeline=None``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.serving.engine.retry import DROP_REASONS
from repro_torch.serving.simulator import InferenceRequest

# timeline column indices (StageTimeline field order)
TL_ADMIT, TL_SHIP, TL_DEVICE, TL_TRANSFER, TL_START, TL_FINISH = range(6)

# drop reasons as small ints (0 = not dropped); names in retry.py
DROP_CODES = {reason: k + 1 for k, reason in enumerate(DROP_REASONS)}
CODE_REASONS = {v: k for k, v in DROP_CODES.items()}


class RecordStore:
    """Preallocated per-request columns for one ``FleetEngine.run``."""

    def __init__(self, requests: Sequence[InferenceRequest],
                 full: bool = True):
        n = len(requests)
        self.n = n
        self.full = bool(full)
        self.requests = requests if isinstance(requests, list) \
            else list(requests)
        self.arrival = np.fromiter(
            (r.arrival_time for r in self.requests), np.float64, count=n)
        self.deadline = np.fromiter(
            (np.nan if r.deadline is None else r.deadline
             for r in self.requests), np.float64, count=n)
        self.server = np.full(n, -1, dtype=np.int64)
        self.start_order = np.full(n, -1, dtype=np.int64)
        self.backlog = np.zeros(n, dtype=np.float64)
        self.queue_delay = np.zeros(n, dtype=np.float64)
        self.degraded_to = np.full(n, np.nan, dtype=np.float64)
        self.rejected = np.zeros(n, dtype=bool)
        self.drop_code = np.zeros(n, dtype=np.int8)
        self.attempts = np.zeros(n, dtype=np.int32)
        self.faults = np.zeros(n, dtype=np.int32)
        self.parked = np.zeros(n, dtype=np.int32)
        self.decode_tokens = np.zeros(n, dtype=np.int64)
        self.tokens_emitted = np.zeros(n, dtype=np.int64)
        self.decode_done = np.full(n, np.nan, dtype=np.float64)
        self.payload_bits = np.full(n, np.nan, dtype=np.float64)
        self.tl = np.full((n, 6), np.nan, dtype=np.float64)
        self.deployments = np.full(n, None, dtype=object) if full else None

    # -- engine-side mutations -----------------------------------------
    def reset_attempt(self, i: int) -> None:
        """Void a fault-cancelled attempt's per-attempt fields (the
        dataclass engine nulled the same set); ``attempts``/``faults``/
        ``parked`` are per-request counters and survive."""
        if self.full:
            self.deployments[i] = None
        self.tl[i] = np.nan
        self.server[i] = -1
        self.start_order[i] = -1
        self.backlog[i] = 0.0
        self.queue_delay[i] = 0.0
        self.degraded_to[i] = np.nan
        self.decode_tokens[i] = 0
        self.tokens_emitted[i] = 0
        self.decode_done[i] = np.nan
        self.payload_bits[i] = np.nan

    # -- view materialization ------------------------------------------
    def materialize(self, i: int):
        """The classic ``FleetRecord`` dataclass view of row ``i``."""
        from repro_torch.serving.engine.events import StageTimeline
        from repro_torch.serving.engine.metrics import FleetRecord
        tl_row = self.tl[i]
        timeline = None if np.isnan(tl_row[TL_ADMIT]) \
            else StageTimeline(*(float(x) for x in tl_row))
        degraded = self.degraded_to[i]
        decode_done = self.decode_done[i]
        code = int(self.drop_code[i])
        return FleetRecord(
            index=i, request=self.requests[i],
            deployment=self.deployments[i] if self.full else None,
            timeline=timeline,
            server=int(self.server[i]),
            start_order=int(self.start_order[i]),
            backlog_at_admission=float(self.backlog[i]),
            queue_delay=float(self.queue_delay[i]),
            degraded_to=None if np.isnan(degraded) else float(degraded),
            rejected=bool(self.rejected[i]),
            drop_reason=CODE_REASONS.get(code),
            attempts=int(self.attempts[i]),
            faults=int(self.faults[i]),
            parked=int(self.parked[i]),
            decode_tokens=int(self.decode_tokens[i]),
            tokens_emitted=int(self.tokens_emitted[i]),
            decode_done=None if np.isnan(decode_done)
            else float(decode_done))


class LazyRecords:
    """Sequence facade over a ``RecordStore``: ``metrics.records[i]``
    materializes (and memoizes) dataclass views on demand, so touching a
    handful of records out of 10⁶ costs a handful of allocations."""

    __slots__ = ("_store", "_cache")

    def __init__(self, store: RecordStore):
        self._store = store
        self._cache = np.full(store.n, None, dtype=object)

    def __len__(self) -> int:
        return self._store.n

    def _one(self, i: int):
        if i < 0:
            i += self._store.n
        if not 0 <= i < self._store.n:
            raise IndexError(i)
        rec = self._cache[i]
        if rec is None:
            rec = self._store.materialize(i)
            self._cache[i] = rec
        return rec

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._one(k) for k in range(*i.indices(self._store.n))]
        return self._one(int(i))

    def __iter__(self):
        return (self._one(i) for i in range(self._store.n))
