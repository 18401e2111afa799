"""Event taxonomy + queue of the fleet serving engine (DESIGN.md §8/§10).

The engine is a discrete-event simulator over a continuous clock. Seven
event kinds, processed in (time, kind, seq) order so simultaneous events
resolve deterministically:

  FAULT          — a ``FaultEvent`` (engine/faults.py) fires: device
                   disconnect/reconnect or channel degradation. First at
                   equal times, so an arrival / epoch / cache install at
                   the same instant already sees the new world.
  ARRIVAL        — a timestamped ``InferenceRequest`` enters the system
                   and joins the pending set.
  RETRY          — a fault-cancelled request's backoff expired; it
                   rejoins the pending set (engine/retry.py). Before
                   EPOCH at equal times so the epoch's window sees it.
  CACHE_INSTALL  — a model shipment finished downlinking: the device's
                   segment cache now holds (model, level, p). Ordered
                   before EPOCH at equal times so a repeat request
                   admitted at the same instant already sees the cache.
  EPOCH          — a decision epoch: every pending request is priced as
                   one ``price_window`` matrix and admitted under the
                   engine's ``AdmissionPolicy`` (policies.py).
  COMPLETE       — a request's last stage finished; bookkeeping only
                   (queue-depth sample, horizon). Carries the admission
                   token: a cancelled attempt's COMPLETE is stale and
                   skipped.
  DECODE_STEP    — a server's continuous-batching decode lane can start
                   its next round (serving/decode/batching.py): every
                   live stream whose next token input has arrived joins,
                   the round is priced once for the whole batch. Stale
                   events (the batcher state changed since queueing) are
                   detected by re-deriving the round time at fire time.
                   With speculation on, one round verifies k drafts and
                   emits 1..k+1 tokens per stream (DESIGN.md §14).
  PREFILL_CHUNK  — one page-aligned chunk of an admitted stream's prompt
                   lands on the server's decode lane (DESIGN.md §14):
                   the chunk's server work shares the batcher's
                   ``busy_until`` timeline with decode rounds, so long
                   prompts interleave with live streams instead of
                   head-of-line-blocking them. The final chunk starts
                   the stream (TTFT).

Admission computes the whole per-request stage timeline analytically
(``StageTimeline``): plan → uplink (model shipment) → device segment →
cut-activation transfer → server segment → complete. Servers reserve
work in admission order, so a timeline never changes after admission —
the ONLY thing that can undo a reservation is a fault cancelling the
attempt (the reservation is released, never moved; DESIGN.md §10).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools

import numpy as np

FAULT = 0
ARRIVAL = 1
RETRY = 2
CACHE_INSTALL = 3
EPOCH = 4
COMPLETE = 5
DECODE_STEP = 6
PREFILL_CHUNK = 7

KIND_NAMES = {FAULT: "fault", ARRIVAL: "arrival", RETRY: "retry",
              CACHE_INSTALL: "cache_install", EPOCH: "epoch",
              COMPLETE: "complete", DECODE_STEP: "decode_step",
              PREFILL_CHUNK: "prefill_chunk"}


@dataclasses.dataclass(frozen=True)
class Event:
    """Descriptive form of one event — kept for callers and tests that
    build events by name; the engine's hot loop moves plain
    ``(time, kind, payload)`` tuples through ``EventQueue`` instead (no
    per-event object at 10⁶ scale)."""
    time: float
    kind: int                     # ARRIVAL | CACHE_INSTALL | EPOCH | COMPLETE
    payload: object = None        # kind-specific (request index, cache key…)


class EventQueue:
    """Min-heap of bare ``(time, kind, seq, payload)`` tuples ordered by
    (time, kind, insertion seq) — same total order as the historical
    Event-object heap, minus the dataclass allocation per push."""

    __slots__ = ("_heap", "_seq")

    def __init__(self):
        self._heap = []
        self._seq = itertools.count()

    def push(self, time: float, kind: int, payload=None) -> None:
        heapq.heappush(self._heap, (time, kind, next(self._seq), payload))

    def push_event(self, ev: Event) -> None:
        self.push(ev.time, ev.kind, ev.payload)

    def pop(self) -> tuple:
        """-> (time, kind, payload) of the earliest event."""
        t, kind, _, payload = heapq.heappop(self._heap)
        return t, kind, payload

    def peek_key(self):
        """(time, kind) of the head event, or None when empty — what the
        engine's sorted-arrival cursor merges against."""
        if not self._heap:
            return None
        head = self._heap[0]
        return head[0], head[1]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


class ArrivalStream:
    """Bulk-loaded arrival cursor: ONE stable argsort over the trace's
    arrival times replaces 10⁶ individual ``heappush``es. The engine
    merges the cursor against the heap lexicographically on
    (time, kind): an arrival fires strictly before any same-time heap
    event of a later kind, and after FAULT (kind 0) at the same instant
    — exactly the order the old all-in-one heap produced, because no
    ARRIVAL ever lived alongside another ARRIVAL in the heap (stable
    sort preserves trace order for ties, matching insertion seq)."""

    __slots__ = ("times", "order", "pos", "n")

    def __init__(self, times):
        t = np.asarray(times, dtype=np.float64)
        self.order = np.argsort(t, kind="stable")
        self.times = t[self.order]
        self.pos = 0
        self.n = int(t.shape[0])

    def __len__(self) -> int:
        return self.n - self.pos

    def pop(self) -> tuple:
        """-> (arrival time, trace index) of the next arrival."""
        i = self.pos
        self.pos = i + 1
        return float(self.times[i]), int(self.order[i])


@dataclasses.dataclass
class StageTimeline:
    """Wall-clock stage boundaries of one admitted request. Durations are
    priced by the same cost model as the objective (core.cost_model); the
    server stage starts when BOTH the cut activation has arrived and the
    server's previously reserved work has drained."""
    admit: float                  # decision-epoch time
    ship_done: float              # model shipment (weight bits) downlinked
    device_done: float            # device segment computed
    transfer_done: float          # cut activation uplinked
    server_start: float           # server segment starts (>= transfer_done)
    finish: float                 # server segment done — request complete

    @property
    def server_wait(self) -> float:
        """Actual seconds the cut activation sat in the server queue."""
        return self.server_start - self.transfer_done

    @property
    def stage_seconds(self) -> dict:
        """Per-stage durations — the timeline as the cost model priced
        it (provider stage times; CostModel v2 fidelity checks compare
        these against ``Deployment.execute``'s measured dict)."""
        return {"ship": self.ship_done - self.admit,
                "device": self.device_done - self.ship_done,
                "transfer": self.transfer_done - self.device_done,
                "server_wait": self.server_wait,
                "server": self.finish - self.server_start}

    def latency_from(self, arrival: float) -> float:
        return self.finish - arrival
