"""Replayable event journal of a fleet-engine run (DESIGN.md §10).

``FleetEngine.run`` appends one ``JournalEntry`` per event it PROCESSES
— in processing order, with the outcome facts the handler decided
(admitted indices, stale-completion flags, whether a cache install
applied) — plus a header naming the engine configuration. Because the
engine is a deterministic DES, the journal is a total account of a run:

  * ``replay(qs, requests)`` re-executes the run from scratch — the
    fault schedule is reconstructed FROM the journal's fault entries and
    the engine config from its header — and returns the fresh metrics;
    ``verify_replay`` additionally asserts the replayed journal is
    entry-for-entry identical (the determinism check the chaos tests
    lean on).
  * ``to_jsonl``/``from_jsonl`` give the journal a stable on-disk form
    (one JSON object per line, header first) for offline debugging of a
    faulted run.

The journal records event *processing*, not queue pushes: a cancelled
attempt's COMPLETE still pops and is journaled as ``stale`` — replay
must reproduce even the non-events.

Journaling modes (``FleetEngine(journal=...)``, DESIGN.md §12): "full"
is this class — one entry with outcome facts per processed event, the
only mode ``replay``/``verify_replay`` work from. "light" is
``LightJournal`` — a columnar (time, kind) tape with per-kind counts
and none of the outcome kwargs, for cheap observability at scale.
"off" journals nothing: the engine holds no journal object at all, so
the per-event cost is one ``is not None`` test (a true no-op — locked
by a hypothesis property that terminal records are unchanged).
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

import numpy as np

from repro_torch.serving.engine.events import KIND_NAMES
from repro_torch.serving.engine.faults import FaultEvent, FaultInjector

JOURNAL_MODES = ("full", "light", "off")


@dataclasses.dataclass(frozen=True)
class JournalEntry:
    """One processed event: (seq, time, kind, outcome data)."""
    seq: int
    time: float
    kind: str                      # KIND_NAMES value
    data: tuple                    # sorted (key, value) outcome facts

    def to_dict(self) -> dict:
        return {"seq": self.seq, "time": self.time, "kind": self.kind,
                **dict(self.data)}


class EventJournal:
    """Ordered record of every event a ``FleetEngine.run`` processed."""

    def __init__(self, header: Optional[dict] = None):
        self.header: dict = dict(header or {})
        self.entries: List[JournalEntry] = []

    # -- recording (engine-side) ---------------------------------------
    def record(self, time: float, kind: int, **data) -> None:
        self.entries.append(JournalEntry(
            len(self.entries), float(time), KIND_NAMES[kind],
            tuple(sorted(data.items()))))

    def __len__(self) -> int:
        return len(self.entries)

    def __eq__(self, other) -> bool:
        return (isinstance(other, EventJournal)
                and self.header == other.header
                and self.entries == other.entries)

    def diff(self, other: "EventJournal") -> Optional[str]:
        """First divergence between two journals, human-readable; None
        when identical."""
        if self.header != other.header:
            return f"headers differ: {self.header} != {other.header}"
        for a, b in zip(self.entries, other.entries):
            if a != b:
                return f"entry {a.seq}: {a.to_dict()} != {b.to_dict()}"
        if len(self.entries) != len(other.entries):
            return (f"lengths differ: {len(self.entries)} != "
                    f"{len(other.entries)}")
        return None

    # -- fault-schedule reconstruction ---------------------------------
    def fault_trace(self) -> List[FaultEvent]:
        """The run's fault schedule, reconstructed from the journaled
        FAULT entries (what ``replay`` injects)."""
        out = []
        for e in self.entries:
            if e.kind == "fault":
                d = dict(e.data)
                out.append(FaultEvent(e.time, d["fault"], d["device"],
                                      float(d.get("factor", 1.0))))
        return out

    # -- replay --------------------------------------------------------
    def replay(self, qs, requests, servers=None, provider=None):
        """Re-execute the journaled run: fresh engine, same config (from
        the header), same requests, fault schedule reconstructed from
        the journal. Returns the replayed ``FleetMetrics`` (carrying its
        own journal)."""
        from repro_torch.serving.engine.fleet import FleetEngine
        from repro_torch.serving.engine.retry import RetryPolicy
        h = self.header
        retry = RetryPolicy(**h["retry"]) if h.get("retry") else None
        eng = FleetEngine(qs, servers=servers, policy=h.get("policy", "fcfs"),
                          slo=h.get("slo", "observe"),
                          epoch_interval=h.get("epoch_interval", 0.0),
                          provider=provider,
                          retry=retry,
                          faults=FaultInjector(self.fault_trace()),
                          # serving-shape knobs (DESIGN.md §14): absent
                          # from zero-knob headers, so their defaults —
                          # and the header the replayed engine builds —
                          # stay bit-identical to a knob-free run's
                          draft_tokens=h.get("draft_tokens", 0),
                          accept_rate=h.get("accept_rate"),
                          prefill_chunk_tokens=h.get("prefill_chunk_tokens"))
        return eng.run(requests)

    def verify_replay(self, qs, requests, servers=None, provider=None):
        """Replay and assert the journals match entry-for-entry; returns
        the replayed metrics. Raises ``AssertionError`` naming the first
        divergence — the determinism contract of DESIGN.md §10."""
        metrics = self.replay(qs, requests, servers=servers,
                              provider=provider)
        delta = self.diff(metrics.journal)
        assert delta is None, f"journal replay diverged: {delta}"
        return metrics

    # -- serialization -------------------------------------------------
    def to_jsonl(self) -> str:
        lines = [json.dumps({"header": self.header}, sort_keys=True)]
        lines += [json.dumps(e.to_dict(), sort_keys=True)
                  for e in self.entries]
        return "\n".join(lines) + "\n"

    @classmethod
    def from_jsonl(cls, text: str) -> "EventJournal":
        lines = [ln for ln in text.splitlines() if ln.strip()]
        jr = cls(json.loads(lines[0])["header"])
        for ln in lines[1:]:
            d = json.loads(ln)
            seq, time, kind = d.pop("seq"), d.pop("time"), d.pop("kind")
            jr.entries.append(JournalEntry(seq, time, kind,
                                           tuple(sorted(d.items()))))
        return jr


class LightJournal:
    """Columnar journal: the (time, kind) tape of every processed event
    in two doubling NumPy buffers, outcome kwargs discarded at the call
    site. Same event COUNT and ORDER as the full journal on the same
    run (asserted in tests/test_fleet_scale.py), none of the per-entry
    tuple/dict cost — the scale-sweep observability tier."""

    def __init__(self, header: Optional[dict] = None, capacity: int = 1024):
        self.header: dict = dict(header or {})
        self._times = np.empty(max(int(capacity), 16), dtype=np.float64)
        self._kinds = np.empty(self._times.shape[0], dtype=np.int8)
        self._len = 0

    def record(self, time: float, kind: int, **data) -> None:
        i = self._len
        if i == self._times.shape[0]:
            self._times = np.concatenate(
                [self._times, np.empty_like(self._times)])
            self._kinds = np.concatenate(
                [self._kinds, np.empty_like(self._kinds)])
        self._times[i] = time
        self._kinds[i] = kind
        self._len = i + 1

    def __len__(self) -> int:
        return self._len

    @property
    def times(self) -> np.ndarray:
        return self._times[:self._len]

    @property
    def kinds(self) -> np.ndarray:
        return self._kinds[:self._len]

    def counts(self) -> dict:
        """Processed-event counts by kind name (only kinds that fired)."""
        kinds, counts = np.unique(self.kinds, return_counts=True)
        return {KIND_NAMES[int(k)]: int(c)
                for k, c in zip(kinds, counts)}
