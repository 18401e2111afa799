"""Continuous batching state for the fleet engine's decode lane.

Each fleet server owns one ``DecodeBatcher``: the set of live decode
streams whose tail segment it hosts. The engine advances the batcher in
ROUNDS — at each DECODE_STEP event every stream whose next token input
has arrived (``ready_at <= t``) joins the round, and the round's server
time is priced ONCE for the whole batch:

    round_s = provider.server_seconds(profile, sum_i o2_tok_i,
                                      max_i srv_bytes_tok_i)

MAC terms add across streams; the weight-stream byte term does NOT —
the tail weights are read once per round regardless of how many streams
share it. Streams that finish a round re-arm at ``round_end +
step_lag`` (their device-segment + wire round trip); new streams join
whenever their prefill pipeline delivers the first decode input.

Pure Python, a copy of the reference's. ``due``/``next_time`` are
heap-backed: entries are keyed on ``ready_at`` with lazy invalidation
(a per-stream version stamp — a re-arm or removal strands the old
entry, skipped when it surfaces), so both are O(log n) amortized.
``due`` returns joiners in ADMISSION order and ``next_time`` is
``max(busy_until, min ready_at)`` over live streams.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class DecodeStream:
    """One live decode stream at a server's tail segment."""
    index: int                # FleetRecord index
    token: tuple              # (index, attempt) liveness token
    device_id: Optional[str]
    remaining: int            # tokens still to emit
    ready_at: float           # when the next step's input is at the server
    o2_tok: float             # server MACs per decode step
    srv_bytes_tok: float      # server tail bytes per decode step
    step_lag: float           # device step + wire seconds per round trip
    # speculative decode — defaults keep the plain
    # one-token-per-round stream bit-for-bit
    draft_k: int = 0          # drafts verified per round (0 = plain)
    alpha: float = 0.0        # expected draft acceptance rate
    rounds_done: int = 0      # rounds this stream completed (the
                              # deterministic acceptance accumulator's j)


@dataclasses.dataclass
class DecodeBatcher:
    """Per-server continuous-batching state (engine-owned)."""
    streams: Dict[int, DecodeStream] = dataclasses.field(default_factory=dict)
    busy_until: float = 0.0          # current round's end time
    # heap of (ready_at, admission_seq, index, version); an entry is live
    # iff its index is registered AND its version matches the stream's
    # current stamp — re-arms/removals bump the stamp, stranding old
    # entries for lazy removal when they reach the top.
    _heap: List[Tuple[float, int, int, int]] = \
        dataclasses.field(default_factory=list)
    _seq: Dict[int, int] = dataclasses.field(default_factory=dict)
    _version: Dict[int, int] = dataclasses.field(default_factory=dict)
    _next_seq: int = 0

    def _push(self, index: int) -> None:
        heapq.heappush(self._heap, (self.streams[index].ready_at,
                                    self._seq[index], index,
                                    self._version[index]))

    def _live_entry(self, entry) -> bool:
        _, seq, index, version = entry
        return (index in self.streams and self._seq.get(index) == seq
                and self._version.get(index) == version)

    def add(self, stream: DecodeStream) -> None:
        if stream.index not in self._seq:
            # admission order survives re-arms; a removed-then-readmitted
            # stream re-enters at the back (dict-insertion semantics)
            self._seq[stream.index] = self._next_seq
            self._next_seq += 1
        self.streams[stream.index] = stream
        self._version[stream.index] = self._version.get(stream.index, 0) + 1
        self._push(stream.index)

    def remove(self, index: int) -> Optional[DecodeStream]:
        stream = self.streams.pop(index, None)
        if stream is not None:
            self._version[index] += 1         # strand heap entries
            self._seq.pop(index, None)
        return stream

    def rearm(self, index: int, ready_at: float) -> None:
        """Move stream ``index``'s next-step time (round finished: its
        device/wire round trip lands at ``ready_at``). O(log n)."""
        stream = self.streams.get(index)
        if stream is None:
            return
        stream.ready_at = float(ready_at)
        self._version[index] += 1
        self._push(index)

    def due(self, t: float) -> List[DecodeStream]:
        """Streams joining a round started at ``t``, in admission order
        (deterministic). Non-destructive: joiners stay armed until the
        engine re-arms or removes them."""
        popped = []
        while self._heap and self._heap[0][0] <= t:
            entry = heapq.heappop(self._heap)
            if self._live_entry(entry):
                popped.append(entry)
        for entry in popped:                  # still armed at ready_at
            heapq.heappush(self._heap, entry)
        return [self.streams[e[2]] for e in sorted(popped,
                                                   key=lambda e: e[1])]

    def next_time(self) -> Optional[float]:
        """Earliest time the next round can start: every state change
        (stream added/removed/re-armed, round finished) re-derives this
        and the engine queues a DECODE_STEP there; stale queued events
        are detected by re-deriving at fire time."""
        while self._heap:
            if not self._live_entry(self._heap[0]):
                heapq.heappop(self._heap)     # permanent lazy cleanup
                continue
            return max(self.busy_until, self._heap[0][0])
        return None
