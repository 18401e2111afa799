"""Retry policy + dead-letter queue for fault-cancelled requests
(DESIGN.md §10).

When a fault cancels an in-flight attempt (engine/faults.py), the
engine hands the request to its ``RetryPolicy``: re-admission after a
capped exponential backoff, at most ``max_attempts`` total admissions
per request (``InferenceRequest.attempt_budget`` overrides per
request), optionally coarsening the accuracy budget one store level per
retry (``degrade_on_retry`` — the same degrade ladder SLO admission
walks). A request that exhausts its attempts — or is still parked on a
disconnected device when the trace drains — lands in the dead-letter
queue with a structured reason, so every request is terminally
accounted for: completed, rejected, or dead-lettered. Backoffs are
deterministic (no jitter): a faulted run replays bit-for-bit from its
journal.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.serving.errors import FaultConfigError

# structured terminal drop reasons (FleetRecord.drop_reason)
REASON_SLO = "slo_reject"                    # SLO admission rejected
REASON_EXHAUSTED = "retries_exhausted"       # fault-cancelled, budget spent
REASON_ABANDONED = "disconnect_abandoned"    # device never reconnected
DROP_REASONS = (REASON_SLO, REASON_EXHAUSTED, REASON_ABANDONED)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with a per-request attempt budget.

    ``max_attempts`` counts ADMISSIONS (first try included): 3 means
    one admission plus up to two retries. ``degrade_on_retry`` coarsens
    the accuracy budget one offline-store level per retry — the
    retry-with-degraded-budget ladder: a flaky device trades accuracy
    for a cheaper (smaller-payload, faster) plan instead of burning its
    remaining attempts on the same doomed shipment."""
    max_attempts: int = 3
    base_backoff_s: float = 0.05
    backoff_factor: float = 2.0
    max_backoff_s: float = 1.0
    degrade_on_retry: bool = False

    def __post_init__(self):
        if self.max_attempts < 1:
            raise FaultConfigError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.base_backoff_s < 0 or self.max_backoff_s < 0:
            raise FaultConfigError("backoffs must be >= 0")
        if self.backoff_factor < 1.0:
            raise FaultConfigError(
                f"backoff_factor must be >= 1, got {self.backoff_factor}")

    def backoff(self, attempt: int) -> float:
        """Seconds to wait before admission attempt ``attempt`` (>= 2):
        base · factor^(attempt − 2), capped."""
        return min(self.base_backoff_s
                   * self.backoff_factor ** max(attempt - 2, 0),
                   self.max_backoff_s)

    def budget_for(self, request) -> int:
        """The request's attempt budget (its own override, else the
        policy default)."""
        budget = getattr(request, "attempt_budget", None)
        return self.max_attempts if budget is None else int(budget)


@dataclasses.dataclass(frozen=True)
class DeadLetter:
    """One terminally failed request: why, when, and after how many
    admission attempts (`reason` is a ``DROP_REASONS`` constant)."""
    index: int                     # trace position of the request
    reason: str
    time: float                    # when the request became terminal
    attempts: int                  # admissions consumed (0 = never admitted)
    device_id: Optional[str] = None

    def to_dict(self) -> dict:
        return {"index": self.index, "reason": self.reason,
                "time": self.time, "attempts": self.attempts,
                "device": self.device_id}
