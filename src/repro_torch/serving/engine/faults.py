"""Fault injection for the fleet engine (DESIGN.md §10).

A ``FaultInjector`` carries a seeded, time-sorted schedule of
``FaultEvent``s that the engine merges into its event queue at ``run()``
— faults are ordinary DES events (kind FAULT, first at equal times), so
a faulted run is exactly as deterministic and replayable as a sunny-day
one. Three fault kinds:

  DISCONNECT — the device drops off the radio. Every in-flight attempt
               of that device still in its ship/device/transfer stage is
               CANCELLED: the server reservation is released, a pending
               CACHE_INSTALL is invalidated, and the request goes to the
               engine's ``RetryPolicy``. Attempts already past
               ``transfer_done`` (cut activation reached the server)
               complete normally. New arrivals from a disconnected
               device are PARKED (no attempt burned) until reconnect.
  RECONNECT  — the device is back; parked requests rejoin the pending
               set at the next decision epoch.
  DEGRADE    — the device's effective channel capacity is multiplied by
               ``factor`` (< 1 degrades, 1.0 restores) for every LATER
               admission. In-flight timelines are reservations and never
               re-priced mid-stage — the drift shows up at the next
               (re-)admission, which is also where replanning would see
               it.

Trace generators (``churn_trace``, ``degrade_trace``) build seeded
renewal-process schedules over a device pool; both compose by
concatenation (``FaultInjector(a.events + b.events)`` or ``a + b``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.serving.errors import FaultConfigError

DISCONNECT = "disconnect"
RECONNECT = "reconnect"
DEGRADE = "degrade"
FAULT_KINDS = (DISCONNECT, RECONNECT, DEGRADE)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: ``kind`` applied to ``device_id`` at
    ``time``. ``factor`` is the channel-capacity multiplier (DEGRADE
    only; 1.0 restores the nominal channel)."""
    time: float
    kind: str                      # disconnect | reconnect | degrade
    device_id: str
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise FaultConfigError(
                f"unknown fault kind {self.kind!r}; known: {FAULT_KINDS}")
        if not self.time >= 0:
            raise FaultConfigError(
                f"fault time must be >= 0, got {self.time}")
        if self.kind == DEGRADE and not self.factor > 0:
            raise FaultConfigError(
                f"degrade factor must be > 0, got {self.factor}")

    def to_dict(self) -> dict:
        return {"time": self.time, "kind": self.kind,
                "device": self.device_id, "factor": self.factor}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        return cls(float(d["time"]), d["kind"], d["device"],
                   float(d.get("factor", 1.0)))


class FaultInjector:
    """A time-sorted fault schedule the engine drains each ``run()``.
    Stateless between runs (the engine owns all fault *state*); two
    injectors compose with ``+``."""

    def __init__(self, events: Iterable[FaultEvent] = ()):
        self.events: List[FaultEvent] = sorted(
            events, key=lambda e: (e.time, e.kind, e.device_id))

    def __len__(self) -> int:
        return len(self.events)

    def __add__(self, other: "FaultInjector") -> "FaultInjector":
        return FaultInjector(self.events + other.events)


def churn_trace(device_ids: Sequence[str], horizon: float,
                mean_uptime: float, mean_downtime: float,
                seed: int = 0,
                first_down: Optional[float] = None) -> FaultInjector:
    """Seeded device churn: each device alternates up/down with
    exponential dwell times (a renewal process — disconnects and
    reconnects always pair up, and a final disconnect without a
    reconnect inside ``horizon`` models a device that never comes
    back)."""
    if mean_uptime <= 0 or mean_downtime <= 0:
        raise FaultConfigError("churn dwell times must be > 0")
    rng = np.random.default_rng(seed)
    events = []
    for dev in device_ids:
        t = float(rng.exponential(mean_uptime)) if first_down is None \
            else first_down
        while t < horizon:
            events.append(FaultEvent(t, DISCONNECT, dev))
            t += float(rng.exponential(mean_downtime))
            if t >= horizon:
                break               # never reconnects inside the horizon
            events.append(FaultEvent(t, RECONNECT, dev))
            t += float(rng.exponential(mean_uptime))
    return FaultInjector(events)


def degrade_trace(device_ids: Sequence[str], horizon: float,
                  mean_interval: float, mean_duration: float,
                  factor_range=(0.1, 0.5), seed: int = 0) -> FaultInjector:
    """Seeded channel-quality drift: per device, capacity-degradation
    episodes (capacity × U[factor_range]) arrive as a Poisson process
    and restore (factor 1.0) after an exponential duration."""
    if mean_interval <= 0 or mean_duration <= 0:
        raise FaultConfigError("degrade interval/duration must be > 0")
    lo, hi = factor_range
    if not (0 < lo <= hi):
        raise FaultConfigError(f"bad factor_range {factor_range}")
    rng = np.random.default_rng(seed)
    events = []
    for dev in device_ids:
        t = float(rng.exponential(mean_interval))
        while t < horizon:
            events.append(FaultEvent(t, DEGRADE, dev,
                                     float(rng.uniform(lo, hi))))
            t += float(rng.exponential(mean_duration))
            if t >= horizon:
                break
            events.append(FaultEvent(t, DEGRADE, dev, 1.0))
            t += float(rng.exponential(mean_interval))
    return FaultInjector(events)
