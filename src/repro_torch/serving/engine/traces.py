"""Arrival-trace generators beyond Poisson (DESIGN.md §10).

The fleet bench's Poisson trace (serving/testing.py) models memoryless
traffic; real edge fleets see BURSTS (flash crowds, synchronized
retries) and DIURNAL swings (day/night load). Two seeded generators
grow the realism, both returning plain arrival-time arrays plus a
``materialize`` helper that decorates them into full
``InferenceRequest`` traces with the same heterogeneous
device/channel/budget/deadline mixing the Poisson fixture uses:

  * ``mmpp_arrivals`` — a 2-state Markov-modulated Poisson process:
    the rate switches between a calm and a burst state with
    exponential dwell times. Burstiness stresses admission ordering
    and, under fault injection, piles retries onto already-congested
    epochs — the regime the chaos bench measures.
  * ``diurnal_arrivals`` — an inhomogeneous Poisson process with a
    sinusoidal rate profile, sampled by thinning (Lewis & Shedler):
    peak-hour load tests that the engine drains overnight what it
    queued at noon.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.cost_model import (Channel, DeviceProfile,
                                         ObjectiveWeights)
from repro_torch.serving.errors import FaultConfigError
from repro_torch.serving.simulator import InferenceRequest


def mmpp_arrivals(n: int, rates=(200.0, 1400.0),
                  mean_dwell=(0.5, 0.1), seed: int = 0) -> np.ndarray:
    """First ``n`` arrival times of a 2-state MMPP: Poisson at
    ``rates[s]`` while in state ``s``, states alternating with
    exponential ``mean_dwell[s]`` sojourns. State 0 is the calm state,
    state 1 the burst state."""
    if len(rates) != 2 or len(mean_dwell) != 2:
        raise FaultConfigError("mmpp takes exactly two (rate, dwell) states")
    if min(rates) <= 0 or min(mean_dwell) <= 0:
        raise FaultConfigError("mmpp rates and dwells must be > 0")
    rng = np.random.default_rng(seed)
    out = np.empty(n, np.float64)
    t, state, k = 0.0, 0, 0
    switch = float(rng.exponential(mean_dwell[0]))
    while k < n:
        t = t + float(rng.exponential(1.0 / rates[state]))
        while t >= switch:          # sojourn ended before this arrival:
            # re-draw the residual gap at the new state's rate
            # (memorylessness makes the residual another exponential)
            t = switch + float(rng.exponential(1.0 / rates[1 - state]))
            state = 1 - state
            switch = switch + float(rng.exponential(mean_dwell[state]))
        out[k] = t
        k += 1
    return out


def diurnal_arrivals(n: int, base_rate: float = 700.0,
                     amplitude: float = 0.8, period: float = 2.0,
                     seed: int = 0) -> np.ndarray:
    """First ``n`` arrivals of an inhomogeneous Poisson process with
    rate ``base_rate · (1 + amplitude·sin(2π t / period))``, sampled by
    thinning against the peak rate. ``period`` is the full day-night
    cycle in trace seconds (scaled down so tests/benches span cycles)."""
    if not 0 <= amplitude < 1:
        raise FaultConfigError(f"amplitude must be in [0, 1), got {amplitude}")
    if base_rate <= 0 or period <= 0:
        raise FaultConfigError("base_rate and period must be > 0")
    rng = np.random.default_rng(seed)
    lam_max = base_rate * (1.0 + amplitude)
    out = np.empty(n, np.float64)
    t, k = 0.0, 0
    while k < n:
        t = t + float(rng.exponential(1.0 / lam_max))
        rate = base_rate * (1.0 + amplitude * np.sin(2 * np.pi * t / period))
        if rng.uniform() * lam_max <= rate:
            out[k] = t
            k += 1
    return out


def materialize(model: str, arrivals: np.ndarray,
                devices: Sequence[DeviceProfile],
                channels: Sequence[Channel],
                weights: ObjectiveWeights,
                budgets: Sequence[float],
                deadlines: Optional[Sequence[float]] = None,
                batches: Sequence[int] = (1,),
                device_pool: int = 200, seed: int = 0) -> list:
    """Decorate raw arrival times into ``InferenceRequest``s with the
    same heterogeneous mixing as ``testing.poisson_trace``: per-request
    device/channel/budget/batch/deadline draws and a finite requester
    population (``device_pool`` distinct ``device_id``s) so segment
    caches — and fault injection, which targets device_ids — see repeat
    traffic."""
    rng = np.random.default_rng(seed)
    return [InferenceRequest(
        model, budgets[rng.integers(len(budgets))],
        devices[rng.integers(len(devices))],
        channels[rng.integers(len(channels))], weights,
        batch=int(batches[rng.integers(len(batches))]),
        arrival_time=float(t),
        deadline=float(deadlines[rng.integers(len(deadlines))])
        if deadlines else None,
        device_id=f"dev-{rng.integers(device_pool)}")
        for t in arrivals]
