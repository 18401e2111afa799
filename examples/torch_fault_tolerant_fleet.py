"""Fault-tolerant fleet serving (serving.engine resilience layer,
DESIGN.md §10): bursty MMPP arrivals over a 3-server fleet while devices
churn — disconnects cancel in-flight attempts (server reservations
released, pending cache installs invalidated), a RetryPolicy re-admits
with capped backoff and a degraded accuracy budget, requests whose
device never returns drain to the dead-letter queue, and the whole run
replays bit-for-bit from its event journal.

The QPART server is stub-calibrated (synthetic noise constants, real
Alg. 1 pattern store): the fault dynamics exercise the pricing/queueing
path only, so the demo needs no training and runs in seconds.

The PyTorch port's twin of ``examples/fault_tolerant_fleet.py``: the
same steps on ``repro_torch``'s engine, whose stdout equals the
reference's byte for byte. The fleet path is NumPy on the host and
launches no kernel, so ``--device`` (taken, as every example takes it)
changes nothing here.

  PYTHONPATH=src python examples/torch_fault_tolerant_fleet.py
"""
import argparse

import numpy as np

from repro_torch.configs.classifier import MNIST_MLP
from repro_torch.core.cost_model import (Channel, DeviceProfile,
                                         ObjectiveWeights, ServerProfile)
from repro_torch.serving.engine import (DISCONNECT, RECONNECT, FaultEvent,
                                        FaultInjector, FleetEngine,
                                        RetryPolicy, churn_trace,
                                        degrade_trace, materialize,
                                        mmpp_arrivals)
from repro_torch.serving.qpart_server import QPARTServer
from repro_torch.serving.testing import stub_classifier_server

W = ObjectiveWeights()
FLEET = [ServerProfile(f_clock=3e8)] * 3
DEVICES = [DeviceProfile(f_clock=f) for f in (4e8, 1e9, 2e9)]
CHANNELS = [Channel(capacity_bps=c) for c in (2e6, 1e7, 5e7)]
POOL = 60                       # repeat-requester population


def stub_server() -> QPARTServer:
    return stub_classifier_server([("mnist", MNIST_MLP)], server=FLEET[0],
                                  device=DEVICES[0], channel=CHANNELS[1],
                                  weights=W)


def make_trace(n=500, seed=0):
    # bursty arrivals: calm 200 rps, bursts of 1400 rps
    arrivals = mmpp_arrivals(n, rates=(200.0, 1400.0),
                             mean_dwell=(0.4, 0.1), seed=seed)
    return materialize("mnist", arrivals, DEVICES, CHANNELS, W,
                       budgets=(0.004, 0.01, 0.02),
                       deadlines=(0.020, 0.035, 0.060),
                       batches=(1, 1, 4), device_pool=POOL, seed=seed)


def make_faults(horizon, seed=0):
    """Churn a third of the pool, drift another third, and kill two
    devices mid-trace (they never reconnect)."""
    flappy = [f"dev-{i}" for i in range(0, POOL, 3)]
    drifty = [f"dev-{i}" for i in range(1, POOL, 3)]
    deaths = FaultInjector([FaultEvent(horizon * 0.4, DISCONNECT, "dev-2"),
                            FaultEvent(horizon * 0.6, DISCONNECT, "dev-5")])
    return (churn_trace(flappy, horizon, mean_uptime=0.3,
                        mean_downtime=0.1, seed=seed)
            + degrade_trace(drifty, horizon, mean_interval=0.8,
                            mean_duration=0.2, seed=seed + 1)
            + deaths)


def main(argv=None) -> dict:
    """Runs the demo; returns the fault-free and chaos runs' key numbers
    and the journal's length."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.parse_args(argv)
    srv = stub_server()
    trace = make_trace()
    horizon = trace[-1].arrival_time + 0.5
    faults = make_faults(horizon)
    retry = RetryPolicy(max_attempts=3, base_backoff_s=0.01,
                        max_backoff_s=0.1, degrade_on_retry=True)
    print(f"{len(trace)} MMPP arrivals over {trace[-1].arrival_time:.2f} s, "
          f"{len(FLEET)} servers, {len(faults)} ambient fault events "
          f"(churn + channel drift + 2 permanent losses)\n")

    # fault-free baseline vs the same trace under chaos
    base_m = FleetEngine(srv, servers=FLEET, policy="edf", slo="degrade",
                         epoch_interval=0.005).run(trace)
    base = base_m.summary()
    # aim a few micro-outages mid-window at the baseline's longest radio
    # transfers: random churn almost never intersects millisecond
    # transfers, targeted cuts make the cancel -> retry path visible
    longest = sorted((r for r in base_m.completed() if r.request.device_id),
                     key=lambda r: r.timeline.transfer_done
                     - r.timeline.admit, reverse=True)
    cuts = []
    for r in longest[:25]:
        t = (r.timeline.admit + r.timeline.transfer_done) / 2
        cuts += [FaultEvent(t, DISCONNECT, r.request.device_id),
                 FaultEvent(t + 0.02, RECONNECT, r.request.device_id)]
    faults = faults + FaultInjector(cuts)
    eng = FleetEngine(srv, servers=FLEET, policy="edf", slo="degrade",
                      epoch_interval=0.005, retry=retry, faults=faults)
    m = eng.run(trace)
    m.assert_terminal()             # every request completed or dropped
    s = m.summary()

    print(f"{'':>22} {'fault-free':>10} {'chaos':>10}")
    for key in ("goodput_rps", "p99_latency_s", "deadline_miss_rate",
                "rejected", "degraded"):
        print(f"{key:>22} {base[key]:>10} {s[key]:>10}")
    print(f"\n  disrupted by faults : {s['disrupted']} "
          f"(cancelled in flight or parked on a down device)")
    print(f"  retried             : {s['retried']}")
    print(f"  dead-lettered       : {s['dead_lettered']}")
    print(f"  drop reasons        : {s['drop_reasons']}")
    for d in m.dead_letters[:3]:
        print(f"    index={d.index:4d} device={d.device_id:<8} "
              f"reason={d.reason} after {d.attempts} attempt(s)")

    # the determinism contract: the run's journal replays to an
    # identical journal (same engine config, fault schedule rebuilt
    # from the journaled FAULT entries)
    m.journal.verify_replay(srv, trace, servers=FLEET)
    print(f"\njournal: {len(m.journal.entries)} entries, "
          f"replay verified identical")
    assert s["completed"] + s["rejected"] == len(trace)
    assert np.isclose(sum(s["drop_reasons"].values()), s["rejected"])
    keys = ("goodput_rps", "p99_latency_s", "deadline_miss_rate",
            "rejected", "degraded", "disrupted", "retried", "dead_lettered")
    return {"fault_free": {k: base[k] for k in keys},
            "chaos": {k: s[k] for k in keys},
            "journal_entries": len(m.journal.entries)}


if __name__ == "__main__":
    main()
