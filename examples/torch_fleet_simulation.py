"""Event-driven fleet serving (serving.engine, DESIGN.md §8): Poisson
arrivals over a 3-server fleet, deadline-aware admission, engine-managed
device segment caches, and the pluggable admission policies side by side.

The QPART server is stub-calibrated (synthetic noise constants, real
Alg. 1 pattern store): the fleet dynamics exercise the pricing/queueing
path only, so the demo needs no training and runs in seconds.

The PyTorch port's twin of ``examples/fleet_simulation.py``: the same
steps on ``repro_torch``'s engine, whose stdout equals the reference's
byte for byte. The fleet path is NumPy on the host and launches no
kernel, so ``--device`` (taken, as every example takes it) changes
nothing here.

  PYTHONPATH=src python examples/torch_fleet_simulation.py
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.configs.classifier import MNIST_MLP
from repro_torch.core.cost_model import (Channel, DeviceProfile,
                                         ObjectiveWeights, ServerProfile)
from repro_torch.serving.engine import FleetEngine
from repro_torch.serving.qpart_server import QPARTServer
from repro_torch.serving.simulator import InferenceRequest
from repro_torch.serving.testing import poisson_trace, stub_classifier_server

W = ObjectiveWeights()
FLEET = [ServerProfile(f_clock=3e8)] * 3
DEVICES = [DeviceProfile(f_clock=f) for f in (4e8, 1e9, 2e9)]
CHANNELS = [Channel(capacity_bps=c) for c in (2e6, 1e7, 5e7)]


def stub_server() -> QPARTServer:
    return stub_classifier_server([("mnist", MNIST_MLP)], server=FLEET[0],
                                  device=DEVICES[0], channel=CHANNELS[1],
                                  weights=W)


def make_trace(n=400, rate=700.0, seed=0):
    # mixed batch sizes: zero-load server demands differ, so balanced
    # (shortest-demand-first) really orders differently from fcfs
    return poisson_trace("mnist", n, rate, DEVICES, CHANNELS, W,
                         budgets=(0.004, 0.01, 0.02),
                         deadlines=(0.020, 0.035, 0.060),
                         batches=(1, 1, 4), device_pool=60, seed=seed)


def main(argv=None) -> dict:
    """Runs the demo; returns each policy's latencies, misses and
    rejections and the segment-cache visits' wire bits."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.parse_args(argv)
    srv = stub_server()
    trace = make_trace()
    print(f"{len(trace)} Poisson arrivals over {trace[-1].arrival_time:.2f} s "
          f"onto {len(FLEET)} servers (0.3 GHz each), 5 ms decision epochs\n")
    print(f"{'policy':>13} {'p50 ms':>7} {'p99 ms':>7} {'miss%':>6} "
          f"{'rej':>4} {'degr':>4} {'util':>5}")
    summaries = {}
    for policy in ("fcfs", "balanced", "edf", "least_loaded"):
        engine = srv.fleet(servers=FLEET, policy=policy, slo="degrade",
                           epoch_interval=0.005)
        m = engine.run(trace)
        s = m.summary()
        summaries[policy] = s
        print(f"{policy:>13} {s['p50_latency_s']*1e3:>7.2f} "
              f"{s['p99_latency_s']*1e3:>7.2f} "
              f"{100*s['deadline_miss_rate']:>6.1f} {s['rejected']:>4} "
              f"{s['degraded']:>4} "
              f"{np.mean(s['server_utilization']):>5.2f}")
    assert summaries["edf"]["deadline_miss_rate"] <= \
        summaries["fcfs"]["deadline_miss_rate"] + 0.05

    # segment-cache amortization: one device, three visits. The engine
    # ships the quantized segment once; later requests upload only the
    # cut activation (segment_cached decided by the ENGINE, not the
    # caller).
    dev = DEVICES[2]
    ch = Channel()                      # 200 Mbps: shipping the segment
    # is cheap enough that keeping layers on the device wins
    first = InferenceRequest("mnist", 0.01, dev, ch, W, device_id="alice")
    probe = FleetEngine(srv, servers=[ServerProfile(f_clock=1e7)])
    tl = probe.run([first]).records[0].timeline
    repeats = [dataclasses.replace(first, arrival_time=tl.ship_done + k)
               for k in (1.0, 2.0)]
    recs = FleetEngine(srv, servers=[ServerProfile(f_clock=1e7)]).run(
        [first] + repeats).records
    print("\nsegment cache (device 'alice', 10 MHz server so p > 0 wins):")
    for r in recs:
        dep = r.deployment
        kind = "activation-only" if dep.payload_bits == \
            dep.plan.payload_x_bits and dep.plan.p else "full shipment"
        print(f"  t={r.arrival:6.3f}s  p={dep.plan.p}  "
              f"wire={dep.payload_bits/1e3:8.1f} kbit  ({kind})")
    assert recs[1].deployment.payload_bits < recs[0].deployment.payload_bits
    keys = ("p50_latency_s", "p99_latency_s", "deadline_miss_rate",
            "rejected", "degraded")
    return {"policies": {k: {m: v[m] for m in keys}
                         for k, v in summaries.items()},
            "cache_wire_bits": [r.deployment.payload_bits for r in recs]}


if __name__ == "__main__":
    main()
