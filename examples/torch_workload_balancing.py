"""Dynamic workload balancing (the paper title's second half): a window of
concurrent inference requests share one server; as the queue builds, the
re-priced Eq. 17 objective pushes later requests' partition points toward
their devices — no new math, just the paper's objective under load.

The port's twin of ``examples/workload_balancing.py``: the same steps,
sizes and printed lines. The weights start from a seeded
``torch.Generator`` (the reference's ``jax.random.key(0)`` has no
PyTorch counterpart). Plain PyTorch: it launches no kernel.

  PYTHONPATH=src python examples/torch_workload_balancing.py [--device cpu]
"""
import argparse
import dataclasses

import torch_mnist_mlp
from repro_torch.configs.classifier import MNIST_MLP
from repro_torch.core.cost_model import (Channel, DeviceProfile,
                                         ObjectiveWeights, ServerProfile)
from repro_torch.serving.backends import ClassifierBackend
from repro_torch.serving.qpart_server import QPARTServer
from repro_torch.serving.scheduler import WorkloadBalancer, total_latency
from repro_torch.serving.simulator import InferenceRequest


def balance(params, x_te, y_te, *, window: int = 48,
            mixed_window: int = 12) -> dict:
    """register -> calibrate -> build_store on a shared 1 GHz server, a
    FCFS window of ``window`` identical requests, then a heterogeneous
    window of ``mixed_window`` under FCFS and balanced."""
    # a 1 GHz shared server: strong enough that low-load requests offload
    # layers to it, weak enough that a 48-request backlog visibly moves
    # the Eq. 17 optimum toward the devices
    shared = ServerProfile(f_clock=1e9)
    srv = QPARTServer(shared)
    srv.register("mnist", ClassifierBackend(MNIST_MLP, params),
                 x_te[2048:3072], y_te[2048:3072])
    srv.calibrate("mnist")
    dev = DeviceProfile()
    ch = Channel(capacity_bps=2e6)
    w = ObjectiveWeights()
    srv.build_store("mnist", dev, ch, w)

    reqs = [InferenceRequest("mnist", 0.01, dev, ch, w, segment_cached=True)
            for _ in range(window)]
    bal = WorkloadBalancer(shared, policy="fcfs")
    results = bal.schedule(srv, reqs)
    print(f"\n{'req':>4} {'queue ms':>9} {'p':>2}  (identical requests; the "
          f"growing queue pushes work on-device)")
    last_p = None
    for i, r in enumerate(results):
        if r.result.plan.p != last_p or i in (0, len(results) - 1):
            print(f"{i:>4} {r.queue_delay*1e3:>8.2f} {r.result.plan.p:>2}")
            last_p = r.result.plan.p
    ps = [r.result.plan.p for r in results]
    assert ps[-1] > ps[0], "congestion should push partition points up"

    # heterogeneous window: balanced (SJF) vs FCFS
    strong = dataclasses.replace(dev, f_clock=2e9)
    mixed = [InferenceRequest("mnist", 0.01, strong if i % 2 else dev, ch, w,
                              segment_cached=True)
             for i in range(mixed_window)]
    t_f = total_latency(WorkloadBalancer(shared,
                                         policy="fcfs").schedule(srv, mixed))
    t_b = total_latency(WorkloadBalancer(shared,
                                         policy="balanced").schedule(srv, mixed))
    print(f"\nheterogeneous window of {mixed_window}: total latency "
          f"FCFS {t_f*1e3:.1f} ms vs balanced {t_b*1e3:.1f} ms "
          f"({100*(1 - t_b/t_f):.1f}% better)")
    return {"ps": ps, "queue_delays": [r.queue_delay for r in results],
            "fcfs_s": t_f, "balanced_s": t_b}


def main(argv=None) -> dict:
    """Runs the example; returns its key numbers."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("training + calibrating the MNIST classifier...")
    params, (x_te, y_te) = torch_mnist_mlp.train(device=args.device)
    out = balance(params, x_te, y_te)
    ps = out["ps"]
    return {"p_first": ps[0], "p_last": ps[-1],
            "p_moves_at": [i for i in range(1, len(ps)) if ps[i] != ps[i - 1]],
            "total_latency_fcfs_s": out["fcfs_s"],
            "total_latency_balanced_s": out["balanced_s"]}


if __name__ == "__main__":
    main()
