"""Adaptive serving under changing conditions (the paper's core pitch):
the SAME model served to heterogeneous devices over fluctuating channels
picks different partition points and bit-widths per request.

Sweeps (channel capacity x device clock x accuracy budget) and prints the
plan QPART chooses for each — watch p move toward the device as the
channel degrades, and bits rise as the budget tightens.

The port's twin of ``examples/adaptive_serving.py``: the same steps,
sizes and printed lines. The weights start from a seeded
``torch.Generator`` (the reference's ``jax.random.key(0)`` has no
PyTorch counterpart). Plain PyTorch: it launches no kernel.

  PYTHONPATH=src python examples/torch_adaptive_serving.py [--device cpu]
"""
import argparse
import dataclasses

import numpy as np

import torch_mnist_mlp
from repro_torch.configs.classifier import MNIST_MLP
from repro_torch.core.cost_model import (Channel, DeviceProfile,
                                         ObjectiveWeights)
from repro_torch.core.quantizer import round_bits
from repro_torch.serving.backends import ClassifierBackend
from repro_torch.serving.qpart_server import QPARTServer
from repro_torch.serving.simulator import InferenceRequest


def scenarios():
    """(capacity, device clock, budget, cached) of the sweep, in order."""
    out = []
    for cap in (200e6, 20e6, 2e6, 0.5e6):             # Mbps: 200 .. 0.5
        for f_clk in (200e6, 50e6):                   # weak / weaker device
            for budget in (0.002, 0.02):
                for cached in (False, True):
                    out.append((cap, f_clk, budget, cached))
    return out


def sweep(params, x_te, y_te) -> dict:
    """register -> calibrate -> build_store, then one served plan per
    scenario -> {"plans": [(p, bits, payload bits, objective)], "distinct":
    set of (p, bits)}."""
    srv = QPARTServer()
    srv.register("mnist", ClassifierBackend(MNIST_MLP, params),
                 x_te[2048:3072], y_te[2048:3072])
    srv.calibrate("mnist")
    base_dev, base_ch, w = DeviceProfile(), Channel(), ObjectiveWeights()
    srv.build_store("mnist", base_dev, base_ch, w)

    print(f"{'channel':>10} {'device_clk':>10} {'budget':>7} {'cached':>6} "
          f"{'p':>2} {'bits':>20} {'uplink':>10} {'objective':>10}")
    cases = scenarios()
    seen_plans, plans = set(), []
    for cap, f_clk, budget, cached in cases:
        dev = dataclasses.replace(base_dev, f_clock=f_clk)
        ch = dataclasses.replace(base_ch, capacity_bps=cap)
        req = InferenceRequest("mnist", budget, dev, ch, w,
                               segment_cached=cached)
        res = srv.serve(req)                 # a Deployment (plan + costs)
        bits = np.asarray(round_bits(res.plan.bits_w)) if res.plan.p else []
        print(f"{cap/1e6:>8.1f}Mb {f_clk/1e6:>8.0f}MHz {budget:>7.3f} "
              f"{str(cached):>6} {res.plan.p:>2} {str(list(bits)):>20} "
              f"{res.payload_bits/1e3:>8.1f}kb {res.objective:>10.4f}")
        key = (res.plan.p, tuple(bits.tolist()) if len(bits) else ())
        seen_plans.add(key)
        plans.append((*key, res.payload_bits, res.objective))
    print(f"\ndistinct plans chosen: {len(seen_plans)} "
          f"across {len(cases)} scenarios — the serving pattern adapts "
          f"to device, channel and accuracy demand (no model retraining).")
    assert len(seen_plans) >= 3
    return {"plans": plans, "distinct": seen_plans}


def main(argv=None) -> dict:
    """Runs the example; returns its key numbers."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    params, (x_te, y_te) = torch_mnist_mlp.train(device=args.device)
    out = sweep(params, x_te, y_te)
    return {"scenarios": len(out["plans"]),
            "distinct_plans": sorted([p, list(b)] for p, b in out["distinct"])}


if __name__ == "__main__":
    main()
