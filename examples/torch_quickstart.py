"""Quickstart: the whole QPART loop in ~60 lines, on the PyTorch port.

Trains the paper's 6-FC-layer MNIST classifier on the synthetic surrogate,
calibrates the quantization-noise model, builds the offline pattern store
(Alg. 1), and serves one inference request (Alg. 2) — printing the chosen
partition point, per-layer bit-widths, payload and the priced plan.

The port's twin of ``examples/quickstart.py``: the same steps, sizes and
printed lines. The weights start from a seeded ``torch.Generator`` (the
reference's ``jax.random.key(0)`` has no PyTorch counterpart), so the
numbers are the port's own. The path is plain PyTorch (matmuls), as the
reference's is plain XLA: it launches no kernel.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

import torch_mnist_mlp
from repro_torch.configs.classifier import MNIST_MLP
from repro_torch.core.cost_model import (Channel, DeviceProfile,
                                         ObjectiveWeights)
from repro_torch.core.quantizer import round_bits
from repro_torch.serving.backends import ClassifierBackend
from repro_torch.serving.qpart_server import QPARTServer
from repro_torch.serving.simulator import InferenceRequest


def train_stage(params=None, *, n_train: int = 8192, steps: int = 400,
                device="cuda"):
    """Step 1 -> (params, (x_test, y_test), test accuracy)."""
    print("1) train the paper's MNIST MLP (synthetic surrogate)...")
    params, (x_te, y_te) = torch_mnist_mlp.train(params, n_train=n_train,
                                                 steps=steps, device=device)
    acc = torch_mnist_mlp.accuracy(params, x_te[:2048], y_te[:2048])
    print(f"   test accuracy: {acc:.4f}")
    return params, (x_te, y_te), acc


def serve_stage(params, x_te, y_te) -> dict:
    """Steps 2 and 3: register -> calibrate -> build_store -> serve ->
    execute on the first 2048 test images."""
    print("2) register + calibrate on the QPART server (Alg. 1)...")
    srv = QPARTServer()
    backend = ClassifierBackend(MNIST_MLP, params)
    srv.register("mnist", backend, x_te[2048:3072], y_te[2048:3072])
    srv.calibrate("mnist")
    # a realistic edge setting: low-power device (200 MHz, cheap joules),
    # congested uplink (2 Mbps) — local inference beats uploading the raw
    # input (with the default 200 Mbps lab channel, full offload p=0 is
    # trivially optimal)
    dev = DeviceProfile()
    ch = Channel(capacity_bps=2e6)
    w = ObjectiveWeights()
    srv.build_store("mnist", dev, ch, w)

    print("3) serve a repeat request with a 1% accuracy budget (Alg. 2)...")
    # segment_cached: the device holds the quantized segment from an
    # earlier request, so only the cut activation is priced (uplink)
    req = InferenceRequest("mnist", accuracy_budget=0.01, device=dev,
                           channel=ch, weights=w, segment_cached=True)
    dep = srv.serve(req)                      # plan + priced Deployment
    res = dep.execute(x_te[:2048], y_te[:2048])   # really run it
    plan = dep.plan
    specs = backend.layer_specs()
    print(f"   partition point p = {plan.p} "
          f"(device runs layers 1..{plan.p}, server the rest)")
    if plan.p:
        seg_f32 = sum(sp.z_w for sp in specs[:plan.p]) * 32
        print(f"   per-layer bits    = {np.asarray(round_bits(plan.bits_w))}")
        print(f"   activation bits   = {int(np.ceil(plan.bits_x))}")
        print(f"   cached segment    = {plan.payload_w_bits / 1e6:.2f} Mbit "
              f"({100 * (1 - plan.payload_w_bits / seg_f32):.1f}% below its "
              f"f32 size {seg_f32 / 1e6:.2f} Mbit)")
        print(f"   uplink activation = {res.payload_bits / 1e3:.2f} kbit "
              f"(vs raw input {784 * 32 / 1e3:.1f} kbit)")
    print(f"   time {res.costs.t_total * 1e3:.2f} ms | energy "
          f"{res.costs.e_total * 1e3:.2f} mJ | objective {res.objective:.4f}")
    print(f"   measured accuracy  = {res.accuracy:.4f} "
          f"(degradation {100 * res.accuracy_degradation:.2f}% vs "
          f"budget {100 * req.accuracy_budget:.0f}%)")
    # Delta calibration is statistical (calib and eval are different
    # splits); allow the tier-1 suite's 2x slack + noise floor
    assert res.accuracy_degradation <= 2 * req.accuracy_budget + 0.02
    return {"srv": srv, "backend": backend, "request": req, "dep": dep,
            "result": res}


def main(argv=None) -> dict:
    """Runs the example; returns its key numbers."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    params, (x_te, y_te), acc = train_stage(device=args.device)
    out = serve_stage(params, x_te, y_te)
    dep, res = out["dep"], out["result"]
    return {"test_accuracy": acc, "p": int(dep.plan.p),
            "bits_w": [int(b) for b in dep.extra["bits_w"]],
            "bits_x": float(dep.extra["bits_x"]),
            "payload_bits": dep.payload_bits, "accuracy": res.accuracy,
            "accuracy_degradation": res.accuracy_degradation,
            "objective": res.objective}


if __name__ == "__main__":
    main()
