"""QPART beyond classifiers: a decoder LM through the FULL serving
pipeline, on the PyTorch port.

With the ``ModelBackend`` protocol a transformer goes through the same
calibrate → build_store → serve → execute path as the paper's
classifiers: per-block (z_w, z_x, o) come from the analytic cost model,
Alg. 1 tabulates per-block bit-widths + partition points, Alg. 2 picks a
plan per request context, and ``Deployment.execute`` really runs the
quantized device blocks + quantized cut activation + f32 server tail —
reporting measured accuracy degradation.

The port's twin of ``examples/quantized_lm_serving.py``: the same steps,
sizes and printed lines. On the card the water-filled bit allocation
runs through the hand-written kernels: the causal flash attention
forward (the training and calibration forwards, ``execute``,
``generate``'s prefill) and its backward (training), single-query decode
attention (both generates and the streamed deployment) and the
dequantize-fused ``qmatmul`` / ``qmatmul4`` the plan's bit-widths pick.
The kernels are built before anything is timed. The weights start from
a seeded ``torch.Generator`` (the reference's ``jax.random.key(0)`` has
no PyTorch counterpart), so the numbers are the port's own.

  PYTHONPATH=src python examples/torch_quantized_lm_serving.py [--device cpu]
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.cost_model import (Channel, DeviceProfile,
                                         ObjectiveWeights)
from repro_torch.core.quantizer import fake_quant, round_bits
from repro_torch.kernels import build, ops
from repro_torch.launch.serve import generate
from repro_torch.models import transformer as T
from repro_torch.serving.backends import TransformerBackend
from repro_torch.serving.qpart_server import QPARTServer
from repro_torch.serving.simulator import InferenceRequest
from repro_torch.train.graphs import DonatedStep
from repro_torch.tree import tree_leaves, tree_map

SEQ = 32


def config():
    """The reference example's 4-layer f32 smollm-8m."""
    return dataclasses.replace(
        get_config("smollm-135m"), name="smollm-8m", num_layers=4,
        d_model=256, num_heads=4, num_kv_heads=2, head_dim=64, d_ff=768,
        vocab_size=256, tp_pad=1, dtype="float32")


def cycle_batch(rng, vocab, n):
    """Learnable synthetic next-token task: t[i+1] = (t[i] + 1) % V."""
    start = rng.integers(0, vocab, size=(n, 1))
    toks = (start + np.arange(SEQ + 1)[None, :]) % vocab
    return toks[:, :SEQ].astype(np.int32), toks[:, SEQ].astype(np.int32)


def train(params, cfg, rng, *, steps: int = 300, batch: int = 32,
          lr: float = 0.3):
    """Step 1: plain SGD on the cycle task -> (params, final loss). The
    step runs as one CUDA graph on the card, as the reference jits it
    (``DonatedStep``); the last step's loss is read once, after the
    loop."""
    print("1) briefly train so quantization has something to preserve...")
    device = params["embed"].device

    def sgd(params, toks):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        leaves = tree_leaves(live)
        logits, _ = T.forward(live, cfg, toks[:, :-1])
        lp = torch.log_softmax(logits, -1)
        loss = -torch.mean(torch.gather(lp, -1, toks[:, 1:].long()[..., None]))
        grads = iter(torch.autograd.grad(loss, leaves))
        return tree_map(lambda t: t.detach() - lr * next(grads), live), \
            loss.detach()

    step = DonatedStep(sgd, donate=1)
    for _ in range(steps):
        start = rng.integers(0, cfg.vocab_size, size=(batch, 1))
        toks = torch.from_numpy(((start + np.arange(SEQ + 1)[None, :])
                                 % cfg.vocab_size).astype(np.int32)).to(device)
        params, loss = step(params, toks)
    loss = loss.item()
    print(f"   final loss {loss:.3f}")
    return params, loss


def serve(params, cfg, rng, *, calib: int = 128, test: int = 128) -> dict:
    """Steps 2 to 5: calibrate and build the store, serve and execute one
    edge request, generate with the plan's fake-quantized blocks against
    f32, then stream the deployment and feed its timings to the ledger."""
    print("2) register the TransformerBackend; calibrate + build the "
          "pattern store (Alg. 1)...")
    # decode_max_len marks the backend decode-PLANNED: KV-cache
    # feasibility enters the plan mask and Deployment.generate streams
    backend = TransformerBackend(cfg, params, seq_len=SEQ, decode_max_len=64)
    srv = QPARTServer()
    x_cal, y_cal = cycle_batch(rng, cfg.vocab_size, calib)
    srv.register("smollm", backend, x_cal, y_cal)
    srv.calibrate("smollm")
    print(f"   base next-token accuracy: "
          f"{srv.models['smollm'].base_accuracy:.3f}")
    dev = DeviceProfile()
    ch = Channel(capacity_bps=2e6)
    # a server-cost-sensitive tenant: eta prices server MACs high enough
    # that keeping quantized blocks on-device wins (cf. the privacy
    # reading: raw tokens never leave the device when p = L)
    w = ObjectiveWeights(eta=1e7)
    srv.build_store("smollm", dev, ch, w)

    print("3) serve one edge request (Alg. 2) and really execute it...")
    req = InferenceRequest("smollm", 0.01, dev, ch, w, segment_cached=True)
    dep = srv.serve(req)
    plan = dep.plan
    bits = np.asarray(round_bits(plan.bits_w)) if plan.p else []
    L = backend.num_layers
    print(f"   partition p = {plan.p}/{L} blocks on-device, bits = {bits}")
    specs = backend.layer_specs()
    f32_bits = sum(sp.z_w for sp in specs[:plan.p]) * 32
    saved = 1 - plan.payload_w_bits / max(f32_bits, 1)
    if plan.p:
        print(f"   device-segment payload: {plan.payload_w_bits/1e6:.1f} "
              f"Mbit vs {f32_bits/1e6:.1f} Mbit f32 "
              f"({100*saved:.0f}% saved)")
    x_te, y_te = cycle_batch(rng, cfg.vocab_size, test)
    res = dep.execute(x_te, y_te)
    print(f"   measured accuracy {res.accuracy:.3f} "
          f"(degradation {100*res.accuracy_degradation:+.2f}% vs f32 on the "
          f"same set)")

    print("4) generate with the plan's quantized blocks, compare to f32...")
    qparams = quantize_blocks(params, bits, cfg.num_layers)
    x_p, _ = cycle_batch(rng, cfg.vocab_size, 2)
    prompt = x_p[:, :16]
    on_device = torch.from_numpy(prompt).to(backend.device)
    out_f32 = generate(params, cfg, on_device, max_len=32, gen=16).cpu()
    out_q = generate(qparams, cfg, on_device, max_len=32, gen=16).cpu()
    match = float(torch.mean((out_f32 == out_q).float()))
    print(f"   greedy tokens agree on {100*match:.0f}% of steps")
    assert res.accuracy_degradation <= 0.25, "quantization hurt the LM too much"

    print("5) stream the SAME deployment through the partitioned "
          "prefill→decode pipeline (DESIGN.md §11)...")
    streamed = []
    out = dep.generate(prompt, 16,
                       stream_cb=lambda i, tok: streamed.append(tok))
    assert len(streamed) == 16 and out.tokens.shape == (2, 16)
    built = " (kernels built before timing)" \
        if backend.device.type == "cuda" else ""
    print(f"   TTFT {out.ttft_s*1e3:.1f} ms, {out.tokens_per_s:.0f} tok/s "
          f"wall-clock{built}; device KV cache "
          f"{out.device_cache_bytes/1024:.0f} KiB @ {out.device_cache_dtype} "
          f"(server tail {out.server_cache_bytes/1024:.0f} KiB)")
    stream_match = float(np.mean(out.tokens == out_f32.numpy()))
    print(f"   streamed tokens agree with f32 greedy on "
          f"{100*stream_match:.0f}% of steps")
    # the measured per-stage stream timings feed the calibration ledger —
    # decode and prefill samples sharpen one set of StageRates
    srv.record_decode(dep)
    print(f"   ledger now holds {len(srv.ledger.samples)} measured sample(s)")
    return {"srv": srv, "dep": dep, "result": res,
            "bits": [int(b) for b in bits], "payload_saved": saved,
            "prompt": prompt, "f32_tokens": out_f32.numpy(),
            "quantized_tokens": out_q.numpy(),
            "match": match, "stream": out, "stream_match": stream_match}


def quantize_blocks(params, bits_per_block, num_blocks):
    """Fake-quantize the first `len(bits)` stacked blocks layer-wise."""
    out = tree_map(lambda x: x, params)          # shallow copy
    for per, bp in enumerate(out["blocks"]):
        def q(leaf):
            new = []
            for layer in range(leaf.shape[0]):
                idx = layer * len(out["blocks"]) + per
                if idx < len(bits_per_block):
                    b = int(bits_per_block[idx])
                    new.append(fake_quant(leaf[layer], b))
                else:
                    new.append(leaf[layer])
            return torch.stack(new)
        out["blocks"][per] = tree_map(q, bp)
    return out


def main(argv=None) -> dict:
    """Runs the example; returns its key numbers."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        build.build_all()
    before = {k: f.launches for k, f in ops.KERNELS.items()}
    cfg = config()
    params = T.init_params(cfg, torch.Generator(device=args.device)
                           .manual_seed(0), device=args.device)
    rng = np.random.default_rng(0)
    params, loss = train(params, cfg, rng)
    out = serve(params, cfg, rng)
    launches = {k: f.launches - before[k] for k, f in ops.KERNELS.items()}
    print(f"   kernel launches: {launches}")
    dep, res, st = out["dep"], out["result"], out["stream"]
    return {"final_loss": loss,
            "base_accuracy": out["srv"].models["smollm"].base_accuracy,
            "p": int(dep.plan.p), "bits": out["bits"],
            "payload_saved": out["payload_saved"], "accuracy": res.accuracy,
            "accuracy_degradation": res.accuracy_degradation,
            "generate_match": out["match"], "ttft_s": st.ttft_s,
            "tokens_per_s": st.tokens_per_s,
            "stream_match": out["stream_match"],
            "device_cache_dtype": st.device_cache_dtype,
            "device_cache_bytes": st.device_cache_bytes,
            "ledger_samples": len(out["srv"].ledger.samples)}


if __name__ == "__main__":
    main()
