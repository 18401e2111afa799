"""End-to-end training example: a ~15M-parameter SmolLM-family decoder
trained for a few hundred steps on the synthetic low-rank bigram stream,
with checkpointing and eval, on the PyTorch port.

The port's twin of ``examples/train_small_lm.py``: the same model,
optimizer, steps and printed lines, through the port's train step (f32
master weights, bf16 activations, on the card the flash attention
kernel forward and its hand-written backward). It runs on one card: the
reference builds its host mesh and replicated parameter specs, but jits
its step without ``in_shardings``, so its batch is never split and every
device computes the same step (``repro_torch.launch.train`` is the one
that splits its batch over every local card). The reference jits its train step with
the parameters and the optimizer state donated, and its eval step; on
the card each runs as a CUDA graph (``repro_torch.train.graphs
.DonatedStep``, the train step's state updated in its own buffers), as
does the token stream's sampler. The weights start from a seeded
``torch.Generator`` and the token stream is the port's own
(``repro_torch.data.pipeline.TokenStream``), so the losses are the
port's own. The checkpoint goes under ``build/``.

  PYTHONPATH=src python examples/torch_train_small_lm.py [--steps 300] \\
      [--device cpu]
"""
import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import TokenStream, TokenStreamConfig
from repro_torch.models import transformer as T
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.graphs import DonatedStep
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_loop import make_eval_step, make_train_step
from repro_torch.tree import tree_leaves

CKPT = Path(__file__).resolve().parent.parent / "build" / "qpart_lm_ckpt"


def config():
    # a 4-layer, d=256 SmolLM-family stack (~8M params): big enough to
    # show real learning on CPU in minutes, same code path as the 135M
    return dataclasses.replace(
        get_config("smollm-135m"), name="smollm-8m", num_layers=4,
        d_model=256, num_heads=4, num_kv_heads=2, head_dim=64, d_ff=768,
        vocab_size=2048, tp_pad=1)


def train(params, cfg, batches, eval_batch, *, steps: int, opt_cfg,
          batch: int, seq: int):
    """``steps`` AdamW steps over ``batches`` (dicts of tokens and
    labels), an eval every 25 steps and at the last -> (params, optimizer
    state, per-step losses, eval cross-entropies by step)."""
    opt_state = init_opt_state(params)
    step_fn = DonatedStep(make_train_step(cfg, opt_cfg, remat=False))
    eval_fn = DonatedStep(make_eval_step(cfg), donate=0)
    losses, evals, t0 = [], {}, time.time()
    for i, b in enumerate(batches):
        if i >= steps:
            break
        params, opt_state, m = step_fn(params, opt_state, b)
        losses.append(float(m["loss"]))
        if i % 25 == 0 or i == steps - 1:
            evals[i] = float(eval_fn(params, eval_batch)["xent"])
            tok_s = batch * seq * (i + 1) / (time.time() - t0)
            print(f"step {i:4d} train {losses[-1]:.4f} "
                  f"eval {evals[i]:.4f} "
                  f"({tok_s:,.0f} tok/s)")
    return params, opt_state, losses, evals


def checkpoint(path, params, opt_state, step: int, arch: str):
    """Save, then restore into the live trees as templates -> (params,
    optimizer state, meta) read back."""
    save_checkpoint(path, params, opt_state, step=step,
                    metadata={"arch": arch})
    # resume check
    p2, o2, meta = load_checkpoint(path, params, opt_state)
    print(f"checkpoint saved + restored (step {meta['step']}) at {path}")
    return p2, o2, meta


def main(argv=None) -> dict:
    """Runs the example; returns its key numbers."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=str(CKPT))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = config()
    n_params = cfg.param_count()
    print(f"model: {cfg.name}  params ~{n_params/1e6:.1f}M  "
          f"layers {cfg.num_layers} d_model {cfg.d_model}")

    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=30, total_steps=args.steps)
    params = T.init_params(cfg, torch.Generator(device=args.device)
                           .manual_seed(0), device=args.device)
    stream = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq + 1,
        batch_size=args.batch), device=args.device)
    eval_batch = next(TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq + 1,
        batch_size=args.batch, seed=123), device=args.device).batches())
    params, opt_state, losses, evals = train(
        params, cfg, stream.batches(), eval_batch, steps=args.steps,
        opt_cfg=opt_cfg, batch=args.batch, seq=args.seq)
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"\nloss {first:.3f} -> {last:.3f}")
    assert last < first - 0.2, "model failed to learn"
    p2, o2, meta = checkpoint(args.ckpt, params, opt_state, args.steps,
                              cfg.name)
    bitwise = all(torch.equal(a, b) for a, b in zip(
        tree_leaves((params, opt_state)), tree_leaves((p2, o2))))
    return {"loss_first10": float(first), "loss_last10": float(last),
            "eval_xent": {str(i): x for i, x in evals.items()},
            "checkpoint_step": meta["step"], "checkpoint_bitwise": bitwise}


if __name__ == "__main__":
    main()
