"""Training launcher: train a (reduced or full) architecture on one card
with the port's train step — AdamW on f32 master weights, bf16
activations, the flash attention kernel forward and backward.

  python -m repro_torch.launch.train --arch smollm-135m --steps 50 \\
      --batch 8 --seq 256 [--remat] [--checkpoint DIR]
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu

One card holds smollm-135m and its optimizer state whole, so there is no
mesh (the 1 x 1 mesh of the reference). Exits 0 only if the mean loss
of the last five steps is below that of the first five.

The reference compiles its step once with the parameters and the
optimizer state donated (``jax.jit(step_fn, donate_argnums=(0, 1))``);
on CUDA the step runs as one CUDA graph (``train.graphs.DonatedStep``:
the first step eager, the second captured and replayed, the state
updated in its own buffers), and the token stream's sampler as another
(``data.pipeline.TokenStream``). :func:`main`'s ``graphs=False`` runs
both eagerly through the same code.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, list_configs
from repro_torch.data.pipeline import TokenStream, TokenStreamConfig
from repro_torch.models import transformer as T
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.graphs import DonatedStep
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_loop import make_train_step


def main(argv=None, *, graphs=None, stats=None):
    """The launcher on ``argv``; ``graphs`` as ``DonatedStep`` and
    ``TokenStream`` take it (default: on for CUDA). ``stats``, when a
    dict, receives each step's metrics as floats (``metrics``), the final
    ``params`` and ``opt_state``, and the ``captures`` of the step and of
    the sampler."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_configs(), default="smollm-135m")
    ap.add_argument("--reduced", action="store_true",
                    help="2-layer smoke variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 10, 1))
    jstep = DonatedStep(make_train_step(cfg, opt_cfg, remat=args.remat),
                        graphs=graphs)

    g = torch.Generator(device=args.device).manual_seed(args.seed)
    params = T.init_params(cfg, g, device=args.device)
    opt_state = init_opt_state(params)
    stream = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq + 1,
        batch_size=args.batch, seed=args.seed), device=args.device,
        graphs=graphs)
    t0 = time.time()
    losses = []
    for step, batch in enumerate(stream.batches()):
        if step >= args.steps:
            break
        params, opt_state, metrics = jstep(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if stats is not None:
            stats.setdefault("metrics", []).append(
                {k: float(v) for k, v in metrics.items()})
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"xent {float(metrics['xent']):.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"({dt:.1f}s)")
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params, opt_state, step=args.steps,
                        metadata={"arch": args.arch})
        print("checkpoint saved:", args.checkpoint)
    if stats is not None:
        stats.update(params=params, opt_state=opt_state, captures={
            "step": jstep.captures, "sampler": stream.captures})
    return 0 if last < first else 1


if __name__ == "__main__":
    raise SystemExit(main())
