"""Training launcher: train a (reduced or full) architecture on the host
mesh, one rank per local card, with the port's train step — AdamW on
f32 master weights, bf16 activations, the flash attention kernel
forward and backward.

  python -m repro_torch.launch.train --arch smollm-135m --steps 50 \\
      --batch 8 --seq 256 [--remat] [--checkpoint DIR]
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu

The reference runs its sharded step on ``make_host_mesh()``, (data=n,
model=1) over every local device: parameters and optimizer state
replicated, the batch split over ``data``, the gradients all-reduced by
XLA. Here, on CUDA, the launcher runs one rank per card
(``torch.cuda.device_count()``; ``launch.distributed``: spawned
processes, a ``file://`` rendezvous, ``nccl``). Every rank starts from
rank 0's parameters (a broadcast), draws the same seeded token stream
on its own card and keeps its block of rows as ``launch.sharding``
lays the batch out on ``make_host_mesh(n)`` (all of them when n does not
divide the batch: the reference's replicated spec), so n cards train on
the tokens of one. The step all-reduces the gradients and the loss
metrics to their mean over the ranks before the update
(``train_loop.make_train_step(group=)``), so every rank holds the same
state. Rank 0 prints the log lines, writes the checkpoint and gives the
exit code; a rank that fails makes the launcher raise. One card is one
rank in the calling process with no collective, as XLA compiles none
for one device. On the CPU the launcher is one process unless
:func:`main`'s ``world`` asks for more (``gloo``).

Exits 0 only if the mean loss of the last five steps is below that of
the first five.

The reference compiles its step once with the parameters and the
optimizer state donated (``jax.jit(step_fn, donate_argnums=(0, 1))``);
on CUDA each rank's step, its all-reduce included, runs as one CUDA
graph (``train.graphs.DonatedStep``: the first step eager, which also
runs the communicator once, the second captured and replayed, the state
updated in its own buffers), and the token stream's sampler as another
(``data.pipeline.TokenStream``). :func:`main`'s ``graphs=False`` runs
both eagerly through the same code.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config, list_configs
from repro_torch.data.pipeline import TokenStream, TokenStreamConfig
from repro_torch.kernels import ops
from repro_torch.launch import distributed
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sharding import batch_rows
from repro_torch.models import transformer as T
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.graphs import DonatedStep
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_loop import make_train_step


def parse_args(argv=None) -> argparse.Namespace:
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
    return ap.parse_args(argv)


def main(argv=None, *, graphs=None, stats=None, world=None, backend=None):
    """The launcher on ``argv``; ``graphs`` as ``DonatedStep`` and
    ``TokenStream`` take it (default: on for CUDA). ``world``: the host
    mesh's ranks, by default every local card on CUDA and one process
    on the CPU; past one, a process per rank. ``backend``: the process
    group's (``nccl`` on CUDA, ``gloo`` on the CPU by default); a world
    of one joins a group only when it is named. ``stats``, when a dict,
    receives rank 0's metrics as floats for each step (``metrics``), its
    final ``params`` and ``opt_state`` and the ``captures`` of the step
    and of the sampler, and for each rank (``ranks``) its losses and,
    from a spawned rank, the digest of its parameters and its kernel
    launches."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if world is None:
        world = torch.cuda.device_count() if device.type == "cuda" else 1
    if world < 1:
        raise ValueError(f"the host mesh needs a rank, not {world} "
                         f"(no card for --device {args.device}?)")
    keep = stats is not None
    if world > 1:
        outs = distributed.spawn(_rank, world, device, args, graphs, keep,
                                 backend=backend)
    elif backend is None:
        outs = [train(args, graphs=graphs, keep=keep)]
    else:
        with distributed.process_group(device, 0, 1, backend) as group:
            outs = [train(args, graphs=graphs, group=group, keep=keep)]
    if keep:
        stats.update(outs[0].pop("kept"))
        stats["ranks"] = [{k: o[k] for k in ("losses", "digest", "launches")
                           if k in o} for o in outs]
    return outs[0]["rc"]


def _rank(rank, world, group, args, graphs, keep):
    """One spawned rank of :func:`main`: its :func:`train` record (the
    trees rank 0's alone, the digest of each rank's), with the kernel
    launches it made (a fresh process counts from 0)."""
    out = train(args, graphs=graphs, group=group, keep=keep)
    if keep:
        out["digest"] = distributed.digest(out["kept"]["params"])
    if rank:
        out.pop("kept", None)
    out["launches"] = {k: f.launches for k, f in ops.KERNELS.items()}
    return out


def train(args, *, graphs=None, group=None, keep=False) -> dict:
    """``args.steps`` steps as rank ``dist.get_rank(group)`` of the host
    mesh (the whole batch, and no collective, when ``group`` is None) ->
    {``rc``, ``losses``} and, with ``keep``, ``kept``: what :func:`main`
    hands its ``stats``."""
    rank, world = (0, 1) if group is None else (dist.get_rank(group),
                                                dist.get_world_size(group))
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 10, 1))
    jstep = DonatedStep(make_train_step(cfg, opt_cfg, remat=args.remat,
                                        group=group), graphs=graphs)

    g = torch.Generator(device=args.device).manual_seed(args.seed)
    params = T.init_params(cfg, g, device=args.device)
    if group is not None:
        distributed.broadcast_tree(params, group)
    opt_state = init_opt_state(params)
    stream = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq + 1,
        batch_size=args.batch, seed=args.seed), device=args.device,
        graphs=graphs)
    rows = batch_rows(make_host_mesh(world), args.batch, rank)
    log = print if rank == 0 else lambda *a: None
    t0 = time.time()
    losses, metric_log = [], []
    for step, batch in enumerate(stream.batches()):
        if step >= args.steps:
            break
        batch = {k: v[rows] for k, v in batch.items()}
        params, opt_state, metrics = jstep(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if keep:
            metric_log.append({k: float(v) for k, v in metrics.items()})
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            log(f"step {step:5d} loss {losses[-1]:.4f} "
                f"xent {float(metrics['xent']):.4f} "
                f"lr {float(metrics['lr']):.2e} "
                f"gnorm {float(metrics['grad_norm']):.2f} "
                f"({dt:.1f}s)")
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    log(f"loss {first:.4f} -> {last:.4f} "
        f"({'improved' if last < first else 'NOT improved'})")
    if args.checkpoint and rank == 0:
        save_checkpoint(args.checkpoint, params, opt_state, step=args.steps,
                        metadata={"arch": args.arch})
        log("checkpoint saved:", args.checkpoint)
    out = {"rc": 0 if last < first else 1, "losses": losses}
    if keep:
        out["kept"] = {"metrics": metric_log, "params": params,
                       "opt_state": opt_state, "captures": {
                           "step": jstep.captures,
                           "sampler": stream.captures}}
    return out


if __name__ == "__main__":
    raise SystemExit(main())
