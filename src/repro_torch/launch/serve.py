"""Serving launcher: batched prefill + decode of one model on one card,
with full-precision or int-N (QPART wire format) block weights.

  python -m repro_torch.launch.serve --arch smollm-135m --quant 4
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

It runs on one card: the reference's launcher replicates the weights
over its host mesh and gives the prompt no spec, so every device serves
the same batch (``launch.train`` is the one that splits its batch over
the cards). At ``--quant 8`` / ``4`` the block weights are quantized on
the device by the quantize / quantize-and-pack-int4 kernels and served
through the dequantize-fused qmatmul / qmatmul4 kernels.

The decode step is compiled once per :func:`generate` call, as the
reference's ``jstep = jax.jit(...)`` in ``repro/launch/serve.py`` is:
on CUDA, ``generate`` runs its first decode step eagerly (the warm-up),
captures the serve step (embed -> blocks ``[0, L)`` -> unembed) as ONE
CUDA graph on the next (``serving.decode.graphs.StageGraph``, which
keeps the launch counters with the replays) and replays it for every
later token. The position lives on the card, a 0-d int32 tensor filled
before each step, as the reference's ``jnp.array(s + i, jnp.int32)``.
The graph bakes in the addresses of the weights and of the caches that
the call's prefill built, so it is private to the call and goes with
it: one capture per call (``stats["captures"]``), as the reference's
fresh ``jax.jit`` traces once per call. Token choice (argmax, or
softmax and ``torch.multinomial`` with the caller's generator) stays
outside the graph, as in the reference. There is no fallback: a capture
that fails raises.

:func:`generate` also runs one rank's program over a model axis
(``axis=``, ``launch.model_parallel``): ``params`` are the rank's shards
(``launch.sharding.shard_tree``), the steps run on them with their
collectives, and each token is chosen from the rank's block of vocab
columns by the distributed argmax (or, sampled, from the logits
gathered over the axis); every rank returns the same tokens. Under the
FSDP layout (``fsdp=``, ``launch.model_parallel.Fsdp``) the params are
also split over the data axis and gathered where read, and ``prompt``
is the rank's rows of the batch. The rank program's decode step is one
CUDA graph a call as on one card, its collectives captured with it,
where every axis it runs over is NCCL's (one rank a card); a ``gloo``
rank passes ``graphs=False``. ``main`` serves on one card.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config, list_configs
from repro_torch.core.quantizer import quantize_params_for_serving
from repro_torch.launch import model_parallel as mp
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import transformer as T
from repro_torch.serving.decode.graphs import StageGraph, use_graphs


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _choose(logits, temperature: float, generator, axis=None):
    """The next token (B, 1) int32 from a step's logits (B, 1, V), or
    from a rank's block of them over a model ``axis``."""
    if temperature > 0.0:
        logits = mp.all_gather(logits, axis, -1)
        probs = torch.softmax(logits[:, 0].float() / temperature, -1)
        return torch.multinomial(probs, 1, generator=generator).to(
            torch.int32)
    return mp.argmax(logits[:, 0:1], axis).to(torch.int32)


def generate(params, cfg, prompt, max_len: int, gen: int, *,
             temperature: float = 0.0, generator=None, stats=None,
             graphs=None, axis=None, fsdp=None):
    """Greedy (or, at ``temperature`` > 0, sampled with ``generator``)
    generation: prefill then ``gen - 1`` decode steps -> (B, gen) int32.
    ``graphs`` (default: on for a CUDA prompt) replays the decode step
    as one CUDA graph from the second step on; ``graphs=False`` runs
    every step eagerly through the same code, and ``graphs=True`` on
    the CPU raises. ``stats``, when a dict, receives ``prefill_s``,
    ``decode_s`` and ``steady_s`` (wall seconds, each ended by a device
    synchronisation; ``steady_s`` the decode steps after the second: a
    graphed call's replays after its capture), ``captures`` (1 for a
    graphed call of ``gen`` >= 3, else 0) and ``last_logits`` (a copy
    of the last step's logits (B, 1, V); over a model ``axis``, the
    rank's block of them). Over an axis whose size
    is larger than 1, or an FSDP layout ``fsdp`` over a data axis larger
    than 1, the ranks must all call it, and a graph captures the step's
    collectives: it needs NCCL's groups (``graphs=True``, or the default
    on CUDA, over a gloo group raises: pass ``graphs=False``); the
    prefill and the token choice (the distributed argmax's gathers) stay
    outside the graph."""
    b, s = prompt.shape
    mp.require_capturable(graphs, prompt.device,
                          (axis, fsdp.axis if fsdp is not None else None))
    graphs = use_graphs(graphs, prompt.device)
    prefill_step = make_prefill_step(cfg, max_len, axis, fsdp)
    serve_step = make_serve_step(cfg, mp.with_len(axis, max_len), fsdp)
    t0 = time.perf_counter()
    logits, caches = prefill_step(params, {"tokens": prompt})
    tok = mp.argmax(logits[:, -1:], axis).to(torch.int32)
    if stats is not None:
        _sync(prompt.device)
        t1 = time.perf_counter()
        stats["prefill_s"] = t1 - t0
    pos = torch.zeros((), dtype=torch.int32, device=prompt.device)
    graph = None
    out = [tok]
    for i in range(gen - 1):
        if stats is not None and i == 2:
            _sync(prompt.device)
            t2 = time.perf_counter()
        pos.fill_(s + i)
        if not graphs or i == 0:
            logits, caches = serve_step(params, tok, caches, pos)
        else:
            if graph is None:       # the caches are this call's own
                graph = StageGraph(
                    lambda t: serve_step(params, t, caches, pos)[0],
                    (tok.clone(),))
            logits = graph.replay(tok)
        tok = _choose(logits, temperature, generator, axis)
        out.append(tok)
    toks = torch.cat(out, dim=1)
    if stats is not None:
        _sync(prompt.device)
        t3 = time.perf_counter()
        stats["decode_s"] = t3 - t1
        stats["steady_s"] = t3 - t2 if gen > 3 else 0.0
        stats["captures"] = int(graph is not None)
        stats["last_logits"] = logits.clone() if gen > 1 else None
    return toks


def run(cfg, *, batch: int = 4, prompt_len: int = 64, gen: int = 32,
        temperature: float = 0.0, quant: int = 0, device="cuda",
        seed: int = 0, graphs=None) -> dict:
    """Seeded weights on ``device`` -> (at ``quant`` 8 or 4) int-N wire
    structs -> a seeded random prompt -> :func:`generate` (``graphs`` as
    there). Returns the tokens, the prompt, both weight trees, the
    phases' seconds (``quantize_s``, ``prefill_s``, ``decode_s``,
    ``steady_s``, ``generate_s``), ``captures`` and ``last_logits``."""
    use_graphs(graphs, device)
    g = torch.Generator(device=device).manual_seed(seed)
    weights = T.init_params(cfg, g, device=device)
    params, stats = weights, {"quantize_s": 0.0}
    if quant:
        _sync(device)
        t0 = time.perf_counter()
        params = quantize_params_for_serving(weights, quant)
        _sync(device)
        stats["quantize_s"] = time.perf_counter() - t0
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=g, device=device, dtype=torch.int32)
    t0 = time.perf_counter()
    toks = generate(params, cfg, prompt, max_len=prompt_len + gen, gen=gen,
                    temperature=temperature, generator=g, stats=stats,
                    graphs=graphs)
    stats["generate_s"] = time.perf_counter() - t0
    return {"tokens": toks, "prompt": prompt, "weights": weights,
            "params": params, **stats}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_configs(), default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--quant", type=int, choices=(0, 4, 8), default=0,
                    help="serve with int-N weights (8 or 4, QPART wire "
                         "format; 0 = full precision)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    out = run(cfg, batch=args.batch, prompt_len=args.prompt_len,
              gen=args.gen, temperature=args.temperature, quant=args.quant,
              device=args.device, seed=args.seed)
    if args.quant:
        print(f"serving with int{args.quant} block weights (quantized in "
              f"{out['quantize_s']:.3f}s)")
    toks, dt = out["tokens"].cpu(), out["generate_s"]
    print(f"generated {tuple(toks.shape)} in {dt:.1f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print("first row:", toks[0][:16].tolist(), "...")
    assert toks.shape == (args.batch, args.gen)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
