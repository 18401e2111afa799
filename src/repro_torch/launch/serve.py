"""Serving launcher: batched prefill + decode of one model on one card,
with full-precision or int-N (QPART wire format) block weights.

  python -m repro_torch.launch.serve --arch smollm-135m --quant 4
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

One card holds smollm-135m whole, so there is no mesh. At ``--quant 8``
/ ``4`` the block weights are quantized on the device by the quantize /
quantize-and-pack-int4 kernels and served through the dequantize-fused
qmatmul / qmatmul4 kernels.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config, list_configs
from repro_torch.core.quantizer import quantize_params_for_serving
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import transformer as T


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, cfg, prompt, max_len: int, gen: int, *,
             temperature: float = 0.0, generator=None, stats=None):
    """Greedy (or, at ``temperature`` > 0, sampled with ``generator``)
    generation: prefill then ``gen - 1`` decode steps -> (B, gen) int32.
    ``stats``, when a dict, receives ``prefill_s`` and ``decode_s``, wall
    seconds each ended by a device synchronisation."""
    b, s = prompt.shape
    prefill_step = make_prefill_step(cfg, max_len)
    serve_step = make_serve_step(cfg)
    t0 = time.perf_counter()
    logits, caches = prefill_step(params, {"tokens": prompt})
    tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
    if stats is not None:
        _sync(prompt.device)
        t1 = time.perf_counter()
        stats["prefill_s"] = t1 - t0
    out = [tok]
    for i in range(gen - 1):
        logits, caches = serve_step(params, tok, caches, s + i)
        if temperature > 0.0:
            probs = torch.softmax(logits[:, 0].float() / temperature, -1)
            tok = torch.multinomial(probs, 1, generator=generator).to(
                torch.int32)
        else:
            tok = torch.argmax(logits[:, 0:1], -1).to(torch.int32)
        out.append(tok)
    toks = torch.cat(out, dim=1)
    if stats is not None:
        _sync(prompt.device)
        stats["decode_s"] = time.perf_counter() - t1
    return toks


def run(cfg, *, batch: int = 4, prompt_len: int = 64, gen: int = 32,
        temperature: float = 0.0, quant: int = 0, device="cuda",
        seed: int = 0) -> dict:
    """Seeded weights on ``device`` -> (at ``quant`` 8 or 4) int-N wire
    structs -> a seeded random prompt -> :func:`generate`. Returns the
    tokens, both weight trees and the phases' seconds (``quantize_s``,
    ``prefill_s``, ``decode_s``, ``generate_s``)."""
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
                    temperature=temperature, generator=g, stats=stats)
    stats["generate_s"] = time.perf_counter() - t0
    return {"tokens": toks, "weights": weights, "params": params, **stats}


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
