#!/usr/bin/env python3
"""Drive the PyTorch/H100 port of QPART (``src/repro_torch``) on one card.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases, each of which raises (and so exits non-zero) on any failure:

1. the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions; TF32 is switched off for the plain versions' matmuls;
2. build every CUDA kernel of the port from ``src/repro_torch/csrc``;
3. hold each kernel against its plain PyTorch version on the card at
   the main path's shapes and time kernel, plain version, the closest
   single PyTorch library call (a yardstick only — the port never calls
   it) and the card's lower bound for the same work;
4. the request loop on smollm-135m at its registered shape (30 layers,
   d_model 576, 9/3 heads padded to 4 x 4 by tp_pad=16, d_ff 1536, vocab
   49152, bf16) with seeded random weights: register -> calibrate ->
   build_store (3 contexts) -> serve -> execute -> generate, with every
   kernel's launch counter zeroed before and read after; a profile of
   the served stream's decode steps follows, and a small input is then
   checked against the plain versions on the CPU;
5. the serving launcher (``repro_torch.launch.serve``) on the same
   full-width model, batch 4, 64-token prompts, 32 new tokens, once each
   at --quant 0, 8 and 4, counters zeroed before each run: quantize
   seconds, prefill seconds, decode tokens/s and launches per kernel;
   after a quantized run its served weights are dequantized through
   ``ops.dequantize_tensor`` (|w - deq| <= scale / 2) and the tree is
   compared byte for byte with the one the plain versions build on the
   CPU.

After the last phase every kernel must have launched in the runs of the
paths that use it. The line before the last is the ``kernels`` JSON
record; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, data sheet
BF16_OPS_PER_S = 989e12            # H100 SXM dense bf16, data sheet
F32_OPS_PER_S = 67e12              # H100 SXM f32 off the tensor cores
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, ops: float, ops_per_s: float = BF16_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


class Timer:
    """Mean device milliseconds of one call, by CUDA events around each of
    ``reps`` launches after a warm-up, with the 50 MB L2 flushed before
    every launch (the main path finds weights and caches cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 20) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version

def check_qmatmul(torch, timer, records):
    """qmatmul (int8, per tensor and per column) and qmatmul4 (packed) at
    every projection shape of a smollm-135m block, decode M = 2 and
    prefill M = 128; timed on the MLP up-projection at decode M."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.qmatmul import qmatmul4_cuda, qmatmul_cuda
    g = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = {"wq": (576, 1024), "wk": (576, 256), "wo": (1024, 576),
              "w_up": (576, 1536), "w_down": (1536, 576)}
    worst = {}
    for packed in (False, True):
        name = "qmatmul4" if packed else "qmatmul"
        levels = 15 if packed else 255
        for wname, (k, n) in shapes.items():
            w = torch.randn(k, n, generator=g, device="cuda") * k ** -0.5
            for per_col in (False, True):
                dims = (0,) if per_col else (0, 1)
                mu = torch.amin(w, dim=dims, keepdim=True).reshape(1, -1)
                scale = ((torch.amax(w, dim=dims, keepdim=True)
                          .reshape(1, -1) - mu) / levels).clamp(min=1e-12)
                codes = torch.clamp(torch.round((w - mu) / scale), 0,
                                    levels).to(torch.uint8)
                if packed:
                    codes = ref.pack_int4_ref(codes)
                fn = qmatmul4_cuda if packed else qmatmul_cuda
                plain = ref.qmatmul4_ref if packed else ref.qmatmul_ref
                for m in (2, 128):
                    x = torch.randn(m, k, generator=g, device="cuda").to(
                        torch.bfloat16)
                    for out_dtype, tol_of in (
                            (torch.float32, lambda r: 1e-3),
                            (torch.bfloat16, lambda r: 2 ** -7 * r)):
                        got = fn(x, codes, scale.contiguous(),
                                 mu.contiguous(), out_dtype)
                        want = plain(x, codes, scale, mu, out_dtype)
                        torch.cuda.synchronize()
                        err = (got.float() - want.float()).abs().max().item()
                        tol = tol_of(want.float().abs().max().item())
                        emit({"check": name, "weight": wname, "m": m,
                              "k": k, "n": n, "per_column": per_col,
                              "out": str(out_dtype), "max_abs_err": err,
                              "tol": tol})
                        if not err <= tol:
                            raise AssertionError(
                                f"{name} {wname} m={m} per_col={per_col} "
                                f"{out_dtype}: max |err| {err} > {tol}")
                        if out_dtype == torch.bfloat16 and not per_col:
                            worst[name] = max(worst.get(name, 0.0), err)
        # timing: decode M on the MLP up-projection, per-tensor metadata
        # (the serving path's per-period-per-tensor structs), bf16 out
        k, n = shapes["w_up"]
        w = torch.randn(k, n, generator=g, device="cuda") * k ** -0.5
        mu, scale = w.min().reshape(1, 1), ((w.max() - w.min()) / levels
                                            ).reshape(1, 1)
        codes = torch.clamp(torch.round((w - mu) / scale), 0,
                            levels).to(torch.uint8)
        w_deq = (codes.float() * scale + mu).to(torch.bfloat16)
        if packed:
            codes = ref.pack_int4_ref(codes)
        x = torch.randn(2, k, generator=g, device="cuda").to(torch.bfloat16)
        fn = qmatmul4_cuda if packed else qmatmul_cuda
        plain = ref.qmatmul4_ref if packed else ref.qmatmul_ref
        ms = timer(lambda: fn(x, codes, scale, mu, torch.bfloat16))
        plain_ms = timer(lambda: plain(x, codes, scale, mu, torch.bfloat16))
        lib_ms = timer(lambda: torch.matmul(x, w_deq))
        b, by = bound_ms(nbytes(x, codes, scale, mu) + 2 * n * 2,
                         2 * 2 * k * n)
        records[name] = dict(max_abs_err=worst[name], ms=ms,
                             plain_ms=plain_ms, bound_ms=b, bound_by=by,
                             library_ms=lib_ms,
                             timed=f"x (2, {k}) bf16 @ codes ({k}, {n}), "
                                   "per-tensor, bf16 out")
        emit({"timing": name, **records[name]})


def check_decode_attention(torch, timer, records):
    """Bf16 and float8 caches, partially filled and wrapped rings, at the
    decode shapes of smollm-135m (B = 2, KVp = Gp = 4, hd = 64, ring of
    256 slots); timed on the float8 device cache at the last step of a
    32-token generation after a 64-token prompt."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.models.common import to_storage
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    b, kvp, gp, hd, buf = 2, 4, 4, 64, 256
    q = torch.randn(b, kvp, gp, hd, generator=g, device="cuda").to(
        torch.bfloat16)
    kv = torch.randn(2, b, buf, kvp, hd, generator=g, device="cuda")
    tol = 2e-2      # bf16 probabilities/values in the plain version
    worst = 0.0
    for dt in (torch.bfloat16, torch.float8_e4m3fn):
        ck, cv = to_storage(kv[0], dt), to_storage(kv[1], dt)
        for pos in (5, 95, buf - 1, buf + 40, 5 * buf + 3):
            got = decode_attention_cuda(q, ck, cv, pos)
            want = ref.decode_attention_ref(q, ck, cv, pos)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            emit({"check": "decode_attention", "cache": str(dt), "pos": pos,
                  "buf": buf, "max_abs_err": err, "tol": tol})
            if not err <= tol:
                raise AssertionError(f"decode attention {dt} pos={pos}: "
                                     f"max |err| {err} > {tol}")
            worst = max(worst, err)
    pos = 64 + 31
    ck, cv = (to_storage(kv[0], torch.float8_e4m3fn),
              to_storage(kv[1], torch.float8_e4m3fn))
    n_valid = pos + 1
    ms = timer(lambda: decode_attention_cuda(q, ck, cv, pos))
    plain_ms = timer(lambda: ref.decode_attention_ref(q, ck, cv, pos))
    qs = q.reshape(b, kvp * gp, 1, hd)
    ks = ck[:, :n_valid].to(torch.bfloat16).permute(0, 2, 1, 3)
    vs = cv[:, :n_valid].to(torch.bfloat16).permute(0, 2, 1, 3)
    ks = ks.repeat_interleave(gp, dim=1).contiguous()
    vs = vs.repeat_interleave(gp, dim=1).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = timer(lambda: sdpa(qs, ks, vs))
    live = 2 * b * n_valid * kvp * hd * ck.element_size()
    bnd, by = bound_ms(nbytes(q) * 2 + live, 4 * b * kvp * gp * n_valid * hd)
    records["decode_attention"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
        bound_by=by, library_ms=lib_ms,
        timed=f"B={b} KVp={kvp} Gp={gp} hd={hd}, float8 ring of {buf}, "
              f"pos {pos} ({n_valid} live slots)")
    emit({"timing": "decode_attention", **records["decode_attention"]})


def check_flash_attention(torch, timer, records, calib_batch, seq):
    """Causal GQA at the calibration shape (the calibration batch of
    ``seq`` tokens, KV = G = 4, hd = 64, bf16) and at a ragged length."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models.attention import _blocked_causal_attention
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    kvh, grp, hd = 4, 4, 64
    tol = 2e-2      # bf16 outputs; the plain version rounds p to bf16
    worst = 0.0
    for b, s in ((calib_batch, seq), (2, 100)):
        q = torch.randn(b, s, kvh, grp, hd, generator=g, device="cuda").to(
            torch.bfloat16)
        k = torch.randn(b, s, kvh, hd, generator=g, device="cuda").to(
            torch.bfloat16)
        v = torch.randn(b, s, kvh, hd, generator=g, device="cuda").to(
            torch.bfloat16)
        got = flash_attention_cuda(q, k, v)
        want = _blocked_causal_attention(q, k, v, s, s)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        emit({"check": "flash_attention", "b": b, "s": s, "max_abs_err": err,
              "tol": tol})
        if not err <= tol:
            raise AssertionError(f"flash attention b={b} s={s}: max |err| "
                                 f"{err} > {tol}")
        worst = max(worst, err)
        if (b, s) == (calib_batch, seq):
            timed = (q, k, v)
    q, k, v = timed
    b, s = q.shape[:2]
    ms = timer(lambda: flash_attention_cuda(q, k, v))
    plain_ms = timer(lambda: _blocked_causal_attention(q, k, v, s, s))
    qs = q.permute(0, 2, 3, 1, 4).reshape(b, kvh * grp, s, hd).contiguous()
    ks = k.permute(0, 2, 1, 3).repeat_interleave(grp, dim=1).contiguous()
    vs = v.permute(0, 2, 1, 3).repeat_interleave(grp, dim=1).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = timer(lambda: sdpa(qs, ks, vs, is_causal=True))
    pairs = s * (s + 1) // 2                   # causal (query, key) pairs
    bnd, by = bound_ms(nbytes(q, k, v) + nbytes(q),
                       4 * b * kvh * grp * pairs * hd)
    records["flash_attention"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
        bound_by=by, library_ms=lib_ms,
        timed=f"B={b} S={s} KV={kvh} G={grp} hd={hd} bf16, causal")
    emit({"timing": "flash_attention", **records["flash_attention"]})


def check_quantize(torch, timer, records):
    """quantize (8 and 4 bits), quantize_pack4 and dequantize (f32 and
    bf16 out) bit for bit against their plain versions on every stacked
    block leaf of full-width smollm-135m, per channel and per tensor, as
    ``quantize_stacked`` lays them out ((P * rows, N) with (P, N|1)
    metadata), and on a ragged (577, 1538); timed on the w_gate leaf."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.quantizer import stacked_grid
    from repro_torch.kernels import quantize as qk
    from repro_torch.kernels import ref
    cfg = get_config("smollm-135m")
    L, d, ff = cfg.num_layers, cfg.d_model, cfg.d_ff
    hd = cfg.resolved_head_dim()
    kvp, gp = cfg.padded_heads()
    leaves = {"wq": (L, d, kvp * gp, hd), "wk": (L, d, kvp, hd),
              "wv": (L, d, kvp, hd), "wo": (L, kvp * gp, hd, d),
              "w_gate": (L, d, ff), "w_up": (L, d, ff), "w_down": (L, ff, d),
              "ragged": (1, 577, 1538)}
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    worst = {"quantize": 0, "quantize_pack4": 0, "dequantize": 0.0}

    def held(name, got, want, **what):
        if name == "quantize_pack4":
            got, want = ref.unpack_int4_ref(got), ref.unpack_int4_ref(want)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        worst[name] = max(worst[name], err)
        cases[name] = cases.get(name, 0) + 1
        if err != 0:
            raise AssertionError(f"{name} {what}: max |err| {err} != 0")

    for wname, shape in leaves.items():
        leaf = torch.randn(shape, generator=g, device="cuda") * 0.05
        p, n = shape[0], shape[-1]
        flat = leaf.reshape(-1, n)
        cases = {}
        for per_channel in (True, False):
            for bits in (8, 4):
                meta = stacked_grid(leaf, bits, per_channel)
                s2 = meta["scale"].reshape(p, -1)
                m2 = meta["mu"].reshape(p, -1)
                what = dict(leaf=wname, shape=list(flat.shape),
                            per_channel=per_channel, bits=bits)
                codes = qk.quantize_cuda(flat, s2, m2, bits)
                held("quantize", codes, qk.quantize_plain(flat, s2, m2, bits),
                     **what)
                if bits == 4:
                    held("quantize_pack4", qk.quantize_pack4_cuda(flat, s2, m2),
                         qk.quantize_pack4_plain(flat, s2, m2), **what)
                for out in (torch.float32, torch.bfloat16):
                    held("dequantize", qk.dequantize_cuda(codes, s2, m2, out),
                         qk.dequantize_plain(codes, s2, m2, out), **what,
                         out=str(out))
        emit({"check": "quantize_kernels", "leaf": wname,
              "rows_n": list(flat.shape), "cases": cases, "tol": 0,
              "per_channel": [True, False], "bits": [8, 4],
              "dequantize_out": ["float32", "bfloat16"]})
    # timing: the w_gate leaf, per channel, as the launcher quantizes it
    leaf = torch.randn(leaves["w_gate"], generator=g, device="cuda") * 0.05
    x = leaf.reshape(-1, ff)
    meta8, meta4 = stacked_grid(leaf, 8), stacked_grid(leaf, 4)
    s8, m8 = meta8["scale"].reshape(L, -1), meta8["mu"].reshape(L, -1)
    s4, m4 = meta4["scale"].reshape(L, -1), meta4["mu"].reshape(L, -1)
    codes = qk.quantize_cuda(x, s8, m8, 8)
    timed = {
        "quantize": (lambda: qk.quantize_cuda(x, s8, m8, 8),
                     lambda: qk.quantize_plain(x, s8, m8, 8),
                     lambda: x.to(torch.uint8), nbytes(x, s8, m8, codes),
                     "uint8 codes"),
        "quantize_pack4": (lambda: qk.quantize_pack4_cuda(x, s4, m4),
                           lambda: qk.quantize_pack4_plain(x, s4, m4), None,
                           nbytes(x, s4, m4) + x.numel() // 2,
                           "packed int4"),
        "dequantize": (lambda: qk.dequantize_cuda(codes, s8, m8),
                       lambda: qk.dequantize_plain(codes, s8, m8),
                       lambda: codes.to(torch.bfloat16),
                       nbytes(codes, s8, m8) + 2 * codes.numel(),
                       "bf16 out")}
    for name, (fn, plain, cast, moved, out) in timed.items():
        ms, plain_ms = timer(fn), timer(plain)
        b, by = bound_ms(moved, 2 * x.numel(), F32_OPS_PER_S)
        records[name] = dict(
            max_abs_err=worst[name], ms=ms, plain_ms=plain_ms, bound_ms=b,
            bound_by=by, library_ms=None,
            timed=f"w_gate leaf ({x.shape[0]}, {ff}) f32, per-column "
                  f"({L}, {ff}) metadata, {out}")
        emit({"timing": name, **records[name], "bytes": moved,
              "same_bytes_cast_ms": timer(cast) if cast else None})


# ---------------------------------------------------------------------------
# Phase 4: the request loop

def cycle_batch(rng, vocab: int, n: int, seq: int):
    """Next-token task t[i+1] = (t[i] + 1) % V, as the repo's LM example."""
    start = rng.integers(0, vocab, size=(n, 1))
    toks = (start + np.arange(seq + 1)[None, :]) % vocab
    return toks[:, :seq].astype(np.int32), toks[:, seq].astype(np.int32)


def request_loop(torch, ops, calib_batch: int, seq: int):
    from repro_torch.configs.base import get_config
    from repro_torch.core.cost_model import (Channel, DeviceProfile,
                                             ObjectiveWeights)
    from repro_torch.core.solver import PartitionPlan
    from repro_torch.models import transformer as T
    from repro_torch.serving.backends import TransformerBackend
    from repro_torch.serving.decode import DecodeSession
    from repro_torch.serving.qpart_server import QPARTServer
    from repro_torch.serving.simulator import InferenceRequest

    cfg = get_config("smollm-135m")
    print(f"main path: {cfg.name} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} "
          f"padded={cfg.padded_heads()} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} dtype={cfg.dtype}", flush=True)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda")
    backend = TransformerBackend(cfg, params, seq_len=seq,
                                 decode_max_len=2 * seq)
    rng = np.random.default_rng(SEED)
    x_cal, y_cal = cycle_batch(rng, cfg.vocab_size, calib_batch, seq)
    x_te, y_te = cycle_batch(rng, cfg.vocab_size, 16, seq)
    prompt, _ = cycle_batch(rng, cfg.vocab_size, 2, seq // 2)
    srv = QPARTServer()
    srv.register("smollm", backend, x_cal, y_cal)
    phases = {}

    def run(name, fn):
        torch.cuda.synchronize()
        before = {k: f.launches for k, f in ops.KERNELS.items()}
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        phases[name] = {
            "s": time.perf_counter() - t0,
            "launches": {k: f.launches - before[k]
                         for k, f in ops.KERNELS.items()}}
        emit({"phase": name, **phases[name]})
        return out

    for f in ops.KERNELS.values():
        f.launches = 0
    run("calibrate", lambda: srv.calibrate("smollm"))
    m = srv.models["smollm"]
    print(f"  base accuracy {m.base_accuracy:.4f}, delta table "
          f"{m.delta_table}", flush=True)
    dev = DeviceProfile()
    contexts = [(Channel(capacity_bps=2e6), ObjectiveWeights(eta=1e7)),
                (Channel(capacity_bps=2e6), ObjectiveWeights()),
                (Channel(capacity_bps=2e8), ObjectiveWeights(eta=1e7))]
    ctxs = run("build_store", lambda: [srv.build_store("smollm", dev, ch, w)
                                       for ch, w in contexts])
    deps = []
    for ctx, (ch, w) in zip(ctxs, contexts):
        for a in (0.001, 0.01, 0.02):
            dep = srv.serve(InferenceRequest("smollm", a, dev, ch, w,
                                             segment_cached=True), ctx)
            deps.append(dep)
            emit({"serve": {"accuracy_budget": a, "eta": w.eta,
                            "capacity_bps": ch.capacity_bps,
                            "p": dep.plan.p,
                            "bits_w": [int(b) for b in dep.extra["bits_w"]],
                            "bits_x": float(dep.extra["bits_x"])}})
    dep = max(deps[:3], key=lambda d: d.plan.p)
    res = run("execute", lambda: dep.execute(x_te, y_te))
    emit({"execute": {"p": dep.plan.p, "accuracy": res.accuracy,
                      "accuracy_degradation": res.accuracy_degradation,
                      **res.extra["measured"]}})
    out = run("generate", lambda: dep.generate(prompt, 32))
    srv.record_execution(dep)
    srv.record_decode(dep)
    emit({"generate": {"p": dep.plan.p, "batch": int(out.tokens.shape[0]),
                       "new_tokens": out.new_tokens, "ttft_s": out.ttft_s,
                       "tokens_per_s": out.tokens_per_s,
                       "t_device_s": out.t_device_s,
                       "t_server_s": out.t_server_s,
                       "device_cache_bytes": out.device_cache_bytes,
                       "device_cache_dtype": out.device_cache_dtype,
                       "server_cache_bytes": out.server_cache_bytes}})
    if out.tokens.shape != (2, 32) or not (
            (out.tokens >= 0) & (out.tokens < cfg.vocab_size)).all():
        raise AssertionError(f"generate gave {out.tokens!r}")
    # a served plan that never quantizes to <= 4 (or to 5..8) bits leaves
    # one of the two matmul kernels unused: drive it with a fixed plan
    L = cfg.num_layers
    for name, bits in (("qmatmul", 8.0), ("qmatmul4", 4.0)):
        if ops.KERNELS[name].launches == 0:
            print(f"  no served plan ran {name}: one extra session on a "
                  f"fixed {int(bits)}-bit plan at p = {L // 2}", flush=True)
            plan = PartitionPlan(p=L // 2, bits_w=np.full(L // 2, bits),
                                 bits_x=bits, objective=0.0, psi_total=0.0,
                                 payload_bits=0.0, breakdown={})
            extra = run(f"generate_fixed_{int(bits)}bit",
                        lambda: DecodeSession(backend, plan,
                                              max_len=2 * seq).generate(
                                                  prompt, 8))
            emit({"generate_fixed": {"bits": bits, "p": plan.p,
                                     "tokens_per_s": extra.tokens_per_s,
                                     "device_cache_dtype":
                                         extra.device_cache_dtype}})
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in ops.KERNELS.items()}
    emit({"request_loop_launches": launches})
    return cfg, params, backend, launches, dep, prompt


def profile_decode(torch, dep, prompt, steps: int = 4):
    """Where a decode step's wall time goes: ``torch.profiler`` over
    ``steps`` steps of the served deployment's stream — device busy time
    (the sum of kernel/memcpy durations on the card), the idle share of
    the wall time, launches per step and the costliest kernels."""
    from torch.profiler import ProfilerActivity, profile
    sess = dep.decode_session()
    tok = sess.step(sess.prefill(prompt))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = sess.step(tok)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    emit({"decode_step_profile": {
        "p": dep.plan.p, "steps": steps, "wall_ms_per_step":
        wall_us / steps / 1e3, "device_busy_ms_per_step":
        busy_us / steps / 1e3, "idle_share": 1 - busy_us / wall_us
        if dev else None, "device_events_per_step": len(dev) / steps,
        "top_device_ms_per_step": {k[:60]: v / steps / 1e3
                                   for k, v in top}}})


def reference_check(torch, cfg, params, backend):
    """The kernels' forward against the plain versions on the CPU, on a
    small input at full width and depth: logits agree to bf16 accuracy
    through 30 layers (5% of the largest logit)."""
    from repro_torch.serving.backends import TransformerBackend
    from repro_torch.tree import tree_map
    cpu = TransformerBackend(cfg, tree_map(lambda t: t.cpu(), params),
                             seq_len=backend.seq_len)
    x, _ = cycle_batch(np.random.default_rng(SEED + 3), cfg.vocab_size, 2,
                       16)
    got = backend.forward(x).float().cpu()
    want = cpu.forward(x).float()
    live = slice(0, cfg.vocab_size)
    err = (got[:, live] - want[:, live]).abs().max().item()
    tol = 5e-2 * want[:, live].abs().max().item()
    same = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    emit({"reference_check": {"max_abs_err": err, "tol": tol,
                              "argmax_agreement": same,
                              "finite": bool(torch.isfinite(
                                  got[:, live]).all())}})
    if not (err <= tol and torch.isfinite(got[:, live]).all()):
        raise AssertionError(f"forward logits vs CPU plain versions: "
                             f"max |err| {err} > {tol}")


# ---------------------------------------------------------------------------
# Phase 5: the serving launcher

def launch_serve(torch, ops, batch: int = 4, prompt_len: int = 64,
                 gen: int = 32):
    """``repro_torch.launch.serve.run`` on full-width smollm-135m at
    --quant 0, 8 and 4, each run with the counters zeroed before and read
    after (its served-weight check included). Returns the launches of
    each run."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    cfg = get_config("smollm-135m")
    runs = {}
    for quant in (0, 8, 4):
        torch.cuda.synchronize()
        for f in ops.KERNELS.values():
            f.launches = 0
        out = serve.run(cfg, batch=batch, prompt_len=prompt_len, gen=gen,
                        quant=quant, device="cuda", seed=SEED)
        toks = out["tokens"]
        if toks.shape != (batch, gen) or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"launch --quant {quant} gave {toks!r}")
        quantize_launches = (ops.KERNELS["quantize"].launches
                             + ops.KERNELS["quantize_pack4"].launches)
        check = {}
        if quant:
            check = served_weights_check(torch, ops, out, quant)
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in ops.KERNELS.items()}
        runs[f"launch_q{quant}"] = launches
        emit({"launch_serve": {
            "arch": cfg.name, "layers": cfg.num_layers, "quant": quant,
            "batch": batch, "prompt_len": prompt_len, "gen": gen,
            "quantize_s": out["quantize_s"],
            "quantize_launches": quantize_launches,
            "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
            "decode_tokens_per_s": batch * (gen - 1) / out["decode_s"],
            "generate_s": out["generate_s"],
            "generate_tokens_per_s": batch * gen / out["generate_s"],
            "first_row": toks[0, :8].tolist(), **check,
            "launches": launches}})
        del out
    return runs


def served_weights_check(torch, ops, out, quant):
    """Every served leaf dequantized on the card through
    ``ops.dequantize_tensor`` (int4 unpacked by plain ops first) is
    within half a step of its weight; the card's quantized tree is byte
    for byte the one the plain versions build on the CPU."""
    from repro_torch.core.quantizer import quantize_params_for_serving
    from repro_torch.kernels import ref
    from repro_torch.tree import tree_leaves, tree_map
    params, weights = out["params"], out["weights"]
    worst, n = 0.0, 0
    for part in ("attn", "mlp"):
        for k, w in params["blocks"][0][part].items():
            if not ops.is_wire_struct(w):
                continue
            leaf = weights["blocks"][0][part][k]
            p, cols = leaf.shape[0], leaf.shape[-1]
            codes = w["codes"] if "codes" in w else \
                ref.unpack_int4_ref(w["codes_packed"]).to(torch.uint8)
            s2, m2 = w["scale"].reshape(p, -1), w["mu"].reshape(p, -1)
            deq = ops.dequantize_tensor(codes.reshape(-1, cols), s2, m2,
                                        torch.float32)
            rows = leaf.reshape(p, -1, cols)
            err = ((rows - deq.reshape(rows.shape)).abs()
                   / s2.reshape(p, 1, -1)).max().item()
            worst, n = max(worst, err), n + 1
    if n != 7 or not worst <= 0.5 + 1e-4:
        raise AssertionError(f"--quant {quant}: {n} served leaves, max "
                             f"|w - deq| / scale {worst} > 0.5 + 1e-4")
    t0 = time.perf_counter()
    plain = quantize_params_for_serving(tree_map(lambda t: t.cpu(), weights),
                                        quant)
    plain_s = time.perf_counter() - t0
    got, want = tree_leaves(params), tree_leaves(plain)
    differ = [i for i, (a, b) in enumerate(zip(got, want))
              if a.dtype != b.dtype or a.shape != b.shape
              or not torch.equal(a.cpu(), b)]
    same = len(got) == len(want) and not differ
    if not same:
        raise AssertionError(f"--quant {quant}: the card's quantized tree "
                             f"differs from the CPU plain build at leaves "
                             f"{differ} of {len(want)}")
    return {"served_leaves": n, "max_err_over_scale": worst,
            "tree_equals_cpu_plain": same, "cpu_plain_quantize_s": plain_s}


SOURCES = {"qmatmul": ("src/repro_torch/csrc/qmatmul.cu",
                       "src/repro/kernels/qmatmul.py:68"),
           "qmatmul4": ("src/repro_torch/csrc/qmatmul.cu",
                        "src/repro/kernels/qmatmul.py:118"),
           "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                "src/repro/kernels/decode_attention.py:127"),
           "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:98"),
           "quantize": ("src/repro_torch/csrc/quantize.cu",
                        "src/repro/kernels/quantize.py:80"),
           "quantize_pack4": ("src/repro_torch/csrc/quantize.cu",
                              "src/repro/kernels/quantize.py:127"),
           "dequantize": ("src/repro_torch/csrc/quantize.cu",
                          "src/repro/kernels/quantize.py:101")}

# the kernels each path's run must launch
EXPECTED = {"request_loop": ("qmatmul", "qmatmul4", "decode_attention",
                             "flash_attention"),
            "launch_q0": ("decode_attention", "flash_attention"),
            "launch_q8": ("quantize", "qmatmul", "dequantize",
                          "decode_attention", "flash_attention"),
            "launch_q4": ("quantize_pack4", "qmatmul4", "dequantize",
                          "decode_attention", "flash_attention")}


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the port's smoke run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for float32 matmuls and convolutions (plain versions "
          "compute in full f32)", flush=True)

    from repro_torch.kernels import build, ops
    t0 = time.perf_counter()
    out_dir = build.build_all()
    emit({"build": {"s": time.perf_counter() - t0,
                    "dir": str(out_dir.relative_to(ROOT))}})
    for name in build.KERNEL_SOURCES:
        log = (out_dir / f"{name}.log").read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                             log)]
        emit({"ptxas": name, "instantiations": len(regs),
              "max_registers": max(regs), "spill_store_bytes": sum(spills)})

    calib_batch, seq = 64, 128
    timer = Timer(torch)
    records = {}
    check_qmatmul(torch, timer, records)
    check_decode_attention(torch, timer, records)
    check_flash_attention(torch, timer, records, calib_batch, seq)
    check_quantize(torch, timer, records)
    del timer

    cfg, params, backend, loop_launches, dep, prompt = request_loop(
        torch, ops, calib_batch, seq)
    profile_decode(torch, dep, prompt)
    reference_check(torch, cfg, params, backend)
    del params, backend, dep
    runs = {"request_loop": loop_launches,
            **launch_serve(torch, ops)}

    missing = [f"{k} in {run}" for run, names in EXPECTED.items()
               for k in names if runs[run][k] == 0]
    launches = {k: sum(r[k] for r in runs.values()) for k in ops.KERNELS}
    missing += [k for k, n in launches.items() if n == 0]
    emit({"launches_by_run": runs, "launches": launches})
    if missing:
        raise AssertionError(f"kernels never launched: {missing}")

    print(smi, flush=True)
    kernels = []
    for name in ops.KERNELS:
        rec = records[name]
        source, replaces = SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                        "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
