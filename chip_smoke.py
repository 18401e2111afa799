#!/usr/bin/env python3
"""Drive the PyTorch/H100 port of QPART (``src/repro_torch``) on one card.

    python3 chip_smoke.py          # from the repository root, one GPU
    python3 chip_smoke.py --profile-launcher [--src OTHER/src]
    python3 chip_smoke.py --profile-tiled [--src OTHER/src]
    python3 chip_smoke.py --profile-flash [--src OTHER/src]
    python3 chip_smoke.py --profile-decode-attention [--src OTHER/src]
    python3 chip_smoke.py --profile-requests [--src OTHER/src]
    python3 chip_smoke.py --profile-forward [--src OTHER/src]
    python3 chip_smoke.py --profile-host-mesh
    python3 chip_smoke.py --profile-model-parallel
    python3 chip_smoke.py --profile-model-parallel-train
    python3 chip_smoke.py --profile-fsdp

Phases, each of which raises (and so exits non-zero) on any failure:

1. the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions; TF32 is switched off for the plain versions' matmuls;
2. build every CUDA kernel of the port from ``src/repro_torch/csrc``;
3. hold each kernel against its plain PyTorch version on the card at
   the main path's shapes (qmatmul/qmatmul4 at M = 2, 4, 32, 128 and 256
   on every projection, decode attention on the request loop's and the
   launcher's rings and a 2048-slot one, flash attention at the
   calibration shape and S = 100 in bf16 and once in f32, its row
   log-sum-exp and the backward kernels at the training shape (B 8, S
   256, hd 64 and 128, bf16) and S = 100 in bf16 and f32, quantize on a
   bf16 leaf as well; then at OLMoE-1B-7B's shapes: qmatmul / qmatmul4
   at K = N = 2048 and M = 4 / 256, flash attention at KV 16, G 1, hd
   128 (B 16 x S 128 and B 4 x S 64), decode attention there on a ring
   of 96, quantize on one expert period; the ring-shard variant of
   decode attention, out and row log-sum-exp, at smollm-135m's and
   chatglm3-6b's decode_32k shards on the pod mesh (chatglm3-6b's in bf16
   and float8: the tensor-core shard kernel) and at phase 9b's
   chatglm3-6b shard, its shards merged against the whole ring),
   with a second call bitwise equal to the first,
   and time kernel, plain version, the closest single PyTorch library
   call (a yardstick only — the port never calls it) and the card's
   lower bound for the same work. The Timer queues every rep behind a
   device sleep and reports the median and minimum of the event pairs,
   so a time is the card's and not the wrapper's host time, and the
   median over its floor (an empty launch); the tiled qmatmul route is
   timed on the MLP up- and down-projections at M = 32, 128 and 256. The
   build's ptxas report of the redesigned kernels (registers, spills, a
   spill fails the run), their dynamic shared memory, the ring-shard
   launch's resident CTAs per SM and clusters, before (CUDA cores) and
   after (tensor cores), and the SASS HMMA counts of the tensor-core
   kernels (flash forward and backward, tiled qmatmul, the ring-shard
   decode attention; one without HMMA fails the run) print first;
4. the request loop on smollm-135m at its registered shape (30 layers,
   d_model 576, 9/3 heads padded to 4 x 4 by tp_pad=16, d_ff 1536, vocab
   49152, bf16) with seeded random weights: register -> calibrate ->
   build_store (3 contexts) -> serve -> execute -> generate (and the
   deployment executed again before its stage times go into the
   ledger), with every kernel's launch counter zeroed before and read
   after; the forward family's block graphs then held to their
   ``forward_graphs=False`` twin on a copy of the backend with no graph
   (``forward_graphs_phase``: the calibration probes, the activations
   and suffixes at four starts, the deployment executed 4 times and
   every distinct served plan executed, bitwise with equal launches and
   one capture per block shape; the seconds of both and the block
   copy's ms beside the block's); a profile of
   the served stream's decode steps follows, eager and replayed as CUDA
   graphs in turns, then graphed sessions held to eager ones at p = 0,
   15 and 30 (tokens and logits bitwise, launches equal, at most 2
   captures), and a small input is checked against the plain versions
   on the CPU (its graphed forward bitwise its eager twin's);
5. the fleet engine (the paper's dynamic workload balancing) over the
   request loop's calibrated server: a seeded 200-stream Poisson trace
   (50 requests/s, 32 new tokens, budgets 0.001 / 0.01 / 0.02, deadlines
   0.5 / 1 / 2 s) on two default server profiles under EDF, priced
   analytically under SLO degrade and observe; up to four admitted
   deployments with distinct plans execute (twice: the second
   execution's stage times are the ones recorded) and generate on the
   card (counters zeroed before, read after), their stage times are fed to
   the calibration ledger, the fitted rates print, and the same trace is
   priced again from them; each run's summary, the cut points chosen
   and the engine's host wall time print. Then the fleet benchmark's two
   recipes on the host (1,200 requests, three servers, the four policies;
   the chaos run with faults and retries, its journal replayed);
6. the classifier loop: ``examples/torch_quickstart.py``'s stages on
   the card — the paper's MNIST MLP at full width trained by plain
   autograd, calibrate -> build_store -> serve (1% budget) -> execute,
   its degradation held to the quickstart's bound; its programs' CUDA
   graphs on a copy of the backend held to the ``forward_graphs=False``
   twin (``classifier_graphs``: ``calibrate_probes`` five times and the
   served deployment executed 4 times, bitwise, captures on a program's
   second use, the seconds of both); then the three baselines at the
   served cut, and a CIFAR CNN forward against the CPU (plain PyTorch:
   no kernel);
7. the decode session's features on the request loop's model at a fixed
   8-bit plan at p = L/2: plain, chunked prefill, speculative decode
   (2 and 4 drafts) and paged KV, and at p = L plain and 4 drafts (every
   draft accepted); each speculative run as a graphed session (its
   prefill chunks and rounds replayed as the backend's CUDA graphs) in 3
   turns and its ``graphs=False`` twin in the first, tokens/s medians
   and each
   stream's seconds split at its ``round_stream`` yields (prefill, first
   round at k, second, later rounds, tail), the graphed stream bitwise
   its twin (tokens, each round's drafts and verified tokens, both
   caches) with equal launches, capturing exactly the stage keys no
   earlier stream ran; speculative tokens bitwise plain, ``to_dense``
   bitwise the dense ring, chunked prefill within tolerance of the
   monolithic one, counters zeroed before each run; then the request
   series: QPART's request loop (``Deployment.generate``, a fresh
   session per request) on one backend, 4 requests each plain, chunked
   by 16, drafting 2 and 4, then 48-token requests and two concurrent
   sessions, each request bitwise its ``graphs=False`` twin with equal
   launches, from the second request of a shape on capturing nothing;
   one line per request (TTFT, tokens/s, captures, the split, peak
   memory);
8. the serving launcher (``repro_torch.launch.serve``) on the same
   full-width model, batch 4, 64-token prompts, 32 new tokens, once each
   at --quant 0, 8 and 4, its decode step replayed as one whole-model
   CUDA graph (the launcher's default on the card; 1 capture per run),
   counters zeroed before each run: quantize seconds, prefill seconds,
   decode tokens/s and launches per kernel; after a quantized run its
   served weights are dequantized through ``ops.dequantize_tensor``
   (|w - deq| <= scale / 2) and the tree is compared byte for byte with
   the one the plain versions build on the CPU; on each run's weights
   and prompt the graphed ``generate`` is held to ``graphs=False``
   (tokens and a replayed step's logits bitwise, launches equal, 1
   capture against 0), greedy at each --quant and sampled at --quant 8;
9. training (``repro_torch.launch.train``) on the same full-width model
   (bf16 activations, f32 masters), counters zeroed before each run: one
   loss backward of a 2-layer f32 copy on the card against the CPU's
   plain versions, leaf by leaf; one step at B 8 x S 256 with remat off
   and on (the same bits; the flash forward launched again under
   remat); ``launch.train.main`` for TRAIN_STEPS steps (exit 0: the loss
   improved) with its step and its token stream's sampler as CUDA
   graphs (one capture each; the flash kernels counted through the
   replays) and its checkpoint restored bit for bit; the graphed
   launcher held to its eager twin over TWIN_STEPS steps, remat off and
   on (metrics, params, moments and ``step`` bitwise, launches equal,
   peak allocated and reserved memory of each); the request loop on the
   trained weights (the Delta table, the plans' cut points and bits,
   which matmul kernels the served plans launched); a profile of the
   step, graphed and eager in turns (wall, device-busy, idle share,
   peak memory, the token stream's own time apart), and the sampler's
   ms graphed and eager in turns, its batches bitwise; then the host
   mesh (``host_mesh_phase``, ``repro_torch.launch.distributed``): the
   launcher at one rank over NCCL, graphed (a data axis of one: no
   collective in the step), bitwise the graphed twin above (metrics,
   params, moments, ``step``), its step profiled after WATCHDOG_CAPTURES
   captures each right after eager collectives; two ranks on this card
   over ``gloo`` (eager), their losses within MESH_LOSS_RTOL of one
   rank's and their parameters bitwise each other's; with two cards or
   more, one rank per card over NCCL, graphed, held the same way, each
   card's step wall and busy ms, all-reduce ms and GB and reserved GB
   (with one card, a line saying so); then (9b,
   ``model_parallel_phase``) the serving steps over the model axis
   (``launch.model_parallel``): with four cards one NCCL rank a card,
   else two ``gloo`` ranks on this card (four for chatglm3-6b),
   each holding its shards of seeded weights (``shard_tree``) and running
   ``launch.serve.generate`` over the axis: smollm-135m at full width, B
   4 x 64 and 16 new tokens at --quant 0, 8 and 4 (KV heads split),
   OLMoE-1B-7B expert-parallel with 8 new tokens, chatglm3-6b two layers
   deep at four ranks (its 72-slot ring split on its slots: the
   ring-shard decode attention; and its 71-slot ring, which does not
   split, held whole by each rank: row 3 over its KV head in place),
   each after its one-card twin, which is freed
   first; per rank the prefill's and last step's logits against the
   twin's (within MP_LOGIT_RTOL of its largest), the tokens' agreement,
   the eager step's wall ms, a profiled step's busy ms and NCCL's device
   ms, peak reserved GB and the launches per kernel (smollm-135m's
   cases generate 16 tokens since phase 9c came); then (9c,
   ``model_parallel_train_phase``) the train step over the model axis
   (``make_train_step(axis=, group=)``: Megatron's boundary operators
   in autograd, the vocab-parallel loss, the sharded global norm), f32
   masters and bf16 activations at B 8 x S 256, MP_TRAIN_STEPS eager
   steps (the last profiled), each case after its one-card twin, which
   is freed first:
   smollm-135m whole (KV heads split, its tied head over the vocab),
   chatglm3-6b two layers deep at four ranks (its replicated KV heads
   sliced: rows 4 and 4b at hd 128 over one KV head), OLMoE-1B-7B at 2 of
   16 layers expert-parallel (the twin phase 9d's one-card OLMoE shares);
   with four cards one NCCL rank a card at
   (1, 4), smollm-135m at (2, 2) and OLMoE-1B-7B whole (its twin the
   step-0 loss of ``make_eval_step``: 83 GB of state does not fit one
   card), else ``gloo`` ranks on this card at (1, 2) (chatglm3-6b at
   (1, 4)) and a line saying no four-card case ran; per rank each step's
   loss (within MESH_LOSS_RTOL) and ``grad_norm`` (MP_TRAIN_NORM_RTOL)
   against the twin's, each leaf's step-0 gradient against its shard of
   the twin's (relative L2 within MP_TRAIN_GRAD_RTOL; chatglm3-6b again
   in f32 activations, within MP_TRAIN_F32_GRAD_TOL of each shard's
   largest), each leaf's update against the twin's (reported), the
   replicated leaves' sha256 and the metrics bitwise across ranks, the
   launches (rows 4 and 4b on every rank), step wall ms, a profiled
   step's busy ms and NCCL's device ms, peak reserved GB, the spawn's
   seconds; then rows 4 and 4b at every signature the ranks launched
   against their plain versions (``check`` lines, ``"shape": "path"``);
   phase 9d (``fsdp_phase``; in the same spawns as 9c, cases of one
   world size together) the FSDP layout (``make_train_step(fsdp=)``,
   ``launch.model_parallel.Fsdp``): each rank holds its shards of
   ``param_pspecs(fsdp=True)`` and of the AdamW moments, each leaf
   gathered over the data axis where read and its gradient
   reduce-scattered back, remat on (but for the one-card (2, 1)), the
   update in place; on one card ``gloo`` ranks:
   smollm-135m at (2, 1) and (2, 2), OLMoE-1B-7B at 2 of 16 layers at
   (2, 1), and smollm-135m's prefill and 8 decode tokens at (2, 1)
   (``fsdp_serve``: each data rank's rows of the logits against phase
   9b's twin, within MP_LOGIT_RTOL); on four cards one NCCL rank a card:
   OLMoE-1B-7B whole at (4, 1) and (2, 2) (its twin the step-0 loss of
   ``make_eval_step``), smollm-135m at (2, 2) and (4, 1); held as phase
   9c's cases, the data-replicated leaves' sha256 per model index, each
   rank's all-gather and reduce-scatter GB a step
   (``CollectiveBytes``), its peak allocated and reserved GB;
10. the model zoo: every assigned arch at ``.reduced()`` in f32 on the
   card against the CPU's plain path (forward with its router aux,
   prefill, 4 decode steps; musicgen and qwen2-vl through ``embeds=``,
   qwen2-vl with M-RoPE triples); OLMoE-1B-7B at its registered shape
   (16 layers, d_model 2048, 16 heads of 128, 64 experts top-8, bf16
   activations, 27.7 GB of f32 masters): the request loop (calibration
   on 16 x 128 tokens, held to its eager twin, the block copy's ms
   beside the block's), its graphed forward in f32 against the CPU and
   its twin, decode sessions at a fixed 8-bit plan at p = 8
   with and without the quantized-kernel segment (bf16 tokens compared,
   f32 tokens equal; the graphed bf16 one bitwise its eager twin), then
   the launcher at --quant 0 and 8 (its
   served-weight check on the first and last period; graphed held to
   eager at --quant 8; its decode step profiled eager and graphed in
   turns at both, with the expert stacks' per-step casts timed alone);
   Mamba2-1.3B at its registered shape (48 SSD layers, d_inner 4096):
   the launcher at --quant 0, 8 and 4 (graphed held to eager at --quant
   4), the forward against the CPU (graphed, bitwise its eager twin),
   and a decode
   session at a fixed 8-bit plan at p = 24, graphed and bitwise its
   eager twin (only the quantize kernels
   run on this attention-free family), then QPART's request loop on it
   (``ring_series``: 4 fresh sessions on one backend at a 48-token
   prompt, the ring prefill's stage pair eager in request 1, captured
   in 2, replayed from 3 on, each request bitwise its ``graphs=False``
   twin with equal launches; TTFT and stage seconds of both); jamba's
   ring requests at its registered widths, two layers deep (an SSD and
   an attention + 16-expert MoE block), at p = 1 (``jamba_ring``:
   ``flash_attention`` inside the server prefill graph, the tiled
   qmatmul inside the device one); smollm-135m's ring requests with
   ``long_500k``'s 4096-token window under a 4608-token prompt at p =
   15 (``window_ring``: the windowed attention, both rings written
   whole, the device ring float8). Peak device memory per sub-phase. Then the zoo trained (``zoo_train_phase``, f32 masters):
   MusicGen-medium at its registered shape (48 layers, d_model 1536,
   fed through ``embeds=``) and OLMoE-1B-7B at full width and 4 of its
   16 layers (router losses in the loss), each 20 steps at B 8 x S 256
   (the loss falls, every gradient norm finite) through the donated
   step's CUDA graph, one f32 loss backward of its ``.reduced()``
   variant against the CPU leaf by leaf, a profile of the graphed step,
   an eager twin of its first three steps from the same seed (metrics
   and final state bitwise, peak reserved memory beside the graph's, its
   third step profiled; OLMoE: the MoE blocks' device ms), and
   ``launch.train.main`` on MusicGen-medium for 10 steps;
11. the step roofline (``roofline_phase``): the launcher's decode-step
   profile at --quant 8 and 0 (eager and graphed in turns on one cache
   state; the roofline reads the graphed step), then the dry run's count
   (``roofline.op_cost`` on fake tensors, no card) of the smoke's train
   step (phase 9's profile, remat off and on), of that decode step and
   of the zoo's two train steps (phase 10's profiles),
   each set against the device-busy and wall ms measured for it: one
   ``roofline`` line per step with the compute and memory terms at the
   card's data-sheet rates (``repro_torch/launch/mesh.py``, the source
   of the kernels' bound column too), their shares of the measured
   times and the MFU; a share over 1.05 fails the run;
12. the port's seven examples (``examples/torch_<name>.py``), each
   through its ``main`` with ``--device cuda`` at the reference's own
   sizes, its own asserts holding: one ``example`` line each with its
   seconds, key numbers and launches (counters zeroed before each); the
   fleet examples' stdout equal to a ``--device cpu`` run's, the
   classifier and fleet examples launching nothing,
   ``torch_quantized_lm_serving`` the flash forward, decode attention
   and the qmatmul kernel its plan picks, its f32 greedy tokens (a
   cycle task) the cycle's, ``torch_train_small_lm`` the flash forward
   and backward, its checkpoint restored bit for bit; each line with
   the captures of the example's graphed steps and token streams; then
   the MNIST MLP's SGD step graphed against ``graphs=False``, its
   weights bitwise;
13. the kernels at the shapes phases 10's training and 12 gave them
   (``check_path_shapes``): a ``ShapeLog`` in place of each attention
   and matmul wrapper kept every distinct signature of those runs
   (shapes, dtypes, options, decode positions), and each is replayed on
   seeded card tensors against the kernel's plain version with phase
   3's tolerances and a bitwise repeat. Every counted run also holds
   each ``ShapeLog``'s launches equal to its kernel's, so no launch
   goes around them; graph replays advance both (``ops.COUNTERS``).

``--profile-launcher`` runs only that profile (at --quant 8, 0 and 4),
and times the launcher's decode without a profiler (five runs per
--quant and mode, eager and graphed in turns; an earlier tree without
the graph, eager alone); ``--profile-tiled`` only
times the tiled qmatmul route over a sweep of shapes and profiles the
prefills that run it; ``--profile-flash`` only times the flash
forward's serving launch and the backward kernels at the training
shape (with SDPA's backward beside them and a digest of the float32
route's output bits) and profiles smollm-135m's train step and
``launch.train``; ``--profile-decode-attention`` only times decode
attention at the request loop's, the launcher's and a 2048-slot ring,
host-int and device-position launches, after a sha256 of the
kernel's outputs over a fixed set of launches
(``decode_attention_digest``: equal between trees, the same bits);
``--profile-requests`` only
times the request series (twice, without twins); ``--profile-forward``
only times QPART's calibration (three ``QPARTServer.calibrate`` calls on
one backend) and four executions each of the loop's deployment and of
p = 0 (``profile_forward``); ``--profile-host-mesh`` only runs the
host mesh's part of phase 9 (its one-rank twin run first);
``--profile-model-parallel`` only checks the ring-shard decode attention
and runs phase 9b; ``--profile-model-parallel-train`` only runs phase
9c; ``--profile-fsdp`` only runs phase 9d.
``--src`` imports the port
from another tree, so
that an earlier commit unpacked by ``git archive`` can be profiled in
the same call as this one.

After the last phase every kernel must have launched in the runs of the
paths that use it (the backward kernel in every training run, the
zoo's and the examples' included; the attention kernels, quantize and
qmatmul in the OLMoE runs; the ring-shard decode attention in phase 9b's
chatglm3-6b ranks; the flash forward and backward on every rank of
phases 9c and 9d), and the
tiled qmatmul route (counted by wrapping the wrappers, ``TiledRoute``)
in every prefill of the decode features, the quantized launchers and
the OLMoE session. The line before the last is the ``kernels`` JSON
record; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import hashlib
import importlib.util
import io
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0


@functools.cache
def h100():
    """The card's data-sheet rates (``PEAK_FLOPS_BF16``, ``PEAK_FLOPS_F32``,
    ``HBM_BW``): the port's ``launch/mesh.py`` of this checkout, the one
    source of the kernels' bound column and the step roofline, loaded by
    its path so that a ``--src`` tree without it still runs."""
    path = ROOT / "src" / "repro_torch" / "launch" / "mesh.py"
    spec = importlib.util.spec_from_file_location("h100_rates", path)
    mesh = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mesh          # its dataclass looks itself up
    spec.loader.exec_module(mesh)
    return mesh


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, ops: float, ops_per_s: float | None = None):
    t_bytes = nbytes / h100().HBM_BW * 1e3
    t_ops = ops / (ops_per_s or h100().PEAK_FLOPS_BF16) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


class Timer:
    """Device milliseconds of one call by CUDA events, median and minimum
    over ``reps`` calls after a warm-up, with the 50 MB L2 flushed before
    every call (the main path finds weights and caches cold).

    Every rep (a read of a 128 MB buffer that evicts L2 without leaving
    dirty lines, a start event, the call, an end event) is queued behind
    a ``torch.cuda._sleep`` that keeps the card busy until the host has
    queued all of them, so an event pair holds the call's device time and
    not the wrapper's host time. The result carries the host's enqueue
    time and the sleep's device time beside the times; the sleep is
    doubled and the measurement repeated while the host fell behind.
    Once ``floor_ms`` is set (the median of an empty launch), every result
    also carries ``ms_over_floor``, the median minus that floor."""

    SLEEP_CYCLES_PER_MS = 2_000_000    # ~the H100's 1.98 GHz boost clock

    def __init__(self, torch):
        self.torch = torch
        self.floor_ms = None
        self.flush = torch.zeros(32 << 20, dtype=torch.float32,
                                 device="cuda")
        self.flush.amax()           # load the reduction kernel once
        torch.cuda.synchronize()

    def __call__(self, fn, reps: int = 20) -> dict:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()            # host time of one rep, queued
        self.flush.amax()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        sleep_ms = max(2.0, 3 * reps * host_ms)
        for _ in range(4):
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(reps)]
            before, after = (torch.cuda.Event(enable_timing=True),
                             torch.cuda.Event(enable_timing=True))
            before.record()
            torch.cuda._sleep(int(sleep_ms * self.SLEEP_CYCLES_PER_MS))
            after.record()
            t0 = time.perf_counter()
            for start, end in ev:
                self.flush.amax()
                start.record()
                fn()
                end.record()
            enqueue_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            slept_ms = before.elapsed_time(after)
            if enqueue_ms < slept_ms:
                break
            sleep_ms *= 2
        times = [s.elapsed_time(e) for s, e in ev]
        out = {"ms": statistics.median(times), "ms_min": min(times),
               "reps": reps, "enqueue_ms": enqueue_ms,
               "sleep_ms": slept_ms, "queued_ahead": enqueue_ms < slept_ms}
        if self.floor_ms is not None:
            out["ms_over_floor"] = out["ms"] - self.floor_ms
        return out


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version

def quantized_weight(torch, g, k, n, levels, per_col):
    """A (K, N) weight ~ N(0, 1/K) on a per-tensor or per-column grid of
    ``levels`` steps: (codes uint8, scale, mu, bf16 dequantized weight)."""
    w = torch.randn(k, n, generator=g, device="cuda") * k ** -0.5
    dims = (0,) if per_col else (0, 1)
    mu = torch.amin(w, dim=dims, keepdim=True).reshape(1, -1)
    scale = ((torch.amax(w, dim=dims, keepdim=True).reshape(1, -1) - mu)
             / levels).clamp(min=1e-12)
    codes = torch.clamp(torch.round((w - mu) / scale), 0,
                        levels).to(torch.uint8)
    w_deq = (codes.float() * scale + mu).to(torch.bfloat16)
    return codes, scale.contiguous(), mu.contiguous(), w_deq


def check_qmatmul(torch, timer, records):
    """qmatmul (int8) and qmatmul4 (packed; both on the skinny split-K
    route at M <= 16, the tiled tensor-core route above) at every
    projection shape of a smollm-135m block, per tensor and per column, at
    decode M = 2 (the request loop) and 4 (the launcher), chunked prefill
    M = 32 (batch 2 x 16-token chunks) and prefill M = 128 (the plain
    session's batch 2 x 64) and 256 (the launcher's batch 4 x 64), each
    call repeated for bitwise equality; both timed beside ``matmul`` on
    the dequantized bf16 weight and the plain version, on the MLP
    up-projection at M = 2 and 4 and on the up- and down-projections at
    M = 32, 128 and 256."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.qmatmul import qmatmul4_cuda, qmatmul_cuda
    g = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = {"wq": (576, 1024), "wk": (576, 256), "wo": (1024, 576),
              "w_up": (576, 1536), "w_down": (1536, 576)}
    worst = {}
    for packed in (False, True):
        name = "qmatmul4" if packed else "qmatmul"
        levels = 15 if packed else 255
        fn = qmatmul4_cuda if packed else qmatmul_cuda
        plain = ref.qmatmul4_ref if packed else ref.qmatmul_ref
        for wname, (k, n) in shapes.items():
            for per_col in (False, True):
                codes, scale, mu, _ = quantized_weight(torch, g, k, n, levels,
                                                       per_col)
                if packed:
                    codes = ref.pack_int4_ref(codes)
                for m in (2, 4, 32, 128, 256):
                    x = torch.randn(m, k, generator=g, device="cuda").to(
                        torch.bfloat16)
                    for out_dtype, tol_of in (
                            (torch.float32, lambda r: 1e-3),
                            (torch.bfloat16, lambda r: 2 ** -7 * r)):
                        got = fn(x, codes, scale, mu, out_dtype)
                        again = fn(x, codes, scale, mu, out_dtype)
                        want = plain(x, codes, scale, mu, out_dtype)
                        torch.cuda.synchronize()
                        err = (got.float() - want.float()).abs().max().item()
                        tol = tol_of(want.float().abs().max().item())
                        same = bool(torch.equal(got, again))
                        emit({"check": name, "weight": wname, "m": m,
                              "k": k, "n": n, "per_column": per_col,
                              "out": str(out_dtype), "max_abs_err": err,
                              "tol": tol, "repeat_bitwise": same})
                        if not (err <= tol and same):
                            raise AssertionError(
                                f"{name} {wname} m={m} per_col={per_col} "
                                f"{out_dtype}: max |err| {err} > {tol} or "
                                f"a second call differs ({same})")
                        if out_dtype == torch.bfloat16 and not per_col:
                            worst[name] = max(worst.get(name, 0.0), err)
        # timing, per-tensor metadata (the serving path's per-period-per-
        # tensor structs), bf16 out: decode M on the MLP up-projection,
        # the tiled route on the up- and down-projections
        rec = {"tiled": {}}
        for wname, ms in (("w_up", (2, 4, 32, 128, 256)),
                          ("w_down", (32, 128, 256))):
            k, n = shapes[wname]
            codes, scale, mu, w_deq = quantized_weight(torch, g, k, n, levels,
                                                       False)
            if packed:
                codes = ref.pack_int4_ref(codes)
            for m in ms:
                x = torch.randn(m, k, generator=g, device="cuda").to(
                    torch.bfloat16)
                t = timer(lambda: fn(x, codes, scale, mu, torch.bfloat16))
                lib = timer(lambda: torch.matmul(x, w_deq))
                plain_t = timer(lambda: plain(x, codes, scale, mu,
                                              torch.bfloat16))
                b, by = bound_ms(nbytes(x, codes, scale, mu) + 2 * m * n,
                                 2 * m * k * n)
                row = dict(ms=t["ms"], ms_min=t["ms_min"],
                           ms_over_floor=t["ms_over_floor"], bound_ms=b,
                           bound_by=by, library_ms=lib["ms"],
                           library_ms_min=lib["ms_min"],
                           plain_ms=plain_t["ms"])
                if m == 2:
                    rec.update(max_abs_err=worst[name], **row,
                               timed=f"x (2, {k}) bf16 @ codes ({k}, {n}), "
                                     "per-tensor, bf16 out")
                elif m <= 16:
                    rec[f"m{m}"] = row
                else:
                    rec["tiled"][f"{wname} m{m}"] = {
                        **row, "over_library": t["ms"] / lib["ms"]}
                emit({"timing": name, "weight": wname, "m": m,
                      "route": "skinny" if m <= 16 else "tiled",
                      "kernel": t, "library": lib, "bound_ms": b,
                      "plain_ms": plain_t["ms"],
                      "ms_over_floor": t["ms_over_floor"]})
        records[name] = rec
        emit({"timing": name, **records[name]})


def check_zoo_kernels(torch, timer, records):
    """The kernels at OLMoE-1B-7B's shapes, which smollm-135m's path
    never gives them: qmatmul / qmatmul4 on the attention projections (K
    = N = 2048) at decode M = 4 (skinny route) and prefill M = 256 (tiled
    route), per tensor and per column, and with f32 x at M = 2, 4, 128
    and 256 (2e-5 of the largest output, as the GPU tests hold f32); flash attention at KV = 16, G = 1,
    hd = 128 at the calibration shape (B 16, S 128) and the launcher's
    prefill (B 4, S 64); decode attention at B 4, KVp 16, Gp 1, hd 128 on
    the launcher's bf16 ring of 96; quantize on one period of an expert
    stack (64, 2048, 1024) f32. Each against its plain version with the
    tolerances of the smollm checks, a second call bitwise the first,
    timed beside the library call and the card's bound; the rows land
    under ``olmoe`` in each kernel's record."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.qmatmul import qmatmul4_cuda, qmatmul_cuda
    from repro_torch.kernels.quantize import quantize_cuda, quantize_plain
    from repro_torch.models.attention import _blocked_causal_attention
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    k = n = 2048
    for packed in (False, True):
        name = "qmatmul4" if packed else "qmatmul"
        levels = 15 if packed else 255
        fn = qmatmul4_cuda if packed else qmatmul_cuda
        plain = ref.qmatmul4_ref if packed else ref.qmatmul_ref
        rows = {}
        for per_col in (False, True):
            codes, scale, mu, w_deq = quantized_weight(torch, g, k, n, levels,
                                                       per_col)
            if packed:
                codes = ref.pack_int4_ref(codes)
            for m in (2, 4, 128, 256):
                x32 = torch.randn(m, k, generator=g, device="cuda")
                # f32 x (the f32 activations of the MoE session's twin):
                # the same route split at M = 16, f32 sums in another order
                got = fn(x32, codes, scale, mu, torch.float32)
                want = plain(x32, codes, scale, mu, torch.float32)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                tol = 2e-5 * max(1.0, want.abs().max().item())
                emit({"check": name, "shape": "olmoe wq", "m": m, "k": k,
                      "n": n, "per_column": per_col, "x": "float32",
                      "out": "torch.float32", "max_abs_err": err,
                      "tol": tol})
                if not err <= tol:
                    raise AssertionError(f"{name} K=N=2048 m={m} f32 x: "
                                         f"max |err| {err} > {tol}")
                if m in (2, 128):
                    continue
                x = x32.to(torch.bfloat16)
                for out_dtype, tol_of in (
                        (torch.float32, lambda r: 1e-3),
                        (torch.bfloat16, lambda r: 2 ** -7 * r)):
                    got = fn(x, codes, scale, mu, out_dtype)
                    again = fn(x, codes, scale, mu, out_dtype)
                    want = plain(x, codes, scale, mu, out_dtype)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    tol = tol_of(want.float().abs().max().item())
                    same = bool(torch.equal(got, again))
                    emit({"check": name, "shape": "olmoe wq", "m": m, "k": k,
                          "n": n, "per_column": per_col,
                          "out": str(out_dtype), "max_abs_err": err,
                          "tol": tol, "repeat_bitwise": same})
                    if not (err <= tol and same):
                        raise AssertionError(
                            f"{name} K=N=2048 m={m} per_col={per_col} "
                            f"{out_dtype}: max |err| {err} > {tol} or a "
                            f"second call differs ({same})")
                if per_col:
                    continue
                t = timer(lambda: fn(x, codes, scale, mu, torch.bfloat16))
                lib = timer(lambda: torch.matmul(x, w_deq))
                plain_t = timer(lambda: plain(x, codes, scale, mu,
                                              torch.bfloat16))
                b, by = bound_ms(nbytes(x, codes, scale, mu) + 2 * m * n,
                                 2 * m * k * n)
                rows[f"m{m}"] = dict(
                    ms=t["ms"], ms_min=t["ms_min"],
                    ms_over_floor=t["ms_over_floor"], plain_ms=plain_t["ms"],
                    bound_ms=b, bound_by=by, library_ms=lib["ms"],
                    library_ms_min=lib["ms_min"],
                    over_library=t["ms"] / lib["ms"],
                    route="skinny" if m <= 16 else "tiled",
                    timed=f"x ({m}, {k}) bf16 @ codes ({k}, {n}), "
                          "per-tensor, bf16 out")
                emit({"timing": name, "shape": "olmoe wq", "m": m,
                      "kernel": t, "library": lib, "plain": plain_t,
                      "bound_ms": b})
        records[name]["olmoe"] = rows

    sdpa = torch.nn.functional.scaled_dot_product_attention
    kvh, grp, hd = 16, 1, 128
    rows = {}
    for b, s in ((16, 128), (4, 64)):
        q = torch.randn(b, s, kvh, grp, hd, generator=g, device="cuda").to(
            torch.bfloat16)
        kk = torch.randn(b, s, kvh, hd, generator=g, device="cuda").to(
            torch.bfloat16)
        v = torch.randn(b, s, kvh, hd, generator=g, device="cuda").to(
            torch.bfloat16)
        got = flash_attention_cuda(q, kk, v)
        again = flash_attention_cuda(q, kk, v)
        want = _blocked_causal_attention(q, kk, v, s, s)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        same = bool(torch.equal(got, again))
        emit({"check": "flash_attention", "shape": "olmoe", "b": b, "s": s,
              "kv": kvh, "g": grp, "hd": hd, "max_abs_err": err,
              "tol": 2e-2, "repeat_bitwise": same})
        if not (err <= 2e-2 and same):
            raise AssertionError(f"flash attention olmoe b={b} s={s}: max "
                                 f"|err| {err} or a second call differs")
        t = timer(lambda: flash_attention_cuda(q, kk, v))
        plain_t = timer(lambda: _blocked_causal_attention(q, kk, v, s, s))
        qs = q.permute(0, 2, 3, 1, 4).reshape(b, kvh * grp, s, hd)
        ks = kk.permute(0, 2, 1, 3).contiguous()
        vs = v.permute(0, 2, 1, 3).contiguous()
        qs = qs.contiguous()
        lib = timer(lambda: sdpa(qs, ks, vs, is_causal=True))
        pairs = s * (s + 1) // 2
        bnd, by = bound_ms(nbytes(q, kk, v) + nbytes(q),
                           4 * b * kvh * grp * pairs * hd)
        rows[f"b{b}_s{s}"] = dict(
            ms=t["ms"], ms_min=t["ms_min"], ms_over_floor=t["ms_over_floor"],
            plain_ms=plain_t["ms"], bound_ms=bnd, bound_by=by,
            library_ms=lib["ms"], library_ms_min=lib["ms_min"],
            over_library=t["ms"] / lib["ms"], max_abs_err=err,
            timed=f"B={b} S={s} KV={kvh} G={grp} hd={hd} bf16, causal")
        emit({"timing": "flash_attention", "shape": "olmoe", **rows[
            f"b{b}_s{s}"]})
    records["flash_attention"]["olmoe"] = rows

    b, buf = 4, 96
    q = torch.randn(b, kvh, grp, hd, generator=g, device="cuda").to(
        torch.bfloat16)
    ck = torch.randn(b, buf, kvh, hd, generator=g, device="cuda").to(
        torch.bfloat16)
    cv = torch.randn(b, buf, kvh, hd, generator=g, device="cuda").to(
        torch.bfloat16)
    worst = 0.0
    for pos in (0, 63, 94, 95, 96 + 30):
        got = decode_attention_cuda(q, ck, cv, pos)
        again = decode_attention_cuda(q, ck, cv, pos)
        want = ref.decode_attention_ref(q, ck, cv, pos)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        same = bool(torch.equal(got, again))
        emit({"check": "decode_attention", "shape": "olmoe", "b": b,
              "kvp": kvh, "gp": grp, "hd": hd, "buf": buf, "pos": pos,
              "max_abs_err": err, "tol": 2e-2, "repeat_bitwise": same})
        if not (err <= 2e-2 and same):
            raise AssertionError(f"decode attention olmoe pos={pos}: max "
                                 f"|err| {err} or a second call differs")
        worst = max(worst, err)
    pos = 64 + 30
    n_valid = pos + 1
    t = timer(lambda: decode_attention_cuda(q, ck, cv, pos))
    plain_t = timer(lambda: ref.decode_attention_ref(q, ck, cv, pos))
    qs = q.reshape(b, kvh * grp, 1, hd)
    ks = ck[:, :n_valid].permute(0, 2, 1, 3).contiguous()
    vs = cv[:, :n_valid].permute(0, 2, 1, 3).contiguous()
    lib = timer(lambda: sdpa(qs, ks, vs))
    bnd, by = bound_ms(nbytes(q) * 2 + 2 * b * n_valid * kvh * hd * 2,
                       4 * b * kvh * grp * n_valid * hd)
    records["decode_attention"]["olmoe"] = dict(
        ms=t["ms"], ms_min=t["ms_min"], ms_over_floor=t["ms_over_floor"],
        plain_ms=plain_t["ms"], bound_ms=bnd, bound_by=by,
        library_ms=lib["ms"], library_ms_min=lib["ms_min"],
        over_library=t["ms"] / lib["ms"], max_abs_err=worst,
        timed=f"B={b} KVp={kvh} Gp={grp} hd={hd}, bf16 ring of {buf}, pos "
              f"{pos} ({n_valid} live slots)")
    emit({"timing": "decode_attention", "shape": "olmoe",
          **records["decode_attention"]["olmoe"]})

    # one period of OLMoE's w_gate expert stack, per column as served
    leaf = torch.randn(64 * 2048, 1024, generator=g, device="cuda") * 0.02
    mu = torch.amin(leaf, dim=0, keepdim=True)
    scale = ((torch.amax(leaf, dim=0, keepdim=True) - mu) / 255).clamp(
        min=1e-12)
    got = quantize_cuda(leaf, scale, mu, 8)
    same = bool(torch.equal(got, quantize_cuda(leaf, scale, mu, 8)))
    exact = bool(torch.equal(got, quantize_plain(leaf, scale, mu, 8)))
    emit({"check": "quantize", "shape": "olmoe w_gate period (131072, "
          "1024) f32", "bitwise_plain": exact, "repeat_bitwise": same})
    if not (exact and same):
        raise AssertionError("quantize on an OLMoE expert period differs "
                             "from its plain version")
    t = timer(lambda: quantize_cuda(leaf, scale, mu, 8))
    plain_t = timer(lambda: quantize_plain(leaf, scale, mu, 8))
    bnd, by = bound_ms(nbytes(leaf, scale, mu) + got.numel(),
                       2 * leaf.numel(), h100().PEAK_FLOPS_F32)
    records["quantize"]["olmoe"] = dict(
        ms=t["ms"], ms_min=t["ms_min"], ms_over_floor=t["ms_over_floor"],
        plain_ms=plain_t["ms"], bound_ms=bnd, bound_by=by,
        timed="one period of OLMoE's w_gate (64 x 2048, 1024) f32, per "
              "column, 8 bits")
    emit({"timing": "quantize", "shape": "olmoe",
          **records["quantize"]["olmoe"]})
    del leaf, got


def profile_tiled(torch, timer):
    """The tiled route (M > 16) of qmatmul / qmatmul4 over a sweep of
    shapes (bf16 x, per-tensor metadata, bf16 out) beside ``matmul`` on
    the dequantized bf16 weight: K at N = 1536 and N at K = 576, both at
    M = 32, then M on the up- and down-projections. How the time scales
    with K, N and M says what bounds the route: a serial walk over K, too
    few CTAs for the card, or the work itself."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.qmatmul import qmatmul4_cuda, qmatmul_cuda
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cases = ([(32, k, 1536) for k in (64, 192, 576, 1536)]
             + [(32, 576, n) for n in (64, 256, 576, 4096)]
             + [(32, 1536, 576)]
             + [(m, k, n) for m in (64, 128, 256)
                for k, n in ((576, 1536), (1536, 576))])
    for packed in (False, True):
        name = "qmatmul4" if packed else "qmatmul"
        fn = qmatmul4_cuda if packed else qmatmul_cuda
        for m, k, n in cases:
            codes, scale, mu, w_deq = quantized_weight(
                torch, g, k, n, 15 if packed else 255, False)
            if packed:
                codes = ref.pack_int4_ref(codes)
            x = torch.randn(m, k, generator=g, device="cuda").to(
                torch.bfloat16)
            t = timer(lambda: fn(x, codes, scale, mu, torch.bfloat16))
            lib = timer(lambda: torch.matmul(x, w_deq))
            emit({"tiled_profile": name, "m": m, "k": k, "n": n,
                  "ms": t["ms"], "ms_min": t["ms_min"],
                  "ms_over_floor": t["ms_over_floor"],
                  "library_ms": lib["ms"], "over_library": t["ms"] / lib["ms"],
                  "host_ms_per_call": host_ms(
                      torch, lambda: fn(x, codes, scale, mu, torch.bfloat16)),
                  "library_host_ms_per_call": host_ms(
                      torch, lambda: torch.matmul(x, w_deq))})


def profile_flash(torch, timer):
    """The serving launch of the flash forward (no log-sum-exp) at the
    calibration shape (B 64, S 128) and the training shape (B 8, S 256),
    KV = G = 4, hd 64, bf16, and the backward kernels at the training
    shape (hd 64 and 128, bf16; device ms and the wrapper's host ms a
    call) beside SDPA's backward, on seeded inputs, with the ptxas report
    of the tree's flash entries, the digest of the float32 backward's
    output bits (``f32_bwd_digest``) and ``profile_train``: run once per
    tree, in turns, it compares parent and change on one card."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    for e in ptxas_entries(build.build_all(), {
            "flash_attention": ("flash_attn",),
            "flash_attention_bwd": ("dq_", "dkv_")}):
        emit({"ptxas_entry": e})
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for b, s in ((64, 128), (8, 256)):
        q = torch.randn(b, s, 4, 4, 64, generator=g, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn(b, s, 4, 64, generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        emit({"flash_profile": {"b": b, "s": s,
                                **timer(lambda: flash_attention_cuda(
                                    q, k, v), reps=50)}})
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    for hd in (64, 128):
        q, k, v, do = attn_grad_inputs(torch, g, 8, 256, hd, torch.bfloat16)
        out, lse = flash_attention_cuda(q, k, v, with_lse=True)
        emit({"flash_bwd_profile": {
            "b": 8, "s": 256, "hd": hd,
            "kernel": timer(lambda: flash_attention_bwd_cuda(
                q, k, v, out, lse, do), reps=50),
            "host_ms_per_call": host_ms(
                torch, lambda: flash_attention_bwd_cuda(q, k, v, out, lse,
                                                        do)),
            "library": timer(sdpa_backward(torch, q, k, v, do), reps=50)}})
    emit({"flash_bwd_f32_sha256": f32_bwd_digest(torch)})
    profile_train(torch)


def f32_bwd_digest(torch) -> str:
    """sha256 of the float32 backward's dq, dk and dv bytes on a fixed
    case (B 2, S 100, KV 4, G 4, hd 64; q, k, v, d_out from NumPy's
    generator seeded 19, in that order; out and lse from the f32
    forward): equal between trees, the route's bits are unchanged.
    ``tests/test_torch_cuda.py`` holds the same case to a digest."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    rng = np.random.default_rng(19)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).cuda() for shape in (
            (2, 100, 4, 4, 64), (2, 100, 4, 64), (2, 100, 4, 64),
            (2, 100, 4, 4, 64)))
    out, lse = flash_attention_cuda(q, k, v, with_lse=True)
    grads = flash_attention_bwd_cuda(q, k, v, out, lse, do)
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes()
                                   for t in grads)).hexdigest()


def decode_attention_digest(torch) -> str:
    """sha256 of ``decode_attention_cuda``'s output bytes over a fixed set
    of launches (NumPy's generator seeded 23: B 2 and 4, KVp 4 and 2, Gp 4
    and 16, hd 64 and 128, bf16 and float8 rings of 1, 96 and 2048 slots,
    bf16 and f32 queries, positions before, at and past the wrap, each
    from the host and from the card): equal between trees, the launch's
    bits are unchanged."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.models.common import to_storage
    rng = np.random.default_rng(23)
    h = hashlib.sha256()
    for b, kvp, gp, hd, buf, cache in (
            (2, 4, 4, 64, 96, torch.bfloat16),
            (4, 2, 16, 128, 2048, torch.bfloat16),
            (2, 4, 4, 64, 2048, torch.float8_e4m3fn),
            (4, 4, 4, 64, 1, torch.bfloat16)):
        q = torch.from_numpy(rng.standard_normal(
            (b, kvp, gp, hd), dtype=np.float32)).cuda()
        kv = torch.from_numpy(rng.standard_normal(
            (2, b, buf, kvp, hd), dtype=np.float32)).cuda()
        ck, cv = to_storage(kv[0], cache), to_storage(kv[1], cache)
        for qt in (q, q.to(torch.bfloat16)):
            for pos in sorted({0, buf // 3, buf - 1, buf + 5, 7 * buf + 2}):
                for p in (pos, torch.tensor(pos, device="cuda")):
                    h.update(decode_attention_cuda(qt, ck, cv, p).cpu()
                             .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def profile_train(torch):
    """smollm-135m's train step at B 8 x S 256 on seeded weights:
    ``train_step_profile`` over 20 steps, then ``launch.train.main`` for
    TRAIN_STEPS steps (no checkpoint) and its wall seconds, the token
    stream included."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train as train_launch
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import init_opt_state
    cfg = get_config("smollm-135m")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED + 7), device="cuda")
    train_step_profile(
        torch, cfg, [params, init_opt_state(params)],
        lambda: stream_batch(torch, cfg.vocab_size, 8, 256, SEED + 11),
        steps=20)
    del params
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = train_launch.main(["--steps", str(TRAIN_STEPS), "--batch", "8",
                            "--seq", "256"])
    torch.cuda.synchronize()
    emit({"train_launch": {"rc": rc, "steps": TRAIN_STEPS,
                           "wall_s": time.perf_counter() - t0}})


def attn_grad_inputs(torch, g, b, s, hd, dt, kvh=4, grp=4):
    """Seeded q, k, v and d_out (B, S, KV, G, hd / B, S, KV, hd) in ``dt``."""
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dt)
                 for shape in ((b, s, kvh, grp, hd), (b, s, kvh, hd),
                               (b, s, kvh, hd), (b, s, kvh, grp, hd)))


def sdpa_backward(torch, q, k, v, do):
    """SDPA's backward alone on the grouped inputs (``torch.autograd.grad``
    on a retained graph, K/V repeated per head): a yardstick only, the
    port never calls it."""
    b, s, kvh, grp, hd = q.shape
    leaves = [t_.contiguous().requires_grad_(True) for t_ in (
        q.permute(0, 2, 3, 1, 4).reshape(b, kvh * grp, s, hd),
        k.permute(0, 2, 1, 3).repeat_interleave(grp, dim=1),
        v.permute(0, 2, 1, 3).repeat_interleave(grp, dim=1))]
    o = torch.nn.functional.scaled_dot_product_attention(*leaves,
                                                         is_causal=True)
    dos = do.permute(0, 2, 3, 1, 4).reshape(b, kvh * grp, s, hd).contiguous()
    return lambda: torch.autograd.grad(o, leaves, dos, retain_graph=True)


def host_ms(torch, fn, calls: int = 200) -> float:
    """Host milliseconds per call of ``fn`` over ``calls`` calls in a row,
    queued behind a device sleep so that the host never waits for the
    card: the wrapper's and the launch's own cost."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(50 * Timer.SLEEP_CYCLES_PER_MS))
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return dt


class TiledRoute:
    """A stand-in for one of ``ops``' qmatmul wrappers: it passes every
    call through and counts, in ``launches``, the launches whose x has
    more than 16 rows (the tiled route)."""

    def __init__(self, fn):
        self.fn, self.launches = fn, 0

    def __call__(self, x, *args, **kwargs):
        before = self.fn.launches
        out = self.fn(x, *args, **kwargs)
        if x.shape[0] > 16:
            self.launches += self.fn.launches - before
        return out


# launches of qmatmul / qmatmul4 that took the tiled route, per run
TILED = {}


def count_tiled_route(ops) -> None:
    """Put a ``TiledRoute`` in place of ``ops``' qmatmul / qmatmul4
    wrappers, through which every path reaches the kernels; its counter
    is zeroed and read with the kernels' own (``counters``)."""
    for attr, name in (("qmatmul_cuda", "qmatmul"),
                       ("qmatmul4_cuda", "qmatmul4")):
        TILED[f"{name}_tiled"] = TiledRoute(getattr(ops, attr))
        setattr(ops, attr, TILED[f"{name}_tiled"])
        ops.watch_counter(TILED[f"{name}_tiled"])     # graph replays


class ShapeLog:
    """A stand-in for a kernel wrapper where the models reach it (a
    module global of ``ops`` or of ``kernels/flash_attention.py``): it
    passes every call through, counts in ``passed`` the calls that
    launched ``kernel``, and while ``on`` keeps each distinct signature
    of those calls (``signature``: shapes, dtypes, options) with the
    decode positions it was called at (none for a call that a CUDA graph
    captures with the position on the card: the stream's eager first
    step has the same signature). ``passed`` is one of ``ops.COUNTERS``,
    so graph replays advance it as they advance the kernel's.
    ``check_path_shapes`` replays every kept signature against the
    kernel's plain version."""

    def __init__(self, name, fn, kernel):
        self.name, self.fn, self.kernel = name, fn, kernel
        self.passed, self.on, self.seen = 0, False, {}

    @property
    def launches(self):
        return self.kernel.launches

    @launches.setter
    def launches(self, n):
        # a wrapper's own ``launches += 1`` lands here when it looks its
        # name up in the module where this stand-in replaced it
        self.kernel.launches = n

    def __call__(self, *args, **kwargs):
        before = self.kernel.launches
        out = self.fn(*args, **kwargs)
        if self.kernel.launches == before:
            return out
        self.passed += 1
        if self.on:
            sig, pos = signature(self.name, args, kwargs)
            self.seen.setdefault(sig, set()).update(pos)
        return out


def signature(name, args, kwargs):
    """(the signature of one launch of kernel ``name``, the positions of a
    decode call)."""
    dt = lambda t: (tuple(t.shape), str(t.dtype)[6:])  # noqa: E731
    if name in ("qmatmul", "qmatmul4"):
        x, codes, scale = args[:3]
        out = args[4] if len(args) > 4 else kwargs.get("out_dtype")
        return (dt(x), tuple(codes.shape), scale.numel() > 1,
                str(out)[6:] if out is not None else "bfloat16"), ()
    if name == "decode_attention":
        q, ck, _, pos = args[:4]    # one card logs no head block (kv0)
        if not isinstance(pos, int):    # a position tensor on the card:
            import torch                # unreadable while a graph captures
            if torch.cuda.is_current_stream_capturing():
                return (dt(q), dt(ck)), ()
        return (dt(q), dt(ck)), (int(pos),)
    q, k = args[:2]
    if name == "flash_attention_bwd":
        return (dt(q), tuple(k.shape)), ()
    with_lse = bool(args[3] if len(args) > 3 else kwargs.get("with_lse"))
    return (dt(q), tuple(k.shape), with_lse), ()


# the stand-ins, by kernel (``log_shapes``)
SHAPES = {}


def log_shapes(ops) -> None:
    """Put a ``ShapeLog`` in place of each attention and matmul wrapper
    where the port calls it: ``ops``' qmatmul / qmatmul4 (over the tiled
    route's counter) and decode attention, and the flash forward and
    backward in ``kernels/flash_attention.py``, which ``ops`` and
    ``FlashAttention`` call. ``read_counters`` holds each one's launches
    to its kernel's, so a launch that goes around it fails the run."""
    from repro_torch.kernels import flash_attention as fa
    for name, mod, attr in (
            ("qmatmul", ops, "qmatmul_cuda"),
            ("qmatmul4", ops, "qmatmul4_cuda"),
            ("decode_attention", ops, "decode_attention_cuda"),
            ("flash_attention", fa, "flash_attention_cuda"),
            ("flash_attention_bwd", fa, "flash_attention_bwd_cuda")):
        SHAPES[name] = ShapeLog(name, getattr(mod, attr), ops.KERNELS[name])
        setattr(mod, attr, SHAPES[name])
        ops.watch_counter(SHAPES[name], "passed")     # graph replays


def counters(ops) -> dict:
    """Every launch counter: the kernels' wrappers and the tiled route's."""
    return {**ops.KERNELS, **TILED}


def zero_counters(torch, ops) -> None:
    torch.cuda.synchronize()
    for f in counters(ops).values():
        f.launches = 0
    for log in SHAPES.values():
        log.passed = 0


def read_counters(torch, ops) -> dict:
    """Every counter (``counters``); fails if a ``ShapeLog`` passed on
    fewer launches than its kernel made."""
    torch.cuda.synchronize()
    out = {k: f.launches for k, f in counters(ops).items()}
    around = {k: (out[k], log.passed) for k, log in SHAPES.items()
              if log.passed != out[k]}
    if around:
        raise AssertionError(f"launches that went around the shape logs "
                             f"(kernel, log): {around}")
    return out


def check_decode_attention(torch, timer, records):
    """Bf16 and float8 caches, partially filled and wrapped rings, at the
    decode shapes of smollm-135m: the request loop's (B = 2, KVp = Gp = 4,
    hd = 64, ring of 256 slots) and the launcher's (B = 4, bf16 ring of
    96), and a 2048-slot ring that runs 16 CTAs per head past 512 live
    slots and at most 8 of its 16 below; every call repeated for bitwise
    equality. At every case the position read by the kernel from an
    int64 tensor on the card (the launch the decode step's CUDA graphs
    replay) gives the host-int launch's bits, and the plain version with
    the tensor its int call's bits. Timed on the request loop's float8
    device cache at the last step of a 32-token generation after a
    64-token prompt, on the launcher's bf16 cache at its last step, and
    on the 2048-slot bf16 ring at 301 live slots: the device-position and
    the host-int launch side by side, beside SDPA with K/V repeated per
    head."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.models.common import to_storage
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    kvp, gp, hd = 4, 4, 64
    tol = 2e-2      # bf16 probabilities/values in the plain version
    worst = 0.0
    cases = (  # (B, ring slots, cache dtypes, positions)
        (2, 256, (torch.bfloat16, torch.float8_e4m3fn),
         (5, 95, 255, 256 + 40, 5 * 256 + 3)),
        (4, 96, (torch.bfloat16,), (0, 63, 94, 95, 96 + 30)),
        (2, 2048, (torch.bfloat16, torch.float8_e4m3fn),
         (31, 300, 511, 512, 1000, 2047, 3 * 2048 + 7)))
    timed = {}
    for b, buf, dtypes, positions in cases:
        q = torch.randn(b, kvp, gp, hd, generator=g, device="cuda").to(
            torch.bfloat16)
        kv = torch.randn(2, b, buf, kvp, hd, generator=g, device="cuda")
        for dt in dtypes:
            ck, cv = to_storage(kv[0], dt), to_storage(kv[1], dt)
            timed[(b, buf, dt)] = (q, ck, cv)
            for pos in positions:
                pos_t = torch.tensor(pos, dtype=torch.int64, device="cuda")
                got = decode_attention_cuda(q, ck, cv, pos)
                again = decode_attention_cuda(q, ck, cv, pos)
                on_card = decode_attention_cuda(q, ck, cv, pos_t)
                want = ref.decode_attention_ref(q, ck, cv, pos)
                want_t = ref.decode_attention_ref(q, ck, cv, pos_t)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                same = bool(torch.equal(got, again))
                dev_same = bool(torch.equal(on_card, got))
                plain_same = bool(torch.equal(want_t, want))
                emit({"check": "decode_attention", "b": b, "cache": str(dt),
                      "pos": pos, "buf": buf, "max_abs_err": err, "tol": tol,
                      "repeat_bitwise": same,
                      "device_pos_bitwise_host_int": dev_same,
                      "plain_tensor_pos_bitwise_int": plain_same})
                if not (err <= tol and same and dev_same and plain_same):
                    raise AssertionError(
                        f"decode attention b={b} {dt} buf={buf} pos={pos}: "
                        f"max |err| {err} > {tol}, or a second call differs "
                        f"({same}), or the device position's launch "
                        f"({dev_same}) or plain call ({plain_same}) differs "
                        f"from the host int's")
                worst = max(worst, err)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rec = {}
    for b, buf, dt, pos, key in (
            (2, 256, torch.float8_e4m3fn, 64 + 31, None),   # request loop
            (4, 96, torch.bfloat16, 64 + 30, "b4_bf16"),    # launcher
            (2, 2048, torch.bfloat16, 300, "ring2048_bf16")):
        q, ck, cv = timed[(b, buf, dt)]
        n_valid = pos + 1
        pos_t = torch.tensor(pos, dtype=torch.int64, device="cuda")
        t_host = timer(lambda: decode_attention_cuda(q, ck, cv, pos))
        t = timer(lambda: decode_attention_cuda(q, ck, cv, pos_t))
        qs = q.reshape(b, kvp * gp, 1, hd)
        ks = ck[:, :n_valid].to(torch.bfloat16).permute(0, 2, 1, 3)
        vs = cv[:, :n_valid].to(torch.bfloat16).permute(0, 2, 1, 3)
        ks = ks.repeat_interleave(gp, dim=1).contiguous()
        vs = vs.repeat_interleave(gp, dim=1).contiguous()
        lib = timer(lambda: sdpa(qs, ks, vs))
        live = 2 * b * n_valid * kvp * hd * ck.element_size()
        bnd, by = bound_ms(nbytes(q) * 2 + live,
                           4 * b * kvp * gp * n_valid * hd)
        what = (f"B={b} KVp={kvp} Gp={gp} hd={hd}, {str(dt)[6:]} ring of "
                f"{buf}, pos {pos} ({n_valid} live slots)")
        emit({"timing": "decode_attention", "timed": what,
              "kernel_device_pos": t, "kernel_host_int": t_host,
              "library": lib, "bound_ms": bnd,
              "ms_over_floor": t["ms_over_floor"]})
        row = dict(ms=t["ms"], ms_min=t["ms_min"],
                   ms_over_floor=t["ms_over_floor"],
                   host_int_ms=t_host["ms"],
                   host_int_ms_min=t_host["ms_min"], bound_ms=bnd,
                   library_ms=lib["ms"], library_ms_min=lib["ms_min"],
                   timed=what)
        if key is None:
            plain_t = timer(lambda: ref.decode_attention_ref(q, ck, cv,
                                                             pos_t))
            rec.update(max_abs_err=worst, plain_ms=plain_t["ms"],
                       bound_by=by, **row)
        else:
            rec[key] = row
    records["decode_attention"] = rec
    emit({"timing": "decode_attention", **records["decode_attention"]})


def check_decode_attention_shard(torch, timer, records):
    """The ring-shard variant of decode attention (the model-parallel rank
    program's ring split on its slots) against its plain version, out
    and row log-sum-exp: at smollm-135m's decode_32k shard on the pod
    mesh (B 8, KVp 4, Gp 4, hd 64, slots [slot0, slot0 + 2048) of a
    32,768-slot bf16 ring), chatglm3-6b's there (KVp 2, Gp 16, hd 128),
    and the shard the phase's chatglm3-6b run gives each of its 4 ranks
    (B 4, 18 of 72 slots), and chatglm3-6b's pod shard again in float8
    (the tensor-core route's other cache dtype); at each, shards partly
    live, wholly live, past
    the position (zeros and -inf) and on a wrapped ring, the position
    from the host and from the card, every call repeated for bitwise
    equality; one shard of each ring merged with the others
    (``attention.combine_shards``) against ``decode_attention_ref`` on
    the whole ring. Out and lse are f32 on both sides, so each is held
    within 1e-4 of its largest magnitude (at least 1), as the f32 checks
    are (the tensor-core route's hi/lo products keep the f32 query and
    probabilities to ~2^-17); the error reported is the absolute one.
    Then row 3's launch over
    a block of the KV heads of a whole ring (the ring every rank holds
    where its slots do not split, read at ``kv0``), at chatglm3-6b's
    rank shape at 4 ranks over a 71-slot ring (one KV head of two, 8 of
    its 16 queries): bitwise the launch over a copy of the block, and
    within row 3's tolerance of the plain version. Timed on the two pod
    shards wholly live (chatglm3-6b's in bf16 and float8), beside SDPA's
    flash route with its LSE
    (``_scaled_dot_product_flash_attention`` on K/V repeated per head:
    the yardstick, which the port never calls)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_shard_cuda)
    from repro_torch.models.attention import combine_shards
    from repro_torch.models.common import to_storage
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rtol = 1e-4    # f32 out and lse on both sides, over their largest

    def held(got, want):
        """(max |got - want|, its limit: rtol x max(1, max |want|)), over
        the finite entries of ``want``."""
        live = torch.isfinite(want)
        got, want = torch.where(live, got, 0), torch.where(live, want, 0)
        return ((got - want).abs().max().item(),
                rtol * max(1.0, want.abs().max().item()))

    worst = 0.0
    bf16, f8 = torch.bfloat16, torch.float8_e4m3fn
    cases = (  # (name, B, KVp, Gp, hd, shard slots, ring, positions, cache)
        ("smollm_pod", 8, 4, 4, 64, 2048, 32768,
         (100, 2047 + 2048 * 3 + 17, 32767, 32768 + 5000), bf16),
        ("chatglm3_pod", 8, 2, 16, 128, 2048, 32768,
         (100, 2047 + 2048 * 3 + 17, 32767, 32768 + 5000), bf16),
        ("chatglm3_smoke", 4, 2, 16, 128, 18, 72, (63, 64, 70, 71), bf16),
        ("chatglm3_pod_f8", 8, 2, 16, 128, 2048, 32768,
         (100, 2047 + 2048 * 3 + 17, 32767, 32768 + 5000), f8))
    timed = {}
    for name, b, kvp, gp, hd, n, ring, positions, cache in cases:
        q = torch.randn(b, kvp, gp, hd, generator=g, device="cuda").to(
            torch.bfloat16).float()
        kv = to_storage(torch.randn(2, b, ring, kvp, hd, generator=g,
                                    device="cuda"), cache)
        for slot0 in sorted({0, n, ring - n}):
            ck = kv[0, :, slot0:slot0 + n].contiguous()
            cv = kv[1, :, slot0:slot0 + n].contiguous()
            timed[(name, slot0)] = (q, ck, cv, n, ring)
            for pos in positions:
                pos_t = torch.tensor(pos, dtype=torch.int64, device="cuda")
                out, lse = decode_attention_shard_cuda(q, ck, cv, pos, slot0,
                                                       ring)
                again = decode_attention_shard_cuda(q, ck, cv, pos, slot0,
                                                    ring)
                on_card = decode_attention_shard_cuda(q, ck, cv, pos_t,
                                                      slot0, ring)
                w_out, w_lse = ref.decode_attention_shard_ref(q, ck, cv, pos,
                                                              slot0, ring)
                torch.cuda.synchronize()
                live = torch.isfinite(w_lse)
                (err_o, tol_o), (err_l, tol_l) = held(out, w_out), \
                    held(lse, w_lse)
                same = all(torch.equal(a, c) for a, c in zip(
                    (out, lse), again)) and all(torch.equal(a, c) for a, c
                                                in zip((out, lse), on_card))
                empty_ok = bool(torch.equal(torch.isfinite(lse), live)) and \
                    bool(torch.all(out[~live] == 0))
                emit({"check": "decode_attention_shard", "case": name,
                      "cache": str(cache)[6:],
                      "slot0": slot0, "pos": pos, "shard": n, "ring": ring,
                      "live_rows": int(live.sum()),
                      "out_max_abs_err": err_o, "out_tol": tol_o,
                      "lse_max_abs_err": err_l, "lse_tol": tol_l,
                      "repeat_and_device_pos_bitwise": same,
                      "empty_rows_zero_and_minus_inf": empty_ok})
                if not (err_o <= tol_o and err_l <= tol_l and same
                        and empty_ok):
                    raise AssertionError(f"decode attention shard {name} "
                                         f"slot0={slot0} pos={pos}: out err "
                                         f"{err_o} (tol {tol_o}), lse err "
                                         f"{err_l} (tol {tol_l}), bitwise "
                                         f"{same}, empty rows {empty_ok}")
                worst = max(worst, err_o, err_l)
        # every shard of the ring, merged, against the whole ring
        pos = positions[1]
        parts = [decode_attention_shard_cuda(
            q, kv[0, :, r:r + n].contiguous(), kv[1, :, r:r + n].contiguous(),
            pos, r, ring) for r in range(0, ring, n)]
        merged = combine_shards(torch.stack([p[0] for p in parts]),
                                torch.stack([p[1] for p in parts]))
        whole = ref.decode_attention_ref(q, kv[0], kv[1], pos)
        err, tol = held(merged, whole)
        emit({"check": "decode_attention_shard_merge", "case": name,
              "pos": pos, "shards": len(parts), "max_abs_err": err,
              "tol": tol})
        if not err <= tol:
            raise AssertionError(f"merged shards of {name}: {err} > {tol}")
        worst = max(worst, err)
    # row 3 over a block of a whole ring's KV heads, read in place
    b, kvc, gp, hd, buf = 4, 2, 8, 128, 71
    q = torch.randn(b, 1, gp, hd, generator=g, device="cuda").to(
        torch.bfloat16)
    kv = torch.randn(2, b, buf, kvc, hd, generator=g, device="cuda").to(
        torch.bfloat16)
    for kv0 in range(kvc):
        for pos in (40, 70, 71 + 9):
            got = decode_attention_cuda(q, kv[0], kv[1], pos, kv0)
            block = [t[:, :, kv0:kv0 + 1].contiguous() for t in kv]
            copy = decode_attention_cuda(q, *block, pos)
            want = ref.decode_attention_ref(q, *block, pos)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            same = bool(torch.equal(got, copy))
            emit({"check": "decode_attention_head_block", "kv0": kv0,
                  "kv_heads": kvc, "pos": pos, "buf": buf,
                  "max_abs_err": err, "tol": 2e-2,
                  "bitwise_the_copied_block": same})
            if not (err <= 2e-2 and same):
                raise AssertionError(f"decode attention at KV head {kv0} "
                                     f"pos={pos}: err {err}, bitwise the "
                                     f"copied block {same}")
    flash = torch.ops.aten._scaled_dot_product_flash_attention
    rec = {}
    for name, key in (("smollm_pod", None), ("chatglm3_pod", "chatglm3"),
                      ("chatglm3_pod_f8", "chatglm3_f8")):
        q, ck, cv, n, ring = timed[(name, 0)]
        b, kvp, gp, hd = q.shape
        pos = ring - 1                      # the shard wholly live
        pos_t = torch.tensor(pos, dtype=torch.int64, device="cuda")
        t = timer(lambda: decode_attention_shard_cuda(q, ck, cv, pos_t, 0,
                                                      ring))
        qs = q.to(torch.bfloat16).reshape(b, kvp * gp, 1, hd)
        ks, vs = (c.to(torch.bfloat16).permute(0, 2, 1, 3).repeat_interleave(
            gp, dim=1).contiguous() for c in (ck, cv))
        lib = timer(lambda: flash(qs, ks, vs, 0.0, False, False))
        moved = nbytes(q, ck, cv) + nbytes(q) + b * kvp * gp * 4
        bnd, by = bound_ms(moved, 4 * b * kvp * gp * n * hd)
        what = (f"B={b} KVp={kvp} Gp={gp} hd={hd}, {str(ck.dtype)[6:]} "
                f"shard of {n} of a {ring}-slot ring, all live, position "
                f"on the card")
        row = dict(ms=t["ms"], ms_min=t["ms_min"],
                   ms_over_floor=t["ms_over_floor"], bound_ms=bnd,
                   library_ms=lib["ms"], library_ms_min=lib["ms_min"],
                   timed=what)
        emit({"timing": "decode_attention_shard", "timed": what, "kernel": t,
              "library": lib, "bound_ms": bnd})
        if key is None:
            plain = timer(lambda: ref.decode_attention_shard_ref(
                q, ck, cv, pos_t, 0, ring))
            rec.update(max_abs_err=worst, plain_ms=plain["ms"], bound_by=by,
                       **row)
        else:
            rec[key] = row
    records["decode_attention_shard"] = rec
    emit({"timing": "decode_attention_shard", **rec})


def profile_decode_attention(torch, timer):
    """Decode attention's device ms (``Timer``) at the request loop's
    float8 ring (B 2, 256 slots, 96 live), the launcher's bf16 ring (B 4,
    96 slots, 95 live) and the 2048-slot bf16 ring at 32, 301, 512 and
    1000 live slots (KVp = Gp = 4, hd 64): the host-int launch, and the
    launch that reads the position on the card where the tree has one
    (``ops.COUNTERS`` marks it). One ``decode_attention_profile`` line
    each; with ``--src`` an earlier tree's kernel, to compare in turns."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.models.common import to_storage
    on_card = hasattr(ops, "COUNTERS")
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    kvp, gp, hd = 4, 4, 64
    for b, buf, dt, live in ((2, 256, torch.float8_e4m3fn, (96,)),
                             (4, 96, torch.bfloat16, (95,)),
                             (2, 2048, torch.bfloat16, (32, 301, 512, 1000))):
        q = torch.randn(b, kvp, gp, hd, generator=g, device="cuda").to(
            torch.bfloat16)
        kv = torch.randn(2, b, buf, kvp, hd, generator=g, device="cuda")
        ck, cv = to_storage(kv[0], dt), to_storage(kv[1], dt)
        for n in live:
            pos = n - 1
            rec = {"b": b, "buf": buf, "cache": str(dt)[6:], "live": n,
                   "host_int": timer(
                       lambda: decode_attention_cuda(q, ck, cv, pos))}
            if on_card:
                pos_t = torch.tensor(pos, dtype=torch.int64, device="cuda")
                rec["device_pos"] = timer(
                    lambda: decode_attention_cuda(q, ck, cv, pos_t))
            emit({"decode_attention_profile": rec})


SHARD_PROFILES = (  # (name, B, KVp, Gp, hd, shard slots, cache, live)
    ("smollm_pod", 8, 4, 4, 64, 2048, "bfloat16", (2048, 301)),
    ("chatglm3_pod", 8, 2, 16, 128, 2048, "bfloat16", (2048, 301)),
    ("chatglm3_pod_f8", 8, 2, 16, 128, 2048, "float8_e4m3fn", (2048,)))


def profile_decode_attention_shard(torch, timer):
    """The ring-shard decode attention's device ms (``Timer``) at
    smollm-135m's and chatglm3-6b's decode_32k pod shards (slots [0,
    2048) of a 32,768-slot ring, the position on the card), wholly live
    and with 301 live slots, chatglm3-6b's also in float8. One
    ``decode_attention_shard_profile`` line each; with ``--src`` an
    earlier tree's kernel, to compare in turns."""
    from repro_torch.kernels.decode_attention import \
        decode_attention_shard_cuda
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    ring = 32768
    for name, b, kvp, gp, hd, n, cache, live in SHARD_PROFILES:
        dt = getattr(torch, cache)
        q = torch.randn(b, kvp, gp, hd, generator=g, device="cuda").to(
            torch.bfloat16).float()
        ck, cv = (torch.randn(b, n, kvp, hd, generator=g, device="cuda").to(
            dt) for _ in range(2))
        for k in live:
            pos_t = torch.tensor(k - 1, dtype=torch.int64, device="cuda")
            emit({"decode_attention_shard_profile": {
                "case": name, "cache": cache, "live": k,
                "device_pos": timer(lambda: decode_attention_shard_cuda(
                    q, ck, cv, pos_t, 0, ring))}})


def check_flash_attention(torch, timer, records, calib_batch, seq):
    """Causal GQA at the calibration shape (the calibration batch of
    ``seq`` tokens, KV = G = 4, hd = 64, bf16: the tensor-core route) and
    at a ragged S = 100, both checked and timed beside SDPA; the float32
    (CUDA-core) route checked once at S = 100. Each call is repeated for
    bitwise equality."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models.attention import _blocked_causal_attention
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    kvh, grp, hd = 4, 4, 64
    sdpa = torch.nn.functional.scaled_dot_product_attention
    worst, rec = 0.0, {}
    for b, s, dt in ((calib_batch, seq, torch.bfloat16),
                     (2, 100, torch.bfloat16), (2, 100, torch.float32)):
        q = torch.randn(b, s, kvh, grp, hd, generator=g, device="cuda").to(dt)
        k = torch.randn(b, s, kvh, hd, generator=g, device="cuda").to(dt)
        v = torch.randn(b, s, kvh, hd, generator=g, device="cuda").to(dt)
        # bf16 outputs and probabilities; f32 as the GPU tests hold it
        tol = 2e-2 if dt == torch.bfloat16 else 1e-4
        got = flash_attention_cuda(q, k, v)
        again = flash_attention_cuda(q, k, v)
        want = _blocked_causal_attention(q, k, v, s, s)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        same = bool(torch.equal(got, again))
        emit({"check": "flash_attention", "b": b, "s": s, "dtype": str(dt),
              "max_abs_err": err, "tol": tol, "repeat_bitwise": same})
        if not (err <= tol and same):
            raise AssertionError(f"flash attention b={b} s={s} {dt}: max "
                                 f"|err| {err} > {tol} or a second call "
                                 f"differs ({same})")
        if dt == torch.float32:
            continue
        worst = max(worst, err)
        t = timer(lambda: flash_attention_cuda(q, k, v))
        qs = q.permute(0, 2, 3, 1, 4).reshape(b, kvh * grp, s, hd)
        ks = k.permute(0, 2, 1, 3).repeat_interleave(grp, dim=1)
        vs = v.permute(0, 2, 1, 3).repeat_interleave(grp, dim=1)
        qs, ks, vs = qs.contiguous(), ks.contiguous(), vs.contiguous()
        lib = timer(lambda: sdpa(qs, ks, vs, is_causal=True))
        pairs = s * (s + 1) // 2                   # causal (query, key) pairs
        bnd, by = bound_ms(nbytes(q, k, v) + nbytes(q),
                           4 * b * kvh * grp * pairs * hd)
        emit({"timing": "flash_attention", "b": b, "s": s, "kernel": t,
              "library": lib, "bound_ms": bnd,
              "ms_over_floor": t["ms_over_floor"]})
        with_lse = timer(lambda: flash_attention_cuda(q, k, v, with_lse=True))
        again = timer(lambda: flash_attention_cuda(q, k, v))
        emit({"timing": "flash_attention_lse", "b": b, "s": s,
              "ms_no_lse": [t["ms"], again["ms"]], "ms_lse": with_lse["ms"],
              "ms_min_no_lse": [t["ms_min"], again["ms_min"]],
              "ms_min_lse": with_lse["ms_min"]})
        if (b, s) == (calib_batch, seq):
            plain_t = timer(lambda: _blocked_causal_attention(q, k, v, s, s))
            rec.update(ms=t["ms"], ms_min=t["ms_min"],
                       ms_over_floor=t["ms_over_floor"],
                       plain_ms=plain_t["ms"], bound_ms=bnd, bound_by=by,
                       library_ms=lib["ms"], library_ms_min=lib["ms_min"],
                       timed=f"B={b} S={s} KV={kvh} G={grp} hd={hd} bf16, "
                             "causal")
        else:
            rec[f"s{s}"] = dict(ms=t["ms"], ms_min=t["ms_min"],
                                ms_over_floor=t["ms_over_floor"],
                                bound_ms=bnd, library_ms=lib["ms"],
                                library_ms_min=lib["ms_min"])
    records["flash_attention"] = dict(max_abs_err=worst, **rec)
    emit({"timing": "flash_attention", **records["flash_attention"]})


def check_flash_attention_bwd(torch, timer, records):
    """The backward kernels against their plain version (the gradient
    written out from the row log-sum-exp) at smollm-135m's training shape
    (B 8, S 256, KV 4, G 4 after tp_pad, hd 64, bf16), at hd 128 there,
    and at a ragged S = 100 in bf16 and f32, with the forward's lse held
    against its plain version and every call repeated for bitwise
    equality. Each case is also held to torch autograd of the plain
    forward (``_blocked_causal_attention``), which rounds nothing the
    kernels round: within 1e-4 in f32, 2^-6 in bf16. Timed at the
    training shape (hd 64 in the kernels record, hd 128 beside it) with
    the plain version and SDPA's backward alone (``sdpa_backward``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    kvh, grp = 4, 4
    worst, rec = 0.0, {}
    for b, s, hd, dt in ((8, 256, 64, torch.bfloat16),
                         (8, 256, 128, torch.bfloat16),
                         (2, 100, 64, torch.bfloat16),
                         (2, 100, 64, torch.float32)):
        q, k, v, do = attn_grad_inputs(torch, g, b, s, hd, dt, kvh, grp)
        got, out, lse, err = held_flash_bwd(torch, q, k, v, do)
        worst = max(worst, err)
        if (b, s) != (8, 256):
            continue
        t = timer(lambda: flash_attention_bwd_cuda(q, k, v, out, lse, do))
        plain_t = timer(lambda: ref.flash_attention_bwd_ref(q, k, v, out,
                                                            lse, do))
        lib = timer(sdpa_backward(torch, q, k, v, do))
        pairs = s * (s + 1) // 2
        bnd, by = bound_ms(nbytes(q, k, v, out, lse, do) + nbytes(*got),
                           10 * b * kvh * grp * pairs * hd)
        emit({"timing": "flash_attention_bwd", "b": b, "s": s, "hd": hd,
              "kernel": t, "plain": plain_t, "library": lib,
              "bound_ms": bnd, "ms_over_floor": t["ms_over_floor"]})
        timed = dict(ms=t["ms"], ms_min=t["ms_min"],
                     ms_over_floor=t["ms_over_floor"],
                     plain_ms=plain_t["ms"], bound_ms=bnd, bound_by=by,
                     library_ms=lib["ms"], library_ms_min=lib["ms_min"],
                     timed=f"B={b} S={s} KV={kvh} G={grp} hd={hd} bf16, "
                           "causal: dq, dk, dv")
        if hd == 64:
            rec.update(timed)
        else:
            rec[f"hd{hd}"] = timed
    records["flash_attention_bwd"] = dict(max_abs_err=worst, **rec)
    emit({"timing": "flash_attention_bwd",
          **records["flash_attention_bwd"]})


def held_flash_bwd(torch, q, k, v, do, **what):
    """The backward kernels on (q, k, v, d_out) against their plain version
    and torch autograd of the plain forward, the forward's lse against
    its plain version, every call repeated for bitwise equality; one
    ``check`` line (``what`` added to it). Raises on a miss -> (dq dk dv,
    out, lse, the largest absolute error against the plain version)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    from repro_torch.models.attention import _blocked_causal_attention
    b, s, kvh, grp, hd = q.shape
    dt = q.dtype
    out, lse = flash_attention_cuda(q, k, v, with_lse=True)
    lse_again = flash_attention_cuda(q, k, v, with_lse=True)[1]
    got = flash_attention_bwd_cuda(q, k, v, out, lse, do)
    again = flash_attention_bwd_cuda(q, k, v, out, lse, do)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do)
    lse_want = ref.flash_attention_lse_ref(q, k)
    torch.cuda.synchronize()
    # f32: sums in another order; bf16: one bf16 step of the largest
    # gradient (P and dS rounded to bf16 in both, outputs rounded to bf16)
    tol = 1e-4 if dt == torch.float32 else 2 ** -7
    errs = {n: (a.float() - w.float()).abs().max().item()
            / max(1.0, w.float().abs().max().item())
            for n, a, w in zip(("dq", "dk", "dv"), got, want)}
    lse_err = (lse - lse_want).abs().max().item() / max(
        1.0, lse_want.abs().max().item())
    same = all(torch.equal(a, c) for a, c in zip(got, again)) and \
        torch.equal(lse, lse_again)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    auto = torch.autograd.grad(_blocked_causal_attention(*leaves, s, s),
                               leaves, do)
    auto_tol = 1e-4 if dt == torch.float32 else 2 ** -6
    auto_errs = {n: (a.float() - w.float()).abs().max().item()
                 / max(1.0, w.float().abs().max().item())
                 for n, a, w in zip(("dq", "dk", "dv"), got, auto)}
    emit({"check": "flash_attention_bwd", **what, "b": b, "s": s, "kv": kvh,
          "g": grp, "hd": hd, "dtype": str(dt), "rel_err": errs, "tol": tol,
          "autograd_rel_err": auto_errs, "autograd_tol": auto_tol,
          "lse_rel_err": lse_err, "lse_tol": 1e-4, "repeat_bitwise": same})
    if not (max(errs.values()) <= tol and lse_err <= 1e-4 and same
            and max(auto_errs.values()) <= auto_tol):
        raise AssertionError(
            f"flash attention backward {tuple(q.shape)} {dt}: {errs} > "
            f"{tol}, autograd of the plain forward {auto_errs} > "
            f"{auto_tol}, lse {lse_err} > 1e-4, or a second call differs "
            f"({same})")
    return got, out, lse, max((a.float() - w.float()).abs().max().item()
                              for a, w in zip(got, want))


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
    # a bf16 leaf on quantize_stacked's int8-code branch: x - mu and the
    # quotient rounded to bf16, at 8 and 5 bits and 3 bits on an odd width
    for wname, bits in (("w_gate", 8), ("w_gate", 5), ("ragged", 3)):
        cases = {}
        shape = leaves[wname][:-1] + (leaves[wname][-1] - (bits == 3),)
        leaf = (torch.randn(shape, generator=g, device="cuda")
                * 0.05).to(torch.bfloat16)
        p, n = shape[0], shape[-1]
        flat = leaf.reshape(-1, n)
        for per_channel in (True, False):
            meta = stacked_grid(leaf, bits, per_channel)
            s2 = meta["scale"].reshape(p, -1)
            m2 = meta["mu"].reshape(p, -1)
            held("quantize", qk.quantize_cuda(flat, s2, m2, bits, True),
                 qk.quantize_plain(flat, s2, m2, bits, True), leaf=wname,
                 dtype="bfloat16", per_channel=per_channel, bits=bits)
        emit({"check": "quantize_kernels", "leaf": wname, "dtype": "bfloat16",
              "in_x_dtype": True, "rows_n": list(flat.shape), "bits": bits,
              "per_channel": [True, False], "cases": cases, "tol": 0})
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
        t, plain_t = timer(fn), timer(plain)
        b, by = bound_ms(moved, 2 * x.numel(), h100().PEAK_FLOPS_F32)
        records[name] = dict(
            max_abs_err=worst[name], ms=t["ms"], ms_min=t["ms_min"],
            ms_over_floor=t["ms_over_floor"], plain_ms=plain_t["ms"],
            bound_ms=b, bound_by=by, library_ms=None,
            timed=f"w_gate leaf ({x.shape[0]}, {ff}) f32, per-column "
                  f"({L}, {ff}) metadata, {out}")
        emit({"timing": name, **records[name], "bytes": moved, "kernel": t,
              "same_bytes_cast_ms": timer(cast)["ms"] if cast else None})


# ---------------------------------------------------------------------------
# Phase 4: the request loop

def cycle_batch(rng, vocab: int, n: int, seq: int):
    """Next-token task t[i+1] = (t[i] + 1) % V, as the repo's LM example."""
    start = rng.integers(0, vocab, size=(n, 1))
    toks = (start + np.arange(seq + 1)[None, :]) % vocab
    return toks[:, :seq].astype(np.int32), toks[:, seq].astype(np.int32)


def request_loop(torch, ops, calib_batch: int, seq: int,
                 arch: str = "smollm-135m", fixed_plans: bool = True,
                 forward_checks: str = "full"):
    """register -> calibrate -> build_store -> serve -> execute ->
    generate on ``arch`` at its registered shape, with seeded weights on
    the card. ``fixed_plans`` adds a session on a fixed 8- / 4-bit plan
    for a matmul kernel no served plan ran. The deployment is executed
    a second time before its stage times go into the ledger (the first
    pays the segment's fake-quantization and the block graphs' warm-up
    and capture). After the counted run, the forward family's block
    graphs are held to their eager twin (``forward_graphs_phase``:
    ``forward_checks`` "full", or "calibrate" for the calibration check
    alone)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.cost_model import (Channel, DeviceProfile,
                                             ObjectiveWeights)
    from repro_torch.core.solver import PartitionPlan
    from repro_torch.models import transformer as T
    from repro_torch.serving.backends import TransformerBackend
    from repro_torch.serving.decode import DecodeSession
    from repro_torch.serving.qpart_server import QPARTServer
    from repro_torch.serving.simulator import InferenceRequest

    cfg = get_config(arch)
    print(f"request loop: {cfg.name} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} "
          f"padded={cfg.padded_heads()} d_ff={cfg.d_ff} moe={cfg.moe} "
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
    name = cfg.name.split("-")[0]
    srv.register(name, backend, x_cal, y_cal)
    phases = {}

    def run(name, fn):
        torch.cuda.synchronize()
        before = {k: f.launches for k, f in counters(ops).items()}
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        phases[name] = {
            "s": time.perf_counter() - t0,
            "launches": {k: f.launches - before[k]
                         for k, f in counters(ops).items()}}
        emit({"phase": name, "arch": cfg.name, **phases[name]})
        return out

    zero_counters(torch, ops)
    run("calibrate", lambda: srv.calibrate(name))
    m = srv.models[name]
    print(f"  base accuracy {m.base_accuracy:.4f}, delta table "
          f"{m.delta_table}", flush=True)
    dev = DeviceProfile()
    contexts = [(Channel(capacity_bps=2e6), ObjectiveWeights(eta=1e7)),
                (Channel(capacity_bps=2e6), ObjectiveWeights()),
                (Channel(capacity_bps=2e8), ObjectiveWeights(eta=1e7))]
    ctxs = run("build_store", lambda: [srv.build_store(name, dev, ch, w)
                                       for ch, w in contexts])
    deps = []
    for ctx, (ch, w) in zip(ctxs, contexts):
        for a in (0.001, 0.01, 0.02):
            dep = srv.serve(InferenceRequest(name, a, dev, ch, w,
                                             segment_cached=True), ctx)
            deps.append(dep)
            emit({"serve": {"arch": cfg.name, "accuracy_budget": a,
                            "eta": w.eta,
                            "capacity_bps": ch.capacity_bps,
                            "p": dep.plan.p,
                            "bits_w": [int(b) for b in dep.extra["bits_w"]],
                            "bits_x": float(dep.extra["bits_x"])}})
    dep = max(deps[:3], key=lambda d: d.plan.p)
    res = run("execute", lambda: dep.execute(x_te, y_te))
    emit({"execute": {"arch": cfg.name, "p": dep.plan.p,
                      "accuracy": res.accuracy,
                      "accuracy_degradation": res.accuracy_degradation,
                      **res.extra["measured"]}})
    out = run("generate", lambda: dep.generate(prompt, 32))
    again = dep.execute(x_te, y_te)
    emit({"execute_again": {"arch": cfg.name, "p": dep.plan.p,
                            "accuracy": again.accuracy,
                            **again.extra["measured"]}})
    srv.record_execution(dep)
    srv.record_decode(dep)
    emit({"generate": {"arch": cfg.name, "p": dep.plan.p,
                       "batch": int(out.tokens.shape[0]),
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
    for kname, bits in (("qmatmul", 8.0), ("qmatmul4", 4.0)):
        if fixed_plans and ops.KERNELS[kname].launches == 0:
            print(f"  no served plan ran {kname}: one extra session on a "
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
    launches = read_counters(torch, ops)
    emit({"request_loop_launches": launches, "arch": cfg.name})
    t0 = time.perf_counter()
    forward_graphs_phase(torch, ops, backend, x_cal, (x_te, y_te), deps,
                         dep, full=forward_checks == "full")
    emit({"forward_graphs_phase_s": time.perf_counter() - t0,
          "arch": cfg.name})
    return cfg, params, backend, launches, dep, prompt, srv, (x_te, y_te)


def profile_steps(torch, step, steps: int, watch=(),
                  cpu: bool = True) -> dict:
    """Where a decode step's wall time goes: ``torch.profiler`` over
    ``steps`` calls of ``step`` — device busy time (the sum of kernel and
    memcpy durations on the card), the idle share of the wall time, device
    events per step and the costliest device consumers; with ``watch``,
    also the device ms and the events per step of the events whose name
    holds each of those strings. ``cpu=False`` traces the card alone (no
    host ops: a cheaper trace to take and to read)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    # kernels summed under a short name that keeps the functor (PyTorch's
    # elementwise kernels share their first 60 characters)
    short = collections.Counter()
    for name, us in by_name.items():
        short[re.sub(r"void |at::native::|\(anonymous namespace\)::", "",
                     name)[:100]] += us
    out = {"steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
           "device_busy_ms_per_step": busy_us / steps / 1e3,
           "idle_share": 1 - busy_us / wall_us if dev else None,
           "device_events_per_step": len(dev) / steps,
           "top_device_ms_per_step": {k: v / steps / 1e3
                                      for k, v in short.most_common(8)}}
    if watch:
        out["watched_device_ms_per_step"] = {
            w: sum(us for n, us in by_name.items() if w in n) / steps / 1e3
            for w in watch}
        out["watched_events_per_step"] = {
            w: sum(w in e.name for e in dev) / steps for w in watch}
    return out


def profile_decode(torch, dep, prompt, steps: int = 4, turns: int = 5):
    """The served deployment's decode step, eager and replayed as CUDA
    graphs, on ONE session in turns (eager, graphed, eager, ...):
    ``profile_steps`` over ``steps`` steps and the wall ms of ``steps``
    unprofiled steps, ``turns`` times each, after the prefill and two
    steps (a key's first use runs eagerly and captures); then
    ``generate`` of 32
    tokens on fresh sessions, eager and graphed in turns, for tokens/s.
    One ``decode_step_profile`` line with the medians of both (wall ms,
    device-busy ms, idle share per step, unprofiled wall ms) and every
    run."""
    sess = dep.decode_session()
    tok = [sess.step(sess.step(sess.prefill(prompt)))]

    def step():
        tok[0] = sess.step(tok[0])

    runs = {"eager": [], "graphed": []}
    for _ in range(turns):
        for mode in runs:
            sess.graphs = mode == "graphed"
            run = profile_steps(torch, step, steps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            run["unprofiled_wall_ms_per_step"] = \
                (time.perf_counter() - t0) * 1e3 / steps
            runs[mode].append(run)
    tps = {"eager": [], "graphed": []}
    for _ in range(turns):
        for mode in tps:
            out = dep.generate(prompt, 32, graphs=mode == "graphed")
            tps[mode].append(out.tokens_per_s)
    def median(vals):
        vals = [v for v in vals if v is not None]
        return statistics.median(vals) if vals else None

    med = {mode: {k: median(r[k] for r in rs)
                  for k in ("wall_ms_per_step", "device_busy_ms_per_step",
                            "idle_share", "device_events_per_step",
                            "unprofiled_wall_ms_per_step")}
           for mode, rs in runs.items()}
    for mode in med:
        med[mode]["generate_tokens_per_s"] = statistics.median(tps[mode])
        med[mode]["top_device_ms_per_step"] = \
            runs[mode][-1]["top_device_ms_per_step"]
    emit({"decode_step_profile": {
        "p": dep.plan.p, "batch": int(np.asarray(prompt).shape[0]),
        "steps": steps, "turns": turns, **med,
        "wall_ratio_eager_over_graphed":
            med["eager"]["wall_ms_per_step"]
            / med["graphed"]["wall_ms_per_step"],
        "runs": {mode: [{k: r[k] for k in ("wall_ms_per_step",
                                           "device_busy_ms_per_step",
                                           "idle_share",
                                           "unprofiled_wall_ms_per_step")}
                        for r in rs]
                 for mode, rs in runs.items()},
        "generate_tokens_per_s_runs": tps}})


# the cuts of smollm-135m (L = 30) the graph phase holds graphs to eager at
GRAPH_CUTS = (0, 15, 30)


def graph_phase(torch, ops, backend, prompt, gen: int = 32) -> dict:
    """The request loop's prefill and decode step replayed as CUDA graphs
    against the same stages run eagerly, on smollm-135m at full width at
    p in ``GRAPH_CUTS`` (8-bit plans: int8 wire structs and a float8
    device cache past p = 0), batch 2, the request loop's 64-token
    prompt, on a copy of the backend with no graph yet. A graphed and an
    eager ``generate`` of ``gen`` tokens give the same tokens bit for
    bit and the same launches kernel by kernel (replays advance the
    counters, ``read_counters`` holds the shape logs to them). A key's
    first use runs eagerly and its second captures: the first graphed
    session captures the step's stages (the device stage's and the
    server's; at p = 0 the server's alone), a second one of 6 tokens the
    prefill chunk's (no device stage at p = 0, no server stage at p = L),
    a third none; stepped side by side, the third session's logits (the
    server graph's static output) equal the eager session's at every
    step. Returns the graphed runs' launches."""
    from repro_torch.serving.decode import DecodeSession
    backend = dataclasses.replace(backend)       # no stage graph yet
    runs = {}
    for p in GRAPH_CUTS:
        plan = fixed_plan(p)
        seg = backend.split(plan) if p else None

        def session(**kw):
            return DecodeSession(backend, plan, segment=seg,
                                 max_len=backend.decode_max_len, **kw)

        out, launches, captures, keys = {}, {}, {}, {}
        uses, want = collections.Counter(), []
        for graphs in (False, True):
            zero_counters(torch, ops)
            before = backend.capture_count
            sess = session(graphs=graphs)
            out[graphs] = sess.generate(prompt, gen)
            launches[graphs] = read_counters(torch, ops)
            captures[graphs] = backend.capture_count - before
            keys[graphs] = len(sess.graph_keys)
        want.append(len(second_uses(uses, sess)))
        before = backend.capture_count
        sess = session()
        sess.generate(prompt, 6)
        captures_6 = backend.capture_count - before
        want.append(len(second_uses(uses, sess)))
        eager, graphed = session(graphs=False), session()
        before = backend.capture_count
        te, tg = eager.prefill(prompt), graphed.prefill(prompt)
        same_steps = []
        for _ in range(4):
            te, tg = eager.step(te), graphed.step(tg)
            same_steps.append(bool(torch.equal(te, tg)) and bool(
                torch.equal(eager.last_logits, graphed.last_logits)))
        captures_3 = backend.capture_count - before
        graphed.sever()          # the next cut's sessions take its slots
        rec = {"p": p, "new_tokens": gen,
               "tokens_bitwise": bool(np.array_equal(out[True].tokens,
                                                     out[False].tokens)),
               "step_logits_bitwise": same_steps,
               "launches_equal": launches[True] == launches[False],
               "captures": captures[True], "stage_keys": keys[True],
               "captures_6_tokens": captures_6,
               "captures_third_session": captures_3,
               "captures_eager": captures[False],
               "tokens_per_s": {"eager": out[False].tokens_per_s,
                                "graphed": out[True].tokens_per_s},
               "launches": launches[True]}
        emit({"graph_session": rec})
        if not (rec["tokens_bitwise"] and all(same_steps)
                and rec["launches_equal"]
                and [captures[True], captures_6] == want
                and captures[True] == {0: 1}.get(p, 2)
                and keys[True] == {0: 2, backend.num_layers: 3}.get(p, 4)
                and captures[True] + captures_6 == keys[True]
                and captures_3 == captures[False] == keys[False] == 0):
            raise AssertionError(f"graphed decode at p = {p} is not the "
                                 f"eager step's: {rec}")
        runs[f"graphs_p{p}"] = launches[True]
    return runs


def launcher_graphs(serve) -> bool:
    """Whether the tree's launcher replays its decode step as a CUDA
    graph (``generate(graphs=)``); an earlier tree's steps eagerly at
    host-int positions."""
    import inspect
    return "graphs" in inspect.signature(serve.generate).parameters


def expert_cast_ms(torch, params, cfg, reps: int = 5) -> float:
    """The device ms per decode step of what a MoE step does to its
    expert stacks before their products: each layer's ``_dequant_block``
    of its ``moe`` node (the int-N structs dequantized at ``--quant``
    8 / 4) and the cast of each 3-D stack to the activations' dtype, as
    ``moe_apply`` casts it (the f32 masters at ``--quant 0``); all
    layers between two CUDA events, the median of ``reps``."""
    from repro_torch.models import transformer as T
    dt = T.model_dtype(cfg)

    def casts():
        for layer in range(cfg.num_layers):
            if not cfg.uses_moe(layer):
                continue
            bp, _ = T.block_at(params, cfg, layer)
            moe = T._dequant_block({"moe": bp["moe"]}, cfg)["moe"]
            for w in moe.values():
                if w.dim() == 3:
                    w.to(dt)

    casts()
    return event_ms(torch, casts, reps)


def profile_launch(torch, quant: int, arch: str = "smollm-135m",
                   params=None, batch: int = 4, prompt_len: int = 64,
                   gen: int = 32, steps: int = 8, prof_steps: int = 4,
                   turns: int = 5):
    """The serving launcher's decode step — ``launch.steps``' serve step
    and the greedy token, as ``launch.serve.generate`` runs them — on
    ``arch`` at full width at ``--quant quant`` (``params``, or weights
    quantized as ``launch.serve.run`` does), batch 4, after a 64-token
    prompt and one eager step, eager and replayed as the one
    whole-model CUDA graph ``generate`` captures, on ONE cache state in
    turns (eager, graphed, eager, ...; ``turns`` runs each, each run
    from the same position): the unprofiled wall ms of ``steps`` steps
    (each ended by a synchronisation), then ``profile_steps`` over
    ``prof_steps`` more, the card alone traced. One
    ``launch_decode_profile`` line with the medians
    of both modes (unprofiled and profiled wall ms, device-busy ms, idle
    share, top device consumers) and every run; on a MoE arch, the
    expert stacks' per-step casts timed alone (``expert_cast_ms``) and
    their share of each mode's busy time. A tree without the graph
    (``launcher_graphs``) runs the eager mode alone at host-int
    positions. Returns the graphed medians (the eager ones on such a
    tree) with the first and last position profiled."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.quantizer import quantize_params_for_serving
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as T
    cfg = get_config(arch)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    if params is None:
        params = T.init_params(cfg, g, device="cuda")
        if quant:
            params = quantize_params_for_serving(params, quant)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=g, device="cuda", dtype=torch.int32)
    logits, caches = make_prefill_step(cfg, prompt_len + gen)(
        params, {"tokens": prompt})
    serve_step = make_serve_step(cfg)
    graphed = launcher_graphs(serve)
    pos_t = torch.zeros((), dtype=torch.int32, device="cuda")
    state = {"tok": torch.argmax(logits[:, -1:], -1).to(torch.int32),
             "pos": prompt_len}

    def position():
        if not graphed:
            return state["pos"]
        pos_t.fill_(state["pos"])
        return pos_t

    def advance(logits):
        state["tok"] = torch.argmax(logits[:, 0:1], -1).to(torch.int32)
        state["pos"] += 1

    def eager():
        advance(serve_step(params, state["tok"], caches, position())[0])

    eager()                          # generate's first step, the warm-up
    modes = {"eager": eager}
    if graphed:
        from repro_torch.serving.decode.graphs import StageGraph
        position()
        graph = StageGraph(lambda t: serve_step(params, t, caches,
                                                pos_t)[0],
                           (state["tok"].clone(),))

        def replayed():
            position()
            advance(graph.replay(state["tok"]))

        replayed()                   # the step that captured
        modes["graphed"] = replayed
    first = state["pos"]
    runs = {mode: [] for mode in modes}
    for _ in range(turns):
        for mode, step in modes.items():
            state["pos"] = first
            run = wall_ms(torch, step, steps)
            run.update(profile_steps(torch, step, prof_steps, cpu=False))
            runs[mode].append(run)
    keys = ("unprofiled_wall_ms", "unprofiled_wall_ms_min",
            "wall_ms_per_step", "device_busy_ms_per_step", "idle_share",
            "device_events_per_step")
    med = {mode: {k: statistics.median(r[k] for r in rs) for k in keys}
           for mode, rs in runs.items()}
    for mode in med:
        med[mode]["top_device_ms_per_step"] = \
            runs[mode][-1]["top_device_ms_per_step"]
    prof = {"arch": cfg.name, "quant": quant, "batch": batch,
            "cache_len": prompt_len + gen,
            "positions": [first + steps, first + steps + prof_steps - 1],
            "steps": steps, "prof_steps": prof_steps, "turns": turns,
            "graphs": graphed, **med}
    if graphed:
        prof["unprofiled_wall_ratio_eager_over_graphed"] = \
            med["eager"]["unprofiled_wall_ms"] \
            / med["graphed"]["unprofiled_wall_ms"]
    if cfg.moe is not None:
        cast = expert_cast_ms(torch, params, cfg)
        prof["expert_cast_ms_per_step"] = cast
        prof["expert_cast_share_of_busy"] = {
            mode: cast / m["device_busy_ms_per_step"]
            for mode, m in med.items()}
    prof["runs"] = {mode: [{k: r[k] for k in keys[:-1]} for r in rs]
                    for mode, rs in runs.items()}
    emit({"launch_decode_profile": prof})
    return {k: v for k, v in prof.items() if k not in modes} | \
        med["graphed" if graphed else "eager"]


def launch_wall(torch, quant: int, reps: int = 5):
    """The serving launcher's decode tokens/s without a profiler:
    ``launch.serve.run`` on full-width smollm-135m at ``--quant quant``
    (batch 4 x 64, 32 tokens), eager and graphed in turns, ``reps`` runs
    each after a warm-up, each as the smoke's ``launch_serve`` line
    reports it (decode tokens/s, and tokens/s over the whole
    ``generate``, its prefill included). A tree without the graph runs
    its eager launcher alone."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    cfg = get_config("smollm-135m")
    modes = {"eager": {"graphs": False}, "graphed": {"graphs": True}} \
        if launcher_graphs(serve) else {"eager": {}}
    serve.run(cfg, quant=quant, device="cuda", seed=SEED)
    tps = {mode: {"decode": [], "generate": []} for mode in modes}
    for _ in range(reps):
        for mode, kw in modes.items():
            out = serve.run(cfg, quant=quant, device="cuda", seed=SEED, **kw)
            tps[mode]["decode"].append(4 * 31 / out["decode_s"])
            tps[mode]["generate"].append(4 * 32 / out["generate_s"])
    emit({"launch_decode_wall": {
        "arch": cfg.name, "quant": quant,
        "decode_tokens_per_s": {m: t["decode"] for m, t in tps.items()},
        "generate_tokens_per_s": {m: t["generate"] for m, t in tps.items()},
        "median": {m: statistics.median(t["decode"])
                   for m, t in tps.items()},
        "generate_median": {m: statistics.median(t["generate"])
                            for m, t in tps.items()}}})


def wall_ms(torch, fn, reps: int) -> dict:
    """Median and minimum wall milliseconds of ``fn`` ended by a device
    synchronisation, over ``reps`` calls, with no profiler attached."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"unprofiled_wall_ms": statistics.median(times),
            "unprofiled_wall_ms_min": min(times)}


def profile_prefill(torch, reps: int = 5):
    """``profile_steps`` over the prefills that run the tiled qmatmul
    route, on full-width smollm-135m with seeded weights: the decode
    session's at a fixed 8-bit plan at p = L/2, batch 2, a 64-token prompt
    monolithic (M = 128) and in 16-token chunks (M = 32), as
    ``decode_features`` runs them, and the serving launcher's prefill step
    at --quant 8 and 4, batch 4 x 64 (M = 256). Wall time, device-busy
    time and the idle share say whether a kernel's time reaches the
    prefill's wall time or the host's launches hide it; the same prefills
    timed first with no profiler attached give the wall time without the
    profiler's own cost."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.quantizer import quantize_params_for_serving
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T
    from repro_torch.serving.backends import TransformerBackend
    from repro_torch.serving.decode import DecodeSession
    cfg = get_config("smollm-135m")
    L = cfg.num_layers
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda")
    backend = TransformerBackend(cfg, params, seq_len=128, decode_max_len=256)
    rng = np.random.default_rng(SEED)
    prompt, _ = cycle_batch(rng, cfg.vocab_size, 2, 64)
    plan = fixed_plan(L // 2)
    seg = backend.split(plan)
    for name, kw in (("decode_plain", {}),
                     ("decode_chunk16", dict(prefill_chunk_tokens=16))):
        sessions = [DecodeSession(backend, plan, max_len=256, segment=seg,
                                  **kw) for _ in range(2 * reps + 1)]
        sessions.pop().prefill(prompt)          # warm-up
        wall = wall_ms(torch, lambda: sessions.pop().prefill(prompt), reps)
        emit({"prefill_profile": name, "m": 32 if kw else 128, **wall,
              **profile_steps(torch, lambda: sessions.pop().prefill(prompt),
                              reps)})
    del backend, sessions
    g = torch.Generator(device="cuda").manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (4, 64), generator=g,
                           device="cuda", dtype=torch.int32)
    step = make_prefill_step(cfg, 96)
    for quant in (8, 4):
        served = quantize_params_for_serving(params, quant)
        step(served, {"tokens": tokens})        # warm-up
        wall = wall_ms(torch, lambda: step(served, {"tokens": tokens}), reps)
        emit({"prefill_profile": f"launch_q{quant}", "m": 256, **wall,
              **profile_steps(torch, lambda: step(served, {"tokens": tokens}),
                              reps)})
        del served


def reference_check(torch, cfg, params, backend, rel: float = 5e-2):
    """The kernels' forward against the plain versions on the CPU, on a
    small input at full width and depth: logits agree within ``rel`` of
    the largest logit (5%: bf16 accuracy through smollm's 30 layers).
    The card's forward runs through the backend's block graphs (a new
    shape: its first block eager, its second captured, the rest
    replayed) and is held bitwise to its ``forward_graphs=False`` twin."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.backends import TransformerBackend
    from repro_torch.tree import tree_map
    cpu = TransformerBackend(cfg, tree_map(lambda t: t.cpu(), params),
                             seq_len=backend.seq_len)
    x, _ = cycle_batch(np.random.default_rng(SEED + 3), cfg.vocab_size, 2,
                       16)
    captured = backend.capture_count
    graphed = backend.forward(x)
    captures = backend.capture_count - captured
    twin = twin_of(backend).forward(x)
    got = graphed.float().cpu()
    want = cpu.forward(x).float()
    live = slice(0, cfg.vocab_size)
    err = (got[:, live] - want[:, live]).abs().max().item()
    tol = rel * want[:, live].abs().max().item()
    same = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    bitwise = bool(torch.equal(graphed, twin))
    emit({"reference_check": {"arch": cfg.name, "dtype": cfg.dtype,
                              "max_abs_err": err, "tol": tol,
                              "argmax_agreement": same,
                              "graphed_bitwise_twin": bitwise,
                              "captures": captures,
                              "finite": bool(torch.isfinite(
                                  got[:, live]).all())}})
    if not (err <= tol and torch.isfinite(got[:, live]).all()):
        raise AssertionError(f"forward logits vs CPU plain versions: "
                             f"max |err| {err} > {tol}")
    if not bitwise or captures > T.period_len(cfg):
        raise AssertionError(f"graphed forward of {cfg.name}: bitwise its "
                             f"twin {bitwise}, {captures} captures")


# ---------------------------------------------------------------------------
# Phase 4: the forward family's block graphs against their eager twin

FORWARD_STARTS = (0, 10, 20, 29)      # smollm-135m's starts held bitwise
EXECUTIONS = 4                        # executions of the loop's deployment


def twin_of(backend):
    """``backend``'s eager twin: the same params, its forward family with
    no block graph (``forward_graphs=False``)."""
    return dataclasses.replace(backend, forward_graphs=False)


def timed_counts(torch, ops, fn):
    """``fn()`` with the counters zeroed just before it, between device
    syncs -> (its result, seconds, each counter read just after)."""
    zero_counters(torch, ops)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_counters(torch, ops)


def event_ms(torch, fn, reps: int = 5) -> float:
    """Median device ms of ``fn()`` between CUDA events, one pair a rep."""
    out = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def block_copy(torch, backend) -> dict:
    """The block graph the backend used last: the ms of copying one
    layer's leaves into its static buffers (``torch._foreach_copy_``, as a
    replay does) beside the ms of the graph's replay alone (the block's
    busy time), by CUDA events, medians of 5."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    key, graph = [(k, e.graphs["block"]) for k, e in
                  backend.__dict__["_stage_graphs"].items()
                  if k[0] == "block" and "block" in e.graphs][-1]
    leaves = tree_leaves(T.block_at(backend.params, backend.cfg,
                                    key[1])[0])
    statics = list(graph.inputs[1:])
    copy_ms = event_ms(torch, lambda: torch._foreach_copy_(statics, leaves))
    block_ms = event_ms(torch, graph.graph.replay)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    return {"batch": key[3], "seq": key[4], "leaf_bytes": nbytes,
            "copy_ms": copy_ms, "block_ms": block_ms,
            "copy_share_of_block": copy_ms / block_ms,
            "copy_gb_per_s": 2 * nbytes / copy_ms / 1e6}


@contextlib.contextmanager
def capture_seconds():
    """The host seconds of each block-graph capture made inside (the
    ``StageGraph`` constructions of ``serving/backends/graphs.py``)."""
    from repro_torch.serving.backends import graphs as graphs_lib
    stage_graph, out = graphs_lib.StageGraph, []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        graph = stage_graph(*args, **kwargs)
        out.append(time.perf_counter() - t0)
        return graph

    graphs_lib.StageGraph = timed
    try:
        yield out
    finally:
        graphs_lib.StageGraph = stage_graph


def forward_graphs_phase(torch, ops, backend, x_cal, batch, deps, dep,
                         full: bool = True) -> None:
    """The forward family's block graphs (``serving/backends/graphs.py``)
    on a copy of the request loop's backend with no graph yet, each run
    against the same run on its ``forward_graphs=False`` twin, counters
    zeroed before each: ``calibrate_probes`` on the calibration set
    (energies and logits bitwise, launches equal, one capture per period
    position; seconds of both, and of a second graphed calibration, all
    replays), and the block copy's ms beside the block's; with ``full``
    also ``layer_activations`` and ``forward_from_layer`` at
    ``FORWARD_STARTS``, the loop's deployment executed ``EXECUTIONS``
    times on each (logits, accuracy and launches equal; captures only in
    execution 1, the test set's new shape; each execution's stage
    seconds), and ``execute_plan`` of every distinct served plan
    (bitwise, no capture)."""
    import copy
    from repro_torch.models import transformer as T
    cfg = backend.cfg
    plen = T.period_len(cfg)
    graphed, twin = dataclasses.replace(backend), twin_of(backend)
    with capture_seconds() as capture_s:
        (ge, g_s, g_n) = timed_counts(
            torch, ops, lambda: graphed.calibrate_probes(x_cal))
    captures = graphed.capture_count
    (te, t_s, t_n) = timed_counts(
        torch, ops, lambda: twin.calibrate_probes(x_cal))
    (ge2, g2_s, g2_n) = timed_counts(
        torch, ops, lambda: graphed.calibrate_probes(x_cal))
    same = all(np.array_equal(a, b) for a, b in zip(ge[:2], te[:2])) and \
        torch.equal(ge[2], te[2]) and \
        all(np.array_equal(a, b) for a, b in zip(ge2[:2], te[:2]))
    rec = {"arch": cfg.name, "batch": int(x_cal.shape[0]),
           "seq": int(x_cal.shape[1]), "bitwise": same,
           "launches_equal": g_n == t_n == g2_n, "captures": captures,
           "captures_second": graphed.capture_count - captures,
           "period_positions": plen, "graphed_s": g_s, "eager_s": t_s,
           "graphed_again_s": g2_s, "capture_s": capture_s,
           "launches": g_n,
           "block_copy": block_copy(torch, graphed)}
    emit({"forward_graphs_calibrate": rec})
    if not (same and rec["launches_equal"] and captures == plen
            and rec["captures_second"] == 0 and twin.capture_count == 0):
        raise AssertionError(f"graphed calibration is not its twin's: "
                             f"{rec}")
    del ge, te, ge2
    if not full:
        return
    before = graphed.capture_count
    (ga, ga_s, ga_n) = timed_counts(
        torch, ops, lambda: graphed.layer_activations(x_cal))
    (ta, ta_s, ta_n) = timed_counts(
        torch, ops, lambda: twin.layer_activations(x_cal))
    starts = {}
    for start in FORWARD_STARTS:
        (g, _, gn) = timed_counts(
            torch, ops, lambda: graphed.forward_from_layer(ga[0][start],
                                                           start))
        (t, _, tn) = timed_counts(
            torch, ops, lambda: twin.forward_from_layer(ta[0][start],
                                                        start))
        starts[start] = bool(torch.equal(g, t)) and gn == tn
    rec = {"arch": cfg.name, "acts_bitwise": all(
        torch.equal(g, t) for g, t in zip(ga[0], ta[0]))
        and len(ga[0]) == len(ta[0]) and bool(torch.equal(ga[1], ta[1])),
        "acts_launches_equal": ga_n == ta_n, "acts_graphed_s": ga_s,
        "acts_eager_s": ta_s, "starts_bitwise": starts,
        "captures": graphed.capture_count - before}
    emit({"forward_graphs_activations": rec})
    if not (rec["acts_bitwise"] and rec["acts_launches_equal"]
            and all(starts.values()) and rec["captures"] == 0):
        raise AssertionError(f"graphed activations / suffixes are not "
                             f"their twin's: {rec}")
    del ga, ta
    x_te, y_te = batch
    name = "forward_from_layer" if dep.plan.p else "forward"
    deps2 = {False: dataclasses.replace(dep, backend=twin,
                                        result=copy.deepcopy(dep.result),
                                        _segment=None),
             True: dataclasses.replace(dep, backend=graphed,
                                       result=copy.deepcopy(dep.result),
                                       _segment=None)}
    runs = []
    for i in range(EXECUTIONS):
        run = {}
        for graphs in (True, False):
            be, logged = (graphed if graphs else twin), []
            before = be.capture_count
            with recording(be, name, logged):
                (res, s, n) = timed_counts(
                    torch, ops, lambda: deps2[graphs].execute(x_te, y_te))
            m = res.extra["measured"]
            run[graphs] = {"logits": logged[0], "accuracy": res.accuracy,
                           "t_device_s": m["t_device_s"],
                           "t_server_s": m["t_server_s"], "s": s,
                           "launches": n,
                           "captures": be.capture_count - before}
        g, t = run[True], run[False]
        rec = {"arch": cfg.name, "execution": i + 1, "p": dep.plan.p,
               "bitwise": bool(torch.equal(g["logits"], t["logits"]))
               and g["accuracy"] == t["accuracy"],
               "launches_equal": g["launches"] == t["launches"],
               **{f"{k}_{mode}": v for mode, r in (("graphed", g),
                                                   ("eager", t))
                  for k, v in r.items() if k not in ("logits", "launches")},
               "launches": g["launches"]}
        emit({"forward_graphs_execute": rec})
        want_captures = plen if i == 0 and \
            tuple(x_te.shape) != tuple(x_cal.shape) else 0
        if not (rec["bitwise"] and rec["launches_equal"]
                and rec["captures_graphed"] == want_captures
                and rec["captures_eager"] == 0):
            raise AssertionError(f"graphed execution {i + 1} is not its "
                                 f"twin's: {rec}")
        runs.append(rec)
    plans = {}
    for d in deps:
        plans.setdefault((d.plan.p, tuple(np.asarray(d.plan.bits_w)),
                          float(d.plan.bits_x)), d.plan)
    before = graphed.capture_count
    same_plans = {}
    for plan in plans.values():
        (g, _, gn) = timed_counts(
            torch, ops, lambda: graphed.execute_plan(plan, x_te))
        (t, _, tn) = timed_counts(
            torch, ops, lambda: twin.execute_plan(plan, x_te))
        same_plans[f"p{plan.p}"] = bool(torch.equal(g, t)) and gn == tn
    later = runs[1:]
    rec = {"arch": cfg.name, "plans_bitwise": same_plans,
           "plans_captures": graphed.capture_count - before,
           "calibrate_s": {"graphed": g_s, "eager": t_s,
                           "graphed_again": g2_s},
           **{f"{k}_{mode}": {"execution_1": runs[0][f"{k}_{mode}"],
                              "executions_2_4": [r[f"{k}_{mode}"]
                                                 for r in later]}
              for k in ("t_device_s", "t_server_s")
              for mode in ("graphed", "eager")},
           "captures": graphed.capture_count}
    emit({"forward_graphs": rec})
    if not (all(same_plans.values()) and rec["plans_captures"] == 0):
        raise AssertionError(f"graphed plans are not their twin's: {rec}")


CALIBRATIONS = 3                      # QPARTServer.calibrate calls a turn


def profile_forward(torch, ops) -> None:
    """The forward family as QPART's loop runs it, on a seeded
    smollm-135m at its registered shape: ``QPARTServer.calibrate`` on 64
    x 128 cycle-task tokens ``CALIBRATIONS`` times on one backend (the
    first pays the block graphs' eager first use and capture, later ones
    replay; a tree without the graphs runs all eagerly), then the
    request loop's deployment (the highest p of the first context's
    three budgets) and the same deployment at p = 0 executed
    ``EXECUTIONS`` times each on 16 x 128 tokens. One ``forward_profile``
    line: every run's seconds, the medians of the later calibrations and
    of executions 2-4, the launches of one calibration."""
    import copy
    from repro_torch.configs.base import get_config
    from repro_torch.core.cost_model import (Channel, DeviceProfile,
                                             ObjectiveWeights)
    from repro_torch.core.solver import PartitionPlan
    from repro_torch.models import transformer as T
    from repro_torch.serving.backends import TransformerBackend
    from repro_torch.serving.qpart_server import QPARTServer
    from repro_torch.serving.simulator import InferenceRequest
    cfg = get_config("smollm-135m")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda")
    backend = TransformerBackend(cfg, params, seq_len=128,
                                 decode_max_len=256)
    rng = np.random.default_rng(SEED)
    x_cal, y_cal = cycle_batch(rng, cfg.vocab_size, 64, 128)
    x_te, y_te = cycle_batch(rng, cfg.vocab_size, 16, 128)
    srv = QPARTServer()
    srv.register("smollm", backend, x_cal, y_cal)
    calibrate, launches = [], None
    for _ in range(CALIBRATIONS):
        (_, s, n) = timed_counts(torch, ops, lambda: srv.calibrate("smollm"))
        calibrate.append(s)
        launches = launches or n
    dev, ch, w = DeviceProfile(), Channel(capacity_bps=2e6), \
        ObjectiveWeights(eta=1e7)
    ctx = srv.build_store("smollm", dev, ch, w)
    dep = max((srv.serve(InferenceRequest("smollm", a, dev, ch, w,
                                          segment_cached=True), ctx)
               for a in (0.001, 0.01, 0.02)), key=lambda d: d.plan.p)
    p0 = PartitionPlan(p=0, bits_w=np.zeros(0), bits_x=16.0, objective=0.0,
                       psi_total=0.0, payload_bits=0.0, breakdown={})
    execute = {}
    for plan in (dep.plan, p0):
        d = dataclasses.replace(dep, plan=plan,
                                result=copy.deepcopy(dep.result),
                                _segment=None)
        stages = []
        for _ in range(EXECUTIONS):
            m = d.execute(x_te, y_te).extra["measured"]
            stages.append({"t_device_s": m["t_device_s"],
                           "t_server_s": m["t_server_s"]})
        execute[f"p{plan.p}"] = {
            "runs": stages,
            **{f"{k}_median_2_4": statistics.median(
                r[k] for r in stages[1:])
               for k in ("t_device_s", "t_server_s")}}
    emit({"forward_profile": {
        "calibrate_s": calibrate,
        "calibrate_first_s": calibrate[0],
        "calibrate_later_median_s": statistics.median(calibrate[1:]),
        "calibrate_launches": launches, "execute": execute,
        "captures": backend.capture_count}})


# ---------------------------------------------------------------------------
# Phase 5: the fleet engine (the paper's dynamic workload balancing)

FLEET_POLICIES = ("fcfs", "balanced", "edf", "least_loaded")


def fleet_summary(metrics, wall_s: float) -> dict:
    """A run's ``summary()``, the unrounded mean stage seconds, how often
    each cut point p was admitted, and the engine's host wall time."""
    cuts = collections.Counter(r.deployment.plan.p
                               for r in metrics.completed())
    return {"summary": metrics.summary(),
            "mean_stage_seconds": metrics.mean_stage_seconds(),
            "p_chosen": {str(p): n for p, n in sorted(cuts.items())},
            "engine_wall_s": wall_s,
            "planned_rps_wall": len(metrics.records) / wall_s}


def lm_fleet(torch, ops, srv, batch, prompt) -> dict:
    """The request loop's calibrated server as a fleet of two default
    ``ServerProfile``s under EDF with a 10 ms epoch: a seeded Poisson
    trace of 200 streams (50 requests/s, 32 new tokens each, 20
    requesters) on the request loop's device and its 2 and 200 Mbit/s
    channels, the requesters alternating between its two weightings.
    Priced analytically, under ``slo="degrade"`` and ``"observe"``; then
    up to four admitted deployments with distinct plans (from the
    ``observe`` run: the default server profile prices a 128-token
    prefill at seconds, past every deadline) execute and generate on the
    card, their fenced stage times go into the calibration ledger, and
    the same trace is priced again from the fitted rates. Returns the
    kernel launches of those executions."""
    from repro_torch.core.cost_model import (Channel, DeviceProfile,
                                             ObjectiveWeights, ServerProfile)
    from repro_torch.serving.testing import poisson_trace
    dev = DeviceProfile()
    near, far = ObjectiveWeights(), ObjectiveWeights(eta=1e7)
    trace = poisson_trace("smollm", 200, 50.0, [dev],
                          [Channel(capacity_bps=2e6),
                           Channel(capacity_bps=2e8)], near,
                          budgets=(0.001, 0.01, 0.02),
                          deadlines=(0.5, 1.0, 2.0), device_pool=20,
                          seed=SEED)
    trace = [dataclasses.replace(
        r, max_new_tokens=32,
        weights=far if int(r.device_id.split("-")[1]) % 2 else near)
        for r in trace]
    servers = [ServerProfile()] * 2

    def run(pricing, provider, slo):
        t0 = time.perf_counter()
        metrics = srv.fleet(servers=servers, policy="edf", slo=slo,
                            epoch_interval=0.01, provider=provider).run(trace)
        wall = time.perf_counter() - t0
        metrics.assert_terminal()
        emit({"lm_fleet": {"pricing": pricing, "slo": slo,
                           **fleet_summary(metrics, wall)}})
        return metrics

    run("analytic", None, "degrade")
    picked = {}
    for r in run("analytic", None, "observe").completed():
        dep = r.deployment
        key = (dep.plan.p, tuple(np.asarray(dep.plan.bits_w).tolist()))
        if key not in picked and len(picked) < 4:
            picked[key] = dep
    x_te, y_te = batch
    zero_counters(torch, ops)
    for dep in picked.values():
        # the first execution pays the segment's fake-quantization (and a
        # new shape's graph captures): the ledger takes the second
        first = dict(dep.execute(x_te, y_te).extra["measured"])
        res = dep.execute(x_te, y_te)
        out = dep.generate(prompt, 32)
        srv.record_execution(dep)
        srv.record_decode(dep)
        emit({"fleet_execute": {
            "p": dep.plan.p,
            "bits_w": [int(b) for b in np.ceil(dep.plan.bits_w)],
            "bits_x": float(dep.plan.bits_x),
            "accuracy": res.accuracy, **res.extra["measured"],
            "first_execution": {k: first[k] for k in
                                ("t_device_s", "t_server_s", "t_total_s")},
            "ttft_s": out.ttft_s, "tokens_per_s": out.tokens_per_s}})
        vocab = dep.backend.cfg.vocab_size
        if out.tokens.shape != (prompt.shape[0], 32) or not (
                (out.tokens >= 0) & (out.tokens < vocab)).all() \
                or not np.isfinite(res.accuracy):
            raise AssertionError(f"fleet deployment p={dep.plan.p} gave "
                                 f"{out.tokens!r}, accuracy {res.accuracy}")
    launches = read_counters(torch, ops)
    emit({"fleet_execute_launches": {"deployments": len(picked),
                                     **launches}})
    cal = srv.calibrated_provider()           # raises on an empty ledger
    emit({"fitted_rates": {
        "ledger_samples": len(srv.ledger),
        "default_device": dataclasses.asdict(cal.default_device),
        "default_server": dataclasses.asdict(cal.default_server),
        "device": [dataclasses.asdict(r) for r in cal.device_rates.values()],
        "server": [dataclasses.asdict(r)
                   for r in cal.server_rates.values()]}})
    for slo in ("degrade", "observe"):
        run("calibrated", cal, slo)
    return launches


def fleet_recipes() -> None:
    """``benchmarks/fleet_bench.py``'s two recipes with the port's
    classes, on the host: 1,200 requests over three slow servers under
    each policy, SLO degrade, 5 ms epochs, on a stub-calibrated MNIST MLP
    (``fleet``: Poisson arrivals; ``fleet_chaos``: MMPP arrivals, device
    churn, channel drift, permanent losses, cuts aimed at the policy's
    own baseline and retries with degraded budgets). Every chaos journal
    is replayed; a divergence raises."""
    from repro_torch.configs.classifier import MNIST_MLP
    from repro_torch.core.cost_model import (Channel, DeviceProfile,
                                             ObjectiveWeights, ServerProfile)
    from repro_torch.serving.engine import (DISCONNECT, RECONNECT,
                                            FaultEvent, FaultInjector,
                                            FleetEngine, RetryPolicy,
                                            churn_trace, degrade_trace,
                                            materialize, mmpp_arrivals)
    from repro_torch.serving.testing import (poisson_trace,
                                             stub_classifier_server)
    devices = [DeviceProfile(f_clock=f) for f in (4e8, 1e9, 2e9)]
    channels = [Channel(capacity_bps=c) for c in (2e6, 1e7, 2e8)]
    weights = ObjectiveWeights()
    fleet = [ServerProfile(f_clock=3e8)] * 3
    srv = stub_classifier_server([("mnist", MNIST_MLP)], server=fleet[0],
                                 device=devices[0], channel=channels[1],
                                 weights=weights)
    mix = dict(budgets=(0.004, 0.01, 0.02), deadlines=(0.020, 0.035, 0.060),
               batches=(1, 1, 4), device_pool=200, seed=SEED)
    poisson = poisson_trace("mnist", 1200, 700.0, devices, channels,
                            weights, **mix)
    chaos = materialize("mnist", mmpp_arrivals(
        1200, rates=(200.0, 1400.0), mean_dwell=(0.5, 0.1), seed=SEED),
        devices, channels, weights, **mix)
    horizon = chaos[-1].arrival_time + 0.5
    rng = np.random.default_rng(SEED + 2)
    ambient = (churn_trace([f"dev-{i}" for i in range(0, 200, 4)], horizon,
                           mean_uptime=0.35, mean_downtime=0.12, seed=SEED)
               + degrade_trace([f"dev-{i}" for i in range(1, 200, 4)],
                               horizon, mean_interval=1.0,
                               mean_duration=0.15, seed=SEED + 1)
               + FaultInjector([FaultEvent(
                   float(rng.uniform(0.3 * horizon, 0.9 * horizon)),
                   DISCONNECT, f"dev-{i}") for i in range(2, 200, 16)]))
    retry = RetryPolicy(max_attempts=3, base_backoff_s=0.01,
                        max_backoff_s=0.1, degrade_on_retry=True)

    def targeted_cuts(baseline, n_cuts=150, downtime=0.03):
        done = sorted((r for r in baseline.completed()
                       if r.request.device_id is not None
                       and r.timeline.transfer_done > r.timeline.admit),
                      key=lambda r: r.timeline.transfer_done
                      - r.timeline.admit, reverse=True)
        cut_rng = np.random.default_rng(SEED)
        events = []
        for r in done[:n_cuts]:
            t0, t1 = r.timeline.admit, r.timeline.transfer_done
            cut = float(t0 + cut_rng.uniform(0.25, 0.75) * (t1 - t0))
            events += [FaultEvent(cut, DISCONNECT, r.request.device_id),
                       FaultEvent(cut + downtime, RECONNECT,
                                  r.request.device_id)]
        return FaultInjector(events)

    for policy in FLEET_POLICIES:
        kw = dict(servers=fleet, policy=policy, slo="degrade",
                  epoch_interval=0.005)
        t0 = time.perf_counter()
        metrics = FleetEngine(srv, **kw).run(poisson)
        wall = time.perf_counter() - t0
        metrics.assert_terminal()
        emit({"fleet_recipe": "fleet", "policy": policy,
              **fleet_summary(metrics, wall)})
        faults = ambient + targeted_cuts(FleetEngine(srv, **kw).run(chaos))
        t0 = time.perf_counter()
        metrics = FleetEngine(srv, retry=retry, faults=faults,
                              **kw).run(chaos)
        wall = time.perf_counter() - t0
        metrics.assert_terminal()
        t0 = time.perf_counter()
        metrics.journal.verify_replay(srv, chaos, servers=fleet)
        emit({"fleet_recipe": "fleet_chaos", "policy": policy,
              "fault_events": len(faults), "retry_rate": metrics.retry_rate(),
              "journal_entries": len(metrics.journal),
              "replay_s": time.perf_counter() - t0, "replayed": True,
              **fleet_summary(metrics, wall)})


# ---------------------------------------------------------------------------
# Phase 6: the classifier request loop (the quickstart on the card)

def example(name: str):
    """``examples/<name>.py`` of this checkout as a module (the examples
    are scripts; their directory goes on ``sys.path`` for the helper
    module the classifier examples share)."""
    path = ROOT / "examples"
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  path / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CLASSIFIER_CALIBRATIONS = 5     # calibrate_probes calls a mode


def classifier_graphs(torch, ops, backend, dep, x_cal, test) -> None:
    """The classifier's programs through their graphs
    (``serving/backends/classifier.py``) on a copy of the quickstart's
    backend with no graph yet, each run against the same run on its
    ``forward_graphs=False`` twin: ``calibrate_probes`` on the
    calibration set ``CLASSIFIER_CALIBRATIONS`` times (the probe
    program's eager first use, its capture, then replays; energies and
    logits bitwise), then the served
    deployment executed ``EXECUTIONS`` times on each (logits and accuracy
    bitwise; captures: at p > 0 the prefix and from-layer programs' in
    execution 2, their second use; at p = 0 the forward's in execution
    1, where ``evaluate`` runs it a second time). Seconds of both."""
    import copy
    graphed, twin = dataclasses.replace(backend), twin_of(backend)
    cal = []
    for i in range(CLASSIFIER_CALIBRATIONS):
        before = graphed.capture_count
        g, g_s, _ = timed_counts(
            torch, ops, lambda: graphed.calibrate_probes(x_cal))
        t, t_s, _ = timed_counts(
            torch, ops, lambda: twin.calibrate_probes(x_cal))
        cal.append({"graphed_s": g_s, "eager_s": t_s,
                    "captures": graphed.capture_count - before,
                    "bitwise": bool(np.array_equal(g[0], t[0])
                                    and np.array_equal(g[1], t[1])
                                    and torch.equal(g[2], t[2]))})
    emit({"classifier_graphs_calibrate": {
        "model": backend.cfg.name, "batch": int(x_cal.shape[0]),
        "runs": cal}})
    if not (all(c["bitwise"] for c in cal)
            and [c["captures"] for c in cal]
            == [0, 1] + [0] * (CLASSIFIER_CALIBRATIONS - 2)):
        raise AssertionError(f"graphed classifier calibration is not its "
                             f"twin's: {cal}")
    x_te, y_te = test
    p = dep.plan.p
    name = "forward_from_layer" if p else "forward"
    deps = {g: dataclasses.replace(dep, backend=be,
                                   result=copy.deepcopy(dep.result),
                                   _segment=None)
            for g, be in ((True, graphed), (False, twin))}
    want = [0, 2, 0, 0] if p else [1, 0, 0, 0]
    runs = []
    for i in range(EXECUTIONS):
        run = {}
        for graphs in (True, False):
            be, logged = deps[graphs].backend, []
            before = be.capture_count
            with recording(be, name, logged):
                res, secs, _ = timed_counts(
                    torch, ops, lambda: deps[graphs].execute(x_te, y_te))
            m = res.extra["measured"]
            run[graphs] = {"logits": logged[0], "accuracy": res.accuracy,
                           "t_device_s": m["t_device_s"],
                           "t_server_s": m["t_server_s"], "s": secs,
                           "captures": be.capture_count - before}
        g, t = run[True], run[False]
        rec = {"model": backend.cfg.name, "execution": i + 1, "p": p,
               "batch": int(x_te.shape[0]),
               "bitwise": bool(torch.equal(g["logits"], t["logits"]))
               and g["accuracy"] == t["accuracy"],
               **{f"{k}_{mode}": v for mode, r in (("graphed", g),
                                                   ("eager", t))
                  for k, v in r.items() if k != "logits"}}
        emit({"classifier_graphs_execute": rec})
        if not (rec["bitwise"] and rec["captures_graphed"] == want[i]
                and rec["captures_eager"] == 0):
            raise AssertionError(f"graphed classifier execution {i + 1} is "
                                 f"not its twin's: {rec}")
        runs.append(rec)
    emit({"classifier_graphs": {
        "model": backend.cfg.name, "p": p,
        "calibrate_s": {mode: [c[f"{mode}_s"] for c in cal]
                        for mode in ("graphed", "eager")},
        **{f"{k}_{mode}": {"execution_1": runs[0][f"{k}_{mode}"],
                           "executions_2_4": [r[f"{k}_{mode}"]
                                              for r in runs[1:]]}
           for k in ("t_device_s", "t_server_s")
           for mode in ("graphed", "eager")},
        "captures": graphed.capture_count}})


def classifier_loop(torch, ops):
    """``examples/torch_quickstart.py``'s stages on the card: the paper's
    MNIST MLP at full width (784-512-256-128-64-32-10, f32) trained on
    the seeded synthetic surrogate (400 SGD steps at lr 0.1, batch 128,
    plain autograd), then register -> calibrate -> build_store -> serve a
    segment-cached request at a 1% budget -> execute on 2048 test images
    (its degradation held to the quickstart's bound by the example's own
    assert); then the three baselines at the served cut, and one CIFAR
    CNN forward against the CPU. The path is plain PyTorch (matmul,
    conv2d, max-pool), as the reference's is plain XLA: no kernel
    launches, and the counters zeroed before it say so after it."""
    from repro_torch.configs.classifier import CIFAR_CNN, MNIST_MLP
    from repro_torch.core.cost_model import ServerProfile
    from repro_torch.data.pipeline import synthetic_images
    from repro_torch.models.classifier import (classifier_forward,
                                               init_classifier)
    from repro_torch.serving import baselines

    quickstart = example("torch_quickstart")
    zero_counters(torch, ops)
    secs = {}
    t0 = time.perf_counter()
    params, (x_te, y_te), acc = quickstart.train_stage(device="cuda")
    torch.cuda.synchronize()
    secs["train"] = time.perf_counter() - t0
    test_x, test_y = x_te[:2048], y_te[:2048]
    t0 = time.perf_counter()
    out = quickstart.serve_stage(params, x_te, y_te)
    torch.cuda.synchronize()
    secs["serve"] = time.perf_counter() - t0
    srv, backend, dep, res = (out[k] for k in ("srv", "backend", "dep",
                                                "result"))
    req = out["request"]
    dev, ch, w = req.device, req.channel, req.weights
    budget = req.accuracy_budget
    p = dep.plan.p
    m = srv.models["mnist"]
    emit({"classifier_loop": {
        "model": MNIST_MLP.name,
        "widths": [MNIST_MLP.layers[0].in_dim]
        + [s.out_dim for s in MNIST_MLP.layers],
        "test_accuracy": acc, "base_accuracy_calib": m.base_accuracy,
        "delta_table": m.delta_table, "accuracy_budget": budget,
        "p": p, "bits_w": [int(b) for b in dep.extra["bits_w"]],
        "bits_x": float(dep.extra["bits_x"]),
        "payload_bits": dep.payload_bits,
        "accuracy": res.accuracy,
        "accuracy_degradation": res.accuracy_degradation,
        "objective": dep.objective, "phase_s": secs,
        "measured": res.extra["measured"]}})
    t0 = time.perf_counter()
    classifier_graphs(torch, ops, backend, dep, m.calib_x,
                      (test_x, test_y))
    emit({"classifier_graphs_s": time.perf_counter() - t0})
    with torch.no_grad():
        base = m.base_accuracy
        server = ServerProfile()
        cx, cy = x_te[2048:3072], y_te[2048:3072]
        out = {"qpart": (dep.payload_bits, dep.objective, res.accuracy)}
        r = baselines.no_opt_offload(backend, p, dev, server, ch, w, test_x,
                                     test_y, base)
        out["no_opt"] = (r.payload_bits, r.objective, r.accuracy)
        p_ae = max(p, 1)        # the autoencoder needs a device segment
        r = baselines.AutoencoderBaseline().offload(
            backend, p_ae, cx, dev, server, ch, w, test_x, test_y, base)
        out[f"autoencoder_p{p_ae}"] = (r.payload_bits, r.objective,
                                       r.accuracy)
        prune = baselines.PruningBaseline().calibrated(backend, p, cx, cy,
                                                       budget, base)
        r = prune.offload(backend, p, dev, server, ch, w, test_x, test_y,
                          base)
        out[f"pruning_retain{prune.retain}"] = (r.payload_bits, r.objective,
                                                r.accuracy)
        emit({"classifier_baselines": {
            "p": p, **{k: dict(payload_bits=v[0], objective=v[1],
                               accuracy=v[2]) for k, v in out.items()}}})

        cnn = init_classifier(CIFAR_CNN, torch.Generator(
            device="cuda").manual_seed(SEED + 5), device="cuda")
        x = torch.from_numpy(synthetic_images(CIFAR_CNN.input_shape,
                                              n_train=8, n_test=256)[2])
        got = classifier_forward(cnn, CIFAR_CNN, x.cuda()).cpu()
        want = classifier_forward([{k: v.cpu() for k, v in lp.items()}
                                   for lp in cnn], CIFAR_CNN, x)
        err = (got - want).abs().max().item()
        tol = 1e-4 * max(1.0, want.abs().max().item())
        emit({"cifar_cnn_forward": {"batch": int(x.shape[0]),
                                    "max_abs_err": err, "tol": tol,
                                    "finite": bool(torch.isfinite(got).all()),
                                    "logits_max": want.abs().max().item()}})
        if not (err <= tol and torch.isfinite(got).all()):
            raise AssertionError(f"CIFAR CNN on the card vs the CPU: max "
                                 f"|err| {err} > {tol}")
    return read_counters(torch, ops)


# ---------------------------------------------------------------------------
# Phase 7: the decode session's features on smollm-135m

@contextlib.contextmanager
def recording(obj, name, out: list):
    """Append every result of ``obj.name(...)`` to ``out`` while inside."""
    fn = getattr(obj, name)

    def rec(*a, **k):
        r = fn(*a, **k)
        out.append(r)
        return r

    setattr(obj, name, rec)
    try:
        yield out
    finally:
        delattr(obj, name)


def as_bits(torch, t):
    """``t`` viewed as the integer dtype of its width (float8 included),
    so that ``torch.equal`` compares bit patterns."""
    return t.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


SPEC_TURNS = 3


@contextlib.contextmanager
def stamping(sess, marks: list):
    """Append (host clock, drafts proposed, backend captures) at every
    yield of ``sess.round_stream`` while inside: the prefill's yield,
    then one per decode round."""
    inner = sess.round_stream

    def stamped(prompt, n):
        for out in inner(prompt, n):
            marks.append((time.perf_counter(), sess.drafts_proposed,
                          sess.backend.capture_count))
            yield out

    sess.round_stream = stamped
    try:
        yield marks
    finally:
        del sess.round_stream


def stream_split(t0: float, marks: list, k: int, captured: int) -> dict:
    """A stream's seconds from its ``stamping`` marks (``t0`` before
    ``generate``, ``captured`` the capture count before it): the prefill,
    the first round at the draft length ``k`` (0: plain steps; with
    graphs, an eager run on the key's first use, an eager run and the
    capture on its second, else a replay), the second, the later rounds
    at ``k`` and the tail (rounds at a smaller k, plain steps); and which
    round at ``k`` captured, if one did."""
    out = {"prefill_s": marks[0][0] - t0, "first_round_s": None,
           "second_round_s": None, "later_rounds_s": 0.0,
           "later_rounds": 0, "later_round_ms_median": None,
           "tail_s": 0.0, "tail_rounds": 0, "captured_in_round_at_k": None}
    later, at_k = [], 0
    prev = (marks[0][0], marks[0][1], captured)
    for mark in marks[1:]:
        dt = mark[0] - prev[0]
        if mark[1] - prev[1] == k:
            at_k += 1
            if mark[2] > prev[2]:
                out["captured_in_round_at_k"] = at_k
            if at_k == 1:
                out["first_round_s"] = dt
            elif at_k == 2:
                out["second_round_s"] = dt
            else:
                later.append(dt)
        else:
            out["tail_s"] += dt
            out["tail_rounds"] += 1
        prev = mark
    if later:
        out.update(later_rounds_s=sum(later), later_rounds=len(later),
                   later_round_ms_median=1e3 * statistics.median(later))
    return out


def second_uses(uses: collections.Counter, sess) -> set:
    """The stage keys ``sess``'s stream used for the second time, which
    it captured (a key's first use runs eagerly, its second captures,
    later ones replay); ``uses``, the backend's uses of each key before
    the stream, is updated."""
    out = {key for key, n in sess.graph_keys.items()
           if uses[key] < 2 <= uses[key] + n}
    uses.update(sess.graph_keys)
    return out


def spec_run(torch, ops, make, prompt, gen: int, graphs: bool) -> dict:
    """One speculative stream (a new session from ``make(graphs=)``),
    counters zeroed before: its result, every round's drafts and verified
    tokens (``_round_ids``' host copies), launches, captures and the
    ``stream_split`` of its seconds."""
    sess = make(graphs=graphs)
    zero_counters(torch, ops)
    captured = sess.backend.capture_count
    with recording(sess, "_round_ids", []) as ids, \
            stamping(sess, []) as marks:
        t0 = time.perf_counter()
        out = sess.generate(prompt, gen)
    return {"sess": sess, "out": out, "ids": ids,
            "launches": read_counters(torch, ops),
            "captures": sess.backend.capture_count - captured,
            "split": stream_split(t0, marks, sess.draft_tokens, captured)}


def paged_dense_checks(torch, sess) -> tuple:
    """A paged session's pages against its dense ring: ``to_dense`` of
    the ring bit for bit the ring, and the slices its pages own read back
    bit for bit from zeros."""
    rebuilt = sess.paged_kv.to_dense(sess.dev_caches)
    paged_same = all(torch.equal(as_bits(torch, a[k]), as_bits(torch, b[k]))
                     for a, b in zip(rebuilt, sess.dev_caches) for k in a)
    zero = sess.paged_kv.to_dense([{k: torch.zeros_like(v)
                                    for k, v in c.items()}
                                   for c in sess.dev_caches])
    owned_same = all(
        torch.equal(as_bits(torch, zero[pos][k][per]),
                    as_bits(torch, sess.dev_caches[pos][k][per]))
        for pos, per in sess.paged_kv.attn_layers.values() for k in "kv")
    return paged_same, owned_same


def spec_twins_bitwise(torch, graphed: dict, eager: dict) -> dict:
    """A graphed speculative stream against its ``graphs=False`` twin:
    tokens, each round's drafts and verified tokens, both caches (bit
    patterns) and launches."""
    caches = all(
        torch.equal(as_bits(torch, a[n]), as_bits(torch, b[n]))
        for side in ("dev_caches", "srv_caches")
        for a, b in zip(getattr(graphed["sess"], side) or [],
                        getattr(eager["sess"], side) or []) for n in a)
    return {
        "tokens": bool(np.array_equal(graphed["out"].tokens,
                                      eager["out"].tokens)),
        "drafts_and_verified": len(graphed["ids"]) == len(eager["ids"])
        and all(np.array_equal(dg, de) and np.array_equal(gg, ge)
                for (dg, gg), (de, ge) in zip(graphed["ids"], eager["ids"])),
        "caches": caches,
        "launches": graphed["launches"] == eager["launches"]}


def decode_features(torch, ops, backend, prompt, gen: int = 32,
                    chunk: int = 16, page: int = 16):
    """Chunked prefill, speculative decode and paged KV on the fixed
    8-bit plan at p = L/2 (int8 wire structs, float8 device cache), batch
    2, the request loop's 64-token prompt, ``gen`` new tokens: one session
    each plain and chunked, then each speculative run (drafting 2 and 4,
    paged + chunked + drafting 2, and drafting 4 at p = L, where every
    draft is accepted, beside a plain session at p = L) as a new graphed
    session in ``SPEC_TURNS`` turns and its ``graphs=False`` twin in the
    first turn alone (after the graphed stream; an eager stream is the
    same bits every time), counters zeroed before each, all on a copy of
    the backend with no graph yet. Each speculative line has the medians
    of the turns' tokens/s and the ``stream_split`` of their seconds
    (prefill, first round at k, second, later rounds, tail; the twin's
    from its one turn). Every graphed turn must equal the twin bit for
    bit (tokens, each round's drafts and verified tokens, both caches)
    with the same launches, and
    capture exactly the stage keys it uses for the second time in the
    phase (the third turn none), the round at k in its second round at k
    on the key's first stream, in its first on the second, and in none
    after. Speculative tokens must equal plain ones
    bit for bit (the paged run's: the chunked run's); the paged cache's
    ``to_dense`` must equal the dense ring bit for bit; the chunked
    prefill's first-token logits and caches must lie within tolerance of
    the monolithic prefill's (logits and the server's bf16 caches 5e-2 of
    the largest value, the float8 device caches two e4m3 steps of their
    top binade: the qmatmul and attention shapes change with the chunk,
    so the sums round differently). Returns the launches of each run's
    (first) graphed session."""
    from repro_torch.serving.decode import DecodeSession
    from repro_torch.serving.decode.cache import segment_cache_bytes
    backend = dataclasses.replace(backend)       # no stage graph yet
    cfg = backend.cfg
    L = cfg.num_layers

    def plan_at(p):
        return fixed_plan(p)

    p = L // 2
    plan, plan_l = plan_at(p), plan_at(L)
    segs = {p: backend.split(plan), L: backend.split(plan_l)}
    max_len = backend.decode_max_len
    knobs = {"decode_plain": (plan, {}),
             f"decode_chunk{chunk}": (plan, dict(prefill_chunk_tokens=chunk)),
             "decode_draft2": (plan, dict(draft_tokens=2)),
             "decode_draft4": (plan, dict(draft_tokens=4)),
             "decode_paged": (plan, dict(paged=True, page_tokens=page,
                                         prefill_chunk_tokens=chunk,
                                         draft_tokens=2)),
             "decode_plain_pL": (plan_l, {}),
             "decode_draft4_pL": (plan_l, dict(draft_tokens=4))}
    runs, outs, sessions, twins, captures = {}, {}, {}, {}, {}
    uses = collections.Counter()
    for name, (pl, kw) in knobs.items():
        def make(graphs=None, pl=pl, kw=kw):
            return DecodeSession(backend, pl, max_len=max_len,
                                 segment=segs[pl.p], graphs=graphs, **kw)
        spec = kw.get("draft_tokens", 0) > 0
        turns = {True: [], False: []}
        for turn in range(SPEC_TURNS if spec else 1):
            # the eager twin runs in the first turn alone (it is
            # deterministic): every graphed turn is held to it
            order = ((True, False) if turn == 0 else (True,)) if spec \
                else (True,)
            done = {g: spec_run(torch, ops, make, prompt, gen, g)
                    for g in order}
            for g, r in done.items():
                turns[g].append(r)
            if spec:
                done[False] = turns[False][0]
            ran = done[True]["sess"].graph_keys
            at_k = [key for key in ran if key[0] == "spec_device"
                    and key[2] == kw.get("draft_tokens", 0) + 1]
            prior = uses[at_k[0]] if at_k else 2
            want_round = 1 if prior == 1 else (
                2 if prior == 0 and at_k and ran[at_k[0]] >= 2 else None)
            new_keys = second_uses(uses, done[True]["sess"])
            if done[True]["captures"] != len(new_keys) or (turn >= 2
                                                           and new_keys):
                raise AssertionError(
                    f"{name} turn {turn}: {done[True]['captures']} "
                    f"captures, {len(new_keys)} keys used a second time")
            if spec:
                same = spec_twins_bitwise(torch, done[True], done[False])
                twins.setdefault(name, []).append(same)
                captures.setdefault(name, []).append(done[True]["captures"])
                emit({"decode_feature_turn": {
                    "run": name, "turn": turn, "order": [
                        "graphed" if g else "eager" for g in order],
                    "bitwise": same, **{
                        "graphed" if g else "eager": {
                            "tokens_per_s": r["out"].tokens_per_s,
                            "captures": r["captures"], **r["split"]}
                        for g, r in done.items() if g in order}}})
                if not (all(same.values()) and done[False]["captures"] == 0
                        and done[True]["split"]["captured_in_round_at_k"]
                        == want_round):
                    raise AssertionError(
                        f"{name} turn {turn}: the graphed speculative "
                        f"stream is not its eager twin's: {same}, "
                        f"captures {done[True]['captures']} / "
                        f"{done[False]['captures']}, split "
                        f"{done[True]['split']}")
            del done
        first = turns[True][0]
        sess, out = first["sess"], first["out"]
        runs[name] = first["launches"]
        outs[name], sessions[name] = out, sess
        if name == "decode_paged":
            # the last graphed stream's slots, before another stream
            # acquires them
            paged_checks = paged_dense_checks(torch, turns[True][-1]["sess"])
        dense_bytes = segment_cache_bytes(cfg, sess.dev_caches, 0, pl.p)
        rec = {"run": name, "p": pl.p, "bits": 8,
               "batch": int(prompt.shape[0]),
               "prompt": int(prompt.shape[1]), "new_tokens": out.new_tokens,
               "ttft_s": out.ttft_s, "tokens_per_s": out.tokens_per_s,
               "t_device_s": out.t_device_s, "t_server_s": out.t_server_s,
               "rounds": out.rounds, "draft_tokens": out.draft_tokens,
               "accept_rate": out.accept_rate,
               "prefill_chunks": out.prefill_chunks,
               "held_pages": (sess.paged_kv.held_pages if sess.paged_kv
                              else None),
               "device_cache_bytes": out.device_cache_bytes,
               "dense_reservation_bytes": dense_bytes,
               "device_cache_dtype": out.device_cache_dtype,
               "graphs": sess.graphs, "captures": first["captures"],
               "split": first["split"], "launches": runs[name]}
        if spec:
            rec["turns"] = SPEC_TURNS
            rec["tokens_per_s_median"] = {
                "graphed" if g else "eager": statistics.median(
                    r["out"].tokens_per_s for r in turns[g])
                for g in (True, False)}
            rec["split_median"] = {
                "graphed" if g else "eager": {
                    key: statistics.median(r["split"][key] for r in turns[g])
                    for key in ("prefill_s", "first_round_s",
                                "second_round_s", "later_rounds_s",
                                "later_round_ms_median", "tail_s")
                    if all(r["split"][key] is not None for r in turns[g])}
                for g in (True, False)}
        emit({"decode_feature": rec})
        del turns, first
    plain = outs["decode_plain"].tokens
    chunked = outs[f"decode_chunk{chunk}"].tokens
    for name, want in (("decode_draft2", plain), ("decode_draft4", plain),
                       ("decode_draft4_pL", outs["decode_plain_pL"].tokens)):
        if not np.array_equal(outs[name].tokens, want):
            raise AssertionError(f"{name}: speculative tokens differ from "
                                 "plain greedy")
    if outs["decode_draft4_pL"].accept_rate != 1.0:
        raise AssertionError("drafting at p = L: acceptance "
                             f"{outs['decode_draft4_pL'].accept_rate}, not 1")
    if not np.array_equal(outs["decode_paged"].tokens, chunked):
        raise AssertionError("paged + chunked + draft 2: tokens differ from "
                             "the chunked plain session's")
    paged_same, owned_same = paged_checks
    # chunked against monolithic prefill: first-token logits and caches
    cmp = {}
    for name, kw in (("mono", {}), ("chunked",
                                    dict(prefill_chunk_tokens=chunk))):
        s = DecodeSession(backend, plan, max_len=max_len, segment=segs[p],
                          **kw)
        with recording(backend, "hidden_logits", []) as seen:
            s.prefill(prompt)
        cmp[name] = (seen[-1].float(), s)
    (lm, sm), (lc, sc) = cmp["mono"], cmp["chunked"]
    diffs = {"logits": ((lc - lm).abs().max().item(),
                        5e-2 * lm.abs().max().item())}
    for side, a, b in (("device", sm.dev_caches, sc.dev_caches),
                       ("server", sm.srv_caches, sc.srv_caches)):
        worst = None                        # (err, tol) of the worst ratio
        for layer in (range(0, p) if side == "device" else range(p, L)):
            per, pos = divmod(layer, len(a))
            for k in "kv":
                x, y = a[pos][k][per].float(), b[pos][k][per].float()
                top = max(x.abs().max().item(), 1e-30)
                tol = 2.0 ** (np.floor(np.log2(top)) - 2) \
                    if side == "device" else 5e-2 * top
                err = (x - y).abs().max().item()
                if worst is None or err / tol > worst[0] / worst[1]:
                    worst = (err, tol)
        diffs[f"{side}_caches"] = worst
    same_tokens = int((chunked == plain).sum())
    emit({"decode_feature_checks": {
        "speculative_bitwise_plain": True,
        "speculative_graphed_bitwise_eager": {
            name: all(all(t.values()) for t in ts)
            for name, ts in twins.items()},
        "captures_per_stream": captures,
        "paged_tokens_bitwise_chunked": True,
        "paged_to_dense_bitwise": paged_same,
        "paged_owned_slices_bitwise": owned_same,
        "chunked_vs_monolithic": {k: {"max_abs_err": v[0], "tol": v[1]}
                                  for k, v in diffs.items()},
        "chunked_tokens_equal_plain": same_tokens,
        "tokens": int(plain.size)}})
    if not (paged_same and owned_same):
        raise AssertionError("paged to_dense differs from the dense ring")
    bad = [k for k, (err, tol) in diffs.items() if not err <= tol]
    if bad:
        raise AssertionError(f"chunked prefill vs monolithic out of "
                             f"tolerance: {bad} {diffs}")
    return runs


# the request series (phase 7): QPART's own loop, one fresh session per
# request through ``Deployment.generate``, by mode (its knobs)
REQUEST_MODES = {"plain": {}, "chunk16": dict(prefill_chunk_tokens=16),
                 "draft2": dict(draft_tokens=2),
                 "draft4": dict(draft_tokens=4)}
REQUESTS = 4                 # requests of each mode on the series' prompt
OTHER_PROMPT = 48            # the odd request's prompt length (3 x 16)


def profile_requests(torch, ops, passes: int = 2) -> None:
    """``request_series`` (with its ``length_series``) without twins,
    ``passes`` times, each on a new copy of one seeded smollm-135m
    backend at its registered shape (the smoke's phase 7 shape: 256-slot
    caches, a 64-token cycle-task prompt of batch 2); one
    ``request_series_pass`` line with each pass's seconds."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.backends import TransformerBackend
    cfg = get_config("smollm-135m")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda")
    backend = TransformerBackend(cfg, params, seq_len=128,
                                 decode_max_len=256)
    prompt, _ = cycle_batch(np.random.default_rng(SEED), cfg.vocab_size, 2,
                            64)
    for i in range(passes):
        t0 = time.perf_counter()
        request_series(torch, ops, backend, prompt, twins=False)
        emit({"request_series_pass": {"pass": i,
                                      "s": time.perf_counter() - t0}})


def fixed_plan(p: int, bits: float = 8.0):
    """A plan of ``p`` device layers at ``bits``, the hop at 8 bits."""
    from repro_torch.core.solver import PartitionPlan
    return PartitionPlan(p=p, bits_w=np.full(p, bits), bits_x=8.0,
                         objective=0.0, psi_total=0.0, payload_bits=0.0,
                         breakdown={})


def fixed_deployment(backend, p: int, bits: float = 8.0):
    """A ``Deployment`` of ``backend`` at a fixed plan (``p`` layers at
    ``bits``, the hop at 8 bits), priced by ``simulate_plan`` under the
    default profiles: QPART's request loop without the solver's pick."""
    from repro_torch.core.cost_model import (Channel, DeviceProfile,
                                             ObjectiveWeights, ServerProfile)
    from repro_torch.serving.deployment import Deployment
    from repro_torch.serving.simulator import (InferenceRequest,
                                               simulate_plan)
    plan = fixed_plan(p, bits)
    req = InferenceRequest(model="smollm", accuracy_budget=0.01,
                           device=DeviceProfile(), channel=Channel())
    result = simulate_plan(plan, backend.layer_specs(), req.device,
                           ServerProfile(), req.channel, ObjectiveWeights())
    return Deployment("smollm", backend, req, plan, result)


def series_request(torch, ops, dep, prompt, gen: int, graphs: bool,
                   knobs: dict) -> dict:
    """One request of the series: ``dep.generate`` on a fresh session,
    counters zeroed and the peak memory reset before. Its result, the
    session, every round's drafts and verified tokens, launches,
    captures, peak allocated GB, reserved GB (now and at the peak) and
    the ``stream_split`` of its seconds."""
    made = []
    make = dep.decode_session
    with contextlib.ExitStack() as stack:
        def session(**kw):
            sess = make(**kw)
            made.append((sess, stack.enter_context(
                recording(sess, "_round_ids", [])), stack.enter_context(
                    stamping(sess, []))))
            return sess

        dep.decode_session = session
        zero_counters(torch, ops)
        torch.cuda.reset_peak_memory_stats()
        captured = dep.backend.capture_count
        try:
            t0 = time.perf_counter()
            out = dep.generate(prompt, gen, graphs=graphs, **knobs)
        finally:
            del dep.decode_session
        sess, ids, marks = made[0]
        return {"sess": sess, "out": out, "ids": ids,
                "launches": read_counters(torch, ops),
                "captures": dep.backend.capture_count - captured,
                "peak_memory_gb": peak_gb(torch), **reserved_gb(torch),
                "split": stream_split(t0, marks, sess.draft_tokens,
                                      captured)}


def request_series(torch, ops, backend, prompt, gen: int = 32,
                   twins: bool = True) -> dict:
    """QPART's request loop on ONE backend (a copy with no graph yet):
    ``Deployment.generate`` on a fresh session per request, at the 8-bit
    plan at p = L/2, batch 2, ``gen`` new tokens. For each mode of
    ``REQUEST_MODES``, ``REQUESTS`` requests on ``prompt``, then (plain
    and chunked) one on its first ``OTHER_PROMPT`` tokens (a new
    monolithic key; the chunk keys shared), then two concurrent plain
    sessions, then ``length_series``. One ``request_series`` line per
    request: TTFT, tokens/s, captures, the ``stream_split``, peak
    allocated and reserved GB; one ``request_series_mode`` line per mode
    with request 1 against the median of the later ones.

    With ``twins`` (the smoke run), each (mode, prompt) first runs a
    ``graphs=False`` twin, and every request must equal it bit for bit
    (tokens; speculative: each round's drafts and verified tokens and
    both caches) with the same launches, capture exactly the stage keys
    it uses for the second time (a key's first use runs eagerly), none
    from the third request of a shape on, and hold the series' slots;
    the concurrent sessions must hold distinct slots and give the twin's
    tokens. Without (``--profile-requests``, timing in turns with an
    earlier tree, whose graphs live per stream) every request must give
    the first one's tokens. Returns the launches of the series' first
    request."""
    from repro_torch.serving.decode import DecodeSession
    backend = dataclasses.replace(backend)       # no stage graph yet
    shared = hasattr(backend, "stage_graphs")
    dep = fixed_deployment(backend, backend.num_layers // 2)
    plan = [(mode, REQUESTS, prompt, knobs)
            for mode, knobs in REQUEST_MODES.items()]
    plan += [(mode, 1, prompt[:, :OTHER_PROMPT], REQUEST_MODES[mode])
             for mode in ("plain", "chunk16")]
    uses, first_launches, summary = collections.Counter(), None, {}
    slots = set()
    for mode, n, x, knobs in plan:
        twin = series_request(torch, ops, dep, x, gen, False, knobs) \
            if twins else None
        recs = []
        for i in range(n):
            r = series_request(torch, ops, dep, x, gen, True, knobs)
            sess = r["sess"]
            rec = {"mode": mode, "request": i + 1, "prompt": int(x.shape[1]),
                   "batch": int(x.shape[0]), "new_tokens": gen,
                   "ttft_s": r["out"].ttft_s,
                   "tokens_per_s": r["out"].tokens_per_s,
                   "captures": r["captures"],
                   "peak_memory_gb": r["peak_memory_gb"],
                   "reserved_gb": r["reserved_gb"],
                   "max_reserved_gb": r["max_reserved_gb"],
                   "split": r["split"]}
            if shared:
                new = second_uses(uses, sess)
                rec["stage_keys"] = len(sess.graph_keys)
                rec["captured_stage_keys"] = sorted(
                    f"{k[0]}:{k[2]}" for k in new)
                slots.add((sess._dev_slot, sess._srv_slot))
            if twins and shared:
                rec["bitwise"] = same = spec_twins_bitwise(torch, r, twin)
                ok = (all(same.values()) and twin["captures"] == 0
                      and r["captures"] == len(new) and len(slots) == 1
                      and (i < 2 or r["captures"] == 0))
                if not ok:
                    raise AssertionError(f"request series {mode} request "
                                         f"{i + 1}: {rec}")
            elif recs and not np.array_equal(r["out"].tokens,
                                             recs[0][1].tokens):
                raise AssertionError(f"request series {mode}: request "
                                     f"{i + 1}'s tokens differ")
            emit({"request_series": rec})
            recs.append((rec, r["out"]))
            first_launches = first_launches or r["launches"]
            del r, sess
        later = [rec for rec, _ in recs[1:]]
        if later:
            summary[mode] = {
                "prompt": int(x.shape[1]),
                "first": {k: recs[0][0][k] for k in
                          ("ttft_s", "tokens_per_s", "captures")},
                "later_median": {k: statistics.median(rec[k] for rec in later)
                                 for k in ("ttft_s", "tokens_per_s")},
                "later_captures": [rec["captures"] for rec in later],
                **{f"{k}_max": max(rec[k] for rec, _ in recs)
                   for k in ("peak_memory_gb", "reserved_gb",
                             "max_reserved_gb")}}
            emit({"request_series_mode": {"mode": mode, **summary[mode]}})
        del twin
    # two concurrent plain streams of one shape, stepped in turns
    pair = [dep.decode_session() for _ in range(2)]
    captured = backend.capture_count
    streams = [s.round_stream(prompt, gen) for s in pair]
    toks = [[], []]
    for outs in zip(*streams):
        for got, out in zip(toks, outs):
            got.extend(out)
    for stream in streams:
        stream.close()
    toks = [np.stack(t, axis=1) for t in toks]
    rec = {"mode": "concurrent", "sessions": 2,
           "captures": backend.capture_count - captured,
           "tokens_equal": bool(np.array_equal(toks[0], toks[1]))}
    if shared:
        rec["distinct_slots"] = all(
            getattr(pair[0], a) is not getattr(pair[1], a)
            for a in ("_dev_slot", "_srv_slot"))
    if twins and shared:
        want = DecodeSession(backend, dep.plan, max_len=backend.decode_max_len,
                             segment=dep.device_segment().segment,
                             graphs=False).generate(prompt, gen).tokens
        rec["tokens_bitwise_twin"] = bool(np.array_equal(toks[0], want))
        if not (rec["tokens_equal"] and rec["tokens_bitwise_twin"]
                and rec["distinct_slots"]):
            raise AssertionError(f"concurrent sessions: {rec}")
    emit({"request_series": rec})
    del pair, streams
    length_series(torch, ops, dep, twins=twins)
    return first_launches


# the length series: prompt lengths drawn uniformly, with replacement,
# from LENGTHS (a synthetic stand-in for varied traffic, not a trace)
LENGTHS = tuple(range(16, 112, 4))      # 24 lengths, 16 .. 108 tokens
LENGTH_REQUESTS = 48
LENGTH_GEN = 8


def cached_stages(backend) -> dict:
    """The backend's stage-graph cache as it stands: pair key -> (the
    eager uses of each stage, the stages captured)."""
    return {key: (dict(entry.uses), set(entry.graphs)) for key, entry in
            backend.__dict__.get("_stage_graphs", {}).items()}


def stage_fates(before: dict, sess) -> dict:
    """What each stage key of ``sess``'s stream found in the backend's
    cache (``before``, ``cached_stages`` ahead of the stream) and so did:
    ``replayed`` (a graph), ``captured`` (its second use since it was
    cached) or ``eager``. A key evicted since its last use counts from
    zero again."""
    from repro_torch.serving.decode.pipeline import _FIRST_STAGE
    out = {}
    for key, n in sess.graph_keys.items():
        uses, graphs = before.get((_FIRST_STAGE.get(key[0], key[0]),)
                                  + key[1:], ({}, set()))
        prior = uses.get(key[0], 0)
        out[key] = ("replayed" if key[0] in graphs else
                    "captured" if prior < 2 <= prior + n else "eager")
    return out


def length_series(torch, ops, dep, twins: bool = True) -> dict:
    """``LENGTH_REQUESTS`` plain requests of ``dep`` (after the request
    series, on its backend), each of ``LENGTH_GEN`` tokens on a
    cycle-task prompt whose length is drawn uniformly from ``LENGTHS``
    (seeded). Per request: TTFT, tokens/s, captures, how often the
    series saw its length before, and (a tree whose graphs live on the
    backend) what its prefill found in the backend's cache: ``eager`` (a
    key new, or evicted, to the cache), ``captured`` (its second use) or
    ``replayed``. One ``request_length_series`` line with the share of
    requests in each class and their median TTFT, the captures, the
    stage-graph keys the backend keeps and ``memory_reserved`` before
    and after the series and at its peak. With ``twins`` (and such a
    tree), every request must equal a ``graphs=False`` twin of its length
    bit for bit and capture exactly its stage keys' second uses, and the
    backend must keep at most ``_STAGE_GRAPH_KEYS`` keys with the card's
    reserved memory at most 0.5 GB above its level before the series."""
    from repro_torch.serving.backends import base as base_lib
    from repro_torch.serving.decode import DecodeSession
    backend = dep.backend
    shared = hasattr(backend, "stage_graphs")
    rng = np.random.default_rng(SEED + 1)
    lengths = [int(n) for n in rng.choice(LENGTHS, LENGTH_REQUESTS)]
    text, _ = cycle_batch(rng, backend.cfg.vocab_size, 2, max(LENGTHS))
    torch.cuda.reset_peak_memory_stats()
    before = reserved_gb(torch)["reserved_gb"]
    seen, want, recs = collections.Counter(), {}, []
    for n in lengths:
        x = text[:, :n]
        if twins and n not in want:
            want[n] = DecodeSession(
                backend, dep.plan, max_len=backend.decode_max_len,
                segment=dep.device_segment().segment,
                graphs=False).generate(x, LENGTH_GEN).tokens
        captured = backend.capture_count
        cache = cached_stages(backend) if shared else None
        sess = dep.decode_session()
        out = sess.generate(x, LENGTH_GEN)
        rec = {"prompt": n, "seen_before": seen[n], "ttft_s": out.ttft_s,
               "tokens_per_s": out.tokens_per_s,
               "captures": backend.capture_count - captured}
        seen[n] += 1
        if shared:
            fates = stage_fates(cache, sess)
            rec["prefill"] = fates[next(k for k in fates
                                        if k[0] == "extend_device")]
            rec["captures_expected"] = sum(f == "captured"
                                           for f in fates.values())
        if twins:
            rec["bitwise"] = bool(np.array_equal(out.tokens, want[n]))
        emit({"request_length": rec})
        recs.append(rec)
        del sess
    after = reserved_gb(torch)

    def by(field, classes):
        groups = {c: [r for r in recs if classes(r[field]) == c]
                  for c in dict.fromkeys(classes(r[field]) for r in recs)}
        return {"share": {c: len(rs) / len(recs) for c, rs in groups.items()},
                "ttft_median_s": {c: statistics.median(r["ttft_s"] for r in rs)
                                  for c, rs in groups.items()}}

    summary = {
        "distribution": f"uniform over {len(LENGTHS)} lengths "
                        f"{LENGTHS[0]}..{LENGTHS[-1]} step 4, seed "
                        f"{SEED + 1}",
        "requests": len(recs), "distinct_lengths": len(seen),
        "new_tokens": LENGTH_GEN,
        "by_times_seen": by("seen_before", lambda m: min(m, 2)),
        "captures": sum(r["captures"] for r in recs),
        "reserved_gb_before": before, "reserved_gb_after":
            after["reserved_gb"], "max_reserved_gb": after["max_reserved_gb"]}
    if shared:
        summary["by_prefill"] = by("prefill", lambda f: f)
        summary["stage_graph_keys_kept"] = len(backend.__dict__.get(
            "_stage_graphs", {}))
        summary["stage_graph_keys_cap"] = base_lib._STAGE_GRAPH_KEYS
    emit({"request_length_series": summary})
    if twins and shared and not (
            all(r["bitwise"] for r in recs)
            and all(r["captures"] == r["captures_expected"] for r in recs)
            and summary["stage_graph_keys_kept"]
            <= summary["stage_graph_keys_cap"]
            and after["reserved_gb"] <= before + 0.5):
        raise AssertionError(f"length series: {summary}")
    return summary


# ---------------------------------------------------------------------------
# Phase 8: the serving launcher

def launch_serve(torch, ops, batch: int = 4, prompt_len: int = 64,
                 gen: int = 32, arch: str = "smollm-135m",
                 quants=(0, 8, 4), tag: str = "launch",
                 sample_periods=None, graph_checks=(), profiles=()):
    """``repro_torch.launch.serve.run`` on full-width ``arch`` at each
    --quant of ``quants``, graphed (the launcher's default on the card),
    each run with the counters zeroed before and read after (its
    served-weight check included; ``sample_periods`` restricts that
    check to those periods of each stacked leaf), the card's peak memory
    reset before and read after. After a run, on its weights and prompt:
    ``launcher_graph_check`` at each (quant, temperature) of
    ``graph_checks``, and ``profile_launch`` at each quant of
    ``profiles``. Returns the launches of each run, keyed
    ``{tag}_q{quant}``."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    cfg = get_config(arch)
    runs = {}
    for quant in quants:
        torch.cuda.reset_peak_memory_stats()
        zero_counters(torch, ops)
        out = serve.run(cfg, batch=batch, prompt_len=prompt_len, gen=gen,
                        quant=quant, device="cuda", seed=SEED)
        toks = out["tokens"]
        if toks.shape != (batch, gen) or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"{arch} launch --quant {quant} gave "
                                 f"{toks!r}")
        quantize_launches = (ops.KERNELS["quantize"].launches
                             + ops.KERNELS["quantize_pack4"].launches)
        peak = torch.cuda.max_memory_allocated()
        check = {}
        if quant:
            check = served_weights_check(torch, ops, out, quant,
                                         sample_periods)
        launches = read_counters(torch, ops)
        runs[f"{tag}_q{quant}"] = launches
        emit({"launch_serve": {
            "arch": cfg.name, "layers": cfg.num_layers, "quant": quant,
            "batch": batch, "prompt_len": prompt_len, "gen": gen,
            "graphs": serve.use_graphs(None, "cuda"),
            "captures": out["captures"],
            "quantize_s": out["quantize_s"],
            "quantize_launches": quantize_launches,
            "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
            "decode_tokens_per_s": batch * (gen - 1) / out["decode_s"],
            "generate_s": out["generate_s"],
            "generate_tokens_per_s": batch * gen / out["generate_s"],
            "peak_memory_gb": peak / 1e9,
            "first_row": toks[0, :8].tolist(), **check,
            "launches": launches}})
        if out["captures"] != 1:
            raise AssertionError(f"{arch} launch --quant {quant}: "
                                 f"{out['captures']} captures, not 1")
        for q, temperature in graph_checks:
            if q == quant:
                launcher_graph_check(torch, ops, cfg, out, quant,
                                     temperature)
        if quant in profiles:
            profile_launch(torch, quant, arch=arch, params=out["params"],
                           batch=batch, prompt_len=prompt_len, gen=gen,
                           steps=4, prof_steps=2)
        del out
    return runs


def launcher_graph_check(torch, ops, cfg, out, quant: int,
                         temperature: float = 0.0) -> dict:
    """The launcher's graphed ``generate`` held to ``graphs=False`` on
    one run's weights and prompt (``out`` of ``launch.serve.run``),
    counters zeroed before each and read after, the card's peak memory
    reset before each: the tokens and the last step's logits (a replayed
    step's) bit for bit, the launches equal kernel by kernel, 1 capture
    against 0; greedy (the graphed tokens also the run's own), or sampled
    at ``temperature`` with generators of one seed. One
    ``launch_graph_check`` line with both calls' decode tokens/s and
    peak memory."""
    from repro_torch.launch import serve
    prompt, (b, gen) = out["prompt"], out["tokens"].shape
    res = {}
    for graphs in (True, False):
        stats = {}
        g = torch.Generator(device="cuda").manual_seed(SEED + 1)
        torch.cuda.reset_peak_memory_stats()
        zero_counters(torch, ops)
        toks = serve.generate(out["params"], cfg, prompt,
                              max_len=prompt.shape[1] + gen, gen=gen,
                              temperature=temperature, generator=g,
                              stats=stats, graphs=graphs)
        res[graphs] = (toks, stats, read_counters(torch, ops),
                       peak_gb(torch))
    (tg, sg, lg, pg), (te, se, le, pe) = res[True], res[False]
    rec = {"arch": cfg.name, "quant": quant, "temperature": temperature,
           "batch": b, "gen": gen,
           "tokens_bitwise": bool(torch.equal(tg, te)),
           "last_logits_bitwise": bool(torch.equal(sg["last_logits"],
                                                   se["last_logits"])),
           "launches_equal": lg == le,
           "captures": sg["captures"], "captures_eager": se["captures"],
           "decode_tokens_per_s": {"graphed": b * (gen - 1) / sg["decode_s"],
                                   "eager": b * (gen - 1) / se["decode_s"]},
           "peak_memory_gb": {"graphed": pg, "eager": pe},
           "launches": lg}
    if temperature == 0.0:
        rec["run_tokens_bitwise"] = bool(torch.equal(tg, out["tokens"]))
    emit({"launch_graph_check": rec})
    if not (rec["tokens_bitwise"] and rec["last_logits_bitwise"]
            and rec["launches_equal"] and rec.get("run_tokens_bitwise", True)
            and (rec["captures"], rec["captures_eager"]) == (1, 0)):
        raise AssertionError(f"{cfg.name} --quant {quant}: the graphed "
                             f"launcher is not the eager one: {rec}")
    return rec


def served_weights_check(torch, ops, out, quant, periods=None):
    """Every served leaf dequantized on the card through
    ``ops.dequantize_tensor`` (int4 unpacked by plain ops first) is
    within half a step of its weight; the card's quantized tree is byte
    for byte the one the plain versions build on the CPU. ``periods``
    (the expert stacks of a large model) restricts both to those periods
    of each stacked leaf: the grid is per period, so a period quantized
    alone gives the same bytes."""
    from repro_torch.core.quantizer import (QUANTIZABLE,
                                            quantize_params_for_serving)
    from repro_torch.kernels import ref
    from repro_torch.tree import tree_leaves, tree_map
    params, weights = out["params"], out["weights"]

    def pick(t):
        return t if periods is None else t[list(periods)]

    worst, n, want_n = 0.0, 0, 0
    for bp, wp in zip(params["blocks"], weights["blocks"]):
        for part, node in bp.items():
            want_n += sum(k in QUANTIZABLE and v.dim() >= 3
                          for k, v in wp[part].items())
            for k, w in node.items():
                if not ops.is_wire_struct(w):
                    continue
                leaf = pick(wp[part][k])
                codes = pick(w["codes"]) if "codes" in w else \
                    ref.unpack_int4_ref(pick(w["codes_packed"])).to(
                        torch.uint8)
                p, cols = leaf.shape[0], leaf.shape[-1]
                s2 = pick(w["scale"]).reshape(p, -1)
                m2 = pick(w["mu"]).reshape(p, -1)
                deq = ops.dequantize_tensor(codes.reshape(-1, cols), s2, m2,
                                            torch.float32)
                rows = leaf.reshape(p, -1, cols)
                err = ((rows - deq.reshape(rows.shape)).abs()
                       / s2.reshape(p, 1, -1)).max().item()
                worst, n = max(worst, err), n + 1
                del deq, codes
    if n != want_n or not worst <= 0.5 + 1e-4:
        raise AssertionError(f"--quant {quant}: {n} of {want_n} served "
                             f"leaves, max |w - deq| / scale {worst} > "
                             "0.5 + 1e-4")
    def on_cpu(tree):
        return {k: tree_map(lambda t: (pick(t) if k == "blocks" else t).cpu(),
                            v) for k, v in tree.items()}

    t0 = time.perf_counter()
    plain = quantize_params_for_serving(on_cpu(weights), quant)
    plain_s = time.perf_counter() - t0
    got, want = tree_leaves(on_cpu(params)), tree_leaves(plain)
    differ = [i for i, (a, b) in enumerate(zip(got, want))
              if a.dtype != b.dtype or a.shape != b.shape
              or not torch.equal(a, b)]
    same = len(got) == len(want) and not differ
    if not same:
        raise AssertionError(f"--quant {quant}: the card's quantized tree "
                             f"differs from the CPU plain build at leaves "
                             f"{differ} of {len(want)}")
    return {"served_leaves": n, "max_err_over_scale": worst,
            "tree_equals_cpu_plain": same, "cpu_plain_quantize_s": plain_s,
            "checked_periods": "all" if periods is None else list(periods)}


# the launcher's graphed-vs-eager checks on smollm-135m: (--quant,
# temperature), greedy at each --quant and one sampled run
LAUNCH_GRAPH_CHECKS = ((0, 0.0), (8, 0.0), (4, 0.0), (8, 1.0))


# ---------------------------------------------------------------------------
# Phase 9: training on the card

TRAIN_STEPS = 40
TRAIN_GRAD_TOL = 1e-3   # f32 on both sides; sums in another order


def counted(torch, ops, fn):
    """``fn()`` with every launch counter zeroed just before it -> (its
    result, each counter read just after)."""
    zero_counters(torch, ops)
    out = fn()
    return out, read_counters(torch, ops)


def stream_batch(torch, vocab: int, batch: int, seq: int, seed: int):
    """One batch of the training launcher's token stream, on the card."""
    from repro_torch.data.pipeline import TokenStream, TokenStreamConfig
    stream = TokenStream(TokenStreamConfig(vocab_size=vocab, seq_len=seq + 1,
                                           batch_size=batch, seed=seed),
                         device="cuda")
    return next(stream.batches())


def train_grads_check(torch, ops, cfg, batch):
    """(i) One ``lm_loss`` backward of ``cfg`` (f32) on ``batch`` on the
    card (flash attention forward and backward kernels) against the same
    step on the CPU (the plain versions), from seeded weights: every
    leaf's gradient present, finite, nonzero where the CPU's is, and
    within TRAIN_GRAD_TOL of the CPU's largest magnitude; the loss (with
    a MoE config's router losses) and its metrics beside."""
    from repro_torch.models import transformer as T
    from repro_torch.train.checkpoint import _flatten
    from repro_torch.train.train_loop import value_and_grad
    from repro_torch.tree import tree_map
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED + 5), device="cuda")
    ((loss, metrics), grads), launches = counted(
        torch, ops, lambda: value_and_grad(params, cfg, batch, False))
    t0 = time.perf_counter()
    (loss_c, metrics_c), grads_c = value_and_grad(
        tree_map(lambda t: t.cpu(), params), cfg,
        {k: t.cpu() for k, t in batch.items()}, False)
    cpu_s = time.perf_counter() - t0
    got, want = _flatten(grads), _flatten(grads_c)
    errs, bad = {}, []
    for key, w in want.items():
        g = got.get(key)
        scale = float(np.abs(w).max())
        if g is None or g.shape != w.shape or not np.isfinite(g).all() or \
                (scale > 0 and not np.abs(g).max() > 0):
            bad.append(key)
            continue
        errs[key] = float(np.abs(g - w).max()) / max(scale, 1e-30)
    worst = max(errs.values())
    emit({"train_check": "grads_vs_cpu_plain", "arch": cfg.name,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "dtype": cfg.dtype, "inputs": sorted(batch),
          "batch": int(batch["labels"].shape[0]),
          "seq": int(batch["labels"].shape[1]),
          "loss": loss.item(), "loss_cpu": loss_c.item(),
          "metrics": {k: [v.item(), metrics_c[k].item()]
                      for k, v in metrics.items()},
          "leaves": len(want), "missing_or_zero": bad,
          "worst_rel_err": worst, "tol": TRAIN_GRAD_TOL,
          "attn_rel_err": {k: v for k, v in errs.items() if "attn" in k},
          "cpu_s": cpu_s, "launches": launches})
    if bad or worst > TRAIN_GRAD_TOL or sorted(got) != sorted(want):
        raise AssertionError(f"{cfg.name} gradients on the card vs the CPU: "
                             f"missing or zero {bad}, worst {worst} > "
                             f"{TRAIN_GRAD_TOL}")
    return launches


def train_remat_check(torch, ops, cfg):
    """(ii) One ``lm_loss`` backward at full width and the launcher's
    shape (B 8, S 256), remat off and on: the same loss and gradient
    bits, with remat the flash forward launched again in the backward
    (2 L forward, L backward launches against L and L)."""
    from repro_torch.models import transformer as T
    from repro_torch.train.train_loop import value_and_grad
    from repro_torch.tree import tree_leaves
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED + 6), device="cuda")
    batch = stream_batch(torch, cfg.vocab_size, 8, 256, SEED + 6)
    outs, runs = {}, {}
    for remat in (False, True):
        outs[remat], runs[f"train_remat{int(remat)}"] = counted(
            torch, ops, lambda: value_and_grad(params, cfg, batch, remat))
    (l0, _), g0 = outs[False]
    (l1, _), g1 = outs[True]
    diff = max((a.float() - b.float()).abs().max().item()
               for a, b in zip(tree_leaves(g0), tree_leaves(g1)))
    same = torch.equal(l0, l1) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(g0), tree_leaves(g1)))
    L = cfg.num_layers
    counts = {r: (n["flash_attention"], n["flash_attention_bwd"])
              for r, n in runs.items()}
    emit({"train_check": "remat", "loss": [l0.item(), l1.item()],
          "grads_max_abs_diff": diff, "bitwise": same,
          "flash_launches_fwd_bwd": counts})
    if not same or counts != {"train_remat0": (L, L),
                              "train_remat1": (2 * L, L)}:
        raise AssertionError(f"remat: bitwise {same} (max diff {diff}), "
                             f"flash launches {counts}")
    return runs


# the flash backward's device kernels (bf16 route), as the profiler names
# them
# the backward's two kernels under either route's names (dq_kernel /
# dq_tc_kernel, dkv_kernel / dkv_tc_kernel)
FLASH_BWD_KERNELS = ("dq_", "dkv_")


def train_step_profile(torch, cfg, state: list, make_batch,
                       remats=(False, True), steps: int = 3,
                       modes=("graphed", "eager"), turns: int = 2):
    """Where a train step's time goes, the data apart: one batch drawn by
    ``make_batch`` (wall ms), then for each of ``remats`` the step on it
    in each of ``modes``: ``graphed`` steps ``state`` ([params, optimizer
    state], donated) in place through ``train.graphs.DonatedStep`` (its
    first call eager, its second the capture), ``eager`` runs the plain
    step from the graphed state on its own trees. After a warm-up in
    each mode, ``turns`` turns of ``steps`` unprofiled steps per mode
    (the median of each mode's medians), then ``profile_steps``' wall,
    device-busy, idle share and top device consumers, the flash
    backward kernels' ms and share of the busy time, per mode; the peak
    allocated and reserved memory of the profiled steps; on a MoE config
    with an eager mode, the MoE blocks' share of the busy time
    (``moe_block_ms``, which brackets eager calls). The first mode's
    figures lead each record, the others' sit under their names. A tree
    without ``train.graphs`` (an earlier commit's, ``--src``) runs eager
    alone. Returns the records."""
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import make_train_step
    try:
        from repro_torch.train.graphs import DonatedStep
    except ImportError:
        modes = ("eager",)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = make_batch()
    torch.cuda.synchronize()
    data_ms = (time.perf_counter() - t0) * 1e3
    out = []
    for remat in remats:
        step_fn = make_train_step(cfg, AdamWConfig(total_steps=TRAIN_STEPS),
                                  remat=remat)
        graphed = DonatedStep(step_fn) if "graphed" in modes else None
        eager = []

        def step(mode):
            if mode == "graphed":
                state[0], state[1], _ = graphed(state[0], state[1], batch)
            else:
                eager[:] = step_fn(*(eager or state), batch)[:2]

        for mode in modes + (("graphed",) if graphed else ()):
            step(mode)
        walls = {m: [] for m in modes}
        for _ in range(turns):
            for m in modes:
                walls[m].append(wall_ms(torch, lambda: step(m), steps))
        recs = {}
        for m in modes:
            torch.cuda.reset_peak_memory_stats()
            prof = profile_steps(torch, lambda: step(m), steps,
                                 watch=FLASH_BWD_KERNELS)
            bwd_ms = sum(prof["watched_device_ms_per_step"].values())
            recs[m] = {
                "flash_bwd_share_of_busy": bwd_ms / prof[
                    "device_busy_ms_per_step"],
                "unprofiled_wall_ms": statistics.median(
                    w["unprofiled_wall_ms"] for w in walls[m]),
                "unprofiled_wall_ms_min": min(
                    w["unprofiled_wall_ms_min"] for w in walls[m]),
                "unprofiled_wall_ms_turns": [w["unprofiled_wall_ms"]
                                             for w in walls[m]],
                **prof,
                "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "peak_reserved_bytes": torch.cuda.max_memory_reserved()}
        first = recs[modes[0]]
        out.append({
            "arch": cfg.name, "layers": cfg.num_layers,
            "batch": int(batch["labels"].shape[0]),
            "seq": int(batch["labels"].shape[1]), "inputs": sorted(batch),
            "remat": remat, "mode": modes[0], "data_ms_per_batch": data_ms,
            **first, **{m: recs[m] for m in modes[1:]},
            "captures": graphed.captures if graphed else 0})
        if cfg.moe is not None and "eager" in modes:
            ms = moe_block_ms(torch, lambda: step("eager"), steps, sum(
                cfg.uses_moe(layer) for layer in range(cfg.num_layers)))
            out[-1]["moe_block_ms_per_step"] = ms
            out[-1]["moe_share_of_busy"] = sum(ms.values()) / first[
                "device_busy_ms_per_step"]
        del graphed, eager
        torch.cuda.empty_cache()
        emit({"train_step_profile": out[-1]})
    return out


def sampler_ms(torch, vocab: int, batch: int, seq: int, reps: int = 5,
               turns: int = 2) -> dict:
    """The training stream's batch (B ``batch`` x ``seq`` + 1 tokens),
    graphed and eager in turns: two ``TokenStream``s of one seed, the
    graphed one past its warm-up and capture, ``reps`` batches a mode a
    turn, each ended by a device synchronisation -> ms per batch
    (medians) and whether every graphed batch equals the eager stream's
    batch of the same step bit for bit; raises if one does not."""
    from repro_torch.data.pipeline import TokenStream, TokenStreamConfig
    cfg = TokenStreamConfig(vocab_size=vocab, seq_len=seq + 1,
                            batch_size=batch, seed=SEED + 13)
    its = {m: TokenStream(cfg, device="cuda", graphs=m == "graphed")
           .batches() for m in ("graphed", "eager")}
    got = {m: [next(its[m])] for m in its}
    got["graphed"].append(next(its["graphed"]))        # the capture
    got["eager"].append(next(its["eager"]))
    times = {m: [] for m in its}
    for _ in range(turns):
        for m in its:
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got[m].append(next(its[m]))
                torch.cuda.synchronize()
                times[m].append((time.perf_counter() - t0) * 1e3)
    same = all(torch.equal(a[k], b[k]) for a, b in zip(got["graphed"],
                                                       got["eager"])
               for k in a)
    rec = {"batch": batch, "seq": seq + 1, "batches": len(got["eager"]),
           "graphed_ms": statistics.median(times["graphed"]),
           "eager_ms": statistics.median(times["eager"]),
           "graphed_ms_min": min(times["graphed"]),
           "eager_ms_min": min(times["eager"]), "bitwise": same}
    emit({"sampler": rec})
    if not same:
        raise AssertionError("graphed token stream batches differ from the "
                             "eager stream's")
    return rec


def moe_block_ms(torch, step, steps: int, blocks: int) -> dict:
    """Device ms per step of the MoE blocks (``moe_apply``, which the
    transformer calls through its module global), forward and backward,
    over ``steps`` calls of ``step``: CUDA events recorded on the stream
    around each block's forward, and in the backward when the gradient
    reaches the block's output and when it leaves its input (an identity
    autograd function at each end; the engine runs a block's backward
    nodes together, its router losses' included). Fails unless each of
    the ``blocks`` MoE blocks a step was bracketed at all four ends."""
    from repro_torch.models import transformer as T
    fwd, bwd = [], []

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    class Mark(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, slot):
            ctx.slot = slot
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            ctx.slot.append(event())
            return g, None

    inner = T.moe_apply

    def timed(params, cfg, x, *args, **kwargs):
        slot = []
        bwd.append(slot)
        start = event()
        out, aux = inner(params, cfg, Mark.apply(x, slot), *args, **kwargs)
        fwd.append((start, event()))
        return Mark.apply(out, slot), aux

    T.moe_apply = timed
    try:
        for _ in range(steps):
            step()
    finally:
        T.moe_apply = inner
    torch.cuda.synchronize()
    if len(fwd) != steps * blocks or any(len(s) != 2 for s in bwd):
        raise AssertionError(f"moe_block_ms bracketed {len(fwd)} forwards "
                             f"and backwards {[len(s) for s in bwd]}, want "
                             f"{steps * blocks} blocks at both ends")
    return {"forward": sum(a.elapsed_time(b) for a, b in fwd) / steps,
            "backward": sum(s[0].elapsed_time(s[1]) for s in bwd) / steps}


def trained_request_loop(torch, ops, cfg, params, seq: int = 128):
    """(v) The request loop on the trained weights: register -> calibrate
    (64 x ``seq`` tokens of the training stream, the next token the
    label) -> build_store (the random-weight loop's three contexts) ->
    serve (three budgets each) -> execute -> generate, counters zeroed
    before and read after. Prints the Delta table and its spread, each
    plan's cut point and bits, and which matmul kernels the served plans
    launched."""
    from repro_torch.core.cost_model import (Channel, DeviceProfile,
                                             ObjectiveWeights)
    from repro_torch.serving.backends import TransformerBackend
    from repro_torch.serving.qpart_server import QPARTServer
    from repro_torch.serving.simulator import InferenceRequest

    def data(n, s, seed):
        b = stream_batch(torch, cfg.vocab_size, n, s, seed)
        return (b["tokens"].cpu().numpy(),
                b["labels"][:, -1].cpu().numpy().astype(np.int32))

    x_cal, y_cal = data(64, seq, SEED + 8)
    x_te, y_te = data(16, seq, SEED + 9)
    prompt, _ = data(2, seq // 2, SEED + 10)
    backend = TransformerBackend(cfg, params, seq_len=seq,
                                 decode_max_len=2 * seq)
    dev = DeviceProfile()
    contexts = [(Channel(capacity_bps=2e6), ObjectiveWeights(eta=1e7)),
                (Channel(capacity_bps=2e6), ObjectiveWeights()),
                (Channel(capacity_bps=2e8), ObjectiveWeights(eta=1e7))]

    def loop():
        srv = QPARTServer()
        srv.register("smollm_trained", backend, x_cal, y_cal)
        t0 = time.perf_counter()
        srv.calibrate("smollm_trained")
        cal_s = time.perf_counter() - t0
        m = srv.models["smollm_trained"]
        plans = []
        for ch, w in contexts:
            ctx = srv.build_store("smollm_trained", dev, ch, w)
            for a in (0.001, 0.01, 0.02):
                dep = srv.serve(InferenceRequest("smollm_trained", a, dev, ch,
                                                 w, segment_cached=True), ctx)
                plans.append((a, w.eta, ch.capacity_bps, dep))
        dep = max([p[3] for p in plans[:3]], key=lambda d: d.plan.p)
        before = {k: ops.KERNELS[k].launches for k in ("qmatmul", "qmatmul4")}
        res = dep.execute(x_te, y_te)
        out = dep.generate(prompt, 32)
        served = {k: ops.KERNELS[k].launches - before[k] for k in before}
        return m, cal_s, plans, dep, res, out, served

    (m, cal_s, plans, dep, res, out, served), launches = counted(torch, ops,
                                                                 loop)
    psi = np.array(list(m.delta_table.values()), np.float64)
    keys = sorted({(int(d.plan.p), tuple(int(b) for b in d.extra["bits_w"]),
                    float(d.extra["bits_x"])) for *_, d in plans})
    emit({"trained_request_loop": {
        "base_accuracy": m.base_accuracy, "calibrate_s": cal_s,
        "delta_table": {str(k): float(v) for k, v in m.delta_table.items()},
        "delta_spread": float(psi.max() / psi.min()) if psi.min() > 0
        else None,
        "plans": [{"accuracy_budget": a, "eta": eta, "capacity_bps": c,
                   "p": int(d.plan.p),
                   "bits_w": [int(b) for b in d.extra["bits_w"]],
                   "bits_x": float(d.extra["bits_x"])}
                  for a, eta, c, d in plans],
        "distinct_plans": len(keys),
        "executed": {"p": int(dep.plan.p), "accuracy": res.accuracy,
                     "accuracy_degradation": res.accuracy_degradation},
        "generate": {"tokens_per_s": out.tokens_per_s, "ttft_s": out.ttft_s},
        "served_matmul_launches": served, "launches": launches}})
    if out.tokens.shape != (2, 32) or not (
            (out.tokens >= 0) & (out.tokens < cfg.vocab_size)).all():
        raise AssertionError(f"generate on trained weights gave "
                             f"{out.tokens!r}")
    return launches


TWIN_STEPS = 5


def launch_twins(torch, ops) -> dict:
    """``launch.train.main`` on smollm-135m for TWIN_STEPS steps at B 8 x
    S 256, remat off and on, graphed (the default: the donated step and
    the sampler as CUDA graphs) and its eager twin (``graphs=False``),
    each alone on the card (the cache emptied and the peaks reset before
    it): every step's metrics, the final params, both moments and
    ``step`` bit for bit, the log lines but their seconds, the launches
    equal; captures (step, sampler) 1 / 1 against 0 / 0; each mode's
    wall seconds and peak allocated and reserved GB. One ``train_twin``
    line per remat; raises on a difference. Returns the launches by
    run, and the graphed run's metrics and final trees (on the host) with
    remat off."""
    from repro_torch.launch import train as train_launch
    from repro_torch.tree import tree_leaves
    runs = {}
    for remat in (False, True):
        argv = ["--steps", str(TWIN_STEPS), "--batch", "8", "--seq",
                "256"] + (["--remat"] if remat else [])
        out = {}
        for graphs in (None, False):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            stats, buf = {}, io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc, launches = counted(torch, ops, lambda: train_launch.main(
                    argv, graphs=graphs, stats=stats, world=1))
            out[graphs] = dict(
                stats, rc=rc, launches=launches,
                wall_s=time.perf_counter() - t0,
                log=re.sub(r"\(\d+\.\ds\)", "", buf.getvalue()),
                peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9)
        g, e = out[None], out[False]
        leaves = {m: tree_leaves((r["params"], r["opt_state"]))
                  for m, r in (("graphed", g), ("eager", e))}
        rec = {"remat": remat, "steps": TWIN_STEPS,
               "metrics_bitwise": g["metrics"] == e["metrics"],
               "state_bitwise": len(leaves["graphed"]) == len(
                   leaves["eager"]) and all(
                   torch.equal(a, b) for a, b in zip(leaves["graphed"],
                                                     leaves["eager"])),
               "log_equal": g["log"] == e["log"],
               "launches_equal": g["launches"] == e["launches"],
               "rc": [g["rc"], e["rc"]], "loss": [m["loss"]
                                                   for m in g["metrics"]],
               **{f"{m}_{k}": r[k] for m, r in (("graphed", g), ("eager", e))
                  for k in ("captures", "wall_s", "peak_allocated_gb",
                            "peak_reserved_gb")},
               "launches": g["launches"]}
        emit({"train_twin": rec})
        if not remat:       # the host mesh's phase (a) holds its run to it
            twin = host_twin(g)
        runs[f"train_twin_remat{int(remat)}"] = g["launches"]
        runs[f"train_twin_remat{int(remat)}_eager"] = e["launches"]
        del out, g, e, leaves
        if not (rec["metrics_bitwise"] and rec["state_bitwise"]
                and rec["log_equal"] and rec["launches_equal"]) or \
                rec["graphed_captures"] != {"step": 1, "sampler": 1} or \
                rec["eager_captures"] != {"step": 0, "sampler": 0}:
            raise AssertionError(f"launch.train graphed vs eager: {rec}")
    torch.cuda.empty_cache()
    return runs, twin


def host_twin(stats) -> dict:
    """A ``launch.train.main`` run's metrics and final trees, the trees
    copied to the host."""
    from repro_torch.tree import tree_map
    return {"metrics": stats["metrics"], **tree_map(
        lambda t: t.cpu(), {k: stats[k] for k in ("params", "opt_state")})}


def train_phase(torch, ops) -> dict:
    """Training smollm-135m at full width on the card: (i) gradients vs the
    plain versions, (ii) remat, (iii) ``launch.train.main`` for
    TRAIN_STEPS steps at B 8 x S 256 (exit 0: the loss improved), its
    step and sampler each captured once, and its graphed runs held to
    their eager twins (``launch_twins``), (iv) its checkpoint restored
    bitwise, (v) the request loop on the trained weights, then a profile
    of its step, graphed and eager in turns, and of its sampler. Returns
    each run's launches, the step's profiles (remat off and on) and the
    twin that ``host_mesh_phase`` holds its one rank to."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train as train_launch
    from repro_torch.models import transformer as T
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import init_opt_state
    cfg = get_config("smollm-135m")
    print(f"training: {cfg.name} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} vocab={cfg.vocab_size}, {cfg.dtype} "
          "activations, float32 masters", flush=True)
    runs = {"train_grads": train_grads_check(
                torch, ops, dataclasses.replace(cfg, num_layers=2,
                                                dtype="float32"),
                stream_batch(torch, cfg.vocab_size, 2, 256, SEED + 5)),
            **train_remat_check(torch, ops, cfg)}
    ck = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ck, ignore_errors=True)
    argv = ["--steps", str(TRAIN_STEPS), "--batch", "8", "--seq", "256",
            "--checkpoint", str(ck)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    rc, runs["train"] = counted(torch, ops, lambda: train_launch.main(
        argv, stats=stats, world=1))
    wall = time.perf_counter() - t0
    captures = stats["captures"]
    del stats
    emit({"train_launch": {"argv": argv, "rc": rc, "wall_s": wall,
                           "wall_s_per_step": wall / TRAIN_STEPS,
                           "captures": captures,
                           "peak_memory_bytes":
                               torch.cuda.max_memory_allocated(),
                           "peak_reserved_bytes":
                               torch.cuda.max_memory_reserved(),
                           "launches": runs["train"]}})
    L = cfg.num_layers
    if rc != 0:
        raise AssertionError("launch.train: the loss did not improve")
    if captures != {"step": 1, "sampler": 1}:
        raise AssertionError(f"launch.train: captures {captures}, want one "
                             "for the step and one for the sampler")
    if (runs["train"]["flash_attention"], runs["train"][
            "flash_attention_bwd"]) != (L * TRAIN_STEPS, L * TRAIN_STEPS):
        raise AssertionError(f"launch.train: flash launches {runs['train']}")
    twin_runs, twin = launch_twins(torch, ops)
    runs.update(twin_runs)
    # (iv) the checkpoint restored into fresh templates, bit for bit
    template = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED + 7), device="cuda")
    params, opt_state, meta = ckpt.load_checkpoint(str(ck), template,
                                                   init_opt_state(template))
    restored = {"params.npz": ckpt._flatten(params),
                "opt_state.npz": ckpt._flatten(opt_state)}
    same, n_bytes = True, 0
    for name, flat in restored.items():
        saved = np.load(ck / name)
        same &= sorted(saved.files) == sorted(flat)
        for key in saved.files:
            a = saved[key]
            n_bytes += a.nbytes
            same &= a.dtype == flat[key].dtype and \
                a.tobytes() == flat[key].tobytes()
    emit({"train_checkpoint": {"meta": meta, "bitwise": bool(same),
                               "bytes": n_bytes,
                               "step": int(opt_state["step"])}})
    if not same or meta["step"] != TRAIN_STEPS or \
            int(opt_state["step"]) != TRAIN_STEPS:
        raise AssertionError(f"checkpoint restore: bitwise {same}, meta "
                             f"{meta}, step {int(opt_state['step'])}")
    shutil.rmtree(ck)
    runs["trained_request_loop"] = trained_request_loop(torch, ops, cfg,
                                                        params)
    # the profile's graphed steps move the trees they are handed
    step_profiles = train_step_profile(
        torch, cfg, [params, opt_state],
        lambda: stream_batch(torch, cfg.vocab_size, 8, 256, SEED + 11))
    del params, opt_state
    sampler_ms(torch, cfg.vocab_size, 8, 256)
    return runs, step_profiles, twin


# ---------------------------------------------------------------------------
# Phase 9, the host mesh: the training launcher data-parallel over ranks

MESH_LOSS_RTOL = 5e-3    # n ranks' losses against one rank's, bf16 activations
WATCHDOG_CAPTURES = 50   # graphs captured each right after eager collectives


def watchdog_captures(torch, group, n: int = WATCHDOG_CAPTURES) -> int:
    """``n`` times: an eager all-reduce (work that ``ProcessGroupNCCL``'s
    watchdog thread then polls), at once a CUDA graph captured with
    eight all-reduces in it, and its replay. Each all-reduce is followed
    by a division by the group's size, so the tensor keeps its ones;
    raises if a capture fails or a value moves. Returns ``n``."""
    import torch.distributed as dist
    world = dist.get_world_size(group)
    x = torch.ones(1 << 20, device="cuda")

    def mean():
        dist.all_reduce(x, group=group)
        x.div_(world)

    for _ in range(n):
        mean()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(8):
                mean()
        graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(x, torch.ones_like(x)):
        raise AssertionError("all-reduces captured after eager ones moved "
                             "the values")
    return n


def mesh_step_profile(rank, world, group, steps: int = 5) -> dict:
    """One rank of the host mesh, for ``launch.distributed.spawn`` (or in
    this process at world 1): ``watchdog_captures``, then smollm-135m's
    train step at B 8 x S 256 as ``launch.train`` runs it on ``world``
    ranks (seeded weights broadcast from rank 0, this rank's rows of the
    stream's batch, ``make_train_step(group=)`` through ``DonatedStep``:
    eager, captured with its all-reduces (none at world 1), replayed):
    the unprofiled wall
    ms and ``profile_steps``' device-busy ms per step over ``steps``
    steps, the all-reduce's device ms (NCCL's kernels), its payload and
    ring GB per card, the peak reserved GB."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch import distributed
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import batch_rows
    from repro_torch.models import transformer as T
    from repro_torch.train.graphs import DonatedStep
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step
    from repro_torch.tree import tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    watchdog = watchdog_captures(torch, group)
    cfg = get_config("smollm-135m")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED + 13), device="cuda")
    distributed.broadcast_tree(params, group)
    state = [params, init_opt_state(params)]
    batch = stream_batch(torch, cfg.vocab_size, 8, 256, SEED + 11)
    rows = batch_rows(make_host_mesh(world), 8, rank)
    batch = {k: v[rows] for k, v in batch.items()}
    step = DonatedStep(make_train_step(cfg, AdamWConfig(
        total_steps=TRAIN_STEPS), remat=False, group=group))

    def one():
        state[0], state[1], _ = step(state[0], state[1], batch)

    one()
    one()                      # the eager step, then the capture
    torch.cuda.reset_peak_memory_stats()
    walls = wall_ms(torch, one, steps)
    prof = profile_steps(torch, one, steps, watch=("nccl",), cpu=False)
    payload = sum(t.numel() * t.element_size()
                  for t in tree_leaves(state[0])) / 1e9
    return {"rank": rank, "world": world, "card": torch.cuda.current_device(),
            "rows": [rows.start, rows.stop], "captures": step.captures,
            "watchdog_captures": watchdog, **walls,
            **{k: prof[k] for k in ("wall_ms_per_step",
                                    "device_busy_ms_per_step", "idle_share",
                                    "top_device_ms_per_step")},
            "allreduce_ms_per_step": prof["watched_device_ms_per_step"][
                "nccl"],
            "allreduce_payload_gb": payload,
            "allreduce_ring_gb_per_card": 2 * (world - 1) / world * payload,
            "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9}


def mesh_losses(torch, stats, one: list, what: str) -> dict:
    """A spawned run's ranks against one rank's losses ``one``: each
    rank's losses within MESH_LOSS_RTOL of them, every rank's losses and
    parameter digest the same; raises otherwise."""
    ranks = stats["ranks"]
    got = ranks[0]["losses"]
    err = max(abs(a - b) / abs(b) for a, b in zip(got, one))
    rec = {"losses": got, "losses_one_rank": one, "max_rel_err": err,
           "rtol": MESH_LOSS_RTOL,
           "ranks_bitwise": all(r["digest"] == ranks[0]["digest"]
                                and r["losses"] == got for r in ranks),
           "launches_by_rank": [r["launches"] for r in ranks]}
    if len(got) != len(one) or err > MESH_LOSS_RTOL or \
            not rec["ranks_bitwise"]:
        raise AssertionError(f"host mesh {what}: {rec}")
    return rec


def rank_launches(ops, rec) -> dict:
    """Every counter (``counters``) summed over a spawned run's ranks,
    each of which counted its own kernels' launches from 0 (the tiled
    route is not counted there: 0)."""
    return {k: sum(r.get(k, 0) for r in rec["launches_by_rank"])
            for k in counters(ops)}


def host_mesh_phase(torch, ops, twin=None) -> dict:
    """The host mesh (``launch.distributed``) on smollm-135m at B 8 x S
    256 for TWIN_STEPS steps, each part raising on a difference:
    (a) ``launch.train.main`` at world 1 over NCCL, graphed (a data axis
    of one adds no all-reduce), bitwise ``twin`` (the ungrouped
    graphed run of ``launch_twins``; run here when None): every step's
    metrics, params, ``mu``, ``nu``, ``step``; one capture each; then
    ``mesh_step_profile`` in this process at world 1;
    (b) ``main`` at world 2 on this one card over ``gloo`` (CUDA tensors,
    eager): each rank's losses within MESH_LOSS_RTOL of (a)'s, the ranks'
    losses and parameters bitwise;
    (c) with two cards or more, ``main`` at one rank per card over NCCL,
    graphed, held as (b) is, then ``mesh_step_profile`` on every card
    (step wall and busy ms, the all-reduce's ms and GB, reserved GB);
    with one card, a line saying so. Returns the launches by run."""
    from repro_torch.launch import distributed
    from repro_torch.launch import train as train_launch
    from repro_torch.tree import tree_leaves
    argv = ["--steps", str(TWIN_STEPS), "--batch", "8", "--seq", "256"]
    if twin is None:
        stats = {}
        with contextlib.redirect_stdout(io.StringIO()):
            train_launch.main(argv, world=1, stats=stats)
        twin = host_twin(stats)
    one = [m["loss"] for m in twin["metrics"]]
    runs = {}
    # (a) one rank over NCCL, graphed
    stats = {}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc, runs["host_mesh_nccl1"] = counted(
            torch, ops, lambda: train_launch.main(argv, world=1,
                                                  backend="nccl",
                                                  stats=stats))
    wall = time.perf_counter() - t0
    got = tree_leaves((stats["params"], stats["opt_state"]))
    want = tree_leaves((twin["params"], twin["opt_state"]))
    rec = {"world": 1, "backend": "nccl", "graphs": True, "rc": rc,
           "wall_s": wall, "metrics_bitwise": stats["metrics"] == twin[
               "metrics"],
           "state_bitwise": len(got) == len(want) and all(
               torch.equal(a.cpu(), b) for a, b in zip(got, want)),
           "captures": stats["captures"],
           "launches": runs["host_mesh_nccl1"]}
    del stats, got, want
    with distributed.process_group("cuda", 0, 1) as group:
        rec["step"] = mesh_step_profile(0, 1, group)
    emit({"host_mesh_nccl1": rec})
    if not (rec["metrics_bitwise"] and rec["state_bitwise"]) or \
            rec["captures"] != {"step": 1, "sampler": 1} or \
            rec["step"]["captures"] != 1:
        raise AssertionError(f"host mesh at one NCCL rank: {rec}")
    torch.cuda.empty_cache()
    # (b) two ranks on this card over gloo, eager
    stats = {}
    t0 = time.perf_counter()
    rc = train_launch.main(argv, world=2, backend="gloo", graphs=False,
                           stats=stats)
    rec = {"world": 2, "backend": "gloo", "graphs": False, "rc": rc,
           "wall_s": time.perf_counter() - t0,
           "captures": stats["captures"],
           **mesh_losses(torch, stats, one, "over gloo")}
    emit({"host_mesh_gloo2": rec})
    runs["host_mesh_gloo2"] = rank_launches(ops, rec)
    del stats
    torch.cuda.empty_cache()
    # (c) one rank per card over NCCL, graphed
    cards = torch.cuda.device_count()
    if cards < 2:
        emit({"host_mesh_cards": {"count": cards, "ran": False,
                                  "why": "one card: no NCCL ranks across "
                                         "cards"}})
        return runs
    stats = {}
    t0 = time.perf_counter()
    rc = train_launch.main(argv, world=cards, stats=stats)
    rec = {"world": cards, "backend": "nccl", "graphs": True, "rc": rc,
           "wall_s": time.perf_counter() - t0,
           "captures": stats["captures"],
           **mesh_losses(torch, stats, one, "over NCCL")}
    del stats
    torch.cuda.empty_cache()
    rec["steps"] = distributed.spawn(mesh_step_profile, cards, "cuda")
    emit({f"host_mesh_nccl{cards}": rec})
    runs[f"host_mesh_nccl{cards}"] = rank_launches(ops, rec)
    if rec["captures"] != {"step": 1, "sampler": 1} or any(
            r["captures"] != 1 for r in rec["steps"]):
        raise AssertionError(f"host mesh over {cards} cards: {rec}")
    return runs


# ---------------------------------------------------------------------------
# Phase 9b: the serving steps over the model axis

MP_LOGIT_RTOL = 5e-2   # bf16 activations: a rank's logits against the twin's,
                       # max |error| over the twin's max |logit|
# (name, arch, layers (None: all), --quant, batch, prompt, new tokens, world)
MP_CASES = (("mp_smollm_q0", "smollm-135m", None, 0, 4, 64, 16, None),
            ("mp_smollm_q8", "smollm-135m", None, 8, 4, 64, 16, None),
            ("mp_smollm_q4", "smollm-135m", None, 4, 4, 64, 16, None),
            ("mp_olmoe", "olmoe-1b-7b", None, 0, 4, 64, 8, None),
            ("mp_chatglm3", "chatglm3-6b", 2, 0, 4, 64, 8, 4),
            ("mp_chatglm3_rep", "chatglm3-6b", 2, 0, 4, 64, 7, 4))


def mp_config(arch: str, layers):
    import dataclasses as dc
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dc.replace(cfg, num_layers=layers)


def mp_weights(torch, cfg, quant: int, batch: int, prompt_len: int):
    """``launch.serve.run``'s seeded weights (int-N wire structs at
    ``quant``) and prompt, on this process's card."""
    from repro_torch.core.quantizer import quantize_params_for_serving
    from repro_torch.models import transformer as T
    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    params = T.init_params(cfg, g, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=g, device="cuda", dtype=torch.int32)
    if quant:
        params = quantize_params_for_serving(params, quant)
    return params, prompt


def mp_twin(torch, case) -> dict:
    """One case on this card with no model axis: the prefill's logits,
    a decode step's after it on the prompt's last token (the same input
    whatever the tokens chosen), ``generate``'s tokens and its last
    step's logits (eager, as the ranks step), on the host."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T
    name, arch, layers, quant, b, s, gen, _ = case
    cfg = mp_config(arch, layers)
    params, prompt = mp_weights(torch, cfg, quant, b, s)
    logits, caches, _ = T.prefill(params, cfg, prompt, max_len=s + gen)
    step, _ = T.decode_step(params, cfg, prompt[:, -1:], caches, s)
    stats = {}
    toks = generate(params, cfg, prompt, s + gen, gen, graphs=False,
                    stats=stats)
    out = {"prefill": logits.cpu(), "step": step.cpu(), "tokens": toks.cpu(),
           "last": stats["last_logits"].cpu(),
           "step_ms": stats["decode_s"] / (gen - 1) * 1e3}
    del params, logits, caches
    torch.cuda.empty_cache()
    return out


def mp_rank(rank, world, group, cases):
    """One rank of a (1, ``world``) mesh, for ``launch.distributed.spawn``:
    per case, the launch counters zeroed, the seeded weights made
    (quantized at ``--quant``) and cut to this rank's shards
    (``shard_tree``; the ranks take turns, so that only one whole tree is
    on a shared card at a time), then the rank program: its prefill and
    a decode step on the prompt's last token after it (its blocks of both
    logits kept), ``launch.serve.generate`` over the model axis (tokens,
    step wall, the last step's block of logits) and ``profile_steps``
    over 2 decode steps (NCCL's device ms), each counter read after; on
    NCCL ranks (after ``watchdog_captures`` on the axis's group) the
    graphed twin (``serve_graph_twin``), and the peak reserved GB."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch import model_parallel as mp
    from repro_torch.launch.mesh import coords, make_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.launch.sharding import param_pspecs, shard_tree
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(1, world)
    axis = mp.make_axis(mesh, rank, group)
    nccl = dist.get_backend(group) == "nccl"
    watchdog = watchdog_captures(torch, axis.group, RANK_WATCHDOG) \
        if nccl else None
    out = {}
    for case in cases:
        name, arch, layers, quant, b, s, gen, _ = case
        cfg = mp_config(arch, layers)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters(torch, ops)
        for turn in range(world):
            if turn == rank:
                full, prompt = mp_weights(torch, cfg, quant, b, s)
                params = shard_tree(full, param_pspecs(cfg, full, mesh=mesh),
                                    mesh, coords(mesh, rank))
                del full
                torch.cuda.empty_cache()
            dist.barrier(group)
        logits, caches, _ = T.prefill(params, cfg, prompt, max_len=s + gen,
                                      axis=axis)
        step_axis = mp.with_len(axis, s + gen)
        step, _ = T.decode_step(params, cfg, prompt[:, -1:], caches, s,
                                axis=step_axis)
        stats = {}

        def run(st, graphs):
            return generate(params, cfg, prompt, s + gen, gen,
                            graphs=graphs, stats=st, axis=axis)

        toks = run(stats, False)
        tok = toks[:, -1:]
        prof = profile_steps(torch, lambda: T.decode_step(
            params, cfg, tok, caches, s, axis=step_axis), 2,
            watch=("nccl",), cpu=False)
        launches = read_counters(torch, ops)
        graphed = serve_graph_twin(torch, ops, run, toks, stats) \
            if nccl else None
        out[name] = {
            "rank": rank, "card": torch.cuda.current_device(),
            "prefill": logits.cpu(), "step": step.cpu(),
            "tokens": toks.cpu(), "last": stats["last_logits"].cpu(),
            "prefill_s": stats["prefill_s"],
            "step_ms": stats["decode_s"] / (gen - 1) * 1e3,
            "profiled_step": {k: prof[k] for k in (
                "wall_ms_per_step", "device_busy_ms_per_step",
                "idle_share")},
            "nccl_device_ms_per_step":
                prof["watched_device_ms_per_step"]["nccl"] if nccl else None,
            "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
            "launches": launches,
            "watchdog_captures": watchdog if nccl and not out else None,
            "graphed": graphed}
        del params, caches, logits
        torch.cuda.empty_cache()
    return out


def mp_held(torch, twin: dict, ranks: list, name: str) -> dict:
    """The ranks' runs of one case against its twin: each rank's block of
    the prefill's logits, of the decode step on the prompt's last token
    and of ``generate``'s last step (when every token agrees) within
    MP_LOGIT_RTOL of the twin's largest logit there, the tokens'
    agreement, every rank's tokens the same."""
    recs = [r[name] for r in ranks]
    v = recs[0]["prefill"].shape[-1]

    def errs(key):
        scale = twin[key].float().abs().max().item()
        return [(r[key].float() - twin[key][..., i * v:(i + 1) * v].float())
                .abs().max().item() / scale for i, r in enumerate(recs)]
    agree = (recs[0]["tokens"] == twin["tokens"]).float().mean().item()
    last = max(errs("last")) if agree == 1.0 else None
    same = all(torch.equal(r["tokens"], recs[0]["tokens"]) for r in recs)
    rec = {"prefill_rel_err_by_rank": errs("prefill"),
           "step_rel_err_by_rank": errs("step"), "last_step_rel_err": last,
           "rtol": MP_LOGIT_RTOL, "tokens_agree": agree,
           "ranks_tokens_equal": same, "twin_step_ms": twin["step_ms"]}
    worst = max(rec["prefill_rel_err_by_rank"] + rec["step_rel_err_by_rank"])
    if worst > MP_LOGIT_RTOL or (last is not None and last >
                                 MP_LOGIT_RTOL) or not same:
        raise AssertionError(f"model axis {name}: {rec}")
    return rec


def model_parallel_phase(torch, ops) -> dict:
    """The serving steps' rank program (``launch.model_parallel``) on the
    card(s): with 4 cards or more one NCCL rank per card on a (1, 4) mesh,
    else 2 ranks over ``gloo`` (chatglm3-6b's case 4) on this card, CUDA
    tensors through the host. Each case's one-card twin runs first and is
    freed before its ranks start (OLMoE's f32 masters are 27.7 GB);
    ``mp_held`` holds the ranks to it. One ``model_parallel`` line per
    case: per rank the logits' error, step wall ms (``generate``'s
    eager steps), a profiled step's busy ms and NCCL's device ms, peak
    reserved GB and launches per kernel; on NCCL ranks the graphed twin
    (``serve_graph_twin``: tokens and last logits bit for bit, one
    capture a call, launches equal, ``generate`` graphed and eager in
    turns);
    with one card a ``rank_graphs_cards`` line. Returns the launches of
    each case summed over its ranks."""
    from repro_torch.launch import distributed
    cards = torch.cuda.device_count()
    rank_graphs_cards(torch, "9b")
    m = 4 if cards >= 4 else 2
    groups = collections.defaultdict(list)
    for case in MP_CASES:
        groups[case[-1] or m].append(case)
    runs = {}
    for world, cases in sorted(groups.items()):
        twins = {c[0]: mp_twin(torch, c) for c in cases}
        backend = "nccl" if cards >= world else "gloo"
        t0 = time.perf_counter()
        ranks = distributed.spawn(mp_rank, world, "cuda", cases,
                                  backend=backend)
        wall = time.perf_counter() - t0
        for case in cases:
            name = case[0]
            recs = [r[name] for r in ranks]
            rec = {"case": name, "arch": case[1], "layers": case[2],
                   "activations": case[7],
                   "quant": case[3], "batch": case[4], "prompt": case[5],
                   "gen": case[6], "world": world, "backend": backend,
                   "spawn_wall_s": wall,
                   **mp_held(torch, twins[name], ranks, name),
                   "ranks": [{k: r[k] for k in (
                       "rank", "card", "prefill_s", "step_ms",
                       "profiled_step", "nccl_device_ms_per_step",
                       "peak_reserved_gb", "launches", "watchdog_captures",
                       "graphed")} for r in recs]}
            emit({"model_parallel": rec})
            runs[name] = case_launches(ops, recs)
    return runs


# ---------------------------------------------------------------------------
# Phase 9c: the train step over the model axis

MP_TRAIN_STEPS = 3      # eager steps of every case, its twin's too
MP_TRAIN_NORM_RTOL = 2e-2   # a rank's grad_norm against the twin's: bf16
                            # cotangents summed over the ranks in other
                            # places than one card rounds them (4 x 2^-8)
MP_TRAIN_GRAD_RTOL = 2e-1   # bf16: each leaf's step-0 gradient on a rank
                            # against its shard of the twin's, L2 of the
                            # error over the twin's L2 (on the card 0.017
                            # on smollm-135m, 0.072-0.080 on OLMoE's
                            # expert stacks, where a rounding moves a token
                            # between near-tied experts). A replicated
                            # leaf's gradient counted m times misses by
                            # m - 1 >= 1, one missing the other ranks'
                            # terms by (m - 1) / m >= 0.5
MP_TRAIN_F32_GRAD_TOL = 1e-4    # f32 activations: max |error| over the
                                # shard's max |gradient|, the CPU test's
                                # LEAF_TOL (sums in other orders)
MP_TRAIN_GRAD_FLOOR = 1e-2  # the update's error is also read over the
                            # entries whose step-0 gradient is at least
                            # this share of its leaf's largest: Adam's
                            # first steps move each entry by ~lr whatever
                            # its size, so below it rounding noise decides
                            # the update's sign
# (name, arch, layers (None: all), data, model (None: the phase's m),
#  cards: "any", "4" (four cards only) or "1" (fewer than four only),
#  twin: "train" its steps, "eval" the step-0 loss, or "serve" (phase 9b's
#  twin: a prefill and decode steps), activations: "bf16" (the config's)
#  or "f32", fsdp: the FSDP layout (phase 9d) or the model axis alone)
MP_TRAIN_CASES = (
    ("mpt_smollm", "smollm-135m", None, 1, None, "any", "train", "bf16",
     False),
    ("mpt_chatglm3", "chatglm3-6b", 2, 1, 4, "any", "train", "bf16", False),
    ("mpt_chatglm3_f32", "chatglm3-6b", 2, 1, 4, "any", "train", "f32",
     False),
    ("mpt_olmoe", "olmoe-1b-7b", 2, 1, None, "any", "train", "bf16", False),
    ("mpt_smollm_dp", "smollm-135m", None, 2, 2, "4", "train", "bf16",
     False),
    ("mpt_olmoe_whole", "olmoe-1b-7b", None, 1, 4, "4", "eval", "bf16",
     False))
# Phase 9d: the FSDP layout, every leaf also split over the data axis
FSDP_CASES = (
    ("fsdp_smollm", "smollm-135m", None, 2, 1, "1", "train", "bf16", True),
    ("fsdp_smollm_2x2", "smollm-135m", None, 2, 2, "any", "train", "bf16",
     True),
    ("fsdp_olmoe", "olmoe-1b-7b", 2, 2, 1, "1", "train", "bf16", True),
    ("fsdp_smollm_serve", "smollm-135m", None, 2, 1, "1", "serve", "bf16",
     True),
    ("fsdp_olmoe_whole", "olmoe-1b-7b", None, 4, 1, "4", "eval", "bf16",
     True),
    ("fsdp_olmoe_2x2", "olmoe-1b-7b", None, 2, 2, "4", "eval", "bf16", True),
    ("fsdp_smollm_4", "smollm-135m", None, 4, 1, "4", "train", "bf16", True),
    ("fsdp_smollm_serve_2x2", "smollm-135m", None, 2, 2, "4", "serve", "bf16",
     True))
# the serving case's batch, prompt and new tokens: each of its decode
# steps gathers smollm-135m's 0.72 GB through the host on one card's gloo
# ranks (about 1 s a step on one H100)
FSDP_SERVE = (4, 64, 8)
# layout cases that keep each gathered block for the backward (no remat):
# the one-card (2, 1) cases, whose gathers cross the host a third less so
# (the one-card (2, 2) and the four-card cases keep remat)
FSDP_NO_REMAT = ("fsdp_smollm", "fsdp_olmoe")
MP_TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd")


def runs_on(case, four: bool) -> bool:
    """Whether a phase-9c / 9d case runs with (``four``) or without four
    cards."""
    return case[5] == "any" or case[5] == ("4" if four else "1")


def serve_case(case) -> tuple:
    """A phase-9d serving case as phase 9b's case tuple (``mp_twin``)."""
    b, s, gen = FSDP_SERVE
    return (case[0], case[1], case[2], 0, b, s, gen, None)


class CollectiveBytes:
    """``model_parallel._collective`` wrapped: while ``on``, each call's
    bytes (the larger of its operand's and its result's, as the dry run
    counts a collective) added up by kind and axis."""

    def __init__(self, mp):
        self.inner, self.on = mp._collective, False
        self.bytes = collections.Counter()
        mp._collective = self

    def __call__(self, kind, x, axis, dim=0):
        out = self.inner(kind, x, axis, dim)
        if self.on:
            self.bytes[f"{kind} {axis.name}"] += max(nbytes(x), nbytes(out))
        return out


def mpt_config(case):
    """A phase-9c case's config: ``mp_config`` at its depth, in f32
    activations for an "f32" case."""
    cfg = mp_config(case[1], case[2])
    return dataclasses.replace(cfg, dtype="float32") if case[7] == "f32" \
        else cfg


def mpt_weights(torch, cfg):
    """Seeded f32 masters of ``cfg`` on this process's card, the same on
    every rank and in the twin."""
    from repro_torch.models import transformer as T
    return T.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED + 31), device="cuda")


def leaf_paths(tree, path: str = "") -> list:
    """Each leaf's path ("/layers/attn/bk") in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [q for k, v in tree.items()
                for q in leaf_paths(v, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [q for i, v in enumerate(tree)
                for q in leaf_paths(v, f"{path}[{i}]")]
    return [path]


def mpt_twin(torch, case, path: str) -> dict:
    """One case on this card with no axis: ``make_train_step`` for
    MP_TRAIN_STEPS eager steps on the whole batch (B 8 x S 256, f32
    masters, the case's activations), each step's metrics and wall ms,
    and the step-0 gradient (``step_grads``) and the update (final minus
    initial) of every leaf, in the case's activations' dtype, saved to
    ``path`` for the ranks to cut by ``shard_tree``; or, for an "eval" twin, the step-0 metrics of
    ``make_eval_step``. Freed before it returns."""
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_loop import (make_eval_step,
                                              make_train_step, step_grads)
    from repro_torch.tree import tree_map
    kind = case[6]
    cfg = mpt_config(case)
    params = mpt_weights(torch, cfg)
    batch = stream_batch(torch, cfg.vocab_size, 8, 256, SEED + 11)
    torch.cuda.reset_peak_memory_stats()
    if kind == "eval":
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = make_eval_step(cfg)(params, batch)
        out = {"metrics": [{k: float(v) for k, v in m.items()}],
               "eval_ms": (time.perf_counter() - t0) * 1e3}
    else:
        # a bf16 case's trees kept in bf16: 2^-9 of each entry, far under
        # MP_TRAIN_GRAD_RTOL, at half the bytes through the file
        keep = torch.float32 if case[7] == "f32" else torch.bfloat16
        _, grads = step_grads(params, cfg, batch, remat=False)
        grads = tree_map(lambda t: t.to(keep).cpu(), grads)
        torch.cuda.empty_cache()
        p0 = params
        step = make_train_step(cfg, AdamWConfig(total_steps=TRAIN_STEPS),
                               remat=False)
        state = init_opt_state(params)
        metrics, walls = [], []
        for _ in range(MP_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
        t0 = time.perf_counter()
        torch.save({"grad": grads, "update": tree_map(
            lambda a, b: (a - b).to(keep).cpu(), params, p0)}, path)
        out = {"metrics": metrics, "step_ms": walls[1:],
               "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
               "save_s": time.perf_counter() - t0}
        del p0, state, grads
    del params, batch
    torch.cuda.empty_cache()
    return out


def mpt_leaf_errors(names, grads, params, inits, want_grads,
                    want_updates) -> dict:
    """A rank's leaves against their shards of the twin's, one leaf at a
    time on the card: the step-0 gradient's max |error| over the twin's
    max |gradient| (``grad_err``, which ``mpt_held`` holds) and its L2
    error over the twin's L2; the update's (final minus initial) L2
    error over the twin's, over every entry and over the entries whose
    twin gradient is at least MP_TRAIN_GRAD_FLOOR of the leaf's largest,
    with the share of entries below that. Returns the worst leaf of each
    figure, the medians, the three leaves of the largest ``grad_err`` and
    the worst update's leaf in full."""
    def rel_l2(d, w):
        return d.norm().item() / max(w.norm().item(), 1e-30)
    rows = []
    for name, g, p, a, wg, wu in zip(names, grads, params, inits,
                                     want_grads, want_updates,
                                     strict=True):
        dev = p.device
        g, wg, wu = g.to(dev), wg.to(dev).float(), wu.to(dev).float()
        top = wg.abs().max().item()
        du = (p - a.to(dev)) - wu
        big = wg.abs() >= MP_TRAIN_GRAD_FLOOR * top
        rows.append({"leaf": name,
                     "grad_err": (g - wg).abs().max().item()
                     / max(top, 1e-30),
                     "grad_rel_l2": rel_l2(g - wg, wg),
                     "update_rel_l2": rel_l2(du, wu),
                     "update_rel_l2_large_grad": rel_l2(du[big], wu[big]),
                     "small_grad_share": 1 - big.float().mean().item()})
    worst = {k: max(rows, key=lambda r: r[k]) for k in (
        "grad_err", "grad_rel_l2", "update_rel_l2",
        "update_rel_l2_large_grad")}
    top = sorted(rows, key=lambda r: -r["grad_err"])[:3]
    return {"grad_err_max": worst["grad_err"]["grad_err"],
            "grad_err_leaf": worst["grad_err"]["leaf"],
            "grad_err_top": [[r["leaf"], r["grad_err"], r["grad_rel_l2"]]
                             for r in top],
            "grad_rel_l2_max": worst["grad_rel_l2"]["grad_rel_l2"],
            "grad_rel_l2_leaf": worst["grad_rel_l2"]["leaf"],
            "grad_rel_l2_median": statistics.median(
                r["grad_rel_l2"] for r in rows),
            "update_rel_l2_median": statistics.median(
                r["update_rel_l2"] for r in rows),
            "update_worst_leaf": worst["update_rel_l2"],
            "update_rel_l2_large_grad_max": worst[
                "update_rel_l2_large_grad"]["update_rel_l2_large_grad"],
            "update_rel_l2_large_grad_leaf": worst[
                "update_rel_l2_large_grad"]["leaf"]}


def mpt_rank(rank, world, group, cases, paths):
    """One rank of a (data, ``world`` / data) mesh, for
    ``launch.distributed.spawn``: per case the seeded weights cut to this
    rank's shards (ranks sharing one card take turns, so that one whole
    tree is on it at a time) — of ``param_pspecs``, or under the FSDP
    layout (phase 9d) of ``param_pspecs(fsdp=True)``, each leaf then
    gathered over the data axis where read (``mp.Fsdp``) and the steps
    checkpointed (remat: the backward gathers each block again) — its
    rows of the twin's batch, its model and data axes, then
    MP_TRAIN_STEPS eager steps of ``make_train_step(axis=, group=,
    fsdp=)`` with every launch counter zeroed before them and read after
    (``ShapeLog`` keeping the flash kernels' signatures), the bytes of
    the second step's collectives by kind and axis (``CollectiveBytes``);
    each step's metrics and wall ms; for a "train" twin, against its
    shard of the twin's (``paths``; a replicated leaf's whole), each
    leaf's step-0 gradient (``step_grads`` before the steps, held by
    ``mpt_held``) and its update (final minus initial, reported:
    ``mpt_leaf_errors``); a sha256 of the leaves no model axis splits
    (under the layout, of those it leaves whole over the data axis);
    the last step profiled (NCCL's device ms), and the peak allocated
    and reserved GB; the steps update in place and, on NCCL ranks under
    the layout, an eval forward's peak over the shards follows
    (``fsdp_eval_peak``). On NCCL ranks each active axis's group first
    takes ``watchdog_captures``, and the steps' graphed twin follows
    from the same start (``mpt_graphed``). A "serve" case runs
    ``mpt_serve``. Returns {"cases": ..., "shapes": the flash kernels'
    signatures}."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch import distributed
    from repro_torch.launch import model_parallel as mp
    from repro_torch.launch.mesh import (DATA_AXIS, MODEL_AXIS, coords,
                                         make_mesh)
    from repro_torch.launch.sharding import (batch_rows, fsdp_dims,
                                             param_pspecs, shard_tree,
                                             split_axes)
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step, step_grads
    from repro_torch.tree import tree_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    log_shapes(ops)
    for name in MP_TRAIN_KERNELS:
        SHAPES[name].on = True
    moved = CollectiveBytes(mp)
    nccl = dist.get_backend(group) == "nccl"
    out = {}
    for case in cases:
        name, data, kind, fsdp = case[0], case[3], case[6], case[8]
        cfg = mpt_config(case)
        mesh = make_mesh(data, world // data)
        axis = mp.make_axis(mesh, rank, group)
        data_axis = mp.make_data_axis(mesh, rank, group)
        where = coords(mesh, rank)
        layout = mp.Fsdp(data_axis, fsdp_dims(cfg, T.param_shapes(cfg),
                                              mesh)) if fsdp else None
        watchdog = {a.name: watchdog_captures(torch, a.group, RANK_WATCHDOG)
                    for a in (axis, data_axis) if nccl and mp.active(a)}

        def shards():
            """The seeded weights cut to this rank's shards (the same
            start for the eager steps and their graphed twin)."""
            if kind == "serve":
                full, prompt = mp_weights(torch, cfg, 0, *FSDP_SERVE[:2])
            else:
                full, prompt = mpt_weights(torch, cfg), None
            params = shard_tree(full, param_pspecs(
                cfg, full, fsdp=fsdp, mesh=mesh), mesh, where)
            del full
            torch.cuda.empty_cache()
            return params, prompt

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for turn in range(1 if nccl else world):
            if nccl or turn == rank:
                params, prompt = shards()
            if not nccl:
                dist.barrier(group)
        if kind == "serve":
            out[name] = mpt_serve(torch, ops, cfg, params, prompt, mesh,
                                  where, axis, layout, moved, nccl, rank)
            out[name]["watchdog_captures"] = watchdog
            del params, prompt
            torch.cuda.empty_cache()
            continue
        # the leaves every rank holds whole (9c: no model axis splits
        # them), or under the layout those whole over the data axis, the
        # same on the ranks of one model index
        flags = [(DATA_AXIS if fsdp else MODEL_AXIS) not in f
                 for f in tree_leaves(split_axes(
                     cfg, params, world // data,
                     layout.dims if fsdp else None))]
        batch = stream_batch(torch, cfg.vocab_size, 8, 256, SEED + 11)
        rows = batch_rows(mesh, 8, where["data"])
        batch = {k: v[rows] for k, v in batch.items()}
        # the layout's program as ZeRO-3 runs it: remat (each block
        # gathered again in the backward; FSDP_NO_REMAT's keep it); every
        # rank program updates in place (a graphed one copies nothing back)
        remat = fsdp and name not in FSDP_NO_REMAT
        step = make_train_step(cfg, AdamWConfig(total_steps=TRAIN_STEPS),
                               remat=remat, group=data_axis, axis=axis,
                               fsdp=layout, in_place=True)
        # the initial shards and step-0 gradients on the host: OLMoE's
        # (2 layers) two ranks fill the card with their training state
        p0 = grads = None
        if kind == "train":
            _, grads = step_grads(params, cfg, batch, remat=remat,
                                  group=data_axis, axis=axis, fsdp=layout)
            grads = tree_map(lambda t: t.cpu(), grads)
            p0 = tree_map(lambda t: t.cpu(), params)
            torch.cuda.empty_cache()
        state = [params, init_opt_state(params)]

        def one():
            state[0], state[1], m = step(state[0], state[1], batch)
            return m

        zero_counters(torch, ops)
        metrics, walls = [], []
        for i in range(MP_TRAIN_STEPS - 1):
            moved.on = i == 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = one()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
        moved.on = False
        # the last step profiled (NCCL's device ms)
        prof = profile_steps(torch, lambda: metrics.append(
            {k: float(v) for k, v in one().items()}), 1, watch=("nccl",),
            cpu=False)
        launches = read_counters(torch, ops)
        rec = {"rank": rank, "card": torch.cuda.current_device(),
               "where": where, "rows": [rows.start, rows.stop],
               "metrics": metrics, "step_ms": walls[1:],
               "profiled_step": {k: prof[k] for k in (
                   "wall_ms_per_step", "device_busy_ms_per_step",
                   "idle_share")},
               "nccl_device_ms_per_step": prof[
                   "watched_device_ms_per_step"]["nccl"] if nccl else None,
               "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
               "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
               "replicated_sha256": distributed.digest(
                   [t for t, f in zip(tree_leaves(state[0]), flags) if f]),
               "collective_gb_per_step": {k: v / 1e9 for k, v in
                                          sorted(moved.bytes.items())},
               "launches": launches}
        moved.bytes.clear()
        if kind == "train":
            t0 = time.perf_counter()
            twin = torch.load(paths[name], mmap=True, weights_only=True)
            specs = param_pspecs(cfg, twin["grad"], fsdp=fsdp, mesh=mesh)
            rec.update(mpt_leaf_errors(
                leaf_paths(state[0]), tree_leaves(grads),
                tree_leaves(state[0]), tree_leaves(p0),
                tree_leaves(shard_tree(twin["grad"], specs, mesh, where)),
                tree_leaves(shard_tree(twin["update"], specs, mesh,
                                       where))),
                compare_s=time.perf_counter() - t0)
            del twin, p0, grads
        # the layout's memory check, on NCCL ranks (one a card): on one
        # card's gloo ranks a forward costs seconds of gathers via the host
        if fsdp and nccl:
            rec.update(fsdp_eval_peak(torch, cfg, state[0], batch, axis,
                                      layout))
        if nccl:      # the graphed twin, from the same start
            rec["watchdog_captures"] = watchdog
            kept = [t.cpu() for t in tree_leaves(state)]
            del state, params
            torch.cuda.empty_cache()
            rec["graphed"] = mpt_graphed(torch, ops, lambda: shards()[0],
                                         step, batch, metrics, kept, launches)
            del kept
        else:
            del state, params
        out[name] = rec
        del batch, step
        torch.cuda.empty_cache()
    return {"cases": out, "shapes": {n: SHAPES[n].seen
                                     for n in MP_TRAIN_KERNELS}}


def fsdp_eval_peak(torch, cfg, params, batch, axis, layout) -> dict:
    """What one forward of the FSDP layout holds beyond the rank's
    shards: ``make_eval_step``'s peak allocated GB over the GB allocated
    before it, beside the largest block's leaves gathered whole (f32) and
    the whole model's. A forward that gathers one block at a time holds
    about one block's weights (and their bf16 casts) beyond its shards;
    one that kept what it gathered would hold the model."""
    from repro_torch.models import transformer as T
    from repro_torch.train.train_loop import make_eval_step
    from repro_torch.tree import tree_leaves
    shapes = T.param_shapes(cfg)
    per = T.num_periods(cfg)
    block = max(sum(t.numel() * t.element_size() for t in tree_leaves(b))
                for b in shapes["blocks"]) / per
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    make_eval_step(cfg, axis, layout)(params, batch)
    torch.cuda.synchronize()
    return {"eval_peak_over_shards_gb": (torch.cuda.max_memory_allocated()
                                         - before) / 1e9,
            "largest_block_gb": block / 1e9,
            "model_gb": sum(t.numel() * t.element_size()
                            for t in tree_leaves(shapes)) / 1e9}


def mpt_graphed(torch, ops, shards, step, batch, eager_metrics: list,
                kept: list, eager_launches: dict) -> dict:
    """A rank case's graphed twin on an NCCL rank: from the same start
    (``shards()``, fresh optimizer state) the case's in-place step through
    ``DonatedStep`` for RANK_GRAPH_STEPS steps (eager, capture + replay,
    replay) with every launch counter zeroed before and read after,
    held to the eager steps' metrics (``eager_metrics``), every leaf of
    params, ``mu``, ``nu`` and ``step`` (``kept``, on the host) and
    launches bit for bit, and the peak allocated and reserved GB from the
    start (the graphed program's: its capture empties the eager warm-up's
    cached blocks); then, the ranks met at a barrier, RANK_TURNS turns of
    a replay and an eager step on the same state (the in-place step
    writes the graph's buffers, so the two modes share them), each
    timed, one more replay profiled (busy and NCCL's device ms), and the
    peaks over the turns (``turns_peak_*``: the eager steps' blocks
    cached beside the graph's pool). Raises on a miss."""
    from repro_torch.train.graphs import DonatedStep
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.tree import tree_leaves
    params = shards()
    state = [params, init_opt_state(params)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    graphed = DonatedStep(step)

    def one(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state[0], state[1], m = fn(state[0], state[1], batch)
        torch.cuda.synchronize()
        metrics.append({k: float(v) for k, v in m.items()})
        return (time.perf_counter() - t0) * 1e3

    metrics = []
    zero_counters(torch, ops)
    first = [one(graphed) for _ in range(RANK_GRAPH_STEPS)]
    launches = read_counters(torch, ops)
    got = tree_leaves(state)
    rec = {"metrics_bitwise": metrics == eager_metrics,
           "state_bitwise": len(got) == len(kept) and all(
               torch.equal(a.cpu(), b) for a, b in zip(got, kept)),
           "launches_equal": launches == eager_launches,
           "captures": graphed.captures, "write_back": graphed.write_back,
           "first_steps_ms": first, "graphed_step_ms": [],
           "eager_step_ms": [], "launches": launches,
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9}
    del got
    # the ranks compared their state on the host, each at its own pace:
    # met again before the timed turns, whose first collective would
    # otherwise wait for the slowest
    torch.distributed.barrier()
    for _ in range(RANK_TURNS):
        rec["graphed_step_ms"].append(one(graphed))
        rec["eager_step_ms"].append(one(step))
    prof = profile_steps(torch, lambda: one(graphed), 1, watch=("nccl",),
                         cpu=False)
    rec.update(profiled_step={k: prof[k] for k in (
        "wall_ms_per_step", "device_busy_ms_per_step", "idle_share")},
        nccl_device_ms_per_step=prof["watched_device_ms_per_step"]["nccl"],
        turns_peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        turns_peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9)
    del graphed, state, params    # the graph before any group goes
    torch.cuda.empty_cache()
    if not (rec["metrics_bitwise"] and rec["state_bitwise"]
            and rec["launches_equal"]) or rec["captures"] != 1 or \
            rec["write_back"] != [0]:
        raise AssertionError(f"a graphed rank step against its eager twin: "
                             f"{rec}")
    return rec


def serve_graph_twin(torch, ops, run, toks, stats) -> dict:
    """A serving rank's graphed twin on an NCCL rank: ``run(stats,
    graphs)`` (``launch.serve.generate`` over the rank's axes) graphed
    (the default on CUDA) and with ``graphs=False`` in RANK_SERVE_TURNS
    turns (graphed, eager, graphed, ...), each call's launch counters
    zeroed just before it (``counted``). Held: every call's tokens and
    last logits bit for bit those of the case's ``graphs=False`` call
    (``toks``, ``stats``), one capture a graphed call, every call's
    launches equal. Per call, the wall ms a decode step after the
    second (``steady_s``: a graphed call's replays) and over all its
    decode steps (``decode_s``: a graphed call's capture included);
    then one call of each mode profiled (busy, idle share and NCCL's
    device ms a call). Raises on a miss."""
    gen = toks.shape[1]
    modes = (("graphed", None), ("eager", False))
    rec = {"tokens_bitwise": True, "last_logits_bitwise": True,
           "captures": [], "launches": None, "launches_equal": True,
           **{f"{mode}_{k}": [] for mode, _ in modes
              for k in ("steady_step_ms", "decode_step_ms")}}
    for _ in range(RANK_SERVE_TURNS):
        for mode, graphs in modes:
            got = {}
            out, counts = counted(torch, ops, lambda: run(got, graphs))
            rec["tokens_bitwise"] &= torch.equal(out, toks)
            rec["last_logits_bitwise"] &= torch.equal(
                got["last_logits"], stats["last_logits"])
            rec["launches"] = rec["launches"] or counts
            rec["launches_equal"] &= counts == rec["launches"]
            if graphs is None:
                rec["captures"].append(got["captures"])
            rec[f"{mode}_steady_step_ms"].append(
                got["steady_s"] / (gen - 3) * 1e3)
            rec[f"{mode}_decode_step_ms"].append(
                got["decode_s"] / (gen - 1) * 1e3)
    for mode, graphs in modes:
        prof = profile_steps(torch, lambda: run({}, graphs), 1,
                             watch=("nccl",), cpu=False)
        rec[f"{mode}_profiled_call"] = {
            "wall_ms": prof["wall_ms_per_step"],
            "device_busy_ms": prof["device_busy_ms_per_step"],
            "idle_share": prof["idle_share"],
            "nccl_device_ms": prof["watched_device_ms_per_step"]["nccl"]}
    if not (rec["tokens_bitwise"] and rec["last_logits_bitwise"]
            and rec["launches_equal"]) or \
            rec["captures"] != [1] * RANK_SERVE_TURNS:
        raise AssertionError(f"a graphed serving rank against its eager "
                             f"twin: {rec}")
    return rec


def case_launches(ops, recs) -> dict:
    """Every counter summed over a case's ranks: the main path's launches
    and, on NCCL ranks, those of the graphed twin's run (its replays)."""
    return {k: sum(r["launches"].get(k, 0) + (
        r["graphed"]["launches"].get(k, 0) if r.get("graphed") else 0)
        for r in recs) for k in counters(ops)}


def mpt_serve(torch, ops, cfg, params, prompt, mesh, where, axis, layout,
              moved, nccl, rank) -> dict:
    """Phase 9d's serving case on one rank: its rows of the prompt
    through the prefill, a decode step on the prompt's last token after
    it and ``launch.serve.generate``, each leaf gathered over the data
    axis where read, the launch counters zeroed before and read after and
    the bytes of the collectives the decode step ran; then 2 decode steps
    profiled (NCCL's device ms), on NCCL ranks the graphed twin
    (``serve_graph_twin``), and the peak allocated and reserved GB. The
    logits are kept gathered over the model axis."""
    from repro_torch.launch import model_parallel as mp
    from repro_torch.launch.serve import generate
    from repro_torch.launch.sharding import batch_rows
    from repro_torch.models import transformer as T
    b, s, gen = FSDP_SERVE
    rows = batch_rows(mesh, b, where["data"])
    prompt = prompt[rows]
    zero_counters(torch, ops)
    logits, caches, _ = T.prefill(params, cfg, prompt, max_len=s + gen,
                                  axis=axis, fsdp=layout)
    step_axis = mp.with_len(axis, s + gen)
    moved.on = True
    step, _ = T.decode_step(params, cfg, prompt[:, -1:], caches, s,
                            axis=step_axis, fsdp=layout)
    moved.on = False
    stats = {}

    def run(st, graphs):
        return generate(params, cfg, prompt, s + gen, gen, graphs=graphs,
                        stats=st, axis=axis, fsdp=layout)

    toks = run(stats, False)
    launches = read_counters(torch, ops)
    tok = toks[:, -1:]
    prof = profile_steps(torch, lambda: T.decode_step(
        params, cfg, tok, caches, s, axis=step_axis, fsdp=layout), 2,
        watch=("nccl",), cpu=False)
    graphed = serve_graph_twin(torch, ops, run, toks, stats) if nccl \
        else None

    def whole(t):       # the logits gathered over the model axis
        return mp.all_gather(t, axis, -1).cpu()

    rec = {"rank": rank, "card": torch.cuda.current_device(),
           "where": where, "rows": [rows.start, rows.stop],
           "prefill": whole(logits), "step": whole(step),
           "tokens": toks.cpu(), "last": whole(stats["last_logits"]),
           "graphed": graphed,
           "prefill_s": stats["prefill_s"],
           "step_ms": stats["decode_s"] / (gen - 1) * 1e3,
           "collective_gb_per_step": {k: v / 1e9 for k, v in
                                      sorted(moved.bytes.items())},
           "profiled_step": {k: prof[k] for k in (
               "wall_ms_per_step", "device_busy_ms_per_step",
               "idle_share")},
           "nccl_device_ms_per_step":
               prof["watched_device_ms_per_step"]["nccl"] if nccl else None,
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
           "launches": launches}
    moved.bytes.clear()
    del caches, logits
    return rec


def mpt_held(twin: dict, recs: list, case) -> dict:
    """The ranks' runs of one case against its twin: each step's loss
    within MESH_LOSS_RTOL and grad_norm within MP_TRAIN_NORM_RTOL of the
    twin's (an "eval" twin: the step-0 xent, zloss and dropped_frac); each
    leaf's step-0 gradient against its shard of the twin's
    (``mpt_leaf_errors``): its relative L2 error within
    MP_TRAIN_GRAD_RTOL in bf16, its max error within MP_TRAIN_F32_GRAD_TOL
    of the shard's largest in f32; the ranks' metrics and replicated
    leaves bitwise each other's (under the FSDP layout, the leaves whole
    over the data axis, on the ranks of one model index); both flash
    kernels launched by every rank. Raises on a miss."""
    name, kind, f32 = case[0], case[6], case[7] == "f32"

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)
    first = recs[0]["metrics"]
    if kind == "eval":
        keys = ("xent", "zloss", "dropped_frac")
        loss_err = max(rel(first[0][k], twin["metrics"][0][k]) for k in keys
                       if twin["metrics"][0][k])
        norm_err = None
    else:
        loss_err = max(rel(a["loss"], b["loss"])
                       for a, b in zip(first, twin["metrics"]))
        norm_err = max(rel(a["grad_norm"], b["grad_norm"])
                       for a, b in zip(first, twin["metrics"]))
    held, tol = ("grad_err_max", MP_TRAIN_F32_GRAD_TOL) if f32 else \
        ("grad_rel_l2_max", MP_TRAIN_GRAD_RTOL)
    rec = {"losses": [m["loss"] for m in first],
           "twin_losses": [m.get("loss") for m in twin["metrics"]],
           "loss_rel_err": loss_err, "loss_rtol": MESH_LOSS_RTOL,
           "grad_norms": [m["grad_norm"] for m in first],
           "twin_grad_norms": [m.get("grad_norm") for m in twin["metrics"]],
           "grad_norm_rel_err": norm_err, "grad_norm_rtol": MP_TRAIN_NORM_RTOL,
           "grad_held": held, "grad_tol": tol,
           "grad_rel_l2_max_by_rank": [r.get("grad_rel_l2_max")
                                       for r in recs],
           "grad_rel_l2_leaf_by_rank": [r.get("grad_rel_l2_leaf")
                                        for r in recs],
           "grad_err_by_rank": [r.get("grad_err_max") for r in recs],
           "grad_err_top_by_rank": [r.get("grad_err_top") for r in recs],
           "update_worst_leaf_by_rank": [r.get("update_worst_leaf")
                                         for r in recs],
           "update_rel_l2_large_grad_max_by_rank": [
               r.get("update_rel_l2_large_grad_max") for r in recs],
           "ranks_metrics_bitwise": all(r["metrics"] == first for r in recs),
           "ranks_replicated_bitwise": all(
               len({r["replicated_sha256"] for r in recs
                    if not case[8] or r["where"]["model"] == m}) == 1
               for m in {r["where"]["model"] for r in recs}),
           "twin_step_ms": twin.get("step_ms"),
           "twin_peak_reserved_gb": twin.get("peak_reserved_gb"),
           "twin_wall_s": twin.get("twin_wall_s"),
           "twin_save_s": twin.get("save_s")}
    missed = [(r["rank"], k) for r in recs for k in MP_TRAIN_KERNELS
              if not r["launches"][k]]
    if loss_err > MESH_LOSS_RTOL or (norm_err or 0) > MP_TRAIN_NORM_RTOL \
            or (kind == "train" and any(r[held] > tol for r in recs)) \
            or not rec["ranks_metrics_bitwise"] \
            or not rec["ranks_replicated_bitwise"] or missed:
        raise AssertionError(f"model-parallel train {name}: {rec}, kernels "
                             f"not launched {missed}")
    return rec


def fsdp_serve_held(twin: dict, recs: list, name: str) -> dict:
    """Phase 9d's serving ranks against their twin, as ``mp_held`` holds
    phase 9b's: each rank's rows of the prefill's logits, of the decode
    step on the prompt's last token and of ``generate``'s last step (when
    every token agrees) within MP_LOGIT_RTOL of the twin's largest logit
    there, and the tokens' agreement; every kernel the twin's path runs
    (flash forward, decode attention) launched by every rank."""
    def errs(key):
        scale = twin[key].float().abs().max().item()
        return [(r[key].float() - twin[key][slice(*r["rows"])].float())
                .abs().max().item() / scale for r in recs]
    agree = min((r["tokens"] == twin["tokens"][slice(*r["rows"])])
                .float().mean().item() for r in recs)
    last = max(errs("last")) if agree == 1.0 else None
    rec = {"prefill_rel_err_by_rank": errs("prefill"),
           "step_rel_err_by_rank": errs("step"), "last_step_rel_err": last,
           "rtol": MP_LOGIT_RTOL, "tokens_agree": agree,
           "rows_by_rank": [r["rows"] for r in recs],
           "twin_step_ms": twin["step_ms"]}
    worst = max(rec["prefill_rel_err_by_rank"] + rec["step_rel_err_by_rank"])
    missed = [(r["rank"], k) for r in recs
              for k in ("flash_attention", "decode_attention")
              if not r["launches"][k]]
    if worst > MP_LOGIT_RTOL or (last is not None and last >
                                 MP_LOGIT_RTOL) or missed:
        raise AssertionError(f"fsdp serving {name}: {rec}, kernels not "
                             f"launched {missed}")
    return rec


@contextlib.contextmanager
def alloc_conf(value: str):
    """``PYTORCH_CUDA_ALLOC_CONF`` set to ``value`` for the processes
    spawned inside (this process's allocator is already made): the
    gloo ranks that share one card allocate without fragmenting it."""
    import os
    saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = value
    try:
        yield
    finally:
        if saved is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved


def mpt_emit(case, twin: dict, recs: list, world: int, backend: str,
             wall: float) -> None:
    """A phase-9c / 9d case's line: its ranks' records (``mpt_rank``)
    held to its twin (``mpt_held``; a serving case's ``fsdp_serve_held``)
    beside the case, its mesh and the spawn's seconds."""
    name, data = case[0], case[3]
    rec = {"case": name, "arch": case[1], "layers": case[2],
           "activations": case[7], "fsdp": case[8],
           "mesh": [data, world // data], "steps": MP_TRAIN_STEPS,
           "backend": backend, "gloo_on_one_card": backend == "gloo",
           "twin": case[6], "spawn_wall_s": wall}
    keys = ("rank", "card", "where", "rows", "step_ms", "profiled_step",
            "nccl_device_ms_per_step", "collective_gb_per_step",
            "peak_allocated_gb", "peak_reserved_gb", "launches",
            "eval_peak_over_shards_gb", "largest_block_gb", "model_gb",
            "watchdog_captures", "graphed")
    if case[6] == "serve":
        b, s, gen = FSDP_SERVE
        rec.update(batch=b, prompt=s, gen=gen,
                   **fsdp_serve_held(twin, recs, name),
                   ranks=[{k: r[k] for k in keys + ("prefill_s",) if k in r}
                          for r in recs])
        emit({"fsdp_serve": rec})
        return
    rec.update(batch=8, seq=256, remat=case[8] and name not in FSDP_NO_REMAT,
               **mpt_held(twin, recs, case),
               ranks=[{k: r[k] for k in keys + (
                   "grad_rel_l2_median", "update_rel_l2_median",
                   "update_rel_l2_large_grad_leaf", "compare_s") if k in r}
                   for r in recs])
    emit({"fsdp_train" if case[8] else "model_parallel_train": rec})


def model_parallel_train_phase(torch, ops, cases=MP_TRAIN_CASES) -> dict:
    """The train step's rank program (``make_train_step(axis=, group=)``)
    on the card(s): with 4 cards or more one NCCL rank per card, smollm-
    135m and OLMoE-1B-7B (2 of 16 layers) at (1, 4), chatglm3-6b (2 of 28
    layers) at (1, 4) in bf16 and in f32 activations, smollm-135m at (2,
    2) and OLMoE-1B-7B whole at (1, 4); with fewer, ``gloo`` ranks on
    this card: smollm-135m and OLMoE at (1, 2), chatglm3-6b's two at (1,
    4), and a line saying no four-card case ran. With ``FSDP_CASES``
    among ``cases`` (phase 9d, ``fsdp_phase``) also the FSDP layout
    (``make_train_step(fsdp=)``): on one card smollm-135m at (2, 1) and
    (2, 2), OLMoE-1B-7B at 2 of 16 layers at (2, 1) and smollm-135m's
    prefill and 8 decode tokens at (2, 1); on four, OLMoE-1B-7B whole at
    (4, 1) and (2, 2), smollm-135m at (2, 2) and (4, 1) and its serving
    at (2, 2). On NCCL ranks (one a card) each case's graphed twin
    follows its eager steps (``mpt_graphed``, ``serve_graph_twin``), held
    bit for bit; with one card a ``rank_graphs_cards`` line says why
    none runs. Cases of one
    world size share one spawn and one twin per model and kind. Each
    case's twin (``mpt_twin``; a serving case's ``mp_twin``) runs first
    and is freed; ``mpt_held`` (``fsdp_serve_held``) holds the ranks to
    it. One ``model_parallel_train`` line per case of phase 9c,
    ``fsdp_train`` / ``fsdp_serve`` of 9d (per rank: step metrics and
    wall ms, the leaves' gradient and update errors, the collectives' GB
    a step by kind and axis, the profiled step's busy ms and NCCL's
    device ms, peak allocated and reserved GB, launches); then the
    flash kernels at every signature the ranks launched
    (``check_path_shapes``). Returns the launches of each case summed
    over its ranks."""
    import tempfile
    from repro_torch.launch import distributed
    cards = torch.cuda.device_count()
    rank_graphs_cards(torch, "9c / 9d")
    four = cards >= 4
    groups = collections.defaultdict(list)
    for case in cases:
        if runs_on(case, four):
            groups[case[3] * (case[4] or (4 if four else 2))].append(case)
    if not four:
        emit({"model_parallel_train_cards": {
            "count": cards, "four_card_cases_ran": False,
            "why": "fewer than four cards: gloo ranks on this card stand in "
                   "for them; smollm-135m at (2, 2) and OLMoE-1B-7B whole "
                   "(and, under the FSDP layout, at (4, 1) and (2, 2)) "
                   "need four"}})
    runs, seen, made = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="mp_train_") as tmp:
        for world, group in sorted(groups.items()):
            backend = "nccl" if cards >= world else "gloo"
            keys = [(c[1], c[2], c[6], c[7]) for c in group]
            for c, key in zip(group, keys):   # one twin a model and kind
                if key not in made:
                    path = str(Path(tmp) / f"{c[0]}.pt")
                    t0 = time.perf_counter()
                    twin = mp_twin(torch, serve_case(c)) \
                        if c[6] == "serve" else mpt_twin(torch, c, path)
                    twin["twin_wall_s"] = time.perf_counter() - t0
                    made[key] = (twin, path)
            paths = {c[0]: made[key][1] for c, key in zip(group, keys)}
            t0 = time.perf_counter()
            with alloc_conf("expandable_segments:True"):
                ranks = distributed.spawn(mpt_rank, world, "cuda", group,
                                          paths, backend=backend)
            wall = time.perf_counter() - t0
            for r in ranks:
                for name, sigs in r["shapes"].items():
                    for sig, pos in sigs.items():
                        seen.setdefault(name, {}).setdefault(
                            sig, set()).update(pos)
            for case, key in zip(group, keys):
                recs = [r["cases"][case[0]] for r in ranks]
                mpt_emit(case, made[key][0], recs, world, backend, wall)
                runs[case[0]] = case_launches(ops, recs)
    emit({"model_parallel_train_path_checks": check_path_shapes(
        torch, ops, seen)})
    return runs


def fsdp_phase(torch, ops) -> dict:
    """Phase 9d alone: ``model_parallel_train_phase`` over
    ``FSDP_CASES``."""
    return model_parallel_train_phase(torch, ops, FSDP_CASES)


# ---------------------------------------------------------------------------
# The rank programs as CUDA graphs (phases 9b-9d on NCCL ranks, and the
# in-place step's graph on one card)

RANK_GRAPH_STEPS = 3     # steps of a graphed rank case held to its eager twin:
                         # eager, capture + replay, replay
RANK_TURNS = 3           # then a replay and an eager step, timed in turns
RANK_SERVE_TURNS = 3     # a serving rank's generate calls, graphed then eager
RANK_WATCHDOG = 10       # watchdog captures on each active subgroup
# the copies a graph's write-back launches (a DtoD memcpy, or foreach's
# copy kernel): a replay of an in-place step's graph holds no more than
# its eager twin's step (the update's own copy_ of each new leaf)
COPY_EVENTS = ("Memcpy DtoD", "CopyFunctor")


def rank_graphs_cards(torch, phase: str) -> bool:
    """Whether this card count runs the rank programs graphed (one NCCL
    rank a card needs two cards or more); with one card, a line saying
    why none is."""
    cards = torch.cuda.device_count()
    if cards < 2:
        emit({"rank_graphs_cards": {
            "phase": phase, "count": cards, "ran": False,
            "why": "one card: NCCL takes one rank a card and a CUDA graph "
                   "cannot capture gloo's collectives (they run on the "
                   "host), so this card's gloo ranks step eagerly "
                   "(graphs=False); the graphed rank programs and their "
                   "eager twins need two cards or more"}})
    return cards >= 2


def in_place_twin(torch, ops) -> dict:
    """The one-card check of the graphs' write-back: smollm-135m's step at
    B 8 x S 256 made with ``make_train_step(in_place=True)`` (no remat),
    three steps of the plain step from seeded weights, then three through
    ``DonatedStep`` (eager, capture + replay, replay) from the same
    start, each run's third step profiled. Held: every step's metrics
    and every leaf of params, ``mu``, ``nu`` and ``step`` bit for bit,
    the launches equal, one capture, no leaf written back
    (``write_back``), and a replay's copies (``COPY_EVENTS``) no more
    than the eager step's, where a write-back would add one a leaf.
    Returns the graphed run's launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train.graphs import DonatedStep
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step
    from repro_torch.tree import tree_leaves
    cfg = get_config("smollm-135m")
    batch = stream_batch(torch, cfg.vocab_size, 8, 256, SEED + 11)
    step = make_train_step(cfg, AdamWConfig(total_steps=TRAIN_STEPS),
                           remat=False, in_place=True)
    t0 = time.perf_counter()
    runs = {}
    for mode in ("eager", "graphed"):
        fn = step if mode == "eager" else DonatedStep(step)
        params = T.init_params(cfg, torch.Generator(
            device="cuda").manual_seed(SEED + 13), device="cuda")
        state, metrics = [params, init_opt_state(params)], []

        def one():
            state[0], state[1], m = fn(state[0], state[1], batch)
            metrics.append({k: float(v) for k, v in m.items()})

        zero_counters(torch, ops)
        one()
        one()
        launches = read_counters(torch, ops)
        prof = profile_steps(torch, one, 1, watch=COPY_EVENTS, cpu=False)
        runs[mode] = {"metrics": metrics, "launches": launches,
                      "leaves": [t.cpu() for t in tree_leaves(state)],
                      "copy_events": prof["watched_events_per_step"],
                      "busy_ms": prof["device_busy_ms_per_step"]}
        if mode == "graphed":
            runs[mode].update(captures=fn.captures,
                              write_back=fn.write_back)
        del fn, state, params
        torch.cuda.empty_cache()
    eager, graphed = runs["eager"], runs["graphed"]
    rec = {"arch": "smollm-135m", "batch": 8, "seq": 256, "steps": 3,
           "in_place": True,
           "metrics_bitwise": eager["metrics"] == graphed["metrics"],
           "state_bitwise": all(torch.equal(a, b) for a, b in zip(
               eager["leaves"], graphed["leaves"], strict=True)),
           "launches_equal": eager["launches"] == graphed["launches"],
           "captures": graphed["captures"],
           "write_back": graphed["write_back"],
           "copy_events_per_step": {"eager": eager["copy_events"],
                                    "graphed": graphed["copy_events"]},
           "busy_ms": {"eager": eager["busy_ms"],
                       "graphed": graphed["busy_ms"]},
           "wall_s": time.perf_counter() - t0}
    emit({"rank_graphs_in_place_twin": rec})
    if not (rec["metrics_bitwise"] and rec["state_bitwise"]
            and rec["launches_equal"]) or rec["captures"] != 1 or \
            rec["write_back"] != [0] or any(
                graphed["copy_events"][k] > eager["copy_events"][k]
                for k in COPY_EVENTS):
        raise AssertionError(f"the in-place step's graph: {rec}")
    return graphed["launches"]


# ---------------------------------------------------------------------------
# Phase 10: the model zoo

def zoo_reduced(torch, ops, b: int = 2, s: int = 16, steps: int = 4):
    """Every assigned arch at ``.reduced()`` (2 layers) in f32 on the
    card against the CPU's plain path on the same seeded weights:
    ``forward`` (logits and router aux), ``prefill`` and ``steps``
    ``decode_step``s from seeded random tokens (musicgen and qwen2-vl:
    frontend embeddings through ``embeds=``, qwen2-vl with M-RoPE
    position triples). Logits within 1e-3 of the largest, aux within
    1e-4 relative (f32 on both sides, sums in another order). Returns
    the run's launches."""
    from repro_torch.configs.base import ASSIGNED_ARCHS, get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.frontend import mrope_positions, stub_embeddings
    from repro_torch.tree import tree_map

    def run(params, cfg, inp, step_inputs, device):
        kw = {k: v.to(device) for k, v in inp.items()}
        tokens = kw.pop("tokens", None)
        logits, aux = T.forward(params, cfg, tokens, **kw)
        pre, caches, _ = T.prefill(params, cfg, tokens, max_len=s + steps,
                                   cache_dtype=torch.float32, **kw)
        outs = [logits, pre]
        for i, x in enumerate(step_inputs):
            lg, caches = T.decode_step(params, cfg, x.to(device), caches,
                                       s + i)
            outs.append(lg)
        return [o.float().cpu() for o in outs], \
            {k: float(v) for k, v in aux.items()}

    zero_counters(torch, ops)
    t0 = time.perf_counter()
    for arch in ASSIGNED_ARCHS:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32")
        cpu = T.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
        card = tree_map(lambda t: t.cuda(), cpu)
        g = torch.Generator().manual_seed(SEED + 1)
        if cfg.frontend != "none":
            inp = {"embeds": stub_embeddings(g, cfg, b, s, torch.float32)}
            step_inputs = [stub_embeddings(g, cfg, b, 1, torch.float32)
                           for _ in range(steps)]
        else:
            inp = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                           generator=g, dtype=torch.int32)}
            step_inputs = [torch.randint(0, cfg.vocab_size, (b, 1),
                                         generator=g, dtype=torch.int32)
                           for _ in range(steps)]
        if cfg.rope == "mrope":
            inp["positions"] = mrope_positions(b, s, (2, 2), device="cpu")
        want, want_aux = run(cpu, cfg, inp, step_inputs, "cpu")
        got, got_aux = run(card, cfg, inp, step_inputs, "cuda")
        top = max(w.abs().max().item() for w in want)
        err = max((a - w).abs().max().item() for a, w in zip(got, want))
        aux_err = max(abs(got_aux[k] - want_aux[k])
                      / max(abs(want_aux[k]), 1e-30) for k in want_aux)
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        emit({"zoo_reduced": {
            "arch": cfg.name, "family": cfg.family,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "blocks": [("moe+" if cfg.uses_moe(i) else "")
                       + cfg.block_kind(i)
                       for i in range(T.period_len(cfg))],
            "frontend": cfg.frontend, "rope": cfg.rope,
            "max_abs_err": err, "tol": 1e-3 * top,
            "aux_rel_err": aux_err, "aux": got_aux, "finite": finite}})
        if not (finite and err <= 1e-3 * top and aux_err <= 1e-4):
            raise AssertionError(f"{arch} reduced on the card vs the CPU: "
                                 f"max |err| {err} (tol {1e-3 * top}), "
                                 f"aux rel err {aux_err}")
    launches = read_counters(torch, ops)
    emit({"zoo_reduced_s": time.perf_counter() - t0,
          "zoo_reduced_launches": launches})
    return launches


def peak_gb(torch) -> float:
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def reserved_gb(torch) -> dict:
    """What the caching allocator holds from the card, now and at its
    peak since the last ``reset_peak_memory_stats`` (GB): unlike the
    allocated peak, it counts the memory the cached graphs' private
    pools keep between replays."""
    torch.cuda.synchronize()
    return {"reserved_gb": torch.cuda.memory_reserved() / 1e9,
            "max_reserved_gb": torch.cuda.max_memory_reserved() / 1e9}


def moe_sessions(torch, ops, backend, prompt, gen: int = 32):
    """The decode session on a MoE arch at a fixed 8-bit plan at p = L/2
    with the quantized-kernel device segment (``qkernels=True``:
    attention projections as int8 wire structs through qmatmul, the
    expert stacks dense, as in the reference) and with the dense
    fake-quantized one, in bf16 activations and, on the same weights and
    segment, in f32. The reference's claim that the two give the same
    tokens rests on its CPU run, where the kernel's plain version is the
    dense matmul; on the card the two sum in other orders, and the
    float8 device cache and the 8-bit hop turn last-bit differences into
    whole rounding steps, so the streams drift apart after some tokens
    (the CPU tests hold the tokens exactly). In bf16 the router's logits
    are rounded to bf16, so a last-bit difference of its input moves a
    token between its 8th and 9th expert often (the reduced model in
    bf16 on the CPU: first-token logits 15% of the largest apart, 46 of 64
    tokens equal); in f32 that needs a near-tie, but the float8 device
    cache and the 8-bit hop still turn last-bit differences into whole
    rounding steps (on an H100: f32 first-token logits 1.2% of the
    largest apart). Held here: the segment's structure (attention
    structs, dense expert stacks), finite logits, and in f32 the first
    token's logits within 5e-2 of the largest (``reference_check``'s
    criterion); the bf16 logits' difference and the tokens equal between
    the two are reported. Returns the bf16 qkernels run's launches."""
    from repro_torch.serving.backends import TransformerBackend
    from repro_torch.serving.decode import DecodeSession
    p = backend.cfg.num_layers // 2
    plan = fixed_plan(p)
    seg = backend.split(plan)
    f32 = TransformerBackend(dataclasses.replace(backend.cfg,
                                                 dtype="float32"),
                             backend.params, seq_len=backend.seq_len,
                             decode_max_len=backend.decode_max_len)
    toks, first, runs = {}, {}, {}
    for be, dt in ((backend, "bf16"), (f32, "f32")):
        for qk in (True, False):
            n = gen if dt == "bf16" else 8
            torch.cuda.reset_peak_memory_stats()
            zero_counters(torch, ops)
            captured = be.capture_count
            sess = DecodeSession(be, plan, max_len=be.decode_max_len,
                                 segment=seg, qkernels=qk)
            with recording(be, "hidden_logits", []) as seen:
                out = sess.generate(prompt, n)
            runs[(dt, qk)] = read_counters(torch, ops)
            if (dt, qk) == ("bf16", True):
                graph_check = graphed_vs_eager(
                    torch, sess, out, be.capture_count - captured,
                    DecodeSession(be, plan, max_len=be.decode_max_len,
                                  segment=seg, qkernels=qk, graphs=False),
                    prompt, n, f"{be.cfg.name} session")
            toks[(dt, qk)], first[(dt, qk)] = out.tokens, seen[0].float()
            if qk:
                layer = sess.dev_params["segment_blocks"][0]
                if not (ops.is_wire_struct(layer["attn"]["wq"]) and not any(
                        ops.is_wire_struct(v) for v in layer["moe"].values())):
                    raise AssertionError("qkernels segment: attention must "
                                         "be wire structs, experts dense")
            emit({"moe_session": {
                "arch": be.cfg.name, "activations": dt, "qkernels": qk,
                "p": p, "bits": 8, "batch": int(prompt.shape[0]),
                "new_tokens": out.new_tokens, "ttft_s": out.ttft_s,
                "tokens_per_s": out.tokens_per_s,
                "t_device_s": out.t_device_s, "t_server_s": out.t_server_s,
                "device_cache_bytes": out.device_cache_bytes,
                "device_cache_dtype": out.device_cache_dtype,
                "peak_memory_gb": peak_gb(torch),
                "launches": runs[(dt, qk)]}})
            del sess
        be.clear_qstacked()
    checks = {}
    for dt in ("bf16", "f32"):
        a, b = first[(dt, True)], first[(dt, False)]
        live = slice(0, backend.cfg.vocab_size)
        err = (a[:, live] - b[:, live]).abs().max().item()
        top = b[:, live].abs().max().item()
        checks[dt] = {"first_logits_max_abs_err": err, "max_abs": top,
                      "tokens_equal": int((toks[(dt, True)]
                                           == toks[(dt, False)]).sum()),
                      "of": int(toks[(dt, True)].size)}
        if not torch.isfinite(a[:, live]).all():
            raise AssertionError(f"MoE session {dt}: non-finite logits")
    checks["f32"]["tol"] = 5e-2 * checks["f32"]["max_abs"]
    if not checks["f32"]["first_logits_max_abs_err"] <= checks["f32"]["tol"]:
        raise AssertionError(f"MoE session f32: first-token logits qkernels "
                             f"vs dense apart: {checks['f32']}")
    emit({"moe_session_checks": checks, "graphed_vs_eager": graph_check})
    if not all(((t >= 0) & (t < backend.cfg.vocab_size)).all()
               for t in toks.values()):
        raise AssertionError(f"MoE session gave {toks!r}")
    return runs[("bf16", True)]


def graphed_vs_eager(torch, sess, out, captures, eager, prompt, n,
                     what) -> dict:
    """Hold a graphed session's ``generate`` (``out``, ``captures``
    graphs), its backend's first on its plan, to an eager twin's on the
    same plan: the tokens and the last step's logits bit for bit, one
    capture per stage key the stream used more than once (a key's
    second use captures)."""
    ref = eager.generate(prompt, n)
    rec = {"tokens_bitwise": bool(np.array_equal(out.tokens, ref.tokens)),
           "last_logits_bitwise": bool(torch.equal(sess.last_logits,
                                                   eager.last_logits)),
           "captures": captures, "stage_keys": len(sess.graph_keys),
           "graphs": sess.graphs,
           "tokens_per_s": {"eager": ref.tokens_per_s,
                            "graphed": out.tokens_per_s}}
    if not (rec["graphs"] and rec["tokens_bitwise"]
            and rec["last_logits_bitwise"]
            and 0 < captures == len(second_uses(collections.Counter(),
                                                sess))):
        raise AssertionError(f"{what}: graphed decode is not the eager "
                             f"step's: {rec}")
    return rec


def olmoe_phase(torch, ops) -> dict:
    """OLMoE-1B-7B at its registered shape (16 layers, d_model 2048,
    16/16 heads of 128, 64 experts top-8 of d_ff 1024, vocab 50304, bf16
    activations, f32 masters of 27.7 GB): the request loop (calibration
    on 16 x 128 cycle-task tokens, its calibration held to the eager
    twin's), the graphed forward in f32 against the CPU and its twin,
    the fixed-plan MoE sessions at p = 8 (L/2),
    then, with the backend freed, the launcher at --quant 0 and 8. Peak
    memory per sub-phase. Returns the launches by run."""
    runs = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, backend, launches, dep, prompt, srv, _ = request_loop(
        torch, ops, 16, 128, arch="olmoe-1b-7b", fixed_plans=False,
        forward_checks="calibrate")
    runs["olmoe_request_loop"] = launches
    emit({"olmoe_request_loop": {"s": time.perf_counter() - t0,
                                 "peak_memory_gb": peak_gb(torch)}})
    del dep, srv
    # in f32 on both sides (TF32 off), as Mamba2's: bf16 routing on the
    # card and the CPU may part at a near tie
    f32 = dataclasses.replace(cfg, dtype="float32")
    t0 = time.perf_counter()
    reference_check(torch, f32, params, dataclasses.replace(
        backend, cfg=f32), rel=1e-3)
    emit({"olmoe_reference_check_s": time.perf_counter() - t0})
    backend.clear_qstacked()
    torch.cuda.empty_cache()
    runs["olmoe_session"] = moe_sessions(torch, ops, backend, prompt)
    del params, backend
    torch.cuda.empty_cache()
    runs.update(launch_serve(torch, ops, arch="olmoe-1b-7b", quants=(0, 8),
                             tag="olmoe_launch",
                             sample_periods=(0, cfg.num_layers - 1),
                             graph_checks=((8, 0.0),), profiles=(0, 8)))
    torch.cuda.empty_cache()
    return runs


RING_REQUESTS = 4     # Mamba2's request series: fresh sessions, one backend
RING_PROMPT = 48      # its prompt length (the phase's session used 64)
RING_GEN = 8          # tokens per request
RING_MAX_LEN = 96     # the sessions' max_len
# the windowed series' prompt: past smollm-135m's long_500k window (4096),
# a multiple of the windowed attention's 512-row query block
WINDOW_PROMPT = 4608


def ring_request(torch, ops, backend, plan, seg, prompt, graphs: bool,
                 gen: int = RING_GEN, max_len: int = RING_MAX_LEN) -> dict:
    """One request of a ring-prefill stack (SSM or hybrid): a fresh
    ``DecodeSession`` (``graphs`` as given) generating ``gen`` tokens,
    counters zeroed before and read after -> its result, the session,
    the launches, the captures, each stage key's fate (``stage_fates``)
    and its seconds."""
    from repro_torch.serving.decode import DecodeSession
    before = cached_stages(backend)
    captured = backend.capture_count
    sess = DecodeSession(backend, plan, max_len=max_len, segment=seg,
                         graphs=graphs)
    out, secs, launches = timed_counts(torch, ops,
                                       lambda: sess.generate(prompt, gen))
    return {"out": out, "sess": sess, "launches": launches,
            "captures": backend.capture_count - captured, "s": secs,
            "fates": stage_fates(before, sess)}


def ring_series(torch, ops, backend, plan, prompt, requests: int,
                tag: str, max_len: int = RING_MAX_LEN) -> dict:
    """QPART's request loop over a ring-prefill stack: ``requests`` fresh
    graphed sessions on ``backend`` at one prompt length, each against a
    fresh ``graphs=False`` twin run just before it: tokens, the last
    step's logits and both caches bitwise, launches equal; each request
    captures exactly the stage keys it uses for the second time, and
    from its third on replays both ring-prefill stages and captures
    nothing. One line per request (TTFT, ``t_device_s``, ``t_server_s``
    of both, captures, each stage key's fate). Returns the last
    request's launches."""
    seg = backend.split(plan) if plan.p else None
    for i in range(requests):
        t = ring_request(torch, ops, backend, plan, seg, prompt, False,
                         max_len=max_len)
        g = ring_request(torch, ops, backend, plan, seg, prompt, True,
                         max_len=max_len)
        sess, twin = g["sess"], t["sess"]
        caches = all(torch.equal(as_bits(torch, a[k]), as_bits(torch, b[k]))
                     for side in ("dev_caches", "srv_caches")
                     for a, b in zip(getattr(sess, side) or [],
                                     getattr(twin, side) or [])
                     for k in a)
        prefill = {k[0]: fate for k, fate in g["fates"].items()
                   if k[0].startswith("prefill")}
        rec = {"arch": backend.cfg.name, "request": i + 1, "p": plan.p,
               "batch": int(prompt.shape[0]),
               "prompt": int(prompt.shape[1]),
               "new_tokens": g["out"].new_tokens,
               "tokens_bitwise": bool(np.array_equal(g["out"].tokens,
                                                     t["out"].tokens)),
               "last_logits_bitwise": bool(torch.equal(sess.last_logits,
                                                       twin.last_logits)),
               "caches_bitwise": caches,
               "launches_equal": g["launches"] == t["launches"],
               "captures": g["captures"],
               "fates": collections.Counter(g["fates"].values()),
               "prefill_stages": prefill,
               **{f"{k}_{mode}": getattr(r["out"], k)
                  for mode, r in (("graphed", g), ("eager", t))
                  for k in ("ttft_s", "t_device_s", "t_server_s")},
               "s_graphed": g["s"], "s_eager": t["s"],
               "launches": g["launches"]}
        emit({f"{tag}_ring_request": rec})
        want = {"prefill_server"} | ({"prefill_device"} if plan.p else set())
        if not (rec["tokens_bitwise"] and rec["last_logits_bitwise"]
                and caches and rec["launches_equal"]
                and rec["captures"] == rec["fates"]["captured"]
                and set(prefill) == want and t["captures"] == 0
                and (i < 2 or (rec["captures"] == 0 and set(
                    prefill.values()) == {"replayed"}))):
            raise AssertionError(f"{tag} ring request {i + 1} is not its "
                                 f"twin's: {rec}")
    return g["launches"]


def jamba_ring(torch, ops) -> dict:
    """Jamba-v0.1 at its registered widths (d_model 4096, 32 heads of
    128 over 8 KV heads, SSD d_state 16 with heads of 64, 16 experts
    top-2 at d_ff 14336, vocab 65536, bf16) with the depth cut to one
    pair of blocks, as ``.reduced()`` pairs them (``attn_every`` 2:
    layer 0 an SSD block, layer 1 attention with MoE), on the card at a
    fixed 8-bit plan at p = 1: the device prefill graph runs the SSD
    block's quantized projections, the server prefill graph
    ``flash_attention`` and the MoE; three requests on one backend, each
    bitwise its twin with equal launches, the third replaying both
    prefill stages. Returns that request's launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.backends import TransformerBackend
    cfg = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(cfg, name=cfg.name + "-2l", num_layers=2,
                              attn_every=2)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda")
    backend = TransformerBackend(cfg, params, seq_len=64,
                                 decode_max_len=RING_MAX_LEN)
    prompt, _ = cycle_batch(np.random.default_rng(SEED), cfg.vocab_size, 2,
                            RING_PROMPT)
    launches = ring_series(torch, ops, backend, fixed_plan(1), prompt, 3,
                           "jamba")
    emit({"jamba_ring_peak_memory_gb": peak_gb(torch)})
    if not launches["flash_attention"]:
        raise AssertionError(f"jamba's replayed ring prefill launched no "
                             f"flash attention: {launches}")
    return launches


def window_ring(torch, ops) -> dict:
    """smollm-135m at its registered shape with the sliding window that
    ``configs.for_shape`` gives a full-attention arch at ``long_500k``
    (4096), on the card at a fixed 8-bit plan at p = L/2 under one
    prompt of ``WINDOW_PROMPT`` tokens, past the window: the ring
    prefill takes the windowed attention and writes both slots' rings
    whole (rolled as bit patterns; the device ring is float8); three
    requests on one backend, each bitwise its twin with equal launches,
    the third replaying both prefill stages. Returns that request's
    launches."""
    from repro_torch.configs.base import INPUT_SHAPES, for_shape, get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.backends import TransformerBackend
    cfg = for_shape(get_config("smollm-135m"), INPUT_SHAPES["long_500k"])
    max_len = WINDOW_PROMPT + RING_GEN
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda")
    backend = TransformerBackend(cfg, params, seq_len=64,
                                 decode_max_len=max_len)
    prompt, _ = cycle_batch(np.random.default_rng(SEED), cfg.vocab_size, 1,
                            WINDOW_PROMPT)
    launches = ring_series(torch, ops, backend,
                           fixed_plan(cfg.num_layers // 2), prompt, 3,
                           "window", max_len=max_len)
    emit({"window_ring": {"window": cfg.sliding_window,
                          "prompt": WINDOW_PROMPT, "max_len": max_len,
                          "peak_memory_gb": peak_gb(torch)}})
    return launches


def mamba2_phase(torch, ops) -> dict:
    """Mamba2-1.3B at its registered shape (48 SSD layers, d_model 2048,
    d_inner 4096, 64 heads of 64, d_state 128, chunk 256, vocab 50280,
    bf16 activations): the launcher at --quant 0, 8 and 4, the full-width
    forward in f32 against the CPU's plain versions (1e-3 of the largest
    logit), and a decode session at a
    fixed 8-bit plan at p = 24 (segment prefill into split SSM caches,
    then decode). The family is attention-free: only the quantize
    kernels launch here. Returns the launches by run."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.backends import TransformerBackend
    from repro_torch.serving.decode import DecodeSession
    arch = "mamba2-1.3b"
    cfg = get_config(arch)
    print("attention-free: no attention or qmatmul kernel runs on "
          f"{cfg.name}, only the quantize kernels (--quant 8 / 4)",
          flush=True)
    runs = launch_serve(torch, ops, arch=arch, quants=(0, 8, 4),
                        tag="mamba2_launch",
                        sample_periods=(0, cfg.num_layers - 1),
                        graph_checks=((4, 0.0),))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda")
    backend = TransformerBackend(cfg, params, seq_len=64, decode_max_len=96)
    # in f32 on both sides (TF32 off): bf16 through 48 SSD layers drifts
    # past reference_check's 5% (5.04% on an H100)
    f32 = dataclasses.replace(cfg, dtype="float32")
    reference_check(torch, f32, params,
                    TransformerBackend(f32, params, seq_len=64), rel=1e-3)
    p = cfg.num_layers // 2
    plan = fixed_plan(p)
    prompt, _ = cycle_batch(np.random.default_rng(SEED), cfg.vocab_size, 2,
                            64)
    zero_counters(torch, ops)
    captured = backend.capture_count
    sess = DecodeSession(backend, plan, max_len=96)
    out = sess.generate(prompt, 32)
    runs["mamba2_session"] = read_counters(torch, ops)
    emit({"mamba2_graphed_vs_eager": graphed_vs_eager(
        torch, sess, out, backend.capture_count - captured,
        DecodeSession(backend, plan, max_len=96, graphs=False), prompt, 32,
        "mamba2 session")})
    emit({"mamba2_session": {
        "p": p, "bits": 8, "batch": 2, "prompt": 64,
        "new_tokens": out.new_tokens, "ttft_s": out.ttft_s,
        "tokens_per_s": out.tokens_per_s, "t_device_s": out.t_device_s,
        "t_server_s": out.t_server_s,
        "device_cache_bytes": out.device_cache_bytes,
        "server_cache_bytes": out.server_cache_bytes,
        "device_cache_dtype": out.device_cache_dtype,
        "peak_memory_gb": peak_gb(torch),
        "launches": runs["mamba2_session"]}})
    if out.tokens.shape != (2, 32) or not (
            (out.tokens >= 0) & (out.tokens < cfg.vocab_size)).all():
        raise AssertionError(f"mamba2 session gave {out.tokens!r}")
    t0 = time.perf_counter()
    series, _ = cycle_batch(np.random.default_rng(SEED + 1), cfg.vocab_size,
                            2, RING_PROMPT)
    runs["mamba2_ring"] = ring_series(torch, ops, backend, plan, series,
                                      RING_REQUESTS, "mamba2")
    emit({"mamba2_ring_series_s": time.perf_counter() - t0})
    del params, backend, sess
    torch.cuda.empty_cache()
    for name, phase in (("jamba_ring", jamba_ring),
                        ("window_ring", window_ring)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runs[name] = phase(torch, ops)
        emit({f"{name}_s": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    return runs


# the zoo's train runs: steps at B 8 x S 256, and steps of the
# launcher's run on musicgen-medium
ZOO_TRAIN_STEPS = 20
ZOO_LAUNCH_STEPS = 10
# AdamW's peak lr for the zoo's steps: OLMoE's cross-entropy does not
# fall in 20 steps at the launcher's 3e-4 (an H100 run: mean of the first
# five 11.218, of the last five 11.233; at 1e-3 11.218 -> 11.142)
ZOO_LR = 1e-3


def zoo_batches(torch, cfg, batch: int, seq: int, seed: int, graphs=None):
    """Endless seeded batches of the training launcher's token stream on
    the card (``graphs`` as the stream takes it); for a frontend arch
    (``embeds=``) the tokens become embeddings through a fixed seeded
    table of ``stub_embeddings`` rows (a codebook lookup, so the labels
    stay learnable), in the model's activation dtype."""
    from repro_torch.data.pipeline import TokenStream, TokenStreamConfig
    from repro_torch.models.frontend import stub_embeddings
    from repro_torch.models.transformer import model_dtype
    stream = TokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size,
                                           seq_len=seq + 1,
                                           batch_size=batch, seed=seed),
                         device="cuda", graphs=graphs)
    table = None
    if cfg.frontend != "none":
        table = stub_embeddings(torch.Generator(device="cuda").manual_seed(
            seed), cfg, 1, cfg.vocab_size, model_dtype(cfg))[0]
    for b in stream.batches():
        if table is not None:
            b = {"embeds": table[b["tokens"].long()], "labels": b["labels"]}
        yield b


ZOO_TWIN_STEPS = 3     # the eager twin: plain, MoE-bracketed, profiled


def zoo_train(torch, ops, arch: str, layers=None):
    """One zoo arch trained on the card with f32 masters and its own
    activation dtype: (i) one f32 loss backward of its ``.reduced()``
    variant against the CPU's plain versions, leaf by leaf
    (``train_grads_check``; B 2 x S 128); (ii) ``make_train_step`` as a
    donated CUDA graph (``DonatedStep``: step 1 eager, step 2 the
    capture) for ZOO_TRAIN_STEPS steps at B 8 x S 256 (AdamW at ZOO_LR,
    2 warm-up steps) on ``zoo_batches`` (its sampler graphed too) — the
    mean cross-entropy of the last five steps below that of the first
    five, every step's global gradient norm finite (so every gradient
    is), the flash forward and backward kernels launched once per
    attention layer per step, one capture of the step; peak allocated
    and reserved memory; the state after ZOO_TWIN_STEPS steps copied to
    the host; (iii) ``train_step_profile`` of the graphed step (remat
    off); (iv) with the graphs gone, the eager twin: the same seeded
    weights, ZOO_TWIN_STEPS plain steps on an eager stream of the same
    seed — its metrics and final params, moments and ``step`` bit for
    bit the graphed run's, its peak memory beside the graph's; its
    second step, on a MoE arch, bracketed by ``moe_block_ms`` (the MoE
    blocks' device ms; it brackets eager calls), its third profiled
    (``profile_steps``: the eager step's busy ms beside the graph's).
    ``layers`` cuts the depth at full width. Returns (launches by run,
    the step's profile)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train.graphs import DonatedStep
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    tag = arch.split("-")[0]
    red = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    runs = {f"{tag}_train_grads": train_grads_check(
        torch, ops, red, next(zoo_batches(torch, red, 2, 128, SEED + 5)))}
    opt_cfg = AdamWConfig(lr=ZOO_LR, warmup_steps=2,
                          total_steps=ZOO_TRAIN_STEPS)
    step_fn = make_train_step(cfg, opt_cfg, remat=False)

    def init():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = T.init_params(cfg, torch.Generator(
            device="cuda").manual_seed(SEED), device="cuda")
        return params, init_opt_state(params)

    def memory() -> dict:
        return {"peak_memory_gb": peak_gb(torch),
                "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9}

    params, opt_state = init()
    state_gb = peak_gb(torch)
    jstep = DonatedStep(step_fn)
    batches = zoo_batches(torch, cfg, 8, 256, SEED + 12)
    losses, norms, xents, metrics, snap = [], [], [], [], None
    wall = 0.0

    def run():
        nonlocal params, opt_state, snap, wall
        for i in range(ZOO_TRAIN_STEPS):
            t0 = time.perf_counter()
            params, opt_state, m = jstep(params, opt_state, next(batches))
            losses.append(m["loss"].item())
            xents.append(m["xent"].item())
            norms.append(m["grad_norm"].item())
            wall += time.perf_counter() - t0
            if i < ZOO_TWIN_STEPS:
                metrics.append({k: v.item() for k, v in m.items()})
            if i == ZOO_TWIN_STEPS - 1:
                snap = [t.to("cpu", copy=True)
                        for t in tree_leaves((params, opt_state))]

    _, runs[f"{tag}_train"] = counted(torch, ops, run)
    graphed_memory = memory()
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    xent_first, xent_last = np.mean(xents[:5]), np.mean(xents[-5:])
    L = cfg.num_layers
    flash = (runs[f"{tag}_train"]["flash_attention"],
             runs[f"{tag}_train"]["flash_attention_bwd"])
    emit({"zoo_train": {
        "arch": cfg.name, "layers": L, "d_model": cfg.d_model,
        "params": sum(t.numel() for t in tree_leaves(params)),
        "state_gb": state_gb, "activations": cfg.dtype,
        "inputs": "embeds" if cfg.frontend != "none" else "tokens",
        "batch": 8, "seq": 256, "steps": ZOO_TRAIN_STEPS, "loss": losses,
        "xent": xents, "grad_norm": norms, "loss_first5": first,
        "loss_last5": last, "xent_first5": xent_first,
        "xent_last5": xent_last, "wall_s": wall,
        "wall_s_per_step": wall / ZOO_TRAIN_STEPS,
        "captures": jstep.captures, **graphed_memory,
        "launches": runs[f"{tag}_train"]}})
    # the cross-entropy, not the total: the router losses in the total
    # can fall while the model learns nothing
    if not (xent_last < xent_first and np.isfinite(losses).all()
            and np.isfinite(norms).all()):
        raise AssertionError(f"{cfg.name} training: xent {xent_first} -> "
                             f"{xent_last}, grad norms {norms}")
    if flash != (L * ZOO_TRAIN_STEPS, L * ZOO_TRAIN_STEPS) or \
            jstep.captures != 1:
        raise AssertionError(f"{cfg.name} training: flash launches {flash}, "
                             f"captures {jstep.captures}")
    state = [params, opt_state]
    del params, opt_state, batches, jstep, run
    torch.cuda.empty_cache()
    prof = train_step_profile(
        torch, cfg, state,
        lambda: next(zoo_batches(torch, cfg, 8, 256, SEED + 11)),
        remats=(False,), modes=("graphed",), turns=1)[0]
    del state
    # (iv) the eager twin, alone on the card
    params, opt_state = init()
    batches = zoo_batches(torch, cfg, 8, 256, SEED + 12, graphs=False)
    twin, twin_s = [], []

    def eager():
        nonlocal params, opt_state
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, next(batches))
        twin.append({k: v.item() for k, v in m.items()})
        twin_s.append(time.perf_counter() - t0)

    moe = None
    eager()
    if cfg.moe is not None:
        moe = moe_block_ms(torch, eager, 1, sum(
            cfg.uses_moe(layer) for layer in range(cfg.num_layers)))
    else:
        eager()
    eager_prof = profile_steps(torch, eager, 1)
    leaves = tree_leaves((params, opt_state))
    same = len(leaves) == len(snap) and all(
        torch.equal(a, b.to("cuda")) for a, b in zip(leaves, snap))
    rec = {"arch": cfg.name, "layers": L, "steps": ZOO_TWIN_STEPS,
           "metrics_bitwise": twin == metrics, "state_bitwise": same,
           "eager_s_per_step": twin_s,
           "eager_profiled_step": {k: eager_prof[k] for k in (
               "wall_ms_per_step", "device_busy_ms_per_step", "idle_share",
               "device_events_per_step", "top_device_ms_per_step")},
           "graphed": graphed_memory, "eager": memory()}
    if moe is not None:
        rec["moe_block_ms_per_step"] = moe
        rec["moe_share_of_graphed_busy"] = sum(moe.values()) / prof[
            "device_busy_ms_per_step"]
    emit({"zoo_train_twin": rec})
    del params, opt_state, batches, leaves, snap
    torch.cuda.empty_cache()
    if not (rec["metrics_bitwise"] and same):
        raise AssertionError(f"{cfg.name}: the graphed steps differ from "
                             f"the eager twin's: {rec}")
    return runs, (cfg, prof)


def zoo_train_phase(torch, ops):
    """Training the zoo on the card: MusicGen-medium at its registered
    shape (48 layers, d_model 1536, 24 heads, d_ff 6144, GeLU, LayerNorm;
    fed through ``embeds=``), then ``launch.train.main`` on it for
    ZOO_LAUNCH_STEPS steps on tokens (exit 0: the loss improved);
    OLMoE-1B-7B at full width (d_model 2048, 16 heads of 128, 64 experts
    top-8 of d_ff 1024, vocab 50304) and 4 of its 16 layers, its router
    losses in the loss (``zoo_train`` each). Returns (launches by run,
    the two steps' (config, profile))."""
    from repro_torch.launch import train as train_launch
    runs, profiles = {}, []
    for arch, layers in (("musicgen-medium", None), ("olmoe-1b-7b", 4)):
        r, prof = zoo_train(torch, ops, arch, layers)
        runs.update(r)
        profiles.append(prof)
        if arch == "musicgen-medium":
            argv = ["--arch", arch, "--steps", str(ZOO_LAUNCH_STEPS),
                    "--batch", "8", "--seq", "256"]
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rc, runs["musicgen_launch_train"] = counted(
                torch, ops, lambda: train_launch.main(argv, world=1))
            emit({"zoo_train_launch": {
                "argv": argv, "rc": rc, "wall_s": time.perf_counter() - t0,
                "peak_memory_gb": peak_gb(torch),
                "launches": runs["musicgen_launch_train"]}})
            if rc != 0:
                raise AssertionError(f"launch.train {argv}: the loss did not "
                                     "improve")
            torch.cuda.empty_cache()
    return runs, profiles


# ---------------------------------------------------------------------------
# Phase 11: the step roofline

SHARES = ("compute_share_busy", "compute_share_wall", "memory_share_busy",
          "memory_share_wall", "mfu_wall")
MAX_SHARE = 1.05


def roofline_phase(torch, smi, train_profiles, decode_profiles,
                   zoo_profiles=()) -> list:
    """The dry run's count (``roofline.op_cost`` on fake tensors: matmul
    FLOPs, unfused bytes) of the smoke's own steps, set against the times
    this run measured for them: the train step (smollm-135m, B 8 x S
    256, remat off and on, ``train_step_profile``), the launcher's
    decode step (batch 4 after a 64-token prompt, --quant 0 and 8, the
    graphed step ``profile_launch`` measured, counted at the last
    position it profiled, a host int) and the
    zoo's train steps (``zoo_profiles``: (config, profile) pairs of
    ``zoo_train``, B 8 x S 256, remat off). One
    ``roofline`` line per step: counted GFLOP and GB, the model FLOPs,
    the compute and memory terms at the card's data-sheet rates and
    their bound, the measured device-busy ms per step (the profiled
    window's) and wall ms per step (the unprofiled median; the profiled
    one beside it), each term's share of both, the model FLOPs' share of
    the wall (MFU), the peak used (by the matmuls' dtype), the ops that
    move the most counted bytes and the card. A share over MAX_SHARE means the count exceeds what the
    card did: the lines print, then the phase fails."""
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.core.quantizer import quantize_params_for_serving
    from repro_torch.launch import steps
    from repro_torch.models.transformer import model_dtype
    from repro_torch.roofline import op_cost
    from repro_torch.roofline.analysis import PEAKS, analyze, model_flops_for
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import make_train_step
    card = dict(zip(("name", "power_limit"),
                    (f.strip() for f in smi.split(","))))
    lines = []

    def line(step, cfg, fn, args, shape, prof, **what):
        peak = "f32" if cfg.dtype == "float32" else "bf16"
        t0 = time.perf_counter()
        summary = op_cost.count(fn, *args)
        count_s = time.perf_counter() - t0
        roof = analyze(summary, arch=cfg.name, shape=shape.name, peak=peak,
                       model_flops=model_flops_for(cfg, shape))
        busy = prof["device_busy_ms_per_step"]
        wall = prof["unprofiled_wall_ms"]
        top = sorted(summary.bytes_by_op.items(), key=lambda kv: -kv[1])
        t_c, t_m = roof.t_compute * 1e3, roof.t_memory * 1e3
        rec = {"step": step, "arch": cfg.name, **what,
               "counted_gflop": roof.gflops, "counted_gb": roof.gbytes,
               "model_gflops": roof.model_gflops, "t_compute_ms": t_c,
               "t_memory_ms": t_m, "bound_ms": max(t_c, t_m),
               "bound_by": roof.bottleneck, "busy_ms": busy,
               "wall_ms": wall,
               "profiled_wall_ms": prof["wall_ms_per_step"],
               "compute_share_busy": t_c / busy,
               "compute_share_wall": t_c / wall,
               "memory_share_busy": t_m / busy,
               "memory_share_wall": t_m / wall,
               "mfu_wall": roof.model_gflops * 1e9 / (wall / 1e3
                                                      * PEAKS[peak]),
               "peak": peak, "peak_flops_per_s": PEAKS[peak],
               "hbm_bytes_per_s": h100().HBM_BW,
               "kernel_calls": summary.kernel_calls,
               "top_gb_by_op": {k: v / 1e9 for k, v in top[:4]},
               "count_s": count_s,
               "card": card}
        emit({"roofline": rec})
        lines.append(rec)

    def train_lines(cfg, profiles):
        params = steps.param_specs(cfg)
        mode = steps.fake_mode_of(params)
        opt_state = steps.opt_specs(params)
        with mode:
            batch = {"labels": torch.empty((8, 256), dtype=torch.int32)}
            if cfg.frontend != "none":
                batch["embeds"] = torch.empty(
                    (8, 256, cfg.d_model), dtype=model_dtype(cfg))
            else:
                batch["tokens"] = torch.empty((8, 256), dtype=torch.int32)
        for prof in profiles:
            fn = make_train_step(cfg, AdamWConfig(total_steps=TRAIN_STEPS),
                                 remat=prof["remat"])
            line("train", cfg, fn, (params, opt_state, batch),
                 InputShape("smoke_train", 256, 8, "train"), prof,
                 layers=cfg.num_layers, batch=8, seq=256,
                 remat=prof["remat"], inputs=sorted(batch))
        return params, mode

    cfg = get_config("smollm-135m")
    params, mode = train_lines(cfg, train_profiles)
    serve_step = steps.make_serve_step(cfg)
    for prof in decode_profiles:
        served = params
        if prof["quant"]:
            with mode:
                served = quantize_params_for_serving(params, prof["quant"])
        caches = steps.cache_specs(cfg, prof["batch"], prof["cache_len"],
                                   mode=mode)
        with mode:
            token = torch.empty((prof["batch"], 1), dtype=torch.int32)
        pos = prof["positions"][1]

        def step(p, tok, c, pos=pos):
            logits, _ = serve_step(p, tok, c, pos)
            return torch.argmax(logits[:, 0:1], -1).to(torch.int32)

        line("decode", cfg, step, (served, token, caches),
             InputShape("smoke_decode", prof["cache_len"], prof["batch"],
                        "decode"), prof, batch=prof["batch"],
             quant=prof["quant"], pos=pos)
    for zoo_cfg, prof in zoo_profiles:
        train_lines(zoo_cfg, [prof])
    over = [r for r in lines if max(r[k] for k in SHARES) > MAX_SHARE]
    if over:
        raise AssertionError(f"a roofline share over {MAX_SHARE}: the count "
                             f"exceeds what the card did: {over}")
    return lines


# ---------------------------------------------------------------------------
# Phase 12: the port's examples on the card

# examples/torch_<name>.py, in the order they are ported
EXAMPLES = ("fleet_simulation", "fault_tolerant_fleet", "quickstart",
            "adaptive_serving", "workload_balancing", "quantized_lm_serving",
            "train_small_lm")
# host-only examples, whose stdout on the card must equal a CPU run's
FLEET_EXAMPLES = ("fleet_simulation", "fault_tolerant_fleet")


@contextlib.contextmanager
def made(cls, out: list):
    """Append every instance of ``cls`` made while inside to ``out``."""
    init = cls.__init__

    def record(self, *a, **k):
        init(self, *a, **k)
        out.append(self)

    cls.__init__ = record
    try:
        yield out
    finally:
        cls.__init__ = init


def run_example(torch, ops, name: str, device: str, prepare=None):
    """``main(["--device", device])`` of ``examples/torch_<name>.py``
    (``prepare(module)`` first, when given), its stdout captured,
    counters zeroed before and read after -> (its key numbers, stdout,
    seconds, launches, the captures of its graphed steps and token
    streams)."""
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.train.graphs import DonatedStep
    module = example(f"torch_{name}")
    if prepare is not None:
        prepare(module)
    buf = io.StringIO()
    zero_counters(torch, ops)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf), made(DonatedStep, []) as \
                steps, made(TokenStream, []) as streams:
            out = module.main(["--device", device])
    finally:
        print(buf.getvalue(), end="", flush=True)
    torch.cuda.synchronize()
    captures = {"steps": [s.captures for s in steps],
                "samplers": [s.captures for s in streams]}
    return out, buf.getvalue(), time.perf_counter() - t0, read_counters(
        torch, ops), captures


def keep_served(kept: dict):
    """A ``prepare`` for ``run_example``: wraps the LM example's ``serve``
    stage so that its arguments and result land in ``kept``."""
    def prepare(module):
        inner = module.serve

        def serve(params, cfg, rng, **kw):
            out = inner(params, cfg, rng, **kw)
            kept.update(module=module, params=params, cfg=cfg, out=out)
            return out
        module.serve = serve
    return prepare


def lm_example_tokens(torch, kept: dict) -> dict:
    """The LM example's greedy tokens against the known answer and the
    CPU: the f32 ``generate`` on the card must continue the cycle task
    from the prompt (t[i + 1] = t[i] + 1 mod V) and equal the plain
    versions' tokens on the CPU from the same trained weights; the
    fake-quantized weights' tokens (``quantize_blocks`` at the plan's
    bits) and the streamed deployment's are set against the same CPU
    run and the cycle, and reported."""
    from repro_torch.launch.serve import generate
    from repro_torch.tree import tree_map
    if not kept:
        raise AssertionError("the LM example's serve stage never ran")
    out, cfg = kept["out"], kept["cfg"]
    prompt = torch.as_tensor(out["prompt"], dtype=torch.int32)
    params = tree_map(lambda t: t.detach().cpu(), kept["params"])
    n = out["f32_tokens"].shape[1]
    cycle = ((prompt[:, -1:].long() + 1 + torch.arange(n))
             % cfg.vocab_size).numpy()
    cpu_f32 = generate(params, cfg, prompt, max_len=32, gen=n).numpy()
    cpu_q = generate(kept["module"].quantize_blocks(
        params, out["bits"], cfg.num_layers), cfg, prompt, max_len=32,
        gen=n).numpy()
    rec = {"f32_is_cycle": bool((out["f32_tokens"] == cycle).all()),
           "f32_equals_cpu": bool((out["f32_tokens"] == cpu_f32).all()),
           "quantized_equals_cpu_share": float(
               (out["quantized_tokens"] == cpu_q).mean()),
           "quantized_cycle_share": float(
               (out["quantized_tokens"] == cycle).mean()),
           "cpu_quantized_cycle_share": float((cpu_q == cycle).mean()),
           "stream_cycle_share": float((out["stream"].tokens
                                        == cycle).mean())}
    emit({"lm_example_tokens": rec})
    if not (rec["f32_is_cycle"] and rec["f32_equals_cpu"]):
        raise AssertionError(f"the LM example's f32 tokens on the card "
                             f"{out['f32_tokens']}, on the CPU {cpu_f32}, "
                             f"the cycle's {cycle}")
    return rec


def examples_phase(torch, ops) -> dict:
    """Every port example (``examples/torch_<name>.py``) through its
    ``main`` with ``--device cuda`` at the reference's own sizes, counters
    zeroed before each: its own asserts hold, its stdout prints, and one
    ``example`` line carries its seconds, key numbers and launches. The
    fleet examples run again with ``--device cpu`` and their stdout must
    be the same bytes: they are NumPy on the host whatever the device,
    so this guards only against host nondeterminism (the CPU tests hold
    them to the reference byte for byte). The classifier and fleet
    examples launch no kernel; ``torch_quantized_lm_serving`` launches
    the matmul kernel its plan picks (qmatmul or qmatmul4) and its
    tokens are held by ``lm_example_tokens``; ``torch_train_small_lm``'s
    checkpoint restores bit for bit. Returns the launches by run."""
    runs = {}
    for name in EXAMPLES:
        kept = {}
        out, text, secs, launches, captures = run_example(
            torch, ops, name, "cuda",
            keep_served(kept) if name == "quantized_lm_serving" else None)
        rec = {"name": f"examples/torch_{name}.py", "s": secs,
               "captures": captures, **out}
        if name == "quantized_lm_serving":
            rec["tokens"] = lm_example_tokens(torch, kept)
        if name in FLEET_EXAMPLES:
            rec["stdout_equals_cpu_run"] = \
                run_example(torch, ops, name, "cpu")[1] == text
        emit({"example": {**rec, "launches": launches}})
        runs[f"example_{name}"] = launches
        if name in FLEET_EXAMPLES and not rec["stdout_equals_cpu_run"]:
            raise AssertionError(f"{name}: stdout on the card differs from "
                                 "the CPU run's")
        if name == "quantized_lm_serving" and not (
                launches["qmatmul"] + launches["qmatmul4"]):
            raise AssertionError(f"{name}: no qmatmul kernel launched "
                                 f"{launches}")
        if name == "train_small_lm" and not rec["checkpoint_bitwise"]:
            raise AssertionError(f"{name}: the checkpoint did not restore "
                                 "bit for bit")
        if name not in ("quantized_lm_serving", "train_small_lm") and any(
                launches.values()):
            raise AssertionError(f"{name} launched kernels: {launches}")
    runs["mnist_step_twin"] = mnist_step_twin(torch, ops)
    return runs


def mnist_step_twin(torch, ops) -> dict:
    """The MNIST MLP's SGD step (``examples/torch_mnist_mlp.py`` ``train``,
    which the three classifier examples share) for its 400 steps,
    graphed (the default on the card) and ``graphs=False``: the trained
    weights bit for bit, each mode's seconds and captures, no kernel
    launched (plain PyTorch). One ``mnist_step_twin`` line; raises on a
    difference. Returns the graphed run's launches."""
    from repro_torch.train.graphs import DonatedStep
    mlp = example("torch_mnist_mlp")
    out = {}
    for graphs in (None, False):
        with made(DonatedStep, []) as steps:
            t0 = time.perf_counter()
            (params, _), launches = counted(torch, ops, lambda: mlp.train(
                device="cuda", graphs=graphs))
            out[graphs] = (params, time.perf_counter() - t0,
                           steps[0].captures, launches)
    (pg, sg, cg, lg), (pe, se, ce, le) = out[None], out[False]
    same = all(torch.equal(a[k], b[k]) for a, b in zip(pg, pe) for k in a)
    rec = {"steps": 400, "bitwise": same, "graphed_s": sg, "eager_s": se,
           "captures": [cg, ce], "launches": lg}
    emit({"mnist_step_twin": rec})
    if not same or (cg, ce) != (1, 0) or any(lg.values()) or lg != le:
        raise AssertionError(f"the MNIST step graphed vs eager: {rec}")
    return lg


# ---------------------------------------------------------------------------
# Phase 13: the kernels at the shapes the zoo's training and the examples
# gave them

def held(what: dict, err: float, tol: float, same: bool) -> None:
    """One ``check`` line; raises on an error over ``tol`` or a second
    call that differs."""
    emit({"check": what["kernel"], "shape": "path", **what,
          "max_abs_err": err, "tol": tol, "repeat_bitwise": same})
    if not (err <= tol and same):
        raise AssertionError(f"{what}: max |err| {err} > {tol} or a second "
                             f"call differs ({same})")


def check_path_shapes(torch, ops, seen=None) -> dict:
    """Every signature the ``ShapeLog``s kept (``SHAPES``: the zoo's
    training and the examples; or ``seen``, {kernel: {signature:
    positions}}, phase 9c's ranks') replayed on seeded card tensors of its
    shapes and dtypes: the kernel's wrapper against its plain version
    with the tolerances of phase 3 and the GPU tests, a second call
    bitwise the first. qmatmul / qmatmul4 on a weight of N(0, 1/K)
    quantized per tensor or per column as the call was: f32 x within
    2e-5 of the largest output, bf16 x within 1e-3 (f32 out) or one bf16
    step of the largest output (bf16 out); decode attention at the
    smallest and largest position called, within 1e-4 on an f32 query
    and f32 ring, else 2e-2, the position read on the card bitwise the
    host int; the flash forward within 1e-4 (f32) or 2e-2
    (bf16) of ``_blocked_causal_attention``, its lse (when called with
    one) within 1e-4; the backward as ``held_flash_bwd``. Returns the
    number of signatures by kernel."""
    from repro_torch.kernels import ref
    from repro_torch.models.attention import _blocked_causal_attention
    from repro_torch.models.common import to_storage
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    dtype = lambda name: getattr(torch, name)  # noqa: E731
    randn = lambda shape, dt: torch.randn(  # noqa: E731
        shape, generator=g, device="cuda").to(dtype(dt))
    counts = {}
    logs = {name: log.seen for name, log in SHAPES.items()} if seen is None \
        else seen
    for name, sigs in logs.items():
        counts[name] = len(sigs)
        fn = ops.KERNELS[name]
        for sig, positions in sorted(sigs.items(), key=str):
            if name in ("qmatmul", "qmatmul4"):
                (xs, xdt), cshape, per_col, out = sig
                packed = name == "qmatmul4"
                k, n = xs[1], cshape[1] * (2 if packed else 1)
                codes, scale, mu, _ = quantized_weight(
                    torch, g, k, n, 15 if packed else 255, per_col)
                if packed:
                    codes = ref.pack_int4_ref(codes)
                plain = ref.qmatmul4_ref if packed else ref.qmatmul_ref
                x = randn(xs, xdt)
                args = (x, codes, scale, mu, dtype(out))
                got, again, want = fn(*args), fn(*args), plain(*args)
                top = want.float().abs().max().item()
                tol = (2e-5 * max(1.0, top) if xdt == "float32" else
                       1e-3 if out == "float32" else 2 ** -7 * top)
                held({"kernel": name, "x": xs, "x_dtype": xdt, "n": n,
                      "per_column": per_col, "out": out},
                     (got.float() - want.float()).abs().max().item(), tol,
                     bool(torch.equal(got, again)))
            elif name == "decode_attention":
                (qs, qdt), (cs, cdt) = sig
                q = randn(qs, qdt)
                kv = torch.randn((2, *cs), generator=g, device="cuda")
                ck, cv = (to_storage(t, dtype(cdt)) for t in kv)
                tol = 1e-4 if (qdt, cdt) == ("float32", "float32") else 2e-2
                positions = positions or {0}
                for pos in sorted({min(positions), max(positions)}):
                    got, again = fn(q, ck, cv, pos), fn(q, ck, cv, pos)
                    on_card = fn(q, ck, cv, torch.tensor(pos, device="cuda"))
                    want = ref.decode_attention_ref(q, ck, cv, pos)
                    held({"kernel": name, "q": qs, "q_dtype": qdt,
                          "cache": cs, "cache_dtype": cdt, "pos": pos},
                         (got.float() - want.float()).abs().max().item(),
                         tol, bool(torch.equal(got, again)
                                   and torch.equal(got, on_card)))
            elif name == "flash_attention":
                (qs, dt), ks, with_lse = sig
                q, k, v = randn(qs, dt), randn(ks, dt), randn(ks, dt)
                (got, lse), (again, lse_again) = (
                    fn(q, k, v, with_lse=True) if with_lse
                    else (fn(q, k, v), None) for _ in range(2))
                want = _blocked_causal_attention(q, k, v, qs[1], qs[1])
                what = {"kernel": name, "q": qs, "dtype": dt,
                        "with_lse": with_lse}
                same = bool(torch.equal(got, again))
                if with_lse:
                    lse_want = ref.flash_attention_lse_ref(q, k)
                    what["lse_rel_err"] = (lse - lse_want).abs().max().item(
                    ) / max(1.0, lse_want.abs().max().item())
                    same = same and bool(torch.equal(lse, lse_again))
                    if what["lse_rel_err"] > 1e-4:
                        raise AssertionError(f"{what}: lse > 1e-4")
                held(what, (got.float() - want.float()).abs().max().item(),
                     1e-4 if dt == "float32" else 2e-2, same)
            else:
                (qs, dt), ks = sig
                held_flash_bwd(torch, randn(qs, dt), randn(ks, dt),
                               randn(ks, dt), randn(qs, dt), shape="path")
        torch.cuda.synchronize()
    if seen is None:
        emit({"path_shape_checks": counts})
    return counts


SOURCES = {"qmatmul": ("src/repro_torch/csrc/qmatmul.cu",
                       "src/repro/kernels/qmatmul.py:68"),
           "qmatmul4": ("src/repro_torch/csrc/qmatmul.cu",
                        "src/repro/kernels/qmatmul.py:118"),
           "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                "src/repro/kernels/decode_attention.py:127"),
           "decode_attention_shard": (
               "src/repro_torch/csrc/decode_attention.cu",
               "src/repro/kernels/decode_attention.py:127"),
           "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:98"),
           "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                                   "src/repro/models/attention.py:120"),
           "quantize": ("src/repro_torch/csrc/quantize.cu",
                        "src/repro/kernels/quantize.py:80"),
           "quantize_pack4": ("src/repro_torch/csrc/quantize.cu",
                              "src/repro/kernels/quantize.py:127"),
           "dequantize": ("src/repro_torch/csrc/quantize.cu",
                          "src/repro/kernels/quantize.py:101")}

# kernels with no TPU kernel of their own: what the reference computes in
# their place
PORT_ONLY = {"flash_attention_bwd": (
    "port-only: the gradient of flash_attention, which the reference "
    "leaves to XLA's autodiff of _blocked_causal_attention (it has no "
    "backward kernel)"),
             "decode_attention_shard": (
    "port-only variant of decode_attention: a shard of a ring split on "
    "its slots over the model axis, with the row log-sum-exp (bf16 and "
    "float8 shards on the tensor cores, decode_shard_tc_kernel; f32 "
    "shards on decode_attention's kernel); the reference's GSPMD "
    "partitions decode_attention's ring instead")}

# kernels whose design changed after their first port, and in which PR
REDESIGNED = {"qmatmul4": "PR 13", "flash_attention": "PR 13",
              "qmatmul": "PR 14", "decode_attention": "PR 14",
              "flash_attention_bwd": "PR 19"}

# the kernels each path's run must launch, the tiled qmatmul route (M >
# 16) included: every prefill of the decode features and of the
# quantized launcher takes it (the classifier loop is plain PyTorch, as
# the reference's is plain XLA: it must launch none); every training run
# launches the flash forward and backward kernels
EXPECTED = {"request_loop": ("qmatmul", "qmatmul4", "decode_attention",
                             "flash_attention"),
            "fleet": ("decode_attention", "flash_attention"),
            # the graphed decode sessions of the graph phase, by cut
            "graphs_p0": ("decode_attention",),
            **{f"graphs_p{p}": ("qmatmul", "decode_attention")
               for p in GRAPH_CUTS[1:]},
            **{run: ("qmatmul", "qmatmul_tiled", "decode_attention")
               for run in ("decode_plain", "decode_chunk16",
                           "decode_draft2", "decode_draft4",
                           "decode_paged", "decode_plain_pL",
                           "decode_draft4_pL")},
            "launch_q0": ("decode_attention", "flash_attention"),
            "launch_q8": ("quantize", "qmatmul", "qmatmul_tiled",
                          "dequantize", "decode_attention",
                          "flash_attention"),
            "launch_q4": ("quantize_pack4", "qmatmul4", "qmatmul4_tiled",
                          "dequantize", "decode_attention",
                          "flash_attention"),
            **{run: ("flash_attention", "flash_attention_bwd")
               for run in ("train_grads", "train_remat0", "train_remat1",
                           "train", "train_twin_remat0", "train_twin_remat1",
                           "musicgen_train_grads", "musicgen_train",
                           "musicgen_launch_train", "olmoe_train_grads",
                           "olmoe_train", "example_train_small_lm")},
            "example_quantized_lm_serving": ("flash_attention",
                                             "decode_attention"),
            "trained_request_loop": ("decode_attention", "flash_attention"),
            # the host mesh: one NCCL rank graphed, two gloo ranks eager
            **{run: ("flash_attention", "flash_attention_bwd")
               for run in ("host_mesh_nccl1", "host_mesh_gloo2")},
            # the zoo: the reduced archs in f32, OLMoE's request loop, its
            # fixed-plan session (bf16, qkernels) and launcher; Mamba2 is
            # attention-free, so only its quantized launches run kernels
            "zoo_reduced": ("flash_attention", "decode_attention"),
            "olmoe_request_loop": ("flash_attention", "decode_attention"),
            "olmoe_session": ("qmatmul", "qmatmul_tiled",
                              "decode_attention"),
            "olmoe_launch_q0": ("decode_attention", "flash_attention"),
            "olmoe_launch_q8": ("quantize", "qmatmul", "qmatmul_tiled",
                                "dequantize", "decode_attention",
                                "flash_attention"),
            "mamba2_launch_q8": ("quantize", "dequantize"),
            # jamba's replayed ring request: flash inside the prefill graph
            "jamba_ring": ("flash_attention", "decode_attention",
                           "qmatmul_tiled"),
            # the windowed ring: quantized device blocks at 4608 rows
            "window_ring": ("qmatmul_tiled", "decode_attention"),
            "mamba2_launch_q4": ("quantize_pack4", "dequantize"),
            # the model axis (counted on its ranks): KV heads split for
            # smollm-135m and OLMoE, chatglm3-6b's ring split on its slots
            "mp_smollm_q0": ("flash_attention", "decode_attention"),
            "mp_smollm_q8": ("quantize", "qmatmul", "flash_attention",
                             "decode_attention"),
            "mp_smollm_q4": ("quantize_pack4", "qmatmul4", "flash_attention",
                             "decode_attention"),
            "mp_olmoe": ("flash_attention", "decode_attention"),
            "mp_chatglm3": ("flash_attention", "decode_attention_shard"),
            # its 71-slot ring, which does not split: held whole, each
            # rank's heads reading their KV head in place
            "mp_chatglm3_rep": ("flash_attention", "decode_attention"),
            # the train step over the model axis (counted on its ranks;
            # the four-card cases hold every rank to both kernels)
            **{run: MP_TRAIN_KERNELS
               for run in ("mpt_smollm", "mpt_chatglm3", "mpt_chatglm3_f32",
                           "mpt_olmoe")},
            # the FSDP layout (counted on its ranks; the serving case's
            # prefill and decode; the four-card cases hold every rank to
            # both kernels)
            **{run: MP_TRAIN_KERNELS
               for run in ("fsdp_smollm", "fsdp_smollm_2x2", "fsdp_olmoe")},
            "fsdp_smollm_serve": ("flash_attention", "decode_attention"),
            "fsdp_smollm_serve_2x2": ("flash_attention", "decode_attention"),
            # the one-card in-place step, graphed and eager
            "in_place_twin": MP_TRAIN_KERNELS}


# the kernels' instantiations that ptxas reports entry by entry, by
# source (qmm_skinny and qmm_tc: the int8 and the int4 instantiations)
REDESIGNED_ENTRIES = {"flash_attention": ("flash_attn_tc_kernel",),
                      "qmatmul": ("qmm_skinny", "qmm_tc"),
                      "decode_attention": ("decode_split_kernel",
                                           "decode_shard_tc_kernel"),
                      "flash_attention_bwd": ("dq_tc_kernel",
                                              "dkv_tc_kernel")}

# the tensor-core kernels, by source: each must hold HMMA in its SASS
TENSOR_CORE_ENTRIES = (("flash_attention", "flash_attn_tc_kernel"),
                       ("qmatmul", "qmm_tc"),
                       ("decode_attention", "decode_shard_tc_kernel"),
                       ("flash_attention_bwd", "dq_tc_kernel"),
                       ("flash_attention_bwd", "dkv_tc_kernel"))


def shard_occupancy(torch, build) -> dict:
    """Resident CTAs per SM and clusters resident on the card at once of
    the ring-shard launch at the pod shards (2048 slots; smollm-135m's
    Gp 4, hd 64 and chatglm3-6b's Gp 16, hd 128), by the CUDA runtime's
    occupancy calculators: ``split`` the CUDA-core kernel the shard ran
    before (``decode_split_kernel``), ``tc`` the tensor-core one."""
    occ = build.launcher("decode_attention",
                         "decode_attention_shard_occupancy", "iiiiii")
    out = {}
    for name, gp, hd in (("smollm_pod", 4, 64), ("chatglm3_pod", 16, 128)):
        for cache in ("bfloat16", "float8_e4m3fn"):
            code = build.DTYPE_CODES[getattr(torch, cache)]
            out[f"{name} {cache}"] = {
                route: {"ctas_per_sm": occ(r, 2048, gp, hd, code, 0),
                        "active_clusters": occ(r, 2048, gp, hd, code, 1)}
                for r, route in enumerate(("split", "tc"))}
    return out


def ptxas_entries(out_dir, wanted):
    """Registers, static shared memory and spill bytes of each kernel
    entry whose mangled name holds one of ``wanted[source]``, from the
    build's ``-Xptxas -v`` logs (dynamic shared memory is not in them)."""
    found = []
    for source, keys in wanted.items():
        log = (out_dir / f"{source}.log").read_text()
        for part in log.split("Compiling entry function '")[1:]:
            entry = part.split("'", 1)[0]
            if not any(key in entry for key in keys):
                continue
            num = {k: re.search(pat, part) for k, pat in (
                ("registers", r"Used (\d+) registers"),
                ("static_smem_bytes", r"(\d+) bytes smem"),
                ("spill_store_bytes", r"(\d+) bytes spill stores"),
                ("spill_load_bytes", r"(\d+) bytes spill loads"))}
            found.append({"source": source, "entry": entry,
                          **{k: int(m.group(1)) if m else 0
                             for k, m in num.items()}})
    return found


def hmma_count(lib, key):
    """HMMA instructions in the SASS of each of ``lib``'s functions whose
    name holds ``key``, by the toolkit's cuobjdump (None where it is
    absent)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    count, inside = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            inside = line.split("Function :", 1)[1].strip()
            if key in inside:
                count[inside] = 0
        elif inside and key in inside and "HMMA" in line:
            count[inside] = count.get(inside, 0) + 1
    return count


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile-launcher", action="store_true",
                    help="only build the kernels, profile the serving "
                         "launcher's decode step, eager and graphed in "
                         "turns, at --quant 8, 0 and 4 and time its "
                         "decode without a profiler")
    ap.add_argument("--profile-tiled", action="store_true",
                    help="only build the kernels, time the tiled qmatmul "
                         "route over a sweep of M, K and N and profile "
                         "the prefills that run it")
    ap.add_argument("--profile-flash", action="store_true",
                    help="only build the kernels, time the flash "
                         "forward's serving launch and the backward "
                         "kernels and profile the train step")
    ap.add_argument("--profile-decode-attention", action="store_true",
                    help="only build the kernels and time decode "
                         "attention at the request loop's, the launcher's "
                         "and a 2048-slot ring, host-int and device "
                         "position, then its ring-shard variant at the "
                         "pod shards of smollm-135m and chatglm3-6b")
    ap.add_argument("--profile-requests", action="store_true",
                    help="only build the kernels and time the request "
                         "series (phase 7's QPART request loop, one "
                         "session per request) on a seeded smollm-135m, "
                         "twice")
    ap.add_argument("--profile-forward", action="store_true",
                    help="only build the kernels and time QPART's "
                         "calibration and execution (the forward family) "
                         "on a seeded smollm-135m")
    ap.add_argument("--profile-model-parallel", action="store_true",
                    help="only build the kernels, check the ring-shard "
                         "decode attention and run the serving steps over "
                         "the model axis (phase 9b)")
    ap.add_argument("--profile-model-parallel-train", action="store_true",
                    help="only build the kernels and run the train step "
                         "over the model axis (phase 9c)")
    ap.add_argument("--profile-fsdp", action="store_true",
                    help="only build the kernels and run the FSDP layout's "
                         "train, prefill and decode steps (phase 9d)")
    ap.add_argument("--profile-host-mesh", action="store_true",
                    help="only build the kernels and run the host mesh's "
                         "phase: the training launcher at one NCCL rank, "
                         "two gloo ranks on one card and, with two cards "
                         "or more, one NCCL rank per card")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the tree whose repro_torch to import (with "
                         "--profile-launcher, --profile-tiled, "
                         "--profile-flash, --profile-decode-attention "
                         "(the ring-shard timings too), "
                         "--profile-requests or --profile-forward: an "
                         "earlier commit's src/, "
                         "unpacked by git archive)")
    args = ap.parse_args(argv)
    if not (args.src / "repro_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              f"({args.src / 'repro_torch'} not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the port's smoke run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    if args.profile_launcher:
        from repro_torch.kernels import build
        print(smi, flush=True)
        emit({"profiled_tree": str(args.src.resolve()),
              "build_dir": str(build.build_all())})
        for quant in (8, 0, 4):
            profile_launch(torch, quant)
            launch_wall(torch, quant)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.profile_model_parallel:
        from repro_torch.kernels import build, ops
        print(smi, flush=True)
        emit({"build_dir": str(build.build_all())})
        timer = Timer(torch)
        one = torch.zeros(1, device="cuda")
        timer.floor_ms = timer(lambda: one.fill_(1.0))["ms"]
        check_decode_attention_shard(torch, timer, {})
        del timer, one
        t0 = time.perf_counter()
        emit({"model_parallel_launches": model_parallel_phase(torch, ops)})
        emit({"model_parallel_phase_s": time.perf_counter() - t0})
        return 0
    if args.profile_model_parallel_train:
        from repro_torch.kernels import build, ops
        print(smi, flush=True)
        emit({"build_dir": str(build.build_all())})
        log_shapes(ops)
        t0 = time.perf_counter()
        emit({"model_parallel_train_launches": model_parallel_train_phase(
            torch, ops)})
        emit({"model_parallel_train_phase_s": time.perf_counter() - t0})
        return 0
    if args.profile_fsdp:
        from repro_torch.kernels import build, ops
        print(smi, flush=True)
        emit({"build_dir": str(build.build_all())})
        log_shapes(ops)
        t0 = time.perf_counter()
        emit({"fsdp_launches": fsdp_phase(torch, ops)})
        emit({"fsdp_phase_s": time.perf_counter() - t0})
        return 0
    if args.profile_host_mesh:
        from repro_torch.kernels import build, ops
        print(smi, flush=True)
        emit({"build_dir": str(build.build_all())})
        t0 = time.perf_counter()
        emit({"host_mesh_launches": host_mesh_phase(torch, ops)})
        emit({"host_mesh_phase_s": time.perf_counter() - t0})
        return 0
    if args.profile_requests or args.profile_forward:
        from repro_torch.kernels import build, ops
        print(smi, flush=True)
        emit({"profiled_tree": str(args.src.resolve()),
              "build_dir": str(build.build_all())})
        count_tiled_route(ops)
        if args.profile_forward:
            torch.backends.cudnn.allow_tf32 = False
            profile_forward(torch, ops)
        else:
            profile_requests(torch, ops)
        return 0
    if args.profile_tiled or args.profile_flash or \
            args.profile_decode_attention:
        from repro_torch.kernels import build
        print(smi, flush=True)
        emit({"profiled_tree": str(args.src.resolve()),
              "build_dir": str(build.build_all())})
        timer = Timer(torch)
        one = torch.zeros(1, device="cuda")
        timer.floor_ms = timer(lambda: one.fill_(1.0))["ms"]
        emit({"timer_floor_ms": timer.floor_ms})
        if args.profile_flash:
            profile_flash(torch, timer)
            return 0
        if args.profile_decode_attention:
            emit({"decode_attention_sha256": decode_attention_digest(torch)})
            profile_decode_attention(torch, timer)
            profile_decode_attention_shard(torch, timer)
            return 0
        profile_tiled(torch, timer)
        del timer
        profile_prefill(torch)
        return 0
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for float32 matmuls and convolutions (plain versions "
          "compute in full f32)", flush=True)

    from repro_torch.kernels import build, ops
    count_tiled_route(ops)
    log_shapes(ops)
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
    redesigned = ptxas_entries(out_dir, REDESIGNED_ENTRIES)
    for e in redesigned:
        emit({"ptxas_entry": e})
    if any(e["spill_store_bytes"] or e["spill_load_bytes"]
           for e in redesigned):
        raise AssertionError("a redesigned kernel spills registers")
    for source, key in TENSOR_CORE_ENTRIES:
        hmma = hmma_count(out_dir / f"lib{source}.so", key)
        emit({"sass_hmma": hmma})
        if hmma is not None and not (hmma and all(hmma.values())):
            raise AssertionError(f"{key}: HMMA missing from its SASS {hmma}")
    tc_smem = build.launcher("flash_attention", "flash_attention_tc_smem", "i")
    bwd_smem = build.launcher("flash_attention_bwd",
                              "flash_attention_bwd_tc_smem", "ii")
    sk_smem = build.launcher("qmatmul", "qmatmul_skinny_smem", "ii")
    qtc_smem = build.launcher("qmatmul", "qmatmul_tc_smem", "ii")
    qtc_split = build.launcher("qmatmul", "qmatmul_tc_split", "ii")
    da_smem = build.launcher("decode_attention", "decode_attention_smem",
                             "iiii")
    da_split = build.launcher("decode_attention", "decode_attention_split",
                              "i")
    da_grid = build.launcher("decode_attention", "decode_attention_grid",
                             "i")
    sh_smem = build.launcher("decode_attention",
                             "decode_attention_shard_smem", "iiii")
    emit({"dynamic_smem_bytes": {
        **{f"flash_attn_tc_kernel hd={hd}": tc_smem(hd) for hd in (64, 128)},
        **{f"{name} hd={hd}": bwd_smem(hd, which)
           for which, name in enumerate(("dq_tc_kernel", "dkv_tc_kernel"))
           for hd in (64, 128)},
        **{f"qmm_skinny M={m} K={k}": sk_smem(m, k)
           for m in (2, 4) for k in (576, 1024, 1536, 2048)},
        **{f"qmm_tc int{bits} M={m}": qtc_smem(bits, m)
           for bits in (8, 4) for m in (32, 128)},
        **{f"decode_split_kernel ring={n} Gp=4 hd=64 {dt}":
           da_smem(n, 4, 64, build.DTYPE_CODES[d])
           for n in (96, 256, 2048)
           for dt, d in (("bf16", torch.bfloat16),
                         ("f8e4m3", torch.float8_e4m3fn))},
        **{f"decode_shard_tc_kernel shard={n} Gp={gp} hd={hd} {dt}":
           sh_smem(n, gp, hd, build.DTYPE_CODES[d])
           for n, gp, hd in ((2048, 4, 64), (2048, 16, 128), (18, 16, 128))
           for dt, d in (("bf16", torch.bfloat16),
                         ("f8e4m3", torch.float8_e4m3fn))}}})
    emit({"decode_attention_shard_occupancy": shard_occupancy(torch,
                                                              build)})
    emit({"qmm_tc_k_slices": {
        f"{w} K={k} N={n}": qtc_split(k, n) for w, (k, n) in (
            ("wq", (576, 1024)), ("wk", (576, 256)), ("wo", (1024, 576)),
            ("w_up", (576, 1536)), ("w_down", (1536, 576)),
            ("olmoe wq", (2048, 2048)))}})
    emit({"decode_attention_ctas_per_head": {
        f"n_valid={n}": da_split(n) for n in (1, 32, 33, 95, 96, 2048)}})
    emit({"decode_attention_cluster_per_ring": {
        f"ring={n}": da_grid(n) for n in (1, 96, 256, 513, 720, 2048)}})

    calib_batch, seq = 64, 128
    timer = Timer(torch)
    records = {}
    t_checks = time.perf_counter()
    one = torch.zeros(1, device="cuda")
    floor = timer(lambda: one.fill_(1.0))
    timer.floor_ms = floor["ms"]
    emit({"timer_floor": {"what": "fill_ of one float", **floor}})
    check_qmatmul(torch, timer, records)
    check_decode_attention(torch, timer, records)
    check_decode_attention_shard(torch, timer, records)
    check_flash_attention(torch, timer, records, calib_batch, seq)
    check_flash_attention_bwd(torch, timer, records)
    check_quantize(torch, timer, records)
    check_zoo_kernels(torch, timer, records)
    del timer
    emit({"kernel_checks_s": time.perf_counter() - t_checks})
    t_paths = time.perf_counter()

    cfg, params, backend, loop_launches, dep, prompt, srv, batch = \
        request_loop(torch, ops, calib_batch, seq)
    profile_decode(torch, dep, prompt)
    t0 = time.perf_counter()
    graph_runs = graph_phase(torch, ops, backend, prompt)
    emit({"graph_phase_s": time.perf_counter() - t0})
    reference_check(torch, cfg, params, backend)
    t0 = time.perf_counter()
    fleet_launches = lm_fleet(torch, ops, srv, batch, prompt)
    fleet_recipes()
    emit({"fleet_s": time.perf_counter() - t0})
    del srv
    t0 = time.perf_counter()
    cls_launches = classifier_loop(torch, ops)
    emit({"classifier_loop_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    feature_runs = decode_features(torch, ops, backend, prompt)
    emit({"decode_features_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    feature_runs["request_series"] = request_series(torch, ops, backend,
                                                    prompt)
    emit({"request_series_s": time.perf_counter() - t0})
    del params, backend, dep
    runs = {"request_loop": loop_launches, "fleet": fleet_launches,
            **graph_runs, **feature_runs,
            **launch_serve(torch, ops, graph_checks=LAUNCH_GRAPH_CHECKS)}
    t0 = time.perf_counter()
    train_runs, train_profiles, twin = train_phase(torch, ops)
    runs.update(train_runs)
    emit({"train_phase_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    runs.update(host_mesh_phase(torch, ops, twin))
    del twin
    emit({"host_mesh_phase_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    runs.update(model_parallel_phase(torch, ops))
    emit({"model_parallel_phase_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    runs.update(model_parallel_train_phase(torch, ops,
                                           MP_TRAIN_CASES + FSDP_CASES))
    emit({"model_parallel_train_phase_s": time.perf_counter() - t0,
          "phases": "9c and 9d"})
    t0 = time.perf_counter()
    runs["in_place_twin"] = in_place_twin(torch, ops)
    emit({"in_place_twin_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    runs["zoo_reduced"] = zoo_reduced(torch, ops)
    runs.update(olmoe_phase(torch, ops))
    emit({"olmoe_phase_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    runs.update(mamba2_phase(torch, ops))
    emit({"mamba2_phase_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    for log in SHAPES.values():
        log.on = True
    zoo_runs, zoo_profiles = zoo_train_phase(torch, ops)
    for log in SHAPES.values():
        log.on = False
    runs.update(zoo_runs)
    emit({"zoo_train_phase_s": time.perf_counter() - t0})
    if any(cls_launches.values()):
        raise AssertionError(f"the classifier loop launched kernels: "
                             f"{cls_launches}")
    decode_profiles = [profile_launch(torch, quant) for quant in (8, 0)]
    t0 = time.perf_counter()
    roofline_phase(torch, smi, train_profiles, decode_profiles,
                   zoo_profiles)
    emit({"roofline_phase_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    for log in SHAPES.values():
        log.on = True
    runs.update(examples_phase(torch, ops))
    for log in SHAPES.values():
        log.on = False
    emit({"examples_phase_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    check_path_shapes(torch, ops)
    emit({"path_shape_checks_s": time.perf_counter() - t0})

    # phase 9d's one-card cases do not run on four cards
    elsewhere = {c[0] for c in FSDP_CASES
                 if not runs_on(c, torch.cuda.device_count() >= 4)}
    missing = [f"{k} in {run}" for run, names in EXPECTED.items()
               if run not in elsewhere for k in names if runs[run][k] == 0]
    launches = {k: sum(r[k] for r in runs.values())
                for k in counters(ops)}
    missing += [k for k, n in launches.items() if n == 0]
    emit({"paths_s": time.perf_counter() - t_paths})
    emit({"launches_by_run": runs, "launches": launches})
    if missing:
        raise AssertionError(f"kernels never launched: {missing}")

    print(smi, flush=True)
    kernels = []
    for name in ops.KERNELS:
        rec = records[name]
        source, replaces = SOURCES[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
               "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
               "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
        if name in REDESIGNED:
            row["redesigned"] = REDESIGNED[name]
        if name in PORT_ONLY:
            row["port_only"] = PORT_ONLY[name]
        if rec.get("tiled"):
            row["tiled_route"] = {"launches": launches[f"{name}_tiled"],
                                  **rec["tiled"]}
        if rec.get("olmoe"):
            row["olmoe"] = {"launches": sum(r[name] for run, r in runs.items()
                                            if run.startswith("olmoe")),
                            **rec["olmoe"]}
        for key in ("chatglm3", "chatglm3_f8"):
            if rec.get(key):
                row[key] = rec[key]
        kernels.append(row)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
