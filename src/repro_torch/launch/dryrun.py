"""Dry run: count every (architecture x input shape) step at full width on
fake tensors and emit its roofline per H100 — the port of
``repro/launch/dryrun.py``.

Usage (the CPU is enough; nothing is allocated or computed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh pod|multipod] [--fsdp]

Each combo's step (``launch.steps.build_step``) is counted by
``roofline.op_cost.count``, and its record — the ``Roofline`` fields,
the argument bytes each card holds under the mesh's sharding rules and
whether they fit the card's 80 GB — is written to ``--record-dir``.
On a mesh whose model axis is larger than 1 (``pod``, ``multipod``),
and under ``--fsdp`` on any mesh of more than one data index, every
combo counts rank 0's program: its local shards (the argument bytes per
card are their sum, which ``sharding.per_card_bytes`` must give too),
its FLOPs and bytes, and the collectives it runs — over the model axis;
for a train step its gradient mean over the data axes; under ``--fsdp``
each leaf's all-gather over the data axes where it is read and its
gradient's reduce-scatter — which give the record its collective term,
each axis's bytes on its link. On the host mesh of one card a combo is
one card's whole step, with no collective term.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import traceback

import torch

from repro_torch.configs.base import (ASSIGNED_ARCHS, INPUT_SHAPES,
                                      ModelConfig, get_config)
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch.mesh import (MODEL_AXIS, make_host_mesh,
                                     make_production_mesh, mesh_num_chips)
from repro_torch.launch.steps import build_step, step_specs
from repro_torch.roofline import op_cost
from repro_torch.roofline.analysis import analyze, model_flops_for, save_record
from repro_torch.tree import tree_leaves

RECORD_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "build", "dryrun")

MESHES = {"host": make_host_mesh,
          "pod": make_production_mesh,
          "multipod": lambda: make_production_mesh(multi_pod=True)}


class SkipCombo(Exception):
    pass


def skip_reason(cfg: ModelConfig, shape) -> str | None:
    """No combination is skipped: dense archs run long_500k through the
    sliding-window variant. Kept as an explicit hook so that any future
    inapplicable pair is documented, not silently dropped."""
    return None


def count_step(arch: str, shape_name: str, *, mesh_name: str = "host",
               fsdp: bool = False, accum_steps: int = 1, serve_dtype=None,
               serve_quant: int = 0):
    """Build one combo's step, count it, print its line and return its
    ``Roofline``."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if skip_reason(cfg, shape):
        raise SkipCombo(skip_reason(cfg, shape))
    mesh = MESHES[mesh_name]()
    sd = {None: None, "bf16": torch.bfloat16,
          "f32": torch.float32}[serve_dtype]
    m = mesh.shape[MODEL_AXIS]
    spec = build_step(cfg, shape, accum_steps=accum_steps, serve_dtype=sd,
                      serve_quant=serve_quant, mesh=mesh, fsdp=fsdp)
    if spec.specs is not None:
        # rank 0's shards: their bytes, which the specs' count must match
        arg_bytes = sum(t.numel() * t.element_size()
                        for t in tree_leaves(spec.args))
        by_specs = shard_lib.per_card_bytes(spec.global_args, spec.specs,
                                            mesh)
        if by_specs != arg_bytes:
            raise AssertionError(f"rank 0 holds {arg_bytes} bytes, the "
                                 f"specs give {by_specs}")
    else:
        arg_bytes = shard_lib.per_card_bytes(
            spec.args, step_specs(spec.kind, spec.cfg, spec.args, mesh,
                                  shape.global_batch, fsdp=fsdp), mesh)
    t0 = time.perf_counter()
    summary = op_cost.count(spec.fn, *spec.args)
    count_s = time.perf_counter() - t0
    roof = analyze(summary, arch=arch, shape=shape_name, mesh_name=mesh_name,
                   chips=mesh_num_chips(mesh),
                   model_flops=model_flops_for(spec.cfg, shape),
                   arg_bytes_per_card=arg_bytes,
                   peak="f32" if spec.cfg.dtype == "float32" else "bf16",
                   count_s=count_s, model_axis=m)
    print(f"[{arch} x {shape_name} x {mesh_name}] counted in "
          f"{count_s:.1f} s: {roof.gflops:.1f} GFLOP {roof.gbytes:.1f} GB "
          f"(model {roof.model_gflops:.1f} GFLOP); args "
          f"{arg_bytes / 1e9:.2f} GB/card (fits 80 GB: {roof.fits_80gb}); "
          f"compute {roof.t_compute * 1e3:.3f} ms memory "
          f"{roof.t_memory * 1e3:.3f} ms collective "
          + (f"{roof.t_collective * 1e3:.3f} ms (" + ", ".join(
              f"{a} {gb:.4f} GB over {roof.link(a)}" for a, gb in
              roof.coll_by_axis.items())
             + ")" if roof.rank_program else "none")
          + f" -> {roof.bottleneck}", flush=True)
    return roof


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ASSIGNED_ARCHS)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=sorted(MESHES), default="host",
                    help="the layout: every step counts rank 0's "
                         "program on it")
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-style extra sharding over data: each leaf "
                         "gathered where read, its gradient "
                         "reduce-scattered")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatch steps")
    ap.add_argument("--serve-dtype", choices=["bf16", "f32"], default=None,
                    help="weight dtype for prefill/decode steps")
    ap.add_argument("--serve-quant", type=int, default=0,
                    help="int-quantize serving weights to N bits")
    ap.add_argument("--record-dir", default=RECORD_DIR)
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    os.makedirs(args.record_dir, exist_ok=True)

    failures = []
    for arch, shape_name in combos:
        try:
            roof = count_step(
                arch, shape_name, mesh_name=args.mesh, fsdp=args.fsdp,
                accum_steps=args.accum, serve_dtype=args.serve_dtype,
                serve_quant=args.serve_quant)
            tag = args.mesh
            tag += "_fsdp" if args.fsdp else ""
            tag += f"_accum{args.accum}" if args.accum > 1 else ""
            tag += f"_{args.serve_dtype}" if args.serve_dtype else ""
            tag += f"_w{args.serve_quant}" if args.serve_quant else ""
            save_record(roof, os.path.join(
                args.record_dir, f"{arch}_{shape_name}_{tag}.json"))
        except SkipCombo as e:
            print(f"[{arch} x {shape_name}] SKIP: {e}")
        except Exception as e:     # report every failing combo, then fail
            traceback.print_exc()
            failures.append((arch, shape_name, repr(e)))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print(f"\nall {len(combos)} combos counted")
    return 0


if __name__ == "__main__":
    sys.exit(main())
