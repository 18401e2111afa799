"""The dry run's collective term: the collectives a rank's program runs
over the model axis, and a train step's over the data axes too
(``launch.model_parallel``'s stand-ins under ``roofline.op_cost.count``),
held to their formula and to the reference's compiled HLO.

Formula: smollm-135m's decode_32k on the pod mesh (data 16 x model 16,
B 128 so 8 rows a rank, d_model 576, 30 layers, bf16 activations) moves
per rank, in bytes:

* all-reduce: the two row-parallel block outputs of each layer, their
  partial sums in f32, and the vocab-parallel embedding's rows in its
  f32 table, 2 x 30 x 8 x 576 x 4 + 8 x 576 x 4 = 1,124,352;
* all-gather: its 4 KV heads do not divide 16 ranks, so the ring is split
  on its 32,768 slots; each layer gathers the 16 query heads (8 x 16 x
  64 x 2 B): 30 x 16,384 = 491,520;
* all-to-all: each layer sends every rank its head of the f32 partial
  outputs and log-sum-exps over this rank's slots (8 x 16 x (64 + 1) x
  4 B): 30 x 33,280 = 998,400.

Its train_4k on the same mesh (B 256 so 16 rows a rank, S 4096: T =
65,536 tokens a rank; f32 masters, bf16 activations, remat on; each
rank's one query head reads its slice of the 4 replicated KV heads):

* model axis, all-reduce: the forward's f32 partial sums, the
  embedding's rows and each layer's two row-parallel outputs, (1 + 2 x
  30) x T x 576 x 4 B = 61 x 150,994,944; remat's recomputed forward,
  as far as the backward reads it (the checkpoint stops before the MLP's
  sum, whose output nothing keeps), 30 x 150,994,944; the backward's
  ``to_ranks`` sums in bf16, the unembedding's input and each layer's
  attention and MLP inputs, 61 x T x 576 x 2 B = 61 x 75,497,472, and
  each layer's k and v slices (zero outside the rank's KV head), 60 x T
  x 4 x 64 x 2 B = 60 x 33,554,432; the loss's sum of exponentials and
  label logit, 2 x T x 4 B = 524,288; the gradient norm's sum, 4 B:
  20,359,675,908 in all;
* model axis, all-gather: each row's largest logit from the 16 ranks,
  T x 16 x 4 B = 4,194,304;
* data axis, all-reduce: the gradient mean, rank 0's f32 gradient
  shards (its parameters' bytes) and the loss with its three metrics,
  16 B: 71,361,808.

The same train_4k under ``--fsdp`` (every leaf of smollm-135m also split
over the 16 data ranks; ``W`` = 71,361,792 B, the rank's f32 shards of
the model axis alone, of which ``E`` = 3,072 x 576 x 4 = 7,077,888 the
embedding's and ``F`` = 576 x 4 = 2,304 the final norm's): the model
axis moves what it moves without the layout, and the data axis

* all-gather: each leaf whole (its model-axis shard) where read, the
  tied embedding at both its uses, W + E, and remat's recomputed blocks
  again, W - E - F: 2W - F = 142,721,280;
* reduce-scatter: each use's gradient back to the rank's shard, W + E =
  78,439,680;
* all-reduce: the loss and its three metrics, 16 B, and the gradient
  norm's partial sums of the leaves split on data (alone and with the
  model axis), 8 B: 24.

Reference: the 2-layer decode step at B 4 over a 64-slot ring, and the
2-layer train step at B 4 x S 64, compiled by the reference on a (1, 4)
mesh of forced CPU devices (one subprocess; never the 256- or
512-device compile) and read by ``hlo_cost.analyze_text``. Where the
port's and GSPMD's decode programs agree on the collective (the KV heads
split: smollm-135m; expert-parallel MoE: OLMoE-1B-7B), both run
all-reduces alone, and the reference's bytes are the port's, to 0.2%:
both sum the row-parallel partials in f32. OLMoE's reference moves 256 B
more (a 64-float all-reduce of the routing's statistics; the port keeps
routing replicated and reduces none). Where they chose differently —
chatglm3-6b's ring split on its slots: GSPMD all-reduces the merge, the
port all-gathers q and sends each rank its heads' (out, lse) by an
all-to-all; Mamba2's replicated conv ring: GSPMD's all-to-all and
collective-permute, the port's all-gather of the new x channels — the
port's total is held at or below the reference's. The train step's
total is held at or below the reference's for all four: the reference
moves 10,619,936 / 37,821,520 (and a 262,144 B all-gather) / 76,024,880
/ 21,636,144 B for smollm-135m / OLMoE / chatglm3-6b / Mamba2.

The FSDP layout: the reference's 2-layer smollm-135m train step under
``param_pspecs(fsdp=True)`` on a (data 2, model 2) mesh of the same four
devices, at B 16 x S 256 (2,048 tokens a data rank, the smoke's training
rows a rank). There GSPMD does not gather the weights: it keeps each
leaf's shard in place and moves activations (f32 logits gathered and
summed over data), 1,159,010,004 B; the port's layout, each leaf
gathered where read and its gradient reduce-scattered, moves
320,929,308, held at or below it. At the decode tests' B 4 x S 64 (128
tokens a data rank) the activations are the cheaper choice and GSPMD's
program moves 92,882,004 B against the port's 278,873,628: the port
always gathers the weights, as the layout's ZeRO-3 program does."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs.base import INPUT_SHAPES, InputShape, get_config
from repro_torch.launch import dryrun, steps
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch.mesh import (make_host_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.roofline import analysis, op_cost
from repro_torch.tree import tree_leaves

HERE = Path(__file__).resolve().parent
ARCHS = ("smollm-135m", "olmoe-1b-7b", "chatglm3-6b", "mamba2-1.3b")
SEQ, BATCH = 64, 4
FSDP_SEQ, FSDP_BATCH = 256, 16


def _port(arch: str, mesh, shape, quant: int = 0) -> dict:
    cfg = get_config(arch)
    spec = steps.build_step(cfg, shape, serve_quant=quant, mesh=mesh)
    return op_cost.count(spec.fn, *spec.args).collectives


def test_pod_train_collectives_by_formula():
    t, d, layers = 16 * 4096, 576, 30
    mesh = make_production_mesh()
    spec = steps.build_step(get_config("smollm-135m"),
                            INPUT_SHAPES["train_4k"], mesh=mesh)
    got = op_cost.count(spec.fn, *spec.args)
    f32, bf16, kv = t * d * 4, t * d * 2, t * 4 * 64 * 2
    model_reduce = ((1 + 2 * layers) + layers) * f32 \
        + (1 + 2 * layers) * bf16 + 2 * layers * kv + 2 * t * 4 + 4
    params = shard_lib.per_card_bytes(spec.global_args[0], spec.specs[0],
                                      mesh)
    assert model_reduce == 20_359_675_908
    assert params + 16 == 71_361_808
    assert got.collectives == {"all-reduce": model_reduce + params + 16,
                               "all-gather": t * 16 * 4}
    assert got.collectives_by_axis == {
        "model": model_reduce + t * 16 * 4, "data": params + 16}


def test_pod_fsdp_train_collectives_by_formula():
    """smollm-135m's train_4k under ``--fsdp`` on the pod: the data
    axis's all-gathers, reduce-scatters and all-reduces by the module
    docstring's formula, the model axis's as without the layout."""
    t, d, layers = 16 * 4096, 576, 30
    mesh = make_production_mesh()
    cfg = get_config("smollm-135m")
    spec = steps.build_step(cfg, INPUT_SHAPES["train_4k"], mesh=mesh,
                            fsdp=True)
    got = op_cost.count(spec.fn, *spec.args)
    unsplit = steps.build_step(cfg, INPUT_SHAPES["train_4k"], mesh=mesh)
    w = shard_lib.per_card_bytes(unsplit.global_args[0], unsplit.specs[0],
                                 mesh)
    e, f = 49152 // 16 * d * 4, d * 4
    assert (w, e) == (71_361_792, 7_077_888)
    f32, bf16, kv = t * d * 4, t * d * 2, t * 4 * 64 * 2
    model_reduce = ((1 + 2 * layers) + layers) * f32 \
        + (1 + 2 * layers) * bf16 + 2 * layers * kv + 2 * t * 4 + 4
    assert 2 * w - f == 142_721_280 and w + e == 78_439_680
    assert got.collectives == {"all-reduce": model_reduce + 24,
                               "all-gather": t * 16 * 4 + 2 * w - f,
                               "reduce-scatter": w + e}
    assert got.collectives_by_axis == {
        "model": model_reduce + t * 16 * 4, "data": 2 * w - f + w + e + 24}


@pytest.mark.parametrize("quant", [0, 8], ids=["q0", "q8"])
def test_pod_decode_collectives_by_formula(quant):
    b, d, layers = 128 // 16, 576, 30
    got = _port("smollm-135m", make_production_mesh(),
                INPUT_SHAPES["decode_32k"], quant)
    assert got == {"all-reduce": 2 * layers * b * d * 4 + b * d * 4,
                   "all-gather": layers * b * 16 * 64 * 2,
                   "all-to-all": layers * b * 16 * (64 + 1) * 4}
    assert got["all-reduce"] == 1_124_352
    assert got["all-gather"] == 491_520
    assert got["all-to-all"] == 998_400


@pytest.fixture(scope="module")
def reference():
    env = {**os.environ,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(HERE.parent / "src"),
                                          os.environ.get("PYTHONPATH", "")])}
    args = [a for kind in ("decode", "train") for arch in ARCHS
            for a in (kind, arch, str(SEQ), str(BATCH))]
    args += ["train_fsdp", "smollm-135m", str(FSDP_SEQ), str(FSDP_BATCH)]
    out = subprocess.run([sys.executable,
                          str(HERE / "_torch_reference_collectives.py"),
                          *args], env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _two_layers(arch: str, kind: str = "decode") -> dict:
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    spec = steps.build_step(cfg, InputShape(f"{kind}_small", SEQ, BATCH,
                                            kind), mesh=make_mesh(1, 4))
    return op_cost.count(spec.fn, *spec.args).collectives


@pytest.mark.parametrize("arch", ["smollm-135m", "olmoe-1b-7b"])
def test_collectives_agree_with_the_reference_hlo(reference, arch):
    port, ref = _two_layers(arch), reference["decode"][arch]
    assert set(port) == set(ref) == {"all-reduce"}
    assert ref["all-reduce"] == pytest.approx(port["all-reduce"], rel=2e-3)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "mamba2-1.3b"])
def test_collectives_where_gspmd_chose_differently(reference, arch):
    port, ref = _two_layers(arch), reference["decode"][arch]
    assert port["all-reduce"] > 0 and port["all-gather"] > 0
    assert (port.get("all-to-all", 0) > 0) == (arch == "chatglm3-6b")
    assert sum(port.values()) <= sum(ref.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_collectives_within_the_reference_hlo(reference, arch):
    """The 2-layer train step's rank program moves at most the bytes the
    reference's compiled (1, 4) program moves (module docstring), and
    over the model axis alone: a data axis of 1 averages nothing."""
    port, ref = _two_layers(arch, "train"), reference["train"][arch]
    assert port["all-reduce"] > 0
    assert 0 < sum(port.values()) <= sum(ref.values())


def test_fsdp_train_collectives_within_the_reference_hlo(reference):
    """The 2-layer smollm-135m train step under the FSDP layout on a (2,
    2) mesh: the port's program all-gathers and reduce-scatters over the
    data axis and moves at most the bytes the reference's compiled
    program moves at B 16 x S 256 (module docstring)."""
    cfg = dataclasses.replace(get_config("smollm-135m"), num_layers=2)
    spec = steps.build_step(cfg, InputShape("train_small", FSDP_SEQ,
                                            FSDP_BATCH, "train"),
                            mesh=make_mesh(2, 2), fsdp=True)
    got = op_cost.count(spec.fn, *spec.args)
    ref = reference["train_fsdp"]["smollm-135m"]
    assert got.collectives["all-gather"] > 0 and \
        got.collectives["reduce-scatter"] > 0 and ref["all-gather"] > 0
    assert set(got.collectives_by_axis) == {"model", "data"}
    assert 0 < sum(got.collectives.values()) <= sum(ref.values())


def test_host_mesh_fsdp_is_a_rank_program():
    """Under the FSDP layout the host mesh's (4, 1) train step is a rank
    program too, with a model axis of 1: its record's collective term is
    the data axis's gathers, reduce-scatters and mean, over the network
    links; without the layout the same mesh's step is one card's whole
    step, with none."""
    cfg = dataclasses.replace(get_config("smollm-135m"), num_layers=2)
    shape = InputShape("train_small", SEQ, BATCH, "train")
    mesh = make_host_mesh(4)
    spec = steps.build_step(cfg, shape, mesh=mesh, fsdp=True)
    roof = analysis.analyze(op_cost.count(spec.fn, *spec.args), arch="a",
                            shape="s", chips=4, model_axis=1)
    assert roof.rank_program and roof.t_collective > 0
    assert set(roof.coll_by_axis) == {"data"}
    assert set(roof.coll_breakdown) == {"all-gather", "reduce-scatter",
                                        "all-reduce"}
    assert roof.to_dict()["coll_links"] == {"data": "nic"}
    whole = steps.build_step(cfg, shape, mesh=mesh)
    assert whole.specs is None and op_cost.count(
        whole.fn, *whole.args).collectives == {}


@pytest.mark.parametrize("mesh_name", ["pod", "multipod"])
def test_dryrun_counts_train_as_a_rank_program(mesh_name):
    """A train combo on a production mesh is rank 0's program: its
    record has a collective term over both axes' links, no note, and
    argument bytes that are its shards' (``per_card_bytes`` of the whole
    arguments); under ``--fsdp`` too, its shards those of the FSDP
    specs, its data axis's term the layout's gathers and
    reduce-scatters."""
    mesh = dryrun.MESHES[mesh_name]()
    for fsdp in (False, True):
        roof = dryrun.count_step("smollm-135m", "train_4k",
                                 mesh_name=mesh_name, fsdp=fsdp)
        spec = steps.build_step(get_config("smollm-135m"),
                                INPUT_SHAPES["train_4k"], mesh=mesh,
                                fsdp=fsdp)
        assert roof.rank_program
        assert roof.t_collective > 0 and set(roof.coll_by_axis) == {
            "model", "data"}
        assert roof.to_dict()["coll_links"] == {"model": "nic",
                                                "data": "nic"}
        assert roof.arg_bytes_per_card == sum(
            t.numel() * t.element_size() for t in tree_leaves(spec.args)) \
            == shard_lib.per_card_bytes(spec.global_args, spec.specs, mesh)
        assert (set(roof.coll_breakdown) >= {"all-gather",
                                             "reduce-scatter"}) == fsdp
    assert roof.arg_bytes_per_card == shard_lib.per_card_bytes(
        spec.global_args, steps.step_specs(
            "train", spec.cfg, spec.global_args, mesh,
            INPUT_SHAPES["train_4k"].global_batch, fsdp=True), mesh)
