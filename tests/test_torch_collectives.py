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
/ 21,636,144 B for smollm-135m / OLMoE / chatglm3-6b / Mamba2."""
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
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.roofline import op_cost
from repro_torch.tree import tree_leaves

HERE = Path(__file__).resolve().parent
ARCHS = ("smollm-135m", "olmoe-1b-7b", "chatglm3-6b", "mamba2-1.3b")
SEQ, BATCH = 64, 4


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


@pytest.mark.parametrize("mesh_name", ["pod", "multipod"])
def test_dryrun_counts_train_as_a_rank_program(mesh_name):
    """A train combo on a production mesh is rank 0's program: its
    record has a collective term over both axes' links, no note, and
    argument bytes that are its shards' (``per_card_bytes`` of the whole
    arguments); under ``--fsdp`` the record keeps the note and no term."""
    roof = dryrun.count_step("smollm-135m", "train_4k", mesh_name=mesh_name)
    mesh = dryrun.MESHES[mesh_name]()
    spec = steps.build_step(get_config("smollm-135m"),
                            INPUT_SHAPES["train_4k"], mesh=mesh)
    assert roof.rank_program and roof.coll_note is None
    assert roof.t_collective > 0 and set(roof.coll_by_axis) == {"model",
                                                                "data"}
    assert roof.to_dict()["coll_links"] == {"model": "nic", "data": "nic"}
    assert roof.arg_bytes_per_card == sum(
        t.numel() * t.element_size() for t in tree_leaves(spec.args)) == \
        shard_lib.per_card_bytes(spec.global_args, spec.specs, mesh)
    fsdp = dryrun.count_step("smollm-135m", "train_4k", mesh_name=mesh_name,
                             fsdp=True)
    assert fsdp.t_collective is None and fsdp.coll_note == dryrun.UNSPLIT
