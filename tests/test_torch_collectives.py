"""The dry run's collective term: the collectives a rank's program runs
over the model axis (``launch.model_parallel``'s stand-ins under
``roofline.op_cost.count``), held to their formula and to the
reference's compiled HLO.

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

Reference: the 2-layer decode step at B 4 over a 64-slot ring, compiled
by the reference on a (1, 4) mesh of forced CPU devices (one
subprocess; never the 256- or 512-device compile) and read by
``hlo_cost.analyze_text``. Where the port's and GSPMD's programs agree on
the collective (the KV heads split: smollm-135m; expert-parallel MoE:
OLMoE-1B-7B), both run all-reduces alone, and the reference's bytes are
the port's, to 0.2%: both sum the row-parallel partials in f32. OLMoE's
reference moves 256 B more (a 64-float all-reduce of the routing's
statistics; the port keeps routing replicated and reduces none). Where
they chose differently — chatglm3-6b's ring split on its slots: GSPMD
all-reduces the merge, the port all-gathers q and sends each rank its
heads' (out, lse) by an all-to-all; Mamba2's
replicated conv ring: GSPMD's all-to-all and collective-permute, the
port's all-gather of the new x channels — the port's total is held at or
below the reference's."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs.base import INPUT_SHAPES, InputShape, get_config
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.roofline import op_cost

HERE = Path(__file__).resolve().parent
ARCHS = ("smollm-135m", "olmoe-1b-7b", "chatglm3-6b", "mamba2-1.3b")
SEQ, BATCH = 64, 4


def _port(arch: str, mesh, shape, quant: int = 0) -> dict:
    cfg = get_config(arch)
    spec = steps.build_step(cfg, shape, serve_quant=quant, mesh=mesh)
    return op_cost.count(spec.fn, *spec.args).collectives


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
    args = [a for arch in ARCHS for a in (arch, str(SEQ), str(BATCH))]
    out = subprocess.run([sys.executable,
                          str(HERE / "_torch_reference_collectives.py"),
                          *args], env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _two_layers(arch: str) -> dict:
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    spec = steps.build_step(cfg, InputShape("decode_small", SEQ, BATCH,
                                            "decode"), mesh=make_mesh(1, 4))
    return op_cost.count(spec.fn, *spec.args).collectives


@pytest.mark.parametrize("arch", ["smollm-135m", "olmoe-1b-7b"])
def test_collectives_agree_with_the_reference_hlo(reference, arch):
    port, ref = _two_layers(arch), reference[arch]
    assert set(port) == set(ref) == {"all-reduce"}
    assert ref["all-reduce"] == pytest.approx(port["all-reduce"], rel=2e-3)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "mamba2-1.3b"])
def test_collectives_where_gspmd_chose_differently(reference, arch):
    port, ref = _two_layers(arch), reference[arch]
    assert port["all-reduce"] > 0 and port["all-gather"] > 0
    assert (port.get("all-to-all", 0) > 0) == (arch == "chatglm3-6b")
    assert sum(port.values()) <= sum(ref.values())
