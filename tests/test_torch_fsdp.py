"""The FSDP layout as one rank's program (``launch.model_parallel.Fsdp``,
``launch.sharding.fsdp_dims``): spawned ``gloo`` ranks on the CPU, f32,
each holding its shards of ``param_pspecs(fsdp=True)`` of the same NumPy
weights (its moments those of ``opt_pspecs``) and its rows of the same
NumPy tokens; every leaf split over the data axis is gathered where the
model reads it and its gradient reduce-scattered back to the shard.
Held to the reference's ``lm_loss`` gradient of the whole batch and its
``make_train_step`` run unsharded, cut to each rank's FSDP shards by
``shard_tree``. Training cases:

* ``dense`` — the 4-layer smollm-8m at ``tp_pad=16`` on a (2, 1) mesh:
  every leaf split over data (the tied head gathered at the embedding
  and the unembedding, its two reduce-scattered gradients summed);
* ``dense_2x2`` — the same on a (2, 2) mesh: leaves split over both
  axes, over the model axis only or over data only;
* ``olmoe`` — reduced OLMoE at (2, 1): expert stacks, the router;
* ``mamba2`` — reduced Mamba2 at (2, 1), where ``_with_fsdp`` splits the
  gated norm and the conv bias on their period axis (asserted), gathered
  whole once a step;
* ``accum2`` — two microbatches, their shards summed;
* ``remat`` — remat on: each period's forward gathers again in the
  backward.

Checks, per rank: every leaf's gradient (``step_grads``, as the step
takes it before its update) against its FSDP shard of the reference's,
within 1e-4 of the leaf's largest magnitude; the loss, the metrics, the
global norm and ``lr`` to 1e-5 relative; the params and ``mu`` after the
step within 1e-4 of each leaf's largest; at AdamW's default
``eps`` the step's change where the gradient is not near zero, within
1e-3 of the leaf's largest change — ``tests/test_torch_model_parallel
_train.py``'s tolerances and the reasons it gives for them. Bitwise:
the loss and metrics across the ranks, and a layout over a data axis of
size 1 against no layout (gradients, metrics, state).

Serving: the smollm-8m prefill (f32 caches) and 8 greedy decode steps,
and ``launch.serve.generate``, at (2, 1) and (2, 2), and at (2, 2) with
int4 wire structs (each leaf's packed codes split on whole bytes over
both axes, gathered whole before the quantized matmul or the
dequantization reads them), each data rank on its row of a 2-row
prompt; the logits gathered over the model axis
against the reference's unsharded ``T.prefill`` / ``T.decode_step``
rows within 1e-4 (``tests/test_torch_model_parallel.py``'s), the greedy
tokens equal.

``optimizer.global_norm`` on a (2, 2) mesh: a leaf split on data only,
one on model only, one on both and one on neither, each counted once.

``make_train_step(in_place=True)`` (the update written into the trees it
was handed) bitwise the step that makes new trees, with and without a
layout.

The rank programs as CUDA graphs, on the CPU's two gloo ranks, over the
model axis at (1, 2) and under the layout at (2, 1), smollm-8m and
reduced OLMoE (the experts' all-to-all, the router): ``DonatedStep``
takes the in-place step and runs it eagerly, bitwise the plain step;
``graphs=True`` over gloo raises there and in ``launch.serve.generate``;
the train and decode steps read nothing on the host (``NoHostReads``).

One spawn per world size (module fixture: two ranks for the (2, 1)
cases, four for the (2, 2) ones and the norm); the reference runs
meanwhile."""
import concurrent.futures

import numpy as np
import pytest
import torch

from repro_torch.launch import distributed
from repro_torch.launch import model_parallel as mp
from repro_torch.launch.mesh import DATA_AXIS, coords, make_mesh
from repro_torch.launch.sharding import fsdp_dims, param_pspecs, shard_tree
from repro_torch.models import transformer as TT
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop
from repro_torch.tree import tree_leaves
import _torch_fsdp_ranks as ranks
import test_torch_model_parallel as mpserve
import test_torch_model_parallel_train as mptrain
from _torch_parity import lm_configs, zoo_configs

RTOL, LEAF_TOL = mptrain.RTOL, mptrain.LEAF_TOL
OPT = mptrain.OPT
SERVE_TOL = mpserve.TOL
B, S = mptrain.B, mptrain.S

DENSE = lm_configs(tp_pad=16)
# case -> ((jax cfg, torch cfg), data, model, remat, accum_steps)
CASES = {"dense": (DENSE, 2, 1, False, 1),
         "dense_2x2": (DENSE, 2, 2, False, 1),
         "olmoe": (zoo_configs("olmoe-1b-7b"), 2, 1, False, 1),
         "mamba2": (zoo_configs("mamba2-1.3b"), 2, 1, False, 1),
         "accum2": (DENSE, 2, 1, False, 2),
         "remat": (DENSE, 2, 1, True, 1)}
# serving case -> (data, model, int-N bits or 0)
SERVE = {"serve": (2, 1, 0), "serve_2x2": (2, 2, 0), "serve_q4_2x2": (2, 2, 4)}
# the rank programs as CUDA graphs take them (``ranks.graph_case``):
# program -> (configs, data, FSDP layout), on two ranks
GRAPHS = {"model_axis": (DENSE, 1, False), "fsdp": (DENSE, 2, True),
          "moe_model_axis": (zoo_configs("olmoe-1b-7b"), 1, False),
          "moe_fsdp": (zoo_configs("olmoe-1b-7b"), 2, True)}


def _world(data, model) -> int:
    return data * model


@pytest.fixture(scope="module")
def runs():
    """(the reference's training runs, its serving run, each rank's runs
    by world size, the port's training cases by name)."""
    port, ref_args = {}, {}
    for i, (name, ((jcfg, tcfg), data, model, remat, accum)) in enumerate(
            CASES.items()):
        tree, batch = mptrain._weights(tcfg, i), mptrain._batch(tcfg, i)
        port[name] = (tcfg, tree, OPT, data, remat, accum, batch)
        ref_args[name] = (jcfg, tree, remat, accum, batch)
    jcfg, tcfg = DENSE
    tree = mptrain._weights(tcfg, 20)
    prompt = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (mpserve.B, mpserve.S)).astype(np.int32)
    serving = {name: (tcfg, tree, prompt, mpserve.MAX_LEN, mpserve.STEPS,
                      data, quant)
               for name, (data, _, quant) in SERVE.items()}
    graphing = {name: (t, mptrain._weights(t, 30), OPT, data,
                       mptrain._batch(t, 30), np.random.default_rng(4).integers(
                           0, t.vocab_size, (mpserve.B, mpserve.S)).astype(
                               np.int32), mpserve.MAX_LEN, fsdp)
                for name, ((_, t), data, fsdp) in GRAPHS.items()}
    by_world = {}
    for name, case in port.items():
        by_world.setdefault(_world(*CASES[name][1:3]), ({}, {}))[0][name] = \
            case
    for name, case in serving.items():
        by_world.setdefault(_world(*SERVE[name][:2]), ({}, {}))[1][name] = \
            case
    with concurrent.futures.ThreadPoolExecutor(len(by_world)) as pool:
        spawned = {w: pool.submit(distributed.spawn, ranks.run_all, w, "cpu",
                                  train, serve, w == 4,
                                  graphing if w == 2 else None)
                   for w, (train, serve) in by_world.items()}
        with concurrent.futures.ThreadPoolExecutor(4) as jit_pool:
            ref = dict(zip(ref_args, jit_pool.map(
                lambda a: mptrain._reference(*a), ref_args.values())))
            served = {q: mpserve._reference(jcfg, tree, q, prompt,
                                            mpserve.MAX_LEN)
                      for q in sorted({c[2] for c in SERVE.values()})}
        got = {w: f.result(timeout=600) for w, f in spawned.items()}
    return ref, served, got, port


def _ranks(got, case):
    return [r["train"][case] for r in got[_world(*CASES[case][1:3])]]


def _graphs(runs, program):
    """Both ranks' ``ranks.graph_case`` records of ``program``."""
    return [r["graphs"][program] for r in runs[2][2]]


def _specs(case, mesh):
    """``param_pspecs(fsdp=True)`` of a port case's weights on ``mesh``."""
    cfg, tree = case[:2]
    return param_pspecs(cfg, TT.params_from_numpy(tree, cfg, device="cpu"),
                        fsdp=True, mesh=mesh)


def _mesh(case):
    return make_mesh(*CASES[case][1:3])


@pytest.mark.parametrize("case", sorted(CASES))
def test_fsdp_gradients_are_the_references_shards(runs, case):
    """Every rank's gradient of every leaf is its FSDP shard of the
    reference's gradient of the whole batch (reduce-scattered over the
    data axis and divided once), and the loss and metrics are the
    reference's, the same bits on every rank."""
    ref, _, got, port = runs
    want, mesh = ref[case], _mesh(case)
    specs = _specs(port[case], mesh)
    recs = _ranks(got, case)
    for r, rec in enumerate(recs):
        shard = shard_tree(want["grads"], specs, mesh, coords(mesh, r))
        mptrain._assert_leaves(rec["grads"], shard, f"{case} rank {r} grads")
        np.testing.assert_allclose(rec["loss"], want["loss"], rtol=RTOL)
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(rec["metrics"][k], v, rtol=RTOL,
                                       err_msg=k)
        assert rec["loss"] == recs[0]["loss"]
        assert rec["step"] == recs[0]["step"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_fsdp_step_is_the_references_step(runs, case):
    """The step's metrics (the global norm over both axes' shards and
    ``lr`` among them) are the reference's; its params and ``mu`` are
    the FSDP shards of the reference's; at AdamW's default ``eps``,
    the change of every entry whose gradient is not near zero is the
    reference's (``test_rank_update_at_default_eps``'s rule)."""
    ref, _, got, port = runs
    want, mesh = ref[case], _mesh(case)
    specs = _specs(port[case], mesh)
    for r, rec in enumerate(_ranks(got, case)):
        for k in ("loss", "xent", "zloss", "dropped_frac", "grad_norm",
                  "lr"):
            np.testing.assert_allclose(rec["step"][k], want["step"][k],
                                       rtol=RTOL, err_msg=k)
        at = coords(mesh, r)
        for key in ("params", "mu"):
            mptrain._assert_leaves(rec[key], shard_tree(want[key], specs,
                                                        mesh, at),
                                   f"{case} rank {r} {key}")
        grads = dict(mptrain._leaves(shard_tree(want["grads"], specs, mesh,
                                                at)))
        moved = dict(mptrain._leaves(shard_tree(want["update"], specs, mesh,
                                                at)))
        mine = dict(mptrain._leaves(rec["update"]))
        assert sorted(mine) == sorted(moved)
        for path, w in moved.items():
            g = np.abs(grads[path])
            big = g >= mptrain.UPDATE_FLOOR * g.max()
            err = float(np.abs(mine[path] - w)[big].max(initial=0.0))
            scale = max(float(np.abs(w).max()), 1e-30)
            assert err <= mptrain.UPDATE_TOL * scale, (case, r, path, err)


def test_mamba2_layout_splits_a_period_axis():
    """At reduced Mamba2 on a (2, 1) mesh ``_with_fsdp`` splits some
    block leaves on their period axis (dimension 0): ``block_at`` gathers
    those whole before the period select, the others after it."""
    tcfg = zoo_configs("mamba2-1.3b")[1]
    full = TT.params_from_numpy(mptrain._weights(tcfg, 0), tcfg,
                                device="cpu")
    dims = fsdp_dims(tcfg, full, make_mesh(2, 1))
    ssm = dims["blocks"][0]["ssm"]
    assert {k for k, d in ssm.items() if d == 0} >= {"gate_norm", "conv_bx"}
    assert dims["embed"] == 1 and any(d not in (0, None)
                                      for d in ssm.values())


@pytest.mark.parametrize("case", sorted(SERVE))
def test_fsdp_serving_matches_the_reference(runs, case):
    """Each data rank's rows of the prefill's and the decode steps'
    logits (gathered over the model axis) are the reference's unsharded
    steps' rows; its greedy tokens, the steps' and ``generate``'s, are the
    reference's."""
    _, served, got, _ = runs
    want = served[SERVE[case][2]]
    recs = [r["serve"][case] for r in got[_world(*SERVE[case][:2])]]
    assert sorted({tuple(r["rows"]) for r in recs}) == [(0, 1), (1, 2)]
    for rec in recs:
        rows = slice(*rec["rows"])
        np.testing.assert_allclose(rec["prefill"], want["prefill"][rows],
                                   atol=SERVE_TOL, rtol=SERVE_TOL)
        for a, b in zip(rec["steps"], want["steps"], strict=True):
            np.testing.assert_allclose(a, b[rows], atol=SERVE_TOL,
                                       rtol=SERVE_TOL)
        np.testing.assert_array_equal(rec["tokens"], want["tokens"][rows])
        np.testing.assert_array_equal(rec["generate"],
                                      want["generate"][rows])


def test_global_norm_counts_each_leaf_once(runs):
    """On a (2, 2) mesh a leaf split on data only, one on model only, one
    on both and one on neither: every rank's norm is the whole tree's
    (each element counted once), the same bits on every rank."""
    _, _, got, _ = runs
    norms = [r["norm"] for r in got[4]]
    for norm, want in norms:
        np.testing.assert_allclose(norm, want, rtol=1e-6)
    assert len({n for n, _ in norms}) == 1


@pytest.mark.parametrize("case", ["dense", "mamba2", "remat"])
def test_data_axis_of_one_is_bitwise_no_layout(case):
    """A layout over a data axis of size 1 steps as no layout does, bit
    for bit: gradients, metrics and the updated state (at one intra-op
    thread)."""
    (_, tcfg), _, _, remat, accum = CASES[case]
    params = TT.params_from_numpy(mptrain._weights(tcfg, 0), tcfg,
                                  device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in mptrain._batch(tcfg, 0).items()}
    one = mp.Fsdp(mp.ModelAxis(0, 1, None, name=DATA_AXIS),
                  fsdp_dims(tcfg, params, make_mesh(1, 1)), sums=False)
    assert any(d is not None for d in tree_leaves(one.dims))
    out = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for layout in (one, None):
        step = tloop.make_train_step(tcfg, topt.AdamWConfig(**OPT), remat,
                                     accum, fsdp=layout)
        _, grads = tloop.step_grads(params, tcfg, batch, remat, accum,
                                    fsdp=layout)
        new, state, m = step(params, topt.init_opt_state(params), batch)
        out.append(tree_leaves((grads, new, state)) + list(m.values()))
    torch.set_num_threads(threads)
    for a, b in zip(*out, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("program", sorted(GRAPHS))
def test_donated_step_refuses_an_fsdp_layout(runs, program):
    """``DonatedStep`` takes a rank program's in-place step, over the
    model axis or under the FSDP layout: on CPU tensors it runs it
    eagerly, two calls bitwise the plain step's (metrics and trees, no
    capture); it refuses ``graphs=True`` over gloo, naming the backend
    (a capture cannot hold a collective that runs on the host)."""
    for rec in _graphs(runs, program):
        assert rec["eager_bitwise"] and rec["captures"] == 0
        assert rec["graphs_true"] is not None
        assert "gloo" in rec["graphs_true"]


@pytest.mark.parametrize("program", sorted(GRAPHS))
@pytest.mark.parametrize("step", ["train", "serve"])
def test_rank_programs_read_nothing_on_the_host(runs, program, step):
    """The in-place train step (after its first call) and the decode step
    of a rank program, over the model axis or under the FSDP layout,
    read no tensor on the host on either rank (``NoHostReads``): the
    CPU's proxy for a capture taking them."""
    for rec in _graphs(runs, program):
        assert rec[f"{step}_host_read"] is None, rec[f"{step}_host_read"]


@pytest.mark.parametrize("program", sorted(GRAPHS))
def test_generate_graphs_true_over_gloo_raises(runs, program):
    """``launch.serve.generate(graphs=True)`` over a gloo rank's axis
    raises, naming the backend, on every rank: no fallback to eager."""
    for rec in _graphs(runs, program):
        assert rec["generate_graphs_true"] is not None
        assert "gloo" in rec["generate_graphs_true"]


@pytest.mark.parametrize("layout", ["none", "data_axis_of_one"])
def test_in_place_step_is_bitwise_the_new_trees_step(layout):
    """``make_train_step(in_place=True)`` writes the new params and
    moments into the trees it was handed and returns them, with the bits
    of the step that makes new trees (two steps, so the second reads the
    first's moments)."""
    (_, tcfg), _, _, remat, accum = CASES["dense"]
    params = TT.params_from_numpy(mptrain._weights(tcfg, 0), tcfg,
                                  device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in mptrain._batch(tcfg, 0).items()}
    fsdp = None if layout == "none" else mp.Fsdp(
        mp.ModelAxis(0, 1, None, name=DATA_AXIS),
        fsdp_dims(tcfg, params, make_mesh(1, 1)), sums=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = []
    for in_place in (False, True):
        step = tloop.make_train_step(tcfg, topt.AdamWConfig(**OPT), remat,
                                     accum, fsdp=fsdp, in_place=in_place)
        p = TT.params_from_numpy(mptrain._weights(tcfg, 0), tcfg,
                                 device="cpu")
        state = topt.init_opt_state(p)
        held = tree_leaves((p, state["mu"], state["nu"]))
        metrics = []
        for _ in range(2):
            p, state, m = step(p, state, batch)
            metrics.append(m)
        leaves = tree_leaves((p, state["mu"], state["nu"]))
        assert all(a is b for a, b in zip(held, leaves)) == in_place
        out.append(leaves + [v for m in metrics for v in m.values()])
    torch.set_num_threads(threads)
    for a, b in zip(*out, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
