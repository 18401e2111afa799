"""The host mesh on the CPU: the port's train step data-parallel over two
spawned ranks (``launch.distributed``, ``gloo``), each on its rows of
the batch, against the reference's ``make_train_step`` run unsharded on
the global batch (what its sharded ``jax.jit`` on ``make_host_mesh``
computes) and against the port's own world of one, fed the same NumPy
weights and tokens. Covered: the 2-layer f32 smollm-135m of
``tests/test_torch_train.py`` on the reference's weights, four steps;
a reduced OLMoE (its router's load-balance and z losses in the loss,
``dropped_frac``); an odd batch, which ``batch_rows`` replicates; two
microbatches per rank; the launcher's ``main`` at world 2; a rank that
fails.

Tolerances are ``tests/test_torch_train.py``'s: the loss metrics, the
global norm and ``lr`` of the first step to 1e-5 relative, params and
``mu`` within 1e-4 of each leaf's largest magnitude, four losses to
1e-5; accumulation to the reference's accumulation as
``test_accumulation`` holds it. World 2 against world 1 is held to the
same tolerances (a mean of two half-batch means is the batch's mean up
to f32 rounding). Bitwise: the two ranks' states (the all-reduce gives
both the same bits), and the replicated odd batch against world 1 (x + x,
then / 2, is exact). The ranks and the world of one run at one intra-op
thread, so a rank's backward is the same bits as another's.

Three spawns, each about 3 s of process start-up: the step cases (one
pair of ranks, module fixture), the launcher, the failure."""
import concurrent.futures
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import transformer as JT
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch.launch import distributed
from repro_torch.launch import sharding as tshard
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_host_mesh
from tests import _torch_host_mesh_ranks as ranks
from tests._torch_parity import lm_weights, zoo_configs

RTOL_LOSS = 1e-5
GRAD_TOL = 1e-4
ACCUM_TOL = 5e-3
S = 32
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8)
FIRST = ("loss", "xent", "zloss", "grad_norm", "lr")


def _batches(vocab, n, batch, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (batch, S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _weights(jcfg):
    """The reference's seeded weights, as NumPy (``test_torch_train.py``'s
    ``setup``)."""
    return jax.tree.map(np.asarray, JT.init_params(jax.random.key(0), jcfg))


def _cases():
    """name -> ((jax cfg, torch cfg), weights, accum_steps, batches)."""
    dense = zoo_configs("smollm-135m")
    moe = zoo_configs("olmoe-1b-7b")
    w_dense, w_moe = _weights(dense[0]), lm_weights(moe[1], seed=1)
    v = dense[1].vocab_size
    return {"dense": (dense, w_dense, 1, _batches(v, 4, 8, 0)),
            "moe": (moe, w_moe, 1, _batches(moe[1].vocab_size, 2, 4, 1)),
            "odd": (dense, w_dense, 1, _batches(v, 2, 3, 2)),
            "accum2": (dense, w_dense, 2, _batches(v, 1, 8, 3))}


def _reference(jcfg, tree, accum, batches):
    """The reference's jitted step on each global batch -> (metrics as
    floats by step, {p, mu} after the first step, params after the
    last)."""
    step = jax.jit(jloop.make_train_step(jcfg, jopt.AdamWConfig(**OPT),
                                         remat=False, accum_steps=accum))
    params = jax.tree.map(jnp.asarray, tree)
    state = jopt.init_opt_state(params)
    metrics, first = [], None
    for b in batches:
        params, state, m = step(params, state, jax.tree.map(jnp.asarray, b))
        metrics.append({k: float(x) for k, x in m.items()})
        if first is None:
            first = jax.tree.map(np.asarray, {"p": params, "mu": state["mu"]})
    return metrics, first, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def runs():
    """(the reference's runs, the port's world 1, the port's two ranks),
    by case."""
    cases = _cases()
    port = {k: (cfgs[1], w, OPT, a, b) for k, (cfgs, w, a, b)
            in cases.items()}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # the ranks run while this process computes the other two
        spawned = pool.submit(distributed.spawn, ranks.run_cases, 2, "cpu",
                              port)
        ref = {k: _reference(cfgs[0], w, a, b) for k, (cfgs, w, a, b)
               in cases.items() if k != "odd"}     # odd: held to world 1
        threads = torch.get_num_threads()
        try:
            one = ranks.run_cases(0, 1, None, port)
        finally:
            torch.set_num_threads(threads)
        two = spawned.result(timeout=300)
    return ref, *jax.tree.map(
        lambda t: t.numpy() if isinstance(t, torch.Tensor) else t, (one, two))


def _leaves(tree):
    return jax.tree.leaves(tree)


def _assert_scaled(got, want, tol=GRAD_TOL):
    """Each leaf of ``got`` within ``tol`` of ``want``'s largest
    magnitude, leaf for leaf."""
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        scale = max(float(np.abs(w).max()), 1e-12)
        assert float(np.abs(g - w).max()) <= tol * scale, i


def _assert_step(got, want_metrics, want_first):
    """``test_train_step_and_four_losses``' checks of a run against
    another: the first step's metrics, params and ``mu``, every loss."""
    for k in FIRST:
        np.testing.assert_allclose(got["metrics"][0][k], want_metrics[0][k],
                                   rtol=RTOL_LOSS, err_msg=k)
    _assert_scaled(got["first"], want_first)
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]],
                               [m["loss"] for m in want_metrics],
                               rtol=RTOL_LOSS)


def _assert_ranks_bitwise(two, case):
    a, b = two[0][case], two[1][case]
    assert a["metrics"] == b["metrics"]
    for key in ("first", "last"):
        for x, y in zip(_leaves(a[key]), _leaves(b[key])):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), key


def test_host_mesh_and_batch_rows():
    """The host mesh is (data=n, model=1); a batch the data ranks divide
    is cut into their blocks in order, any other replicated, as
    ``batch_pspecs`` lays it out."""
    mesh = make_host_mesh(4)
    assert mesh.shape == {"data": 4, "model": 1}
    assert make_host_mesh().shape == {"data": 1, "model": 1}
    for b, want in ((8, [slice(2 * r, 2 * r + 2) for r in range(4)]),
                    (6, [slice(0, 6)] * 4), (2, [slice(0, 2)] * 4)):
        assert [tshard.batch_rows(mesh, b, r) for r in range(4)] == want
        split = tshard.batch_pspecs(mesh, b, False, False)["tokens"][0]
        assert (split is not None) == (want[0] != slice(0, b))


def test_world_2_is_the_references_global_step(runs):
    """Two ranks of four rows each step as the reference's unsharded step
    on all eight: first-step metrics, params and ``mu``, four losses;
    the two ranks hold the same bits."""
    ref, _, two = runs
    metrics, first, last = ref["dense"]
    for rank in (0, 1):
        _assert_step(two[rank]["dense"], metrics, first)
    _assert_ranks_bitwise(two, "dense")


def test_world_2_against_world_1(runs):
    """The port's two ranks against its one process on the whole batch,
    to the reference comparison's tolerances."""
    _, one, two = runs
    want = one["dense"]
    _assert_step(two[0]["dense"], want["metrics"], want["first"])
    _assert_scaled(two[0]["dense"]["last"], want["last"])


def test_moe_world_2_is_the_references(runs):
    """A reduced OLMoE at two ranks of two rows: the first step's metrics,
    both losses (which carry the router's load-balance and z losses)
    and ``dropped_frac`` as the reference's on the global batch — each
    rank routes its own rows' groups, and a mean of the ranks' group
    means is the batch's. Params and ``mu`` after the first step are
    held to the port's world of one: on this arch the port's own single
    process is 1.4e-4 of scale from the reference there (expert weights
    with gradients near zero, which AdamW's first step scales to about
    ``lr``), past ``GRAD_TOL``, with or without the mesh."""
    ref, one, two = runs
    metrics, _, _ = ref["moe"]
    got = two[0]["moe"]
    for k in FIRST:
        np.testing.assert_allclose(got["metrics"][0][k], metrics[0][k],
                                   rtol=RTOL_LOSS, err_msg=k)
    for step, want in enumerate(metrics):
        for k in ("loss", "dropped_frac"):
            np.testing.assert_allclose(got["metrics"][step][k], want[k],
                                       rtol=RTOL_LOSS, atol=1e-7, err_msg=k)
    assert all(m["dropped_frac"] > 0 for m in metrics)
    _assert_scaled(got["first"], one["moe"]["first"])
    _assert_ranks_bitwise(two, "moe")


def test_odd_batch_is_replicated_bitwise(runs):
    """A batch of 3 does not split over 2 ranks: each steps on all of it,
    and the mean of two equal gradients is the gradient, so the ranks
    give the world of one's metrics and state bit for bit."""
    _, one, two = runs
    for rank in (0, 1):
        got, want = two[rank]["odd"], one["odd"]
        assert got["metrics"] == want["metrics"]
        for key in ("first", "last"):
            for x, y in zip(_leaves(got[key]), _leaves(want[key])):
                assert x.tobytes() == y.tobytes(), key


def test_accumulation_splits_each_ranks_rows(runs):
    """Two microbatches of each rank's four rows against the reference's
    accum_steps=2 on the global batch (another split of the same rows),
    as ``test_accumulation`` holds the port's."""
    ref, _, two = runs
    metrics, _, last = ref["accum2"]
    got = two[0]["accum2"]
    for k in ("loss", "xent", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][0][k], metrics[0][k],
                                   rtol=RTOL_LOSS, err_msg=k)
    for g, w in zip(_leaves(got["last"]["p"]), _leaves(last)):
        np.testing.assert_allclose(g, w, rtol=RTOL_LOSS,
                                   atol=ACCUM_TOL * 1e-2)
    _assert_ranks_bitwise(two, "accum2")


def test_launcher_at_world_2(tmp_path, capfd):
    """``launch.train.main`` at world 2 on the CPU: rank 0's log lines
    alone, exit 0 (the loss improved), both ranks' losses and parameters
    the same, the first loss the world of one's (the same tokens), and
    one checkpoint the reference restores."""
    argv = ["--device", "cpu", "--reduced", "--steps", "12", "--batch", "4",
            "--seq", "32", "--lr", "3e-3", "--log-every", "5"]
    stats = {}
    rc = ttrain.main(argv + ["--checkpoint", str(tmp_path / "ck")], world=2,
                     stats=stats)
    out = capfd.readouterr().out
    assert rc == 0, out
    for line in ("step     0 loss", "step    11 loss", "(improved)",
                 "checkpoint saved"):
        assert out.count(line) == 1, (line, out)
    r0, r1 = stats["ranks"]
    assert r0["losses"] == r1["losses"] and r0["digest"] == r1["digest"]
    assert [m["loss"] for m in stats["metrics"]] == r0["losses"]
    assert stats["captures"] == {"step": 0, "sampler": 0}
    assert distributed.digest(stats["params"]) == r0["digest"]
    one = {}
    ttrain.main(argv, stats=one)
    np.testing.assert_allclose(r0["losses"][0], one["ranks"][0]["losses"][0],
                               rtol=RTOL_LOSS)
    template = JT.init_params(jax.random.key(0),
                              jax_get_config("smollm-135m").reduced())
    params, state, meta = jckpt.load_checkpoint(
        str(tmp_path / "ck"), template, jopt.init_opt_state(template))
    assert meta == {"step": 12, "arch": "smollm-135m"}
    assert int(state["step"]) == 12
    for got, want in zip(jax.tree.leaves(params),
                         _leaves(stats["params"])):
        assert np.array_equal(np.asarray(got), want.numpy())


def test_a_failed_rank_fails_the_run():
    """Rank 1 raises while rank 0 waits for it in an all-reduce: the
    spawn raises (with rank 1's error, or rank 0's lost peer, whichever
    the join sees first), and no rank is left running."""
    with pytest.raises(torch.multiprocessing.ProcessRaisedException):
        distributed.spawn(ranks.fail_on_rank_1, 2, "cpu")
    assert not multiprocessing.active_children()
