"""The train step as one rank's program over the mesh's model axis
(``train_loop.make_train_step(axis=, group=)``, ``launch.model_parallel``
``to_ranks`` / ``from_ranks``): spawned ``gloo`` ranks on the CPU, f32,
each holding its shards of the same NumPy weights (``shard_tree`` of
``param_pspecs``) and its rows of the same NumPy tokens, held to the
reference's ``lm_loss`` gradient and ``make_train_step`` run unsharded,
cut to each rank's shards by ``shard_tree``. Cases:

* ``dense`` — the 4-layer smollm-8m at ``tp_pad=16`` on a (1, 2) mesh:
  its KV heads split (``kv_sharded``), padded heads, its tied head over
  a 256-column vocab (250 real) split in two;
* ``one_kv`` — a 2-layer config with one KV head of four queries, qk-norm
  and QKV biases: the replicated k / v sliced to each rank's KV head,
  the replicated norm scales met by each rank's heads;
* ``olmoe`` — reduced OLMoE, expert-parallel (2 of 4 experts a rank),
  the router and its losses replicated;
* ``mamba2`` — reduced Mamba2: head blocks, the replicated B / C and
  per-head leaves, the gated norm's sum over the axis;
* ``jamba`` — reduced Jamba: SSD, attention and expert-parallel MoE;
* ``dense_dp`` — smollm-8m on a (2, 2) mesh of four ranks: two rows a
  data index, the gradients averaged over the data axis;
* ``accum2`` — two microbatches;
* ``remat`` — remat on, with qk-norm and QKV biases on split KV heads:
  each period's forward collectives run again inside the backward.

Checks, per rank: every leaf's gradient (``step_grads``, as the step
takes it before its update) against its shard of the reference's
gradient of the whole batch (a replicated leaf's whole gradient), within
1e-4 of the leaf's largest magnitude; the loss, the metrics, the global
norm and ``lr`` to 1e-5 relative; the params and ``mu`` after the step
within 1e-4 of each leaf's largest magnitude — ``tests/test_torch_train.py``'s
tolerances for f32 products and sums over two frameworks, the ranks'
partial sums being one more reordering — at ``eps`` 1e-6; at the
default 1e-8, the step's change where the gradient is not near zero
(``test_rank_update_at_default_eps``). Bitwise: every leaf that no
model axis splits, gradient and updated value, equal across the ranks;
the loss and metrics equal across the ranks; an axis of size 1 against
no axis (gradients, metrics, state).

One spawn per world size (module fixtures: two ranks for the (1, 2)
cases, four for ``dense_dp``); the reference runs meanwhile."""
import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch.configs.base import get_config as torch_get_config
from repro_torch.launch import distributed
from repro_torch.launch import model_parallel as mp
from repro_torch.launch.mesh import MODEL_AXIS, coords, make_mesh
from repro_torch.launch.sharding import model_sharded, param_pspecs, \
    shard_tree
from repro_torch.models import transformer as TT
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop
from repro_torch.train.graphs import DonatedStep
from repro_torch.tree import tree_leaves
import _torch_model_parallel_train_ranks as ranks
from _torch_parity import lm_configs, lm_weights, zoo_configs

RTOL = 1e-5          # loss, metrics, global norm, lr
LEAF_TOL = 1e-4      # gradients, params and mu: of each leaf's largest
UPDATE_FLOOR = 1e-2  # the default-eps update: entries whose gradient is at
                     # least this share of the leaf's largest
UPDATE_TOL = 1e-3    # ... within this share of the leaf's largest change
B, S = 4, 32
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8, eps=1e-6)


def _with(configs, **kw):
    return tuple(dataclasses.replace(c, **kw) for c in configs)


def _one_kv():
    """A 2-layer f32 config with one KV head of four queries, qk-norm and
    QKV biases, as (jax cfg, torch cfg)."""
    kw = dict(name="smollm-mqa", num_layers=2, d_model=128, num_heads=4,
              num_kv_heads=1, head_dim=32, d_ff=256, vocab_size=256,
              tp_pad=1, dtype="float32", qk_norm=True, qkv_bias=True)
    return tuple(dataclasses.replace(get("smollm-135m"), **kw)
                 for get in (jax_get_config, torch_get_config))


# case -> ((jax cfg, torch cfg), data, remat, accum_steps)
CASES = {"dense": (lm_configs(tp_pad=16), 1, False, 1),
         "one_kv": (_one_kv(), 1, False, 1),
         "olmoe": (zoo_configs("olmoe-1b-7b"), 1, False, 1),
         "mamba2": (zoo_configs("mamba2-1.3b"), 1, False, 1),
         "jamba": (zoo_configs("jamba-v0.1-52b"), 1, False, 1),
         "dense_dp": (lm_configs(tp_pad=16), 2, False, 1),
         "accum2": (lm_configs(tp_pad=16), 1, False, 2),
         "remat": (_with(lm_configs(tp_pad=16), qk_norm=True,
                         qkv_bias=True), 1, True, 1)}
MODEL = 2                                  # every case's model axis


def _batch(cfg, seed: int) -> dict:
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _weights(tcfg, seed: int):
    """``lm_weights`` with the norm scales, biases and SSM skip and gate
    leaves jittered off their init (ones and zeros, where a wrong sum
    can hide)."""
    tree = lm_weights(tcfg, seed=seed)
    rng = np.random.default_rng(100 + seed)

    def jitter(node, key=None):
        if isinstance(node, dict):
            return {k: jitter(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [jitter(v, key) for v in node]
        if key in ("scale", "bias", "q_norm", "k_norm", "bq", "bk", "bv",
                   "gate_norm", "dt_bias", "D", "conv_bx", "conv_bB",
                   "conv_bC"):
            return (node + 0.1 * rng.standard_normal(node.shape)).astype(
                node.dtype)
        return node

    return jitter(tree)


_GRADS = jax.jit(jax.value_and_grad(jloop.lm_loss, has_aux=True),
                 static_argnums=(1, 3))


@functools.lru_cache(maxsize=None)
def _jstep(jcfg, remat: bool, accum: int, eps: float = OPT["eps"]):
    """The reference's jitted train step, one per config and ``eps``
    (cases of one config compile it once)."""
    return jax.jit(jloop.make_train_step(
        jcfg, jopt.AdamWConfig(**dict(OPT, eps=eps)), remat=remat,
        accum_steps=accum))


def _reference(jcfg, tree, remat: bool, accum: int, batch):
    """The reference's gradient of ``lm_loss`` over the whole batch, and
    its ``make_train_step`` from fresh moments: (loss, metrics, grads,
    step metrics, params, mu), NumPy."""
    params = jax.tree.map(jnp.asarray, tree)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = _GRADS(params, jcfg, jb, remat)
    new, state, m = _jstep(jcfg, remat, accum)(
        params, jopt.init_opt_state(params), jb)
    moved, _, _ = _jstep(jcfg, remat, accum, jopt.AdamWConfig.eps)(
        params, jopt.init_opt_state(params), jb)
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"loss": float(loss), "metrics": as_np(metrics),
            "grads": as_np(grads), "step": as_np(m), "params": as_np(new),
            "mu": as_np(state["mu"]),
            "update": as_np(jax.tree.map(jnp.subtract, moved, params))}


@pytest.fixture(scope="module")
def runs():
    """(the reference's runs, each rank's runs by case, the port's cases
    by name)."""
    port, ref_args = {}, {}
    for i, (name, ((jcfg, tcfg), data, remat, accum)) in enumerate(
            CASES.items()):
        tree, batch = _weights(tcfg, i), _batch(tcfg, i)
        port[name] = (tcfg, tree, OPT, data, remat, accum, batch)
        ref_args[name] = (jcfg, tree, remat, accum, batch)
    by_world = {}
    for name, case in port.items():
        by_world.setdefault(case[3] * MODEL, {})[name] = case
    with concurrent.futures.ThreadPoolExecutor(len(by_world)) as pool:
        spawned = {w: pool.submit(distributed.spawn, ranks.run_cases, w,
                                  "cpu", cases)
                   for w, cases in by_world.items()}
        with concurrent.futures.ThreadPoolExecutor(4) as jit_pool:
            ref = dict(zip(ref_args, jit_pool.map(lambda a: _reference(*a),
                                                  ref_args.values())))
        got = {w: f.result(timeout=600) for w, f in spawned.items()}
    two = {name: [r[name] for r in got[case[3] * MODEL]]
           for name, case in port.items()}
    return ref, two, port


def _leaves(tree, path=""):
    """(path, leaf) of a nested dict / list tree (a spec tree's tuples
    are leaves)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _assert_leaves(got, want, what: str):
    """Leaf by leaf, by path (the reference's dicts come back with their
    keys sorted), within LEAF_TOL of the want leaf's largest magnitude."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w), what
    for path, b in w.items():
        a = g[path]
        assert a.shape == b.shape, (what, path, a.shape, b.shape)
        scale = max(float(np.abs(b).max()), 1e-12)
        err = float(np.abs(a - b).max())
        assert err <= LEAF_TOL * scale, (what, path, err, scale)


def _mesh(case):
    return make_mesh(case[3], MODEL)


def _specs(case, mesh):
    """``param_pspecs`` of a port case's weights on ``mesh``."""
    cfg, tree = case[:2]
    return param_pspecs(cfg, TT.params_from_numpy(tree, cfg, device="cpu"),
                        mesh=mesh)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rank_gradients_are_the_references_shards(runs, case):
    """Every rank's gradient of every leaf is its shard of the
    reference's (a replicated leaf's, the whole gradient), and the loss
    and metrics are the reference's."""
    ref, two, port = runs
    want, mesh = ref[case], _mesh(port[case])
    specs = _specs(port[case], mesh)
    for r, got in enumerate(two[case]):
        shard = shard_tree(want["grads"], specs, mesh, coords(mesh, r))
        _assert_leaves(got["grads"], shard, f"{case} rank {r} grads")
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=RTOL,
                                       err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rank_step_is_the_references_step(runs, case):
    """The step's metrics (the global norm over the shards and ``lr``
    among them) are the reference's; its params and ``mu`` are the
    shards of the reference's."""
    ref, two, port = runs
    want, mesh = ref[case], _mesh(port[case])
    specs = _specs(port[case], mesh)
    for r, got in enumerate(two[case]):
        for k in ("loss", "xent", "zloss", "dropped_frac", "grad_norm",
                  "lr"):
            np.testing.assert_allclose(got["step"][k], want["step"][k],
                                       rtol=RTOL, err_msg=k)
        at = coords(mesh, r)
        for key in ("params", "mu"):
            _assert_leaves(got[key], shard_tree(want[key], specs, mesh, at),
                           f"{case} rank {r} {key}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_rank_update_at_default_eps(runs, case):
    """At AdamW's default ``eps`` (1e-8, the launcher's; the other checks
    take OPT's 1e-6), the first step's change of every shard is the
    reference's over the entries whose reference gradient is at least
    UPDATE_FLOOR of its leaf's largest, within UPDATE_TOL of the leaf's
    largest change. A first step moves an entry by lr · g / (|g| + eps):
    where |g| is within the gradients' f32 reorderings (LEAF_TOL of the
    largest) of zero, that ratio is rounding noise, on one card as on
    ranks (up to 5.6% of the largest change on these weights). Above
    the floor the change is ~lr, and the f32 spacing of a norm scale
    near 1 (1.2e-7) is 2.4e-4 of a warm-up step's 5e-4."""
    ref, two, port = runs
    want, mesh = ref[case], _mesh(port[case])
    specs = _specs(port[case], mesh)
    for r, got in enumerate(two[case]):
        at = coords(mesh, r)
        grads = dict(_leaves(shard_tree(want["grads"], specs, mesh, at)))
        moved = dict(_leaves(shard_tree(want["update"], specs, mesh, at)))
        mine = dict(_leaves(got["update"]))
        assert sorted(mine) == sorted(moved)
        for path, w in moved.items():
            g = np.abs(grads[path])
            big = g >= UPDATE_FLOOR * g.max()
            err = float(np.abs(mine[path] - w)[big].max(initial=0.0))
            scale = max(float(np.abs(w).max()), 1e-30)
            assert err <= UPDATE_TOL * scale, (case, r, path, err, scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_replicated_leaves_bitwise_across_ranks(runs, case):
    """Every leaf no model axis splits holds the same bits on every rank
    (gradient, updated value, moment), and so do the loss and the
    metrics: the ranks clip by one norm and step alike."""
    _, two, port = runs
    tcfg, tree = port[case][:2]
    flags = tree_leaves(model_sharded(
        tcfg, TT.params_from_numpy(tree, tcfg, device="cpu"), MODEL))
    first = two[case][0]
    assert not all(flags) and any(flags)
    for other in two[case][1:]:
        assert other["loss"] == first["loss"]
        assert other["metrics"] == first["metrics"]
        assert other["step"] == first["step"]
        for key in ("grads", "params", "mu"):
            for split, a, b in zip(flags, tree_leaves(first[key]),
                                   tree_leaves(other[key])):
                if not split:
                    np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("case", ["dense", "olmoe", "mamba2"])
def test_axis_of_one_is_bitwise_no_axis(case):
    """An axis of size 1 steps as no axis does, bit for bit: gradients,
    metrics and the updated state (at one intra-op thread: the CPU's
    threaded embedding backward is not bitwise repeatable)."""
    (_, tcfg), _, remat, accum = CASES[case]
    params = TT.params_from_numpy(_weights(tcfg, 0), tcfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg, 0).items()}
    out = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for axis in (mp.ModelAxis(0, 1, None), None):
        step = tloop.make_train_step(tcfg, topt.AdamWConfig(**OPT), remat,
                                     accum, axis=axis)
        _, grads = tloop.step_grads(params, tcfg, batch, remat, accum,
                                    axis=axis)
        new, state, m = step(params, topt.init_opt_state(params), batch)
        out.append(tree_leaves((grads, new, state)) + list(m.values()))
    torch.set_num_threads(threads)
    for a, b in zip(*out, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_donated_step_refuses_a_model_axis(backend, monkeypatch):
    """``DonatedStep`` takes a step over an active model axis, and over
    an axis of size 1. Asked for a graph, it refuses an axis whose group
    is gloo's, naming the backend (a capture cannot hold a collective
    that runs on the host); over NCCL it refuses only the CPU, as it
    does a one-card step (the group's backend read through a stand-in
    for ``torch.distributed.get_backend``: no process group here)."""
    import torch.distributed as dist
    monkeypatch.setattr(dist, "get_backend", lambda group: backend)
    tcfg = lm_configs(tp_pad=16)[1]
    opt = topt.AdamWConfig(**OPT)
    step = tloop.make_train_step(tcfg, opt,
                                 axis=mp.ModelAxis(0, 2, "model group"))
    params = TT.params_from_numpy(_weights(tcfg, 0), tcfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg, 0).items()}
    want = "NCCL over the model axis" if backend == "gloo" else \
        "CUDA graphs need a CUDA device"
    with pytest.raises(ValueError, match=want):
        DonatedStep(step, graphs=True)(params, topt.init_opt_state(params),
                                       batch)
    DonatedStep(tloop.make_train_step(tcfg, opt, axis=mp.ModelAxis(0, 1)))


def test_model_sharded_flags_follow_the_specs():
    """``model_sharded`` marks exactly the leaves whose spec names the
    model axis: the embedding and the split projections, not the norm
    scales, the router or the SSM's replicated leaves."""
    for arch in ("olmoe-1b-7b", "mamba2-1.3b"):
        tcfg = zoo_configs(arch)[1]
        tree = TT.params_from_numpy(lm_weights(tcfg), tcfg, device="cpu")
        specs = param_pspecs(tcfg, tree, mesh=make_mesh(1, MODEL))
        flags = model_sharded(tcfg, tree, MODEL)
        for (path, flag), (_, spec) in zip(_leaves(flags), _leaves(specs)):
            assert flag == (MODEL_AXIS in spec), path
        assert flags["embed"] and not flags["final_norm"]["scale"]
