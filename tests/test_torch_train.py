"""The port's training path against the JAX package on the same inputs:
the reference's seeded weights carried across as NumPy
(``params_from_numpy``) and the same NumPy token batches, on the 2-layer
f32 smoke variant of smollm-135m. Covered: the schedule, the global
norm and the AdamW update; ``lm_loss`` and every leaf's gradient; one
train step and four steps' losses; gradient accumulation; remat;
padded heads' gradients; ``.npz`` checkpoints crossing both ways; the
launcher on the CPU.

Tolerances: the optimizer's arithmetic is the reference's op for op, so
1e-6 relative (f32 rounding of the same formulas, summed in another
order for the norm). The loss and the gradients come through two
frameworks' f32 matmuls and reductions over 2 layers: 1e-5 relative on
the loss, and each leaf's gradient within 1e-4 of its largest
magnitude; remat against no remat to 1e-5 (the same arithmetic, but the
CPU's GEMMs are not bitwise across buffer alignments). Accumulated
against full-batch steps: the reference's own 5e-3."""
import dataclasses
import json

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
from repro_torch.configs.base import get_config as torch_get_config
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as TT
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop
from repro_torch.tree import tree_leaves, tree_map
from tests._torch_parity import to_numpy, to_torch, tree_to_torch

RTOL_OPT = 1e-6
RTOL_LOSS = 1e-5
GRAD_TOL = 1e-4
ACCUM_TOL = 5e-3
REMAT_TOL = 1e-5
B, S = 8, 32
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8)


def _configs(**kw):
    return tuple(dataclasses.replace(get()("smollm-135m").reduced(),
                                     dtype="float32", **kw)
                 for get in (lambda: jax_get_config,
                             lambda: torch_get_config))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _batches(vocab, n, seed=0, batch=B):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (batch, S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: to_torch(v) for k, v in b.items()}


def _flat(tree):
    """{path: leaf} of a reference tree, as the checkpoint keys it."""
    return jckpt._flatten(tree)


def _tflat(tree):
    return tckpt._flatten(tree)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _configs()
    jparams = JT.init_params(jax.random.key(0), jcfg)
    tree = _np_tree(jparams)
    tparams = TT.params_from_numpy(tree, tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams, _batches(jcfg.vocab_size, 4)


def _assert_grads(tgrads, jgrads, tol=GRAD_TOL):
    want, got = _flat(jgrads), _tflat(tgrads)
    assert sorted(want) == sorted(got)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        scale = max(np.abs(w).max(), 1e-12)
        err = np.abs(g - w).max()
        assert err <= tol * scale, (key, err, scale)


# ---------------------------------------------------------------------------
# Optimizer

def test_cosine_lr():
    cfg_j, cfg_t = jopt.AdamWConfig(**OPT), topt.AdamWConfig(**OPT)
    for step in (0, 1, 2, 3, 5, 8, 9, 100):
        np.testing.assert_allclose(
            to_numpy(topt.cosine_lr(cfg_t, torch.tensor(step,
                                                        dtype=torch.int32))),
            np.asarray(jopt.cosine_lr(cfg_j, jnp.int32(step))),
            rtol=RTOL_OPT)


def test_global_norm(setup):
    _, _, jparams, tparams, _ = setup
    np.testing.assert_allclose(to_numpy(topt.global_norm(tparams)),
                               np.asarray(jopt.global_norm(jparams)),
                               rtol=RTOL_OPT)


@pytest.mark.parametrize("clip_norm", [1.0, 1e3], ids=["clipped",
                                                       "unclipped"])
def test_adamw_update(setup, clip_norm):
    """Two updates from zero moments with the same NumPy gradients: the
    parameters (1-D norm scales undecayed, every >= 2-D leaf decayed, the
    stacked norm scales of the reference's layout included), both
    moments, the int32 step, the norm and the rate."""
    _, _, jparams, tparams, _ = setup
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32) * 0.05, _np_tree(jparams)) for _ in range(2)]
    cfg = dict(OPT, clip_norm=clip_norm)
    jp, js = jparams, jopt.init_opt_state(jparams)
    tp, ts = tparams, topt.init_opt_state(tparams)
    for g in grads:
        jp, js, jm = jopt.adamw_update(jopt.AdamWConfig(**cfg), jp,
                                       jax.tree.map(jnp.asarray, g), js)
        tp, ts, tm = topt.adamw_update(topt.AdamWConfig(**cfg), tp,
                                       tree_to_torch(g), ts)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 2
    for key, w in _flat({"p": jp, "mu": js["mu"], "nu": js["nu"]}).items():
        np.testing.assert_allclose(
            _tflat({"p": tp, "mu": ts["mu"], "nu": ts["nu"]})[key], w,
            rtol=RTOL_OPT, atol=1e-9, err_msg=key)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(to_numpy(tm[k]), np.asarray(jm[k]),
                                   rtol=RTOL_OPT)


def test_init_train_state():
    """Seeded f32 masters and a fresh state: zero f32 moments shaped like
    every leaf, an int32 step at 0 — the reference's layout."""
    _, tcfg = _configs()
    params, state = tloop.init_train_state(tcfg, torch.Generator().manual_seed(
        0), device="cpu")
    j_state = jopt.init_opt_state(JT.init_params(jax.random.key(0),
                                                 _configs()[0]))
    assert sorted(_tflat(state)) == sorted(_flat(j_state))
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for p, m, v in zip(tree_leaves(params), tree_leaves(state["mu"]),
                       tree_leaves(state["nu"])):
        assert p.dtype == m.dtype == v.dtype == torch.float32
        assert m.shape == p.shape and not m.any() and not v.any()


# ---------------------------------------------------------------------------
# Loss, gradients, steps

@pytest.fixture(scope="module")
def reference_grads(setup):
    jcfg, _, jparams, _, batches = setup
    fn = jax.jit(jax.value_and_grad(jloop.lm_loss, has_aux=True),
                 static_argnums=(1, 3))
    return fn(jparams, jcfg, _jbatch(batches[0]), False)


def test_lm_loss_and_every_gradient(setup, reference_grads):
    _, tcfg, _, tparams, batches = setup
    (jloss, jm), jgrads = reference_grads
    (tloss, tm), tgrads = tloop.value_and_grad(tparams, tcfg,
                                               _tbatch(batches[0]), False)
    np.testing.assert_allclose(to_numpy(tloss), np.asarray(jloss),
                               rtol=RTOL_LOSS)
    for k in ("xent", "zloss", "dropped_frac"):
        np.testing.assert_allclose(to_numpy(tm[k]), np.asarray(jm[k]),
                                   rtol=RTOL_LOSS)
    _assert_grads(tgrads, jgrads)


def test_remat_equals_no_remat(setup, reference_grads):
    """Checkpointed periods recompute the same forward: the same loss and
    gradients as without remat, and as the reference's. Not bitwise on
    the CPU: its GEMMs may take another path for another buffer
    alignment, so the two agree to REMAT_TOL of each leaf's largest
    gradient (on the card they are the same bits,
    tests/test_torch_cuda.py)."""
    _, tcfg, _, tparams, batches = setup
    batch = _tbatch(batches[0])
    (l0, _), g0 = tloop.value_and_grad(tparams, tcfg, batch, False)
    (l1, _), g1 = tloop.value_and_grad(tparams, tcfg, batch, True)
    np.testing.assert_allclose(to_numpy(l1), to_numpy(l0), rtol=REMAT_TOL)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert (a - b).abs().max() <= REMAT_TOL * a.abs().max()
    _assert_grads(g1, reference_grads[1])


def test_train_step_and_four_losses(setup):
    """One step's parameters, moments and metrics, then four steps'
    losses, through ``launch.steps.make_train_step`` as the reference's
    launcher builds it."""
    jcfg, tcfg, jparams, tparams, batches = setup
    jstep = jax.jit(jloop.make_train_step(jcfg, jopt.AdamWConfig(**OPT),
                                          remat=False))
    tstep = tsteps.make_train_step(tcfg, topt.AdamWConfig(**OPT),
                                   remat=False)
    jp, js = jparams, jopt.init_opt_state(jparams)
    tp, ts = tparams, topt.init_opt_state(tparams)
    jl, tl = [], []
    for i, b in enumerate(batches):
        jp, js, jm = jstep(jp, js, _jbatch(b))
        tp, ts, tm = tstep(tp, ts, _tbatch(b))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        if i == 0:
            for k in ("loss", "xent", "zloss", "grad_norm", "lr"):
                np.testing.assert_allclose(to_numpy(tm[k]),
                                           np.asarray(jm[k]),
                                           rtol=RTOL_LOSS, err_msg=k)
            for key, w in _flat({"p": jp, "mu": js["mu"]}).items():
                got = _tflat({"p": tp, "mu": ts["mu"]})[key]
                scale = max(np.abs(w).max(), 1e-12)
                assert np.abs(got - w).max() <= GRAD_TOL * scale, key
    np.testing.assert_allclose(tl, jl, rtol=RTOL_LOSS)


def test_accumulation(setup):
    """accum_steps=4 against the reference's accum_steps=4 (the same
    microbatch rows: (B/A, A) moved A-first) and against the port's own
    full batch."""
    jcfg, tcfg, jparams, tparams, batches = setup
    cfg_j, cfg_t = jopt.AdamWConfig(**OPT), topt.AdamWConfig(**OPT)
    batch = batches[1]
    j4 = jax.jit(jloop.make_train_step(jcfg, cfg_j, remat=False,
                                       accum_steps=4))
    jp4, _, jm4 = j4(jparams, jopt.init_opt_state(jparams), _jbatch(batch))
    t4 = tloop.make_train_step(tcfg, cfg_t, remat=False, accum_steps=4)
    t1 = tloop.make_train_step(tcfg, cfg_t, remat=False)
    ts0 = topt.init_opt_state(tparams)
    tp4, _, tm4 = t4(tparams, ts0, _tbatch(batch))
    tp1, _, tm1 = t1(tparams, ts0, _tbatch(batch))
    for k in ("loss", "xent", "grad_norm"):
        np.testing.assert_allclose(to_numpy(tm4[k]), np.asarray(jm4[k]),
                                   rtol=RTOL_LOSS, err_msg=k)
    for key, w in _flat(jp4).items():
        np.testing.assert_allclose(_tflat(tp4)[key], w, rtol=RTOL_LOSS,
                                   atol=ACCUM_TOL * 1e-2, err_msg=key)
    assert abs(float(tm1["loss"]) - float(tm4["loss"])) < ACCUM_TOL
    for a, b in zip(tree_leaves(tp1), tree_leaves(tp4)):
        np.testing.assert_allclose(to_numpy(a), to_numpy(b), atol=ACCUM_TOL)


class _Seen(Exception):
    pass


def test_microbatch_split_is_the_references(monkeypatch):
    """Microbatch a holds rows a, a + A, a + 2A, ... of the batch."""
    seen = []

    def spy(params, cfg, batch, remat):
        seen.append(batch["tokens"][:, 0].tolist())
        raise _Seen

    monkeypatch.setattr(tloop, "value_and_grad", spy)
    toks = torch.arange(8, dtype=torch.int32)[:, None].expand(8, 4)
    step = tloop.make_train_step(None, topt.AdamWConfig(), accum_steps=4)
    with pytest.raises(_Seen):
        step({"w": torch.zeros(1)}, None, {"tokens": toks, "labels": toks})
    split = np.asarray(jnp.swapaxes(jnp.arange(8).reshape(2, 4), 0, 1))
    assert seen == [split[0].tolist()]


def test_eval_step(setup, reference_grads):
    jcfg, tcfg, jparams, tparams, batches = setup
    tm = tloop.make_eval_step(tcfg)(tparams, _tbatch(batches[0]))
    jm = reference_grads[0][1]
    for k in ("xent", "zloss", "dropped_frac"):
        np.testing.assert_allclose(to_numpy(tm[k]), np.asarray(jm[k]),
                                   rtol=RTOL_LOSS)


def test_padded_heads_get_exactly_zero_gradient():
    """tp_pad=16 pads the 4 / 2 heads to 2 x 8 (and the padded heads are
    zero-masked after attention): their slices of wq and wo get exactly
    zero gradient, in the port and in the reference, and the real heads'
    gradients agree."""
    jcfg, tcfg = _configs(tp_pad=16)
    kvp, gp = tcfg.padded_heads()
    kv, g = tcfg.num_kv_heads, tcfg.num_heads // tcfg.num_kv_heads
    assert (kvp, gp) != (kv, g)
    jparams = JT.init_params(jax.random.key(1), jcfg)
    tparams = TT.params_from_numpy(_np_tree(jparams), tcfg, device="cpu")
    batch = _batches(jcfg.vocab_size, 1, seed=5, batch=2)[0]
    _, jgrads = jax.jit(jax.value_and_grad(jloop.lm_loss, has_aux=True),
                        static_argnums=(1, 3))(jparams, jcfg, _jbatch(batch),
                                               False)
    _, tgrads = tloop.value_and_grad(tparams, tcfg, _tbatch(batch), True)
    _assert_grads(tgrads, jgrads)
    for grads in (_flat(jgrads), _tflat(tgrads)):
        for name, axis in (("wq", 2), ("wo", 1)):
            w = grads[f"blocks%%0%%attn%%{name}"]
            heads = np.moveaxis(w, axis, 1).reshape(
                (w.shape[0], kvp, gp) + np.moveaxis(w, axis, 1).shape[2:])
            padded = np.ones((kvp, gp), bool)
            padded[:kv, :g] = False
            assert (heads[:, padded] == 0).all(), name
            assert np.abs(heads[:, ~padded]).max() > 0, name


# ---------------------------------------------------------------------------
# Checkpoints

def test_checkpoints_cross_both_ways(setup, tmp_path):
    """Saved by the reference, loaded by the port, and the other way:
    every leaf of the parameters and of the optimizer state (moments,
    the int32 step) the same bits, meta.json the same text; a template
    of another shape is refused."""
    jcfg, tcfg, jparams, tparams, _ = setup
    rng = np.random.default_rng(7)
    jstate = jopt.init_opt_state(jparams)
    jstate = {"mu": jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
        a.shape).astype(np.float32)), jstate["mu"]),
        "nu": jax.tree.map(lambda a: jnp.asarray(rng.random(
            a.shape).astype(np.float32)), jstate["nu"]),
        "step": jnp.int32(17)}
    tstate = tree_to_torch(_np_tree(jstate))
    meta = {"arch": "smollm-135m"}
    jckpt.save_checkpoint(str(tmp_path / "ref"), jparams, jstate, step=17,
                          metadata=meta)
    tckpt.save_checkpoint(str(tmp_path / "port"), tparams, tstate, step=17,
                          metadata=meta)
    assert (tmp_path / "ref" / "meta.json").read_text() == \
        (tmp_path / "port" / "meta.json").read_text()
    for name in ("params.npz", "opt_state.npz"):
        a, b = np.load(tmp_path / "ref" / name), np.load(tmp_path / "port"
                                                         / name)
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype and \
                a[key].tobytes() == b[key].tobytes(), key
    assert "step" in np.load(tmp_path / "port" / "opt_state.npz").files
    # reference -> port
    t_template = tree_map(torch.zeros_like, tparams)
    s_template = topt.init_opt_state(t_template)
    tp, ts, tmeta = tckpt.load_checkpoint(str(tmp_path / "ref"), t_template,
                                          s_template)
    assert tmeta == json.loads((tmp_path / "ref" / "meta.json").read_text())
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 17
    for key, w in _flat({"p": jparams, "s": jstate}).items():
        got = _tflat({"p": tp, "s": ts})[key]
        assert got.dtype == w.dtype and got.tobytes() == w.tobytes(), key
    # port -> reference
    jt = jax.tree.map(jnp.zeros_like, jparams)
    jp, js, jmeta = jckpt.load_checkpoint(str(tmp_path / "port"), jt,
                                          jopt.init_opt_state(jt))
    assert jmeta == tmeta
    for key, w in _tflat({"p": tparams, "s": tstate}).items():
        got = _flat({"p": jp, "s": js})[key]
        assert got.dtype == w.dtype and got.tobytes() == w.tobytes(), key
    wrong = dict(t_template, embed=torch.zeros(3, 3))
    with pytest.raises(ValueError, match="embed"):
        tckpt.load_checkpoint(str(tmp_path / "ref"), wrong)


# ---------------------------------------------------------------------------
# Launcher

def test_launch_train_on_cpu(tmp_path, capsys):
    """The launcher on the CPU: the reference's log lines, a loss that
    improves (exit 0) and a checkpoint the reference can read."""
    rc = ttrain.main(["--device", "cpu", "--reduced", "--steps", "12",
                      "--batch", "4", "--seq", "32", "--lr", "3e-3",
                      "--log-every", "5", "--checkpoint",
                      str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "(improved)" in out and "step     0 loss" in out
    cfg = jax_get_config("smollm-135m").reduced()
    template = JT.init_params(jax.random.key(0), cfg)
    params, state, meta = jckpt.load_checkpoint(
        str(tmp_path / "ck"), template, jopt.init_opt_state(template))
    assert meta == {"step": 12, "arch": "smollm-135m"}
    assert int(state["step"]) == 12
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree.leaves(params))
