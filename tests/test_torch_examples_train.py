"""The port's ``torch_train_small_lm`` example against the reference's
steps, replayed here through the reference's library: the example's
4-layer d_model 256 model (vocab 2048, bf16 activations, f32 masters)
from the reference's ``init_params(jax.random.key(0))`` weights carried
across with ``params_from_numpy``, the example's AdamW (lr 1e-3, 30
warm-up steps), 6 steps on the same seeded NumPy batches (B 4 x S 64;
the example's own run is 300 steps at B 16 x S 256 on the port's token
stream), the eval at steps 0 and 5; then the example's checkpoint
save-and-restore.

Held: every step's loss and both evals' cross-entropy within 1e-4
relative of the reference's (the same arithmetic through two
frameworks' bf16 matmuls); the checkpoint restored bit for bit."""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config
from repro.models import transformer as JT
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch.models import transformer as TT
from repro_torch.train import optimizer as topt
from repro_torch.tree import tree_leaves
from tests._torch_parity import EXAMPLES, load_example, to_torch

ROOT = EXAMPLES.parent

STEPS, B, S = 6, 4, 64
LOSS_RTOL = 1e-4


def _batches(vocab, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


@pytest.fixture(scope="module")
def both():
    ex = load_example("torch_train_small_lm")
    tcfg = ex.config()
    jcfg = dataclasses.replace(
        get_config("smollm-135m"), name="smollm-8m", num_layers=4,
        d_model=256, num_heads=4, num_kv_heads=2, head_dim=64, d_ff=768,
        vocab_size=2048, tp_pad=1)
    assert (tcfg.dtype, tcfg.vocab_size) == (jcfg.dtype, 2048)
    batches = _batches(jcfg.vocab_size, STEPS, 0)
    eval_batch = _batches(jcfg.vocab_size, 1, 123)[0]
    kw = dict(lr=1e-3, warmup_steps=30, total_steps=STEPS)

    init = JT.init_params(jax.random.key(0), jcfg)
    step = jax.jit(jloop.make_train_step(jcfg, jopt.AdamWConfig(**kw),
                                         remat=False))
    ev = jax.jit(jloop.make_eval_step(jcfg))
    p, s = init, jopt.init_opt_state(init)
    jlosses, jevals = [], {}
    for i, b in enumerate(batches):
        p, s, m = step(p, s, {k: jnp.asarray(v) for k, v in b.items()})
        jlosses.append(float(m["loss"]))
        if i % 25 == 0 or i == STEPS - 1:
            jevals[i] = float(ev(p, {k: jnp.asarray(v)
                                     for k, v in eval_batch.items()})["xent"])

    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, init), tcfg,
                                   device="cpu")
    tb = [{k: to_torch(v) for k, v in b.items()} for b in batches]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        params, opt_state, losses, evals = ex.train(
            tparams, tcfg, iter(tb), {k: to_torch(v)
                                      for k, v in eval_batch.items()},
            steps=STEPS, opt_cfg=topt.AdamWConfig(**kw), batch=B, seq=S)
    return dict(ex=ex, params=params, opt_state=opt_state, losses=losses,
                evals=evals, text=buf.getvalue(), jlosses=jlosses,
                jevals=jevals)


def test_losses_and_evals(both):
    np.testing.assert_allclose(both["losses"], both["jlosses"],
                               rtol=LOSS_RTOL)
    assert sorted(both["evals"]) == sorted(both["jevals"]) == [0, STEPS - 1]
    np.testing.assert_allclose([both["evals"][i] for i in (0, STEPS - 1)],
                               [both["jevals"][i] for i in (0, STEPS - 1)],
                               rtol=LOSS_RTOL)
    assert both["text"].splitlines()[0].startswith("step    0 train ")


def test_checkpoint_restores_bitwise(both, tmp_path):
    """The example's save-and-restore: every leaf of the parameters and
    the optimizer state the same bits; the step and arch in its meta.
    Its default directory is the repository's ``build/``."""
    params, state = both["params"], both["opt_state"]
    path = str(tmp_path / "ck")
    with contextlib.redirect_stdout(io.StringIO()):
        p2, s2, meta = both["ex"].checkpoint(path, params, state, STEPS,
                                             "smollm-8m")
    assert meta == {"step": STEPS, "arch": "smollm-8m"}
    for a, b in zip(tree_leaves((params, state)), tree_leaves((p2, s2))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(s2["step"]) == STEPS
    assert both["ex"].CKPT.parent == ROOT / "build"
