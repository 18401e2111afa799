"""The port's decoder stack against the JAX package on the same weights
(the reference's seeded init carried across as NumPy): logits at every
kind of cut, the prefill/extend and decode caches, RoPE variants and
sliding-window attention. f32 throughout; 1e-4 allows the f32
summation-order differences of two frameworks' matmuls through 4
layers."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import rope as jrope
from repro.models import transformer as JT
from repro_torch.models import attention as tattn
from repro_torch.models import rope as trope
from repro_torch.models import transformer as TT
from tests._torch_parity import lm_configs, lm_weights, to_numpy, to_torch

TOL = 1e-4
SEQ = 16

# the reference's segment programs, compiled once per shape as it runs them
j_forward = jax.jit(JT.segment_forward, static_argnums=1,
                    static_argnames="collect")
j_logits = jax.jit(JT.segment_logits, static_argnums=1)
j_extend = jax.jit(JT.segment_extend, static_argnums=1)
j_decode = jax.jit(JT.segment_decode_step, static_argnums=1)
j_prefill = jax.jit(JT.segment_prefill, static_argnums=1)


def _lm(tp_pad):
    jcfg, tcfg = lm_configs(tp_pad=tp_pad)
    tree = lm_weights(tcfg)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, SEQ))
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            TT.params_from_numpy(tree, tcfg, device="cpu"), tokens)


@pytest.fixture(scope="module")
def lm():
    return _lm(1)


@pytest.mark.parametrize("tp_pad", [1, 16], ids=["smollm-8m", "tp_pad16"])
def test_logits_at_cuts(lm, tp_pad):
    """Device segment [0, p) then server tail [p, L) at p in {0, 1, L/2,
    L}: the cut activation (the reference's collected activations) and
    the logits agree; padded vocab columns are masked."""
    jcfg, jparams, tcfg, tparams, tokens = lm if tp_pad == 1 else _lm(16)
    L = jcfg.num_layers
    jh0 = JT.embed_tokens(jparams, jcfg, jnp.asarray(tokens))
    th0 = TT.embed_tokens(tparams, tcfg, to_torch(tokens))
    np.testing.assert_array_equal(to_numpy(th0), np.asarray(jh0))
    _, tacts = TT.segment_forward(tparams, tcfg, th0, 0, L, collect=True)
    jh_out, jacts = j_forward(jparams, jcfg, jh0, 0, L, collect=True)
    np.testing.assert_allclose(to_numpy(tacts), np.asarray(jacts), atol=TOL,
                               rtol=TOL)
    for p in (0, 1, L // 2, L):
        th = TT.segment_forward(tparams, tcfg, th0, 0, p)
        jh = jacts[p] if p < L else jh_out
        np.testing.assert_allclose(to_numpy(th), np.asarray(jh), atol=TOL,
                                   rtol=TOL)
        tl = TT.segment_logits(tparams, tcfg, th, p, L)
        jl = j_logits(jparams, jcfg, jh, p, L)
        np.testing.assert_allclose(to_numpy(tl), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
    pad = to_numpy(tl)[:, jcfg.vocab_size:]
    assert pad.shape[1] == jcfg.padded_vocab() - jcfg.vocab_size
    assert (pad == -1e30).all()


def test_extend_and_decode_caches(lm):
    """The prefill (one extend chunk, as decode sessions run it) and two
    decode steps over a cut segment [1, L): hidden states and every
    cache slice agree."""
    jcfg, jparams, tcfg, tparams, tokens = lm
    L, max_len = jcfg.num_layers, 24
    jc = JT.init_cache(jcfg, 2, max_len, jnp.float32)
    tc = TT.init_cache(tcfg, 2, max_len, torch.float32, device="cpu")
    jh = JT.embed_tokens(jparams, jcfg, jnp.asarray(tokens))
    th = TT.embed_tokens(tparams, tcfg, to_torch(tokens))
    jh, jc = j_extend(jparams, jcfg, jh, jc, 0, 1, L)
    th, tc = TT.segment_extend(tparams, tcfg, th, tc, 0, 1, L)
    np.testing.assert_allclose(to_numpy(th), np.asarray(jh), atol=TOL,
                               rtol=TOL)
    for pos in (SEQ, SEQ + 1):
        x = np.random.default_rng(pos).standard_normal(
            (2, 1, jcfg.d_model)).astype(np.float32)
        jx, jc = j_decode(jparams, jcfg, jnp.asarray(x), jc, pos, 1, L)
        tx, tc = TT.segment_decode_step(tparams, tcfg, to_torch(x), tc, pos,
                                        1, L)
        np.testing.assert_allclose(to_numpy(tx), np.asarray(jx), atol=TOL,
                                   rtol=TOL)
    for jpos, tpos in zip(jc, tc):
        for name in ("k", "v"):
            np.testing.assert_allclose(to_numpy(tpos[name]),
                                       np.asarray(jpos[name]), atol=TOL,
                                       rtol=TOL)


def test_prefill_ring_write(lm):
    """``segment_prefill``'s ring write for a prompt longer than the ring
    (the rolled layout)."""
    jcfg, jparams, tcfg, tparams, tokens = lm
    jc = JT.init_cache(jcfg, 2, 8, jnp.float32)
    tc = TT.init_cache(tcfg, 2, 8, torch.float32, device="cpu")
    jh, jc = j_prefill(jparams, jcfg,
                       JT.embed_tokens(jparams, jcfg, jnp.asarray(tokens)),
                       jc, 0, 2)
    th, tc = TT.segment_prefill(
        tparams, tcfg, TT.embed_tokens(tparams, tcfg, to_torch(tokens)), tc,
        0, 2)
    np.testing.assert_allclose(to_numpy(th), np.asarray(jh), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(to_numpy(tc[0]["k"]), np.asarray(jc[0]["k"]),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["rope", "rope2d", "mrope"])
def test_rope_variants(kind):
    x = np.random.default_rng(1).standard_normal((2, 5, 3, 64)).astype(
        np.float32)
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0) + 7
    got = trope.apply_rope(kind, to_torch(x), to_torch(pos), 10_000.0)
    want = jrope.apply_rope(kind, jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_windowed_attention():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((1, 32, 2, 2, 64)).astype(np.float32)
    k = rng.standard_normal((1, 32, 2, 64)).astype(np.float32)
    v = rng.standard_normal((1, 32, 2, 64)).astype(np.float32)
    got = tattn._windowed_attention(to_torch(q), to_torch(k), to_torch(v),
                                    8, 16)
    want = jattn._windowed_attention(q, k, v, 8, 16)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_unported_blocks_raise():
    """MoE and SSM blocks, which the port once refused, now run: a
    hybrid smollm-8m (per period of 2, a Mamba2 mixer with a dense MLP,
    then attention with a 4-expert MoE) initialises in the reference's
    stacked layout, and its forward logits and router aux are the
    reference's on the same weights."""
    from repro.configs import base as jbase
    from repro_torch.configs import base as tbase
    jcfg, tcfg = (dataclasses.replace(
        cfg, attn_every=2,
        moe=base.MoEConfig(num_experts=4, top_k=2, d_ff=128, every=2),
        ssm=base.SSMConfig(d_state=16, head_dim=32, chunk=8))
        for cfg, base in zip(lm_configs(), (jbase, tbase)))
    tree = lm_weights(tcfg)
    assert sorted(tree["blocks"][0]) == ["mlp", "norm1", "norm2", "ssm"]
    assert sorted(tree["blocks"][1]) == ["attn", "moe", "norm1", "norm2"]
    j = jax.eval_shape(lambda: JT.init_params(jax.random.key(0), jcfg))
    assert jax.tree.map(lambda a: tuple(a.shape), j) == tree_shapes(tree)
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, SEQ))
    jlogits, jaux = jax.jit(JT.forward, static_argnums=1)(
        jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(tokens))
    tlogits, taux = TT.forward(TT.params_from_numpy(tree, tcfg, "cpu"),
                               tcfg, to_torch(tokens))
    np.testing.assert_allclose(to_numpy(tlogits), np.asarray(jlogits),
                               atol=TOL, rtol=TOL)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-5, err_msg=k)
    assert float(taux["lb_loss"]) > 0.0


def test_seeded_init_layout():
    """The port's own seeded init has the reference's stacked layout."""
    jcfg, tcfg = lm_configs(tp_pad=16)
    t = TT.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    j = jax.eval_shape(lambda: JT.init_params(jax.random.key(0), jcfg))
    assert jax.tree.map(lambda a: tuple(a.shape), j) == tree_shapes(t)


def tree_shapes(tree):
    if isinstance(tree, dict):
        return {k: tree_shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_shapes(v) for v in tree]
    return tuple(tree.shape)

