"""The port's MoE and Mamba2 (SSD) blocks against the JAX package's on
the same NumPy inputs, and the cut-point segment functions over SSM
and hybrid stacks against the monolithic path.

Exact where the reference's output is discrete: capacities, the
dispatch one-hot (expert choice, slot, dropped tokens). The combine
gates come from a softmax whose last ulp differs between the two
frameworks' ``exp``: 1e-6. Block outputs and aux: rtol 1e-5 (f32 sums
in another order); SSM states, rings and outputs through the chunked
scan: 1e-4. The reference runs eagerly here, so its bf16 load density
keeps its rounding (a jitted run drops it, see
tests/test_torch_zoo_models.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as TT
from tests._torch_parity import (assert_trees_close, lm_weights, to_numpy,
                                 to_torch, zoo_configs)

RTOL = 1e-5
TOL = 1e-4


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _layer(tree, part):
    """Period 0's slice of position 0's ``part`` leaves as NumPy."""
    return {k: np.asarray(v[0]) for k, v in tree["blocks"][0][part].items()}


@pytest.mark.parametrize("gs,e,k,cf", [(128, 64, 8, 1.25), (1, 64, 8, 1.25),
                                        (12, 4, 2, 1.25), (64, 16, 4, 0.5),
                                        (3, 16, 1, 2.0)])
def test_capacity_for(gs, e, k, cf):
    assert tmoe.capacity_for(gs, e, k, cf) == jmoe.capacity_for(gs, e, k, cf)


@pytest.mark.parametrize("top_k,cf", [(2, 1.25), (8, 1.25), (4, 0.5)],
                         ids=["k2", "k8", "k4_dropping"])
def test_route(top_k, cf):
    """Dispatch exactly (which expert, which slot, which tokens dropped
    past capacity), combine gates and aux; ties in the probabilities
    (duplicated logits) go to the lower expert index, as jax.lax.top_k
    breaks them."""
    g, gs, e = 3, 32, 16
    logits = _x((g, gs, e), top_k)
    logits[0, :8, 5] = logits[0, :8, 3]            # ties
    logits[1, :, :] = 0.0                          # all tied
    cap = jmoe.capacity_for(gs, e, top_k, cf)
    jd, jc, ja = jmoe._route(jnp.asarray(logits), top_k, cap)
    td, tc, ta = tmoe._route(to_torch(logits), top_k, cap)
    assert td.dtype == torch.bfloat16 and tc.dtype == torch.float32
    np.testing.assert_array_equal(to_numpy(td), np.asarray(jd, np.float32))
    np.testing.assert_allclose(to_numpy(tc), np.asarray(jc), atol=1e-6,
                               rtol=1e-6)
    for name in ja:
        np.testing.assert_allclose(float(ta[name]), float(ja[name]),
                                   rtol=RTOL, err_msg=name)
    if cf < 1:
        assert float(ta["dropped_frac"]) > 0.0


@pytest.mark.parametrize("arch,s", [("olmoe-1b-7b", 12), ("olmoe-1b-7b", 1),
                                    ("dbrx-132b", 40),
                                    ("musicgen-medium", 12)],
                         ids=["swiglu_s12", "swiglu_decode", "swiglu_s40",
                              "gelu_s12"])
def test_moe_apply(arch, s):
    """``moe_apply`` and its aux on one layer's weights: swiglu experts
    (olmoe, dbrx) and gelu ones (musicgen's MLP kind on a MoE block), a
    decode step (groups of one token, capacity = top_k) and a group of
    40 tokens that drops some."""
    jcfg, tcfg = zoo_configs(arch)
    if tcfg.moe is None:
        moe = zoo_configs("olmoe-1b-7b")[1].moe
        jcfg, tcfg = (dataclasses.replace(c, moe=moe) for c in (jcfg, tcfg))
    mp = _layer(lm_weights(tcfg), "moe")
    assert ("w_gate" in mp) == (tcfg.mlp == "swiglu")
    x = _x((2, s, tcfg.d_model), s)
    jo, ja = jmoe.moe_apply(jax.tree.map(jnp.asarray, mp), jcfg,
                            jnp.asarray(x))
    to, ta = tmoe.moe_apply({k: to_torch(v) for k, v in mp.items()}, tcfg,
                            to_torch(x))
    np.testing.assert_allclose(to_numpy(to), np.asarray(jo), rtol=RTOL,
                               atol=RTOL)
    for name in ja:
        np.testing.assert_allclose(float(ta[name]), float(ja[name]),
                                   rtol=RTOL, atol=1e-7, err_msg=name)


@pytest.fixture(scope="module")
def mamba():
    """mamba2's reduced layer (d_inner 512, 16 heads of 32, d_state 16,
    chunk 32) as both packages' leaves."""
    jcfg, tcfg = zoo_configs("mamba2-1.3b")
    sp = _layer(lm_weights(tcfg), "ssm")
    # nonzero biases and conv offsets, so that every leaf is exercised
    rng = np.random.default_rng(9)
    for k in ("conv_bx", "conv_bB", "conv_bC", "dt_bias"):
        sp[k] = (0.1 * rng.standard_normal(sp[k].shape)).astype(np.float32)
    return (jcfg, jax.tree.map(jnp.asarray, sp), tcfg,
            {k: to_torch(v) for k, v in sp.items()})


@pytest.mark.parametrize("s", [96, 70, 20], ids=["3chunks", "padded",
                                                  "short"])
def test_ssm_forward(mamba, s):
    """The chunked scan over three chunks, a length that is not a chunk
    multiple (right-padded, trimmed) and one shorter than a chunk; the
    final carried state too."""
    jcfg, jp, tcfg, tp = mamba
    x = _x((2, s, tcfg.d_model), s)
    jo, jh = jssm._ssm_forward_with_state(jp, jcfg, jnp.asarray(x))
    to, th = tssm._ssm_forward_with_state(tp, tcfg, to_torch(x))
    assert tuple(to.shape) == (2, s, tcfg.d_model)
    np.testing.assert_allclose(to_numpy(to), np.asarray(jo), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(to_numpy(th), np.asarray(jh), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(
        to_numpy(tssm.ssm_forward(tp, tcfg, to_torch(x))), np.asarray(jo),
        atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_prefill_then_decode(mamba, dtype):
    """``ssm_prefill``'s state and conv ring (PRE-conv x, B, C in the
    cache dtype; the state f32 whatever it is), then four
    ``ssm_decode`` steps updating both in place. A bf16 ring holds f32
    projections that differ in their last bits rounded to bf16, so
    there a value may sit one bf16 step (2^-8 relative) away."""
    jcfg, jp, tcfg, tp = mamba
    tol = TOL if dtype == "float32" else 2.0 ** -8
    x = _x((2, 40, tcfg.d_model), 1)
    jcache = jssm.init_ssm_cache(jcfg, 2, getattr(jnp, dtype))
    tcache = tssm.init_ssm_cache(tcfg, 2, getattr(torch, dtype), "cpu")
    assert tcache["state"].dtype == torch.float32
    jo, jcache = jssm.ssm_prefill(jp, jcfg, jnp.asarray(x), jcache)
    to, same = tssm.ssm_prefill(tp, tcfg, to_torch(x), tcache)
    assert same is tcache
    np.testing.assert_allclose(to_numpy(to), np.asarray(jo), atol=TOL,
                               rtol=TOL)
    assert_trees_close(tcache, jcache, tol)
    for i in range(4):
        xi = _x((2, 1, tcfg.d_model), 50 + i)
        jo, jcache = jssm.ssm_decode(jp, jcfg, jnp.asarray(xi), jcache)
        to, _ = tssm.ssm_decode(tp, tcfg, to_torch(xi), tcache)
        np.testing.assert_allclose(to_numpy(to), np.asarray(jo), atol=tol,
                                   rtol=tol, err_msg=f"step {i}")
    assert tcache["state"].dtype == torch.float32
    assert tcache["conv"].dtype == getattr(torch, dtype)
    assert_trees_close(tcache, jcache, tol)


j_seg_prefill = jax.jit(JT.segment_prefill, static_argnums=1)
j_seg_decode = jax.jit(JT.segment_decode_step, static_argnums=1)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_segments_at_every_cut(arch):
    """Device segment [0, p) then server tail [p, L) at every cut p, as
    a decode session splits the stack: prefill into two cache trees and
    three decode steps give the monolithic ``prefill`` /
    ``decode_step`` logits, and each segment's cache slices the
    reference's ``segment_prefill`` / ``segment_decode_step`` (jamba's
    period holds an SSM and an attention position)."""
    jcfg, tcfg = zoo_configs(arch)
    tree = lm_weights(tcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = TT.params_from_numpy(tree, tcfg, device="cpu")
    L, b, s, max_len = tcfg.num_layers, 2, 16, 24
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab_size, (b, s))
    want, caches, _ = TT.prefill(tparams, tcfg, to_torch(tokens),
                                 max_len=max_len, cache_dtype=torch.float32)
    steps = [np.argmax(to_numpy(want)[:, -1:], -1).astype(np.int32)]
    mono = []
    for i in range(3):
        lg, caches = TT.decode_step(tparams, tcfg, to_torch(steps[-1]),
                                    caches, s + i)
        mono.append(to_numpy(lg))
        steps.append(np.argmax(mono[-1], -1).astype(np.int32))
    for p in range(L + 1):
        segs = [TT.init_cache(tcfg, b, max_len, torch.float32, "cpu")
                for _ in range(2)]
        jsegs = [JT.init_cache(jcfg, b, max_len, jnp.float32)
                 for _ in range(2)]
        h = TT.embed_tokens(tparams, tcfg, to_torch(tokens))
        jh = JT.embed_tokens(jparams, jcfg, jnp.asarray(tokens))
        for i, (lo, hi) in enumerate(((0, p), (p, L))):
            h, _ = TT.segment_prefill(tparams, tcfg, h, segs[i], lo, hi)
            jh, jsegs[i] = j_seg_prefill(jparams, jcfg, jh, jsegs[i], lo, hi)
        np.testing.assert_allclose(to_numpy(TT.unembed(tparams, tcfg, h)),
                                   to_numpy(want), atol=TOL, rtol=TOL)
        for i in range(3):
            x = TT.embed_tokens(tparams, tcfg, to_torch(steps[i]))
            jx = JT.embed_tokens(jparams, jcfg, jnp.asarray(steps[i]))
            for k, (lo, hi) in enumerate(((0, p), (p, L))):
                x, _ = TT.segment_decode_step(tparams, tcfg, x, segs[k],
                                              s + i, lo, hi)
                jx, jsegs[k] = j_seg_decode(jparams, jcfg, jx, jsegs[k],
                                            jnp.int32(s + i), lo, hi)
            np.testing.assert_allclose(
                to_numpy(TT.unembed(tparams, tcfg, x)), mono[i], atol=TOL,
                rtol=TOL, err_msg=f"p={p} step {i}")
        for k in range(2):
            assert_trees_close(segs[k], jsegs[k], TOL, f"p={p} seg {k}")


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_extend_and_verify_refuse_ssm_blocks(arch):
    """As the reference: chunked extend and speculative verify need an
    attention-only stack."""
    _, tcfg = zoo_configs(arch)
    params = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    caches = TT.init_cache(tcfg, 1, 8, torch.float32, "cpu")
    h = torch.zeros(1, 2, tcfg.d_model)
    for fn in (TT.segment_extend, TT.segment_verify):
        with pytest.raises(NotImplementedError,
                           match="attention blocks only: block kind at "
                                 "period position 0 is not ATTN"):
            fn(params, tcfg, h, caches, 0, 0, tcfg.num_layers)
