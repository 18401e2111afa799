"""The ten assigned architectures in the port against the JAX package,
each at its 2-layer ``.reduced()`` variant in f32 on the same weights
(the port's seeded init carried across as NumPy): the init layout,
``forward`` logits and router aux, ``prefill`` logits and every cache
leaf, and four ``decode_step``s. musicgen-medium and qwen2-vl-72b run
through ``embeds=`` (NumPy-seeded frame / patch embeddings), qwen2-vl
with M-RoPE position triples.

Tolerance: 1e-4 (abs and rel), as tests/test_torch_model.py, for f32
products summed in another order through 2 layers; the router aux to
1e-5 relative. The reference runs jitted, as its launchers run it.

The prompt is 16 tokens, a power of two, so that a MoE group of S
tokens has an exact bf16 load density (count / S): jitted, XLA drops
the reference's bf16 rounding of that density, which its eager run
(and the port) keep; ``tests/test_torch_zoo_blocks.py`` holds the
rounding at a 12-token group against the eager reference."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ASSIGNED_ARCHS
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import list_configs as jax_list_configs
from repro.models import frontend as jfront
from repro.models import transformer as JT
from repro_torch.configs.base import get_config as torch_get_config
from repro_torch.configs.base import list_configs as torch_list_configs
from repro_torch.models import frontend as tfront
from repro_torch.models import transformer as TT
from tests._torch_parity import (assert_trees_close, lm_weights, to_numpy,
                                 to_torch, zoo_configs)

TOL = 1e-4
AUX_RTOL = 1e-5
B, S, MAX_LEN, STEPS = 2, 16, 24, 4

j_forward = jax.jit(JT.forward, static_argnums=1)
j_prefill = jax.jit(JT.prefill, static_argnums=1,
                    static_argnames=("max_len", "cache_dtype"))
j_decode = jax.jit(JT.decode_step, static_argnums=1)


def _inputs(cfg, seq: int, seed: int):
    """(tokens or None, embeds or None, positions or None) as NumPy."""
    rng = np.random.default_rng(seed)
    if cfg.frontend != "none":
        embeds = (cfg.d_model ** -0.5 * rng.standard_normal(
            (B, seq, cfg.d_model))).astype(np.float32)
        return None, embeds
    return rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32), None


class Arch:
    """One arch's weights, prompt and the reference's results."""

    def __init__(self, arch):
        self.jcfg, self.tcfg = zoo_configs(arch)
        tree = lm_weights(self.tcfg)
        self.jparams = jax.tree.map(jnp.asarray, tree)
        self.tparams = TT.params_from_numpy(tree, self.tcfg, device="cpu")
        self.tokens, self.embeds = _inputs(self.jcfg, S, 0)
        self.positions = (np.asarray(jfront.mrope_positions(B, S, (2, 2)))
                          if self.jcfg.rope == "mrope" else None)
        kw = self.jax_kw()
        self.forward = j_forward(self.jparams, self.jcfg, self.jtok(), **kw)
        self.prefill = j_prefill(self.jparams, self.jcfg, self.jtok(),
                                 max_len=MAX_LEN, cache_dtype=jnp.float32,
                                 **kw)

    def jtok(self):
        return None if self.tokens is None else jnp.asarray(self.tokens)

    def jax_kw(self):
        kw = {}
        if self.embeds is not None:
            kw["embeds"] = jnp.asarray(self.embeds)
        if self.positions is not None:
            kw["positions"] = jnp.asarray(self.positions)
        return kw

    def torch_kw(self):
        return {k: to_torch(np.asarray(v)) for k, v in self.jax_kw().items()}

    def step_input(self, i, logits):
        """Step i's input: the greedy token, or a fresh embedding."""
        if self.embeds is not None:
            return _inputs(self.jcfg, 1, 100 + i)[1]
        return np.argmax(np.asarray(logits)[:, -1:], -1).astype(np.int32)


_ARCHS = {}


@pytest.fixture(scope="module")
def zoo():
    def get(arch):
        if arch not in _ARCHS:
            _ARCHS[arch] = Arch(arch)
        return _ARCHS[arch]
    yield get
    _ARCHS.clear()


def test_registry_is_the_references():
    assert torch_list_configs() == jax_list_configs()
    assert set(ASSIGNED_ARCHS) <= set(torch_list_configs())


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_config_fields_are_the_references(arch):
    """Every field (MoE and SSM sub-configs included) and every derived
    quantity equal to the reference's, at full size and ``.reduced()``."""
    for jcfg, tcfg in ((jax_get_config(arch), torch_get_config(arch)),
                       (jax_get_config(arch).reduced(),
                        torch_get_config(arch).reduced())):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        for name in ("resolved_head_dim", "padded_vocab", "padded_heads",
                     "param_count", "active_param_count"):
            assert getattr(tcfg, name)() == getattr(jcfg, name)(), name
        assert [(tcfg.block_kind(i), tcfg.uses_moe(i))
                for i in range(tcfg.num_layers)] == \
            [(jcfg.block_kind(i), jcfg.uses_moe(i))
             for i in range(jcfg.num_layers)]


def tree_shapes(tree):
    if isinstance(tree, dict):
        return {k: tree_shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_init_layout(arch):
    """The port's seeded init has the reference's stacked layout: MoE
    expert stacks, SSM mixers, hybrid periods (jamba: 2 positions at
    .reduced())."""
    jcfg, tcfg = zoo_configs(arch)
    t = TT.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    j = jax.eval_shape(lambda: JT.init_params(jax.random.key(0), jcfg))
    assert jax.tree.map(lambda a: tuple(a.shape), j) == tree_shapes(t)
    jc = jax.eval_shape(lambda: JT.init_cache(jcfg, B, MAX_LEN, jnp.float32))
    tc = TT.init_cache(tcfg, B, MAX_LEN, torch.float32, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), jc) == tree_shapes(tc)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_forward(zoo, arch):
    a = zoo(arch)
    logits, aux = TT.forward(a.tparams, a.tcfg, None if a.tokens is None
                             else to_torch(a.tokens), **a.torch_kw())
    jlogits, jaux = a.forward
    np.testing.assert_allclose(to_numpy(logits), np.asarray(jlogits),
                               atol=TOL, rtol=TOL)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   rtol=AUX_RTOL, atol=1e-7, err_msg=k)
    if a.tcfg.moe is not None:
        assert float(aux["lb_loss"]) > 0.0 and float(aux["z_loss"]) > 0.0


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_prefill_and_decode(zoo, arch):
    """Prefill logits, aux and every cache leaf (K/V rings, SSM states
    and conv rings), then four decode steps' logits and the caches
    after them."""
    a = zoo(arch)
    logits, caches, aux = TT.prefill(
        a.tparams, a.tcfg, None if a.tokens is None else to_torch(a.tokens),
        max_len=MAX_LEN, cache_dtype=torch.float32, **a.torch_kw())
    jlogits, jcaches, jaux = a.prefill
    np.testing.assert_allclose(to_numpy(logits), np.asarray(jlogits),
                               atol=TOL, rtol=TOL)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   rtol=AUX_RTOL, atol=1e-7, err_msg=k)
    assert_trees_close(caches, jcaches, TOL)
    x = a.step_input(0, jlogits)
    for i in range(STEPS):
        jl, jcaches = j_decode(a.jparams, a.jcfg, jnp.asarray(x), jcaches,
                               jnp.int32(S + i))
        tl, caches = TT.decode_step(a.tparams, a.tcfg, to_torch(x), caches,
                                    S + i)
        np.testing.assert_allclose(to_numpy(tl), np.asarray(jl), atol=TOL,
                                   rtol=TOL, err_msg=f"step {i}")
        x = a.step_input(i + 1, jl)
    assert_trees_close(caches, jcaches, TOL)


def test_frontend_stubs():
    """``mrope_positions`` equals the reference's exactly (an image grid
    shorter and longer than the stream); ``stub_embeddings`` has the
    reference's shape, dtype and scale."""
    for seq, grid in ((12, (2, 2)), (40, (4, 8)), (6, (4, 4))):
        np.testing.assert_array_equal(
            to_numpy(tfront.mrope_positions(3, seq, grid, device="cpu")),
            np.asarray(jfront.mrope_positions(3, seq, grid)))
    _, tcfg = zoo_configs("musicgen-medium")
    e = tfront.stub_embeddings(torch.Generator().manual_seed(0), tcfg, 4, 64)
    want = jfront.stub_embeddings(jax.random.key(0), tcfg, 4, 64)
    assert tuple(e.shape) == want.shape and e.dtype == torch.bfloat16
    assert abs(float(e.float().std()) * tcfg.d_model ** 0.5 - 1.0) < 0.05
