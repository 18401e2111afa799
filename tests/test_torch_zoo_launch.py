"""The zoo through the port's serving launcher and training step against
the JAX package, on the 2-layer ``.reduced()`` f32 variants and the same
weights: the launcher's greedy tokens (full precision, int8 and int4
block weights) and its command line, and ``lm_loss`` with every
gradient on a MoE arch (router losses in) and on frontend ``embeds``
batches.

Exact: tokens. Loss 1e-5 relative and each leaf's gradient within 1e-4
of its largest magnitude, as tests/test_torch_train.py. Training batches
are 16 tokens, a power of two, so that the MoE load density is exact in
bf16 (see tests/test_torch_zoo_models.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.quantizer import \
    quantize_params_for_serving as jax_quantize_params
from repro.launch import serve as jserve
from repro.train import train_loop as jloop
from repro_torch.core.quantizer import quantize_params_for_serving
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.train import train_loop as tloop
from repro_torch.tree import tree_leaves
from tests._torch_parity import to_numpy, to_torch, zoo_weights

SEQ, GEN = 16, 6
RTOL_LOSS, GRAD_TOL = 1e-5, 1e-4


def _prompt(cfg, b=2, s=SEQ, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("quant", [0, 8, 4])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-1.3b",
                                  "jamba-v0.1-52b"])
def test_launcher(arch, quant, capsys):
    """The launcher's greedy tokens equal ``repro.launch.serve``'s on the
    same (quantized) weights, and its command line runs on the CPU."""
    jcfg, jparams, tcfg, tparams = zoo_weights(arch)
    if quant:
        jparams = jax_quantize_params(jparams, quant)
        tparams = quantize_params_for_serving(tparams, quant)
    prompt = _prompt(tcfg, s=12, seed=quant)
    want = jserve.generate(jparams, jcfg, jnp.asarray(prompt),
                           max_len=12 + GEN, gen=GEN)
    got = tserve.generate(tparams, tcfg, to_torch(prompt), max_len=12 + GEN,
                          gen=GEN)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    assert tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--quant", str(quant), "--batch", "2",
                        "--prompt-len", "8", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 4) in" in out
    assert (f"serving with int{quant} block weights" in out) == bool(quant)


def _batch(cfg, embeds: bool, mrope: bool):
    rng = np.random.default_rng(4)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (4, SEQ)).astype(
        np.int32)}
    if embeds:
        batch["embeds"] = (cfg.d_model ** -0.5 * rng.standard_normal(
            (4, SEQ, cfg.d_model))).astype(np.float32)
    else:
        batch["tokens"] = _prompt(cfg, b=4, seed=5)
    if mrope:
        from repro.models.frontend import mrope_positions
        batch["positions"] = np.asarray(mrope_positions(4, SEQ, (2, 2)))
    return batch


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "musicgen-medium",
                                  "qwen2-vl-72b"])
def test_lm_loss_and_every_gradient(arch):
    """``lm_loss`` and the gradient of every leaf against
    ``jax.value_and_grad`` of the reference's: olmoe with the router's
    load-balance and z losses added, musicgen and qwen2-vl on frontend
    ``embeds`` batches (qwen2-vl with M-RoPE triples), where the unread
    token embedding gets a zero gradient."""
    jcfg, jparams, tcfg, tparams = zoo_weights(arch)
    fe = tcfg.frontend != "none"
    batch = _batch(tcfg, embeds=fe, mrope=tcfg.rope == "mrope")
    (jl, jm), jg = jax.value_and_grad(jloop.lm_loss, has_aux=True)(
        jparams, jcfg, jax.tree.map(jnp.asarray, batch), True)
    (tl, tm), tg = tloop.value_and_grad(
        tparams, tcfg, {k: to_torch(v) for k, v in batch.items()}, True)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL_LOSS)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=RTOL_LOSS, atol=1e-7, err_msg=k)
    if tcfg.moe is not None:
        assert float(tm["dropped_frac"]) >= 0.0
        _, aux = TT.forward(tparams, tcfg, to_torch(batch["tokens"]))
        dense = float(tm["xent"] + tm["zloss"])
        assert float(tl) == pytest.approx(
            dense + tcfg.moe.aux_loss_weight * float(aux["lb_loss"])
            + 1e-3 * float(aux["z_loss"]), rel=1e-6)
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(flat) == len(tree_leaves(tg))
    tflat = {}

    def walk(node, key=""):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{key}['{k}']")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{key}[{i}]")
        else:
            tflat[key] = node

    walk(tg)
    for path, w in flat:
        key = jax.tree_util.keystr(path)
        w = np.asarray(w)
        g = to_numpy(tflat[key])
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, atol=GRAD_TOL * scale, rtol=0,
                                   err_msg=key)
    if fe:
        assert not tflat["['embed']"].any()
