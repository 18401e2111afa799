"""The port's serving launcher against the JAX package's on the same
weights (the 4-layer f32 smollm-8m of ``tests/_torch_parity.py``), at
full precision and with int8 / int4 block weights: whole-model
``forward`` / ``prefill`` logits and caches, and greedy ``generate``
tokens; then the launcher's command line on the CPU.

Tolerance: 1e-4, as tests/test_torch_model.py, for f32 products summed
in another order through 4 layers. The prefill caches are compared at
``cache_dtype=float32`` so that no bf16 rounding boundary amplifies
that difference; ``generate`` runs the default bf16 caches in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantizer import \
    quantize_params_for_serving as jax_quantize_params
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro_torch.core.quantizer import quantize_params_for_serving
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import transformer as TT
from tests._torch_parity import lm_configs, lm_weights, to_numpy, to_torch

TOL = 1e-4
B, S, GEN = 2, 12, 6


@pytest.fixture(scope="module", params=[0, 8, 4], ids=["q0", "q8", "q4"])
def served(request):
    """Both packages' weight trees at ``--quant`` q, a prompt, and the
    reference's forward / prefill (f32 caches) / greedy generation."""
    quant = request.param
    jcfg, tcfg = lm_configs()
    tree = lm_weights(tcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = TT.params_from_numpy(tree, tcfg, device="cpu")
    if quant:
        jparams = jax_quantize_params(jparams, quant)
        tparams = quantize_params_for_serving(tparams, quant)
    prompt = np.random.default_rng(quant).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jlogits, _ = JT.forward(jparams, jcfg, jnp.asarray(prompt))
    jpre, jcaches, _ = JT.prefill(jparams, jcfg, jnp.asarray(prompt),
                                  max_len=S + GEN, cache_dtype=jnp.float32)
    jtoks = jserve.generate(jparams, jcfg, jnp.asarray(prompt),
                            max_len=S + GEN, gen=GEN)
    return dict(tcfg=tcfg, tparams=tparams, prompt=prompt,
                forward=np.asarray(jlogits), prefill=np.asarray(jpre),
                caches=jcaches, tokens=np.asarray(jtoks))


def test_forward_logits(served):
    logits, aux = TT.forward(served["tparams"], served["tcfg"],
                             to_torch(served["prompt"]))
    np.testing.assert_allclose(to_numpy(logits), served["forward"],
                               atol=TOL, rtol=TOL)
    assert all(float(v) == 0.0 for v in aux.values())


def test_prefill_logits_and_caches(served):
    logits, caches, _ = TT.prefill(served["tparams"], served["tcfg"],
                                   to_torch(served["prompt"]),
                                   max_len=S + GEN,
                                   cache_dtype=torch.float32)
    np.testing.assert_allclose(to_numpy(logits), served["prefill"],
                               atol=TOL, rtol=TOL)
    assert len(caches) == len(served["caches"])
    for got, want in zip(caches, served["caches"]):
        for name in ("k", "v"):
            assert tuple(got[name].shape) == want[name].shape
            np.testing.assert_allclose(to_numpy(got[name]),
                                       np.asarray(want[name]), atol=TOL,
                                       rtol=TOL)


def test_generate_greedy_tokens(served):
    toks = tserve.generate(served["tparams"], served["tcfg"],
                           to_torch(served["prompt"]), max_len=S + GEN,
                           gen=GEN)
    assert toks.dtype == torch.int32 and tuple(toks.shape) == (B, GEN)
    np.testing.assert_array_equal(to_numpy(toks), served["tokens"])


def test_decode_step_continues_prefill(served):
    """One serve step after the prefill is the forward's last logits
    over the prompt extended by that token (f32 caches)."""
    tcfg, tparams = served["tcfg"], served["tparams"]
    prompt = to_torch(served["prompt"])
    logits, caches, _ = TT.prefill(tparams, tcfg, prompt, max_len=S + 1,
                                   cache_dtype=torch.float32)
    tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
    step, _ = TT.decode_step(tparams, tcfg, tok, caches, S)
    full, _ = TT.forward(tparams, tcfg, torch.cat([prompt, tok], dim=1))
    np.testing.assert_allclose(to_numpy(step[:, 0]), to_numpy(full[:, -1]),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("quant,temperature", [(4, 0.0), (8, 0.7),
                                               (0, 0.0)])
def test_main_on_the_cpu(quant, temperature, capsys):
    assert tserve.main(["--reduced", "--device", "cpu", "--quant",
                        str(quant), "--batch", "2", "--prompt-len", "8",
                        "--gen", "4", "--temperature", str(temperature),
                        "--seed", "3"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 4) in" in out
    assert (f"serving with int{quant} block weights" in out) == bool(quant)


def test_prefill_step_rejects_embeds():
    """The prefill step, which once refused ``embeds``, now takes them
    (a frontend config's precomputed embeddings): its logits and caches
    are the reference's prefill step's on the same batch."""
    from repro.launch.steps import make_prefill_step as jax_prefill_step
    jcfg, tcfg = lm_configs()
    tree = lm_weights(tcfg)
    embeds = (tcfg.d_model ** -0.5 * np.random.default_rng(6).standard_normal(
        (B, S, tcfg.d_model))).astype(np.float32)
    want, wcaches = jax_prefill_step(jcfg, S + GEN)(
        jax.tree.map(jnp.asarray, tree), {"embeds": jnp.asarray(embeds)})
    got, caches = make_prefill_step(tcfg, S + GEN)(
        TT.params_from_numpy(tree, tcfg, device="cpu"),
        {"embeds": to_torch(embeds)})
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=TOL,
                               rtol=TOL)
    for g, w in zip(caches, wcaches):
        for name in ("k", "v"):       # bf16 caches: within one bf16 step
            np.testing.assert_allclose(to_numpy(g[name]),
                                       np.asarray(w[name], np.float32),
                                       atol=2.0 ** -8, rtol=2.0 ** -8)
