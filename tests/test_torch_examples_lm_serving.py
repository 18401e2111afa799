"""The port's ``torch_quantized_lm_serving`` example against the
reference's steps, replayed here through the reference's library at a
reduced size: 40 SGD steps (the example's own 300), 32 calibration and
32 test sequences (its 128), from the reference's
``init_params(jax.random.key(0))`` weights carried across with
``params_from_numpy``, both packages drawing the example's NumPy task
from ``default_rng(0)``. Each package calibrates on its own.

Held: the final training loss within 1e-4 relative (f32 SGD through two
frameworks' matmuls); the served plan's p and rounded bits exactly;
``execute``'s accuracy within one test example; the greedy tokens of
both ``generate``s (f32 and fake-quantized) and of
``Deployment.generate`` exactly; the ledger's sample count."""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.cost_model import Channel, DeviceProfile, ObjectiveWeights
from repro.core.quantizer import round_bits
from repro.launch.serve import generate
from repro.models import transformer as JT
from repro.serving.backends import TransformerBackend
from repro.serving.qpart_server import QPARTServer
from repro.serving.simulator import InferenceRequest
from repro_torch.models import transformer as TT
from tests._torch_parity import load_example, lm_configs

STEPS, CALIB, TEST = 40, 32, 32
LOSS_RTOL = 1e-4


def _reference(jcfg, params, ex):
    """The reference example's steps at the reduced size."""
    rng = np.random.default_rng(0)
    seq = ex.SEQ

    def batch(n):
        start = rng.integers(0, jcfg.vocab_size, size=(n, 1))
        toks = (start + np.arange(seq + 1)[None, :]) % jcfg.vocab_size
        return (jnp.asarray(toks[:, :seq], jnp.int32),
                jnp.asarray(toks[:, seq], jnp.int32))

    def loss_fn(p, toks):
        logits, _ = JT.forward(p, jcfg, toks[:, :-1])
        lp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(lp, toks[:, 1:][..., None], -1))

    @jax.jit
    def step(p, toks):
        loss, g = jax.value_and_grad(loss_fn)(p, toks)
        return jax.tree.map(lambda a, b: a - 0.3 * b, p, g), loss

    for _ in range(STEPS):
        start = rng.integers(0, jcfg.vocab_size, size=(32, 1))
        params, loss = step(params, jnp.asarray(
            (start + np.arange(seq + 1)[None, :]) % jcfg.vocab_size,
            jnp.int32))
    backend = TransformerBackend(jcfg, params, seq_len=seq,
                                 decode_max_len=64)
    srv = QPARTServer()
    srv.register("smollm", backend, *batch(CALIB))
    srv.calibrate("smollm")
    dev, ch, w = DeviceProfile(), Channel(capacity_bps=2e6), \
        ObjectiveWeights(eta=1e7)
    srv.build_store("smollm", dev, ch, w)
    dep = srv.serve(InferenceRequest("smollm", 0.01, dev, ch, w,
                                     segment_cached=True))
    bits = np.asarray(round_bits(dep.plan.bits_w)) if dep.plan.p else []
    res = dep.execute(*batch(TEST))
    lm = load_example("quantized_lm_serving")
    qparams = lm.quantize_blocks(params, bits, jcfg.num_layers)
    prompt = batch(2)[0][:, :16]
    out_f32 = generate(params, jcfg, prompt, max_len=32, gen=16)
    out_q = generate(qparams, jcfg, prompt, max_len=32, gen=16)
    out = dep.generate(prompt, 16)
    srv.record_decode(dep)
    return {"loss": float(loss), "p": dep.plan.p,
            "bits": [int(b) for b in bits], "result": res,
            "f32": np.asarray(out_f32), "q": np.asarray(out_q),
            "stream": out.tokens, "samples": len(srv.ledger.samples)}


@pytest.fixture(scope="module")
def both():
    jcfg, tcfg = lm_configs()
    ex = load_example("torch_quantized_lm_serving")
    assert ex.config() == tcfg
    init = JT.init_params(jax.random.key(0), jcfg)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, init), tcfg,
                                   device="cpu")
    rng = np.random.default_rng(0)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tparams, loss = ex.train(tparams, tcfg, rng, steps=STEPS)
        got = ex.serve(tparams, tcfg, rng, calib=CALIB, test=TEST)
    return dict(got, loss=loss, text=buf.getvalue()), \
        _reference(jcfg, init, ex)


def test_prints_the_references_steps(both):
    got, _ = both
    steps = [line.split(")")[0] for line in got["text"].splitlines()
             if line[:2] in ("1)", "2)", "3)", "4)", "5)")]
    assert steps == ["1", "2", "3", "4", "5"]
    assert "ledger now holds 1 measured sample(s)" in got["text"]


def test_training_and_plan(both):
    got, want = both
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert got["dep"].plan.p == want["p"] > 0
    assert got["bits"] == want["bits"]
    assert abs(got["result"].accuracy - want["result"].accuracy) <= 1 / TEST


def test_token_streams(both):
    got, want = both
    np.testing.assert_array_equal(got["f32_tokens"], want["f32"])
    np.testing.assert_array_equal(got["quantized_tokens"], want["q"])
    np.testing.assert_array_equal(got["stream"].tokens, want["stream"])
    assert want["samples"] == len(got["srv"].ledger.samples) == 1
