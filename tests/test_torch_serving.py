"""The port's LM serving slice against the JAX package on the same
weights and data: quantized wire structs bit for bit, calibration
energies, the offline store / window pricing / served plans exactly
(with the reference's calibration copied in), and greedy tokens from
the partitioned decode pipeline exactly, through the quantized-kernel
device segment at 8 and 4 bits."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro.core.solver import PartitionPlan as JPlan
from repro.serving.backends import TransformerBackend as JBackend
from repro.serving.decode import DecodeSession as JSession
from repro.serving.decode import tree_cache_bytes as j_tree_cache_bytes
from repro.serving.pricing import price_window as j_price_window
from repro.serving.qpart_server import QPARTServer as JServer
from repro.serving.simulator import InferenceRequest as JRequest
from repro_torch.core import cost_model as tcm
from repro_torch.core.noise import backend_layer_energies
from repro_torch.core.solver import PartitionPlan as TPlan
from repro_torch.models import transformer as TT
from repro_torch.serving.backends import TransformerBackend as TBackend
from repro_torch.serving.decode import DecodeSession as TSession
from repro_torch.serving.decode import tree_cache_bytes
from repro_torch.serving.engine import FleetEngine as TFleetEngine
from repro_torch.serving.errors import ServingError
from repro_torch.serving.pricing import price_window as t_price_window
from repro_torch.serving.qpart_server import QPARTServer as TServer
from repro_torch.serving.simulator import InferenceRequest as TRequest
from tests._torch_parity import lm_configs, lm_weights, to_numpy

SEQ, MAX_LEN, N_CAL = 16, 32, 8


@pytest.fixture(scope="module")
def pair():
    """Both packages' backends on one seeded weight tree + calibration
    tokens (next-token labels from a cycling sequence)."""
    jcfg, tcfg = lm_configs()
    tree = lm_weights(tcfg)
    rng = np.random.default_rng(0)
    start = rng.integers(0, jcfg.vocab_size, (N_CAL, 1))
    seq = (start + np.arange(SEQ + 1)[None]) % jcfg.vocab_size
    x, y = seq[:, :SEQ].astype(np.int32), seq[:, SEQ].astype(np.int32)
    jb = JBackend(jcfg, jax.tree.map(jnp.asarray, tree), seq_len=SEQ,
                  decode_max_len=MAX_LEN)
    tb = TBackend(tcfg, TT.params_from_numpy(tree, tcfg, device="cpu"),
                  seq_len=SEQ, decode_max_len=MAX_LEN)
    return jb, tb, x, y


def _plans(p, bits):
    kw = dict(p=p, bits_w=np.asarray(bits, np.float64)[:p],
              bits_x=float(bits[0]) if p else 16.0, objective=0.0,
              psi_total=0.0, payload_bits=0.0, breakdown={})
    return JPlan(**kw), TPlan(**kw)


def test_calibration_energies(pair):
    """Alg. 1 probe energies: the port resumes each weight probe from
    the clean activation, the reference runs a masked full forward. The
    energies are squared differences of nearly equal logits (an 8-bit
    probe moves them by ~5e-3), so the 1e-4 f32 agreement of the logits
    themselves becomes ~1e-3 relative in the energies: 5e-3 allowed."""
    jb, tb, x, _ = pair
    je_w, je_x, jl = jb.calibrate_probes(jnp.asarray(x))
    te_w, te_x, tl = tb.calibrate_probes(x)
    np.testing.assert_allclose(to_numpy(tl), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(te_w, je_w, rtol=5e-3)
    np.testing.assert_allclose(te_x, je_x, rtol=5e-3)
    # the probe shortcut (resume from the clean activation) is bit for
    # bit the port's own scalar loop of full perturbed forwards
    se_w, se_x, _ = backend_layer_energies(tb, x)
    assert np.array_equal(te_w, se_w) and np.array_equal(te_x, se_x)


def test_calibration_probe_chunk(pair):
    """``chunk`` (the reference's layers per probe step) is accepted and
    does not change the energies: chunk=1 and chunk=3 give the same bits,
    both within the reference's 5e-3 (its own test holds its two chunk
    sizes to 1e-5 of each other)."""
    jb, tb, x, _ = pair
    je_w, je_x, _ = jb.calibrate_probes(jnp.asarray(x))
    e1_w, e1_x, l1 = tb.calibrate_probes(x, chunk=1)
    e3_w, e3_x, l3 = tb.calibrate_probes(x, chunk=3)
    assert np.array_equal(e1_w, e3_w) and np.array_equal(e1_x, e3_x)
    assert torch.equal(l1, l3)
    for e_w, e_x in ((e1_w, e1_x), (e3_w, e3_x)):
        np.testing.assert_allclose(e_w, je_w, rtol=5e-3)
        np.testing.assert_allclose(e_x, je_x, rtol=5e-3)


@pytest.fixture(scope="module")
def servers(pair):
    """Both servers registered and calibrated; the port's ModelState gets
    the reference's calibration so the planner sees identical inputs."""
    jb, tb, x, y = pair
    jsrv, tsrv = JServer(), TServer()
    jsrv.register("lm", jb, x, y)
    tsrv.register("lm", tb, x, y)
    jsrv.calibrate("lm")
    jm, tm = jsrv.models["lm"], tsrv.models["lm"]
    for f in ("s_w", "s_x", "rho", "delta_table", "base_accuracy"):
        setattr(tm, f, getattr(jm, f))
    return jsrv, tsrv


CONTEXTS = [dict(eta=1e7, capacity=2e6), dict(eta=0.0, capacity=2e6),
            dict(eta=1e7, capacity=2e8)]


def _context(cm, c):
    return (cm.DeviceProfile(), cm.Channel(capacity_bps=c["capacity"]),
            cm.ObjectiveWeights(eta=c["eta"]))


def test_store_pricing_and_serve_exact(servers):
    """Offline stores (every plan of every level and cut), window
    objective matrices and served plans (p, bits) are identical."""
    jsrv, tsrv = servers
    jreqs, treqs = [], []
    for c in CONTEXTS:
        jctx = jsrv.build_store("lm", *_context(jcm, c))
        tctx = tsrv.build_store("lm", *_context(tcm, c))
        js = jsrv.models["lm"].stores[jctx]
        ts = tsrv.models["lm"].stores[tctx]
        assert js.plans.keys() == ts.plans.keys()
        for key, jp in js.plans.items():
            tp = ts.plans[key]
            assert (tp.p, tp.bits_x, tp.objective, tp.payload_bits) == \
                (jp.p, jp.bits_x, jp.objective, jp.payload_bits)
            np.testing.assert_array_equal(tp.bits_w, jp.bits_w)
        for a in (0.001, 0.01, 0.02):
            for cached in (False, True):
                jreqs.append(JRequest("lm", a, *_context(jcm, c),
                                      segment_cached=cached))
                treqs.append(TRequest("lm", a, *_context(tcm, c),
                                      segment_cached=cached))
    jtab = j_price_window(jsrv.models, jsrv.server, jreqs)
    ttab = t_price_window(tsrv.models, tsrv.server, treqs)
    for jo, to in zip(jtab.obj, ttab.obj):
        assert np.array_equal(to, jo)
    for jr, tr in zip(jreqs, treqs):
        jd, td = jsrv.serve(jr), tsrv.serve(tr)
        assert td.plan.p == jd.plan.p
        np.testing.assert_array_equal(td.extra["bits_w"],
                                      np.asarray(jd.extra["bits_w"]))
    for jd, td in zip(jsrv.serve_batch(jreqs), tsrv.serve_batch(treqs)):
        assert td.plan.p == jd.plan.p and td.objective == jd.objective


def _assert_trees_equal(jtree, ttree):
    flat_j, _ = jax.tree_util.tree_flatten_with_path(jtree)
    flat_t = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(to_numpy, ttree))[0])
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_t[path], np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("bits", [8, 4])
def test_greedy_tokens_quantized_kernel_segment(pair, bits, monkeypatch):
    """The device segment on quantized wire structs (qkernels) at p in
    {0, 1, L}: the structs themselves (codes, packed nibbles, scale, mu,
    and the fake-quantized dense leaves) of every device layer bit for
    bit those of the reference's stacked tree at that layer's period
    (the port carries the device layers' trees alone, with no filler
    periods past the cut), and the greedy tokens of the partitioned
    pipeline exactly. The device caches are float8 (bits_x <= 8), so the
    storage cast is on this path too."""
    monkeypatch.setenv("REPRO_KERNELS", "reference")
    jb, tb, x, _ = pair
    prompt = x[:2, :12]
    L = jb.num_layers
    for p in (0, 1, L):
        jplan, tplan = _plans(p, [bits] * L)
        js = JSession(jb, jplan, max_len=MAX_LEN, qkernels=True)
        ts = TSession(tb, tplan, max_len=MAX_LEN, qkernels=True)
        if p:
            layers = ts.dev_params["segment_blocks"]
            assert len(layers) == p
            plen = TT.period_len(tb.cfg)
            for layer, tree in enumerate(layers):
                per, pos = divmod(layer, plen)
                _assert_trees_equal(jax.tree.map(
                    lambda t, per=per: t[per], js.dev_params["blocks"][pos]),
                    tree)
            packed = "codes_packed" in layers[0]["attn"]["wq"]
            assert packed == (bits <= 4)
        jr, tr = js.generate(prompt, 6), ts.generate(prompt, 6)
        np.testing.assert_array_equal(tr.tokens, jr.tokens)
        assert tr.device_cache_dtype == jr.device_cache_dtype
        assert tr.device_cache_bytes == jr.device_cache_bytes
        assert tr.server_cache_bytes == jr.server_cache_bytes
        if p:
            assert tree_cache_bytes(ts.dev_caches) == \
                j_tree_cache_bytes(js.dev_caches)


def test_deployment_execute_and_generate(servers, pair, monkeypatch):
    """The served deployment end to end: ``execute`` measures accuracy
    against the full-precision model, and ``generate`` (dense
    fake-quantized device weights, the CPU default) streams the tokens
    the reference's quantized-kernel session gives on the same plan."""
    monkeypatch.setenv("REPRO_KERNELS", "reference")
    jsrv, tsrv = servers
    jb, tb, x, y = pair
    c = CONTEXTS[0]
    jsrv.build_store("lm", *_context(jcm, c))
    tsrv.build_store("lm", *_context(tcm, c))
    jd = jsrv.serve(JRequest("lm", 0.01, *_context(jcm, c),
                             segment_cached=True))
    td = tsrv.serve(TRequest("lm", 0.01, *_context(tcm, c),
                             segment_cached=True))
    assert td.plan.p == jd.plan.p > 0
    res = td.execute(x, y)
    assert res.accuracy + res.accuracy_degradation == \
        tb.evaluate(x, y) == tsrv.models["lm"].base_accuracy
    streamed = []
    tout = td.generate(x[:2, :12], 6,
                       stream_cb=lambda i, t: streamed.append(i))
    jout = JSession(jb, jd.plan, max_len=MAX_LEN, qkernels=True).generate(
        x[:2, :12], 6)
    np.testing.assert_array_equal(tout.tokens, jout.tokens)
    assert streamed == list(range(6))
    tsrv.record_execution(td)
    tsrv.record_decode(td)
    assert len(tsrv.ledger.samples) == 2


def test_deployment_queue_delay(servers):
    """``Deployment.queue_delay`` is 0.0 on the queue-less ``serve`` path,
    as the reference's, and reads ``extra["queue_delay"]`` once the
    fleet engine sets it."""
    jsrv, tsrv = servers
    c = CONTEXTS[1]
    jsrv.build_store("lm", *_context(jcm, c))
    tsrv.build_store("lm", *_context(tcm, c))
    jd = jsrv.serve(JRequest("lm", 0.01, *_context(jcm, c)))
    td = tsrv.serve(TRequest("lm", 0.01, *_context(tcm, c)))
    assert td.queue_delay == jd.queue_delay == 0.0
    td.result.extra["queue_delay"] = 0.25
    assert td.queue_delay == 0.25


def test_unported_paths_raise(pair):
    """What still raises: chunked or speculative decode on a
    sliding-window config (the reference's ``ServingError``: the ring
    wraps). Plain windowed decode, chunked prefill and speculative
    decode run (``test_torch_decode_features``), and ``fleet()`` hands
    back the port's ``FleetEngine`` (``test_torch_fleet``)."""
    _, tb, _, _ = pair
    _, tplan = _plans(1, [8])
    windowed = dataclasses.replace(tb, cfg=dataclasses.replace(
        tb.cfg, sliding_window=8))
    with pytest.raises(ServingError, match="sliding-window"):
        TSession(windowed, tplan, max_len=MAX_LEN, draft_tokens=2)
    with pytest.raises(ServingError, match="sliding-window"):
        TSession(windowed, tplan, max_len=MAX_LEN, prefill_chunk_tokens=4)
    assert TSession(windowed, tplan, max_len=MAX_LEN).p == 1
    engine = TServer().fleet(policy="edf", slo="degrade")
    assert isinstance(engine, TFleetEngine)
    assert engine.policy.name == "edf" and engine.slo == "degrade"
    assert torch.is_tensor(tb.params["embed"])
