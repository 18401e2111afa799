"""The port's classifier request loop against the JAX package: the
paper's MNIST MLP and CIFAR CNN forwards, calibration energies, the
device/server split, the three baselines, the pricing-only fixtures and
the data surrogates, on the same NumPy weights and inputs; then a twin
of ``examples/quickstart.py`` on weights the reference trained.

Tolerances, stated per comparison: float32 forwards agree to 1e-4 of
the largest logit (another summation order; the CNN's convolutions run
as XLA's conv on one side and im2col on the other); calibration
energies to 5e-3 relative, as ``test_torch_serving.py`` allows
(squared differences of nearly equal logits amplify the logits'
agreement); a quantized cut activation to one code step (the prefix's
rounding can move a value across a rounding boundary); measured
accuracies to one example in N. Payloads, plans, bit-widths and
objective matrices are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.classifier import CIFAR_CNN as J_CIFAR
from repro.configs.classifier import MNIST_MLP as J_MNIST
from repro.core import cost_model as jcm
from repro.core.solver import PartitionPlan as JPlan
from repro.data import pipeline as jdata
from repro.models import classifier as JC
from repro.serving import baselines as jbase
from repro.serving import testing as jtesting
from repro.serving.backends import ClassifierBackend as JBackend
from repro.serving.pricing import price_window as j_price_window
from repro.serving.qpart_server import QPARTServer as JServer
from repro.serving.simulator import InferenceRequest as JRequest
from repro_torch.configs import CIFAR_CNN as T_CIFAR
from repro_torch.configs import MNIST_MLP as T_MNIST
from repro_torch.configs.cifar_cnn import CIFAR_CNN as T_CIFAR_ALIAS
from repro_torch.configs.mnist_mlp import MNIST_MLP as T_MNIST_ALIAS
from repro_torch.core import cost_model as tcm
from repro_torch.core.solver import PartitionPlan as TPlan
from repro_torch.data import pipeline as tdata
from repro_torch.models import classifier as TC
from repro_torch.serving import baselines as tbase
from repro_torch.serving import testing as ttesting
from repro_torch.serving.backends import ClassifierBackend as TBackend
from repro_torch.serving.pricing import price_window as t_price_window
from repro_torch.serving.qpart_server import QPARTServer as TServer
from repro_torch.serving.simulator import InferenceRequest as TRequest
from tests._torch_parity import to_numpy

CONFIGS = {"mnist": (J_MNIST, T_MNIST, (28, 28)),
           "cifar": (J_CIFAR, T_CIFAR, (32, 32, 3))}


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(to_numpy(got), want, rtol=0,
                               atol=rel * max(1.0, np.abs(want).max()))


def _weights(cfg, seed=0):
    """Seeded NumPy weights in the reference's layout (Dense (in, out),
    conv HWIO) at its init's scale (std = fan-in ** -0.5, the fan-in
    being the input channels), small nonzero biases."""
    rng = np.random.default_rng(seed)
    out = []
    for spec in cfg.layers:
        shape = (spec.in_dim, spec.out_dim) if hasattr(spec, "in_dim") \
            else (spec.f1, spec.f2, spec.c_in, spec.c_out)
        fan_in = shape[-2]
        out.append({"w": (rng.standard_normal(shape) / fan_in ** 0.5)
                    .astype(np.float32),
                    "b": (0.01 * rng.standard_normal(shape[-1]))
                    .astype(np.float32)})
    return out


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """Both packages' backends on one seeded reference weight list (HWIO
    conv weights carried across as OIHW), and 16 seeded images."""
    jcfg, tcfg, shape = CONFIGS[request.param]
    weights = _weights(jcfg)
    tparams = TC.params_from_numpy(weights, tcfg, device="cpu")
    x = np.random.default_rng(1).uniform(0, 1, (16,) + shape).astype(
        np.float32)
    return (JBackend(jcfg, jax.tree.map(jnp.asarray, weights)),
            TBackend(tcfg, tparams), x)


def test_configs_equal_the_reference():
    assert T_MNIST == T_MNIST_ALIAS and T_CIFAR == T_CIFAR_ALIAS
    for jcfg, tcfg, _ in CONFIGS.values():
        assert (tcfg.name, tcfg.input_shape, tcfg.num_classes) == \
            (jcfg.name, jcfg.input_shape, jcfg.num_classes)
        assert [vars(s) for s in tcfg.layers] == \
            [vars(s) for s in jcfg.layers]


def test_forward_family(pair):
    """Logits, every layer's input activation (NHWC at the conv layers,
    so the first Dense reads the reference's feature order), and the
    server-side resume from each layer: 1e-4 of the largest value."""
    jb, tb, x = pair
    _close(tb.forward(x), jb.forward(jnp.asarray(x)))
    jacts, jlogits = jb.layer_activations(jnp.asarray(x))
    tacts, tlogits = tb.layer_activations(x)
    assert [tuple(a.shape) for a in tacts] == [a.shape for a in jacts]
    for ta, ja in zip(tacts, jacts):
        _close(ta, ja)
    _close(tlogits, jlogits)
    for start in range(jb.num_layers):
        _close(tb.forward_from_layer(np.asarray(jacts[start]), start),
               jb.forward_from_layer(jacts[start], start))
    # a single unbatched image is batched, as the reference does
    _close(tb.forward(x[0]), jb.forward(jnp.asarray(x[0])))


def test_calibrate_probes(pair):
    """Alg. 1 energies of every layer: 5e-3 relative."""
    jb, tb, x = pair
    je_w, je_x, jl = jb.calibrate_probes(jnp.asarray(x))
    te_w, te_x, tl = tb.calibrate_probes(x)
    _close(tl, jl)
    np.testing.assert_allclose(te_w, je_w, rtol=5e-3)
    np.testing.assert_allclose(te_x, je_x, rtol=5e-3)


def test_split_and_device_segment(pair):
    """The quantized device segment: per-layer bits, bits_x and the exact
    wire payload equal the reference's; its weights equal the
    reference's fake-quantized ones (conv weights compared HWIO); the
    cut activation agrees to one code step."""
    jb, tb, x = pair
    L = jb.num_layers
    for p, bits in ((1, 7.3), (L, 4.0)):
        kw = dict(p=p, bits_w=np.linspace(bits, 3.0, p), bits_x=bits,
                  objective=0.0, psi_total=0.0, payload_bits=0.0,
                  breakdown={})
        jplan, tplan = JPlan(**kw), TPlan(**kw)
        jseg, tseg = jb.split(jplan), tb.split(tplan)
        np.testing.assert_array_equal(tseg.bits_w, jseg.bits_w)
        assert (tseg.bits_x, tseg.payload_bits) == \
            (jseg.bits_x, jseg.payload_bits)
        for jl, tl in zip(jseg.params, tseg.params):
            tw = to_numpy(tl["w"])
            if tw.ndim == 4:
                tw = tw.transpose(2, 3, 1, 0)           # OIHW -> HWIO
            np.testing.assert_array_equal(tw, np.asarray(jl["w"]))
            np.testing.assert_array_equal(to_numpy(tl["b"]),
                                          np.asarray(jl["b"]))
        jh = np.asarray(jb.run_device_segment(jseg, jplan, jnp.asarray(x)))
        th = to_numpy(tb.run_device_segment(tseg, tplan, x))
        step = (jh.max() - jh.min()) / (2 ** tseg.bits_x - 1)
        np.testing.assert_allclose(th, jh, rtol=0, atol=step * 1.001)


@pytest.fixture(scope="module")
def quickstart():
    """``examples/quickstart.py``'s training, run by the reference: the
    MNIST MLP on the synthetic surrogate, 400 SGD steps at lr 0.1, batch
    128; then its register → calibrate → build_store on both servers,
    the port's ModelState given the reference's calibration."""
    x_tr, y_tr, x_te, y_te = jdata.synthetic_mnist(n_train=8192, n_test=4096)
    params = JC.init_classifier(jax.random.key(0), J_MNIST)

    def loss_fn(p, x, y):
        lg = JC.classifier_forward(p, J_MNIST, x)
        return -jnp.mean(jax.nn.log_softmax(lg)[jnp.arange(len(y)), y])

    @jax.jit
    def step(p, x, y):
        _, g = jax.value_and_grad(loss_fn)(p, x, y)
        return jax.tree.map(lambda a, b: a - 0.1 * b, p, g)

    it = jdata.minibatches(x_tr, y_tr, 128)
    for _ in range(400):
        params = step(params, *next(it))
    jb = JBackend(J_MNIST, params)
    tb = TBackend(T_MNIST, TC.params_from_numpy(
        jax.tree.map(np.asarray, params), T_MNIST, device="cpu"))
    calib = (x_te[2048:3072], y_te[2048:3072])
    jsrv, tsrv = JServer(), TServer()
    jsrv.register("mnist", jb, *calib)
    tsrv.register("mnist", tb, *calib)
    jsrv.calibrate("mnist")
    jm, tm = jsrv.models["mnist"], tsrv.models["mnist"]
    for f in ("s_w", "s_x", "rho", "delta_table", "base_accuracy"):
        setattr(tm, f, getattr(jm, f))
    ctx = (jcm.DeviceProfile(), jcm.Channel(capacity_bps=2e6),
           jcm.ObjectiveWeights())
    tctx = (tcm.DeviceProfile(), tcm.Channel(capacity_bps=2e6),
            tcm.ObjectiveWeights())
    jsrv.build_store("mnist", *ctx)
    tsrv.build_store("mnist", *tctx)
    return dict(jsrv=jsrv, tsrv=tsrv, ctx=ctx, tctx=tctx, calib=calib,
                test=(x_te[:2048], y_te[:2048]))


def test_quickstart_twin(quickstart):
    """The served plans of the quickstart's request at every budget: the
    same p, per-layer bits and bits_x (the budget-0.01 plan cuts the
    trained model with bits <= 8), objective matrices of the window
    exactly equal, and the executed accuracy within one test example."""
    q = quickstart
    jsrv, tsrv = q["jsrv"], q["tsrv"]
    jreqs = [JRequest("mnist", a, *q["ctx"], segment_cached=c)
             for a in (0.001, 0.005, 0.01, 0.02) for c in (True, False)]
    treqs = [TRequest("mnist", a, *q["tctx"], segment_cached=c)
             for a in (0.001, 0.005, 0.01, 0.02) for c in (True, False)]
    for jo, to in zip(j_price_window(jsrv.models, jsrv.server, jreqs).obj,
                      t_price_window(tsrv.models, tsrv.server, treqs).obj):
        assert np.array_equal(to, jo)
    for jr, tr in zip(jreqs, treqs):
        jd, td = jsrv.serve(jr), tsrv.serve(tr)
        assert td.plan.p == jd.plan.p
        np.testing.assert_array_equal(td.extra["bits_w"],
                                      np.asarray(jd.extra["bits_w"]))
        assert td.extra["bits_x"] == jd.extra["bits_x"]
        assert td.objective == jd.objective
    jd, td = jsrv.serve(jreqs[4]), tsrv.serve(treqs[4])     # 0.01, cached
    assert td.plan.p > 0 and max(td.extra["bits_w"]) <= 8
    x, y = q["test"]
    jres, tres = jd.execute(jnp.asarray(x), y), td.execute(x, y)
    assert abs(tres.accuracy - jres.accuracy) <= 1 / len(y)
    assert abs(tres.accuracy_degradation - jres.accuracy_degradation) \
        <= 2 / len(y)
    assert tres.accuracy_degradation <= 2 * 0.01 + 0.02


def test_baselines(quickstart):
    """No-optimization, autoencoder and pruning at the served cut: wire
    payloads and objectives exact; accuracies within one test example.
    The autoencoder is held by its reconstruction's accuracy, never by
    its encoder (eigenvector signs and order differ between backends)."""
    q = quickstart
    jb = q["jsrv"].models["mnist"].backend
    tb = q["tsrv"].models["mnist"].backend
    jctx, tctx = q["ctx"], q["tctx"]
    jsrv_p, tsrv_p = jcm.ServerProfile(), tcm.ServerProfile()
    (cx, cy), (x, y) = q["calib"], q["test"]
    base = q["jsrv"].models["mnist"].base_accuracy

    def same(jres, tres):
        assert tres.payload_bits == jres.payload_bits
        assert tres.objective == jres.objective
        assert tres.plan.p == jres.plan.p
        assert abs(tres.accuracy - jres.accuracy) <= 1 / len(y)

    for p in (0, 3):
        same(jbase.no_opt_offload(jb, p, jctx[0], jsrv_p, *jctx[1:],
                                  test_x=jnp.asarray(x), test_y=y,
                                  base_accuracy=base),
             tbase.no_opt_offload(tb, p, tctx[0], tsrv_p, *tctx[1:],
                                  test_x=x, test_y=y, base_accuracy=base))
    for p in (1, 6):
        jr = jbase.AutoencoderBaseline().offload(
            jb, p, jnp.asarray(cx), jctx[0], jsrv_p, *jctx[1:],
            test_x=jnp.asarray(x), test_y=y, base_accuracy=base)
        tr = tbase.AutoencoderBaseline().offload(
            tb, p, cx, tctx[0], tsrv_p, *tctx[1:], test_x=x, test_y=y,
            base_accuracy=base)
        same(jr, tr)
        assert tr.extra["code_dim"] == jr.extra["code_dim"]
    with pytest.raises(ValueError, match="on-device segment"):
        tbase.AutoencoderBaseline().offload(tb, 0, cx, tctx[0], tsrv_p,
                                            *tctx[1:])
    jprune = jbase.PruningBaseline().calibrated(jb, 2, jnp.asarray(cx), cy,
                                                0.01, base)
    tprune = tbase.PruningBaseline().calibrated(tb, 2, cx, cy, 0.01, base)
    assert tprune.retain == jprune.retain
    for p in (0, 2):
        same(jprune.offload(jb, p, jctx[0], jsrv_p, *jctx[1:],
                            test_x=jnp.asarray(x), test_y=y,
                            base_accuracy=base),
             tprune.offload(tb, p, tctx[0], tsrv_p, *tctx[1:], test_x=x,
                            test_y=y, base_accuracy=base))


def test_pricing_only_fixtures():
    """``stub_classifier_server`` builds the reference's stores plan for
    plan (params None: nothing executes), and ``poisson_trace`` draws
    the reference's requests."""
    jsrv = jtesting.stub_classifier_server([("mnist", J_MNIST),
                                            ("cifar", J_CIFAR)])
    tsrv = ttesting.stub_classifier_server([("mnist", T_MNIST),
                                            ("cifar", T_CIFAR)])
    for name in ("mnist", "cifar"):
        js, ts = jsrv.models[name].store(), tsrv.models[name].store()
        assert js.plans.keys() == ts.plans.keys()
        for key, jp in js.plans.items():
            tp = ts.plans[key]
            assert (tp.p, tp.bits_x, tp.objective) == \
                (jp.p, jp.bits_x, jp.objective)
            np.testing.assert_array_equal(tp.bits_w, jp.bits_w)
    kw = dict(n=40, rate=5.0, budgets=(0.01, 0.02), deadlines=(0.5, 2.0),
              batches=(1, 4), device_pool=7, seed=3)
    jt = jtesting.poisson_trace("mnist", devices=[jcm.DeviceProfile()],
                                channels=[jcm.Channel(capacity_bps=2e6)],
                                weights=jcm.ObjectiveWeights(), **kw)
    tt = ttesting.poisson_trace("mnist", devices=[tcm.DeviceProfile()],
                                channels=[tcm.Channel(capacity_bps=2e6)],
                                weights=tcm.ObjectiveWeights(), **kw)
    for jr, tr in zip(jt, tt):
        assert (tr.accuracy_budget, tr.batch, tr.arrival_time, tr.deadline,
                tr.device_id) == (jr.accuracy_budget, jr.batch,
                                  jr.arrival_time, jr.deadline, jr.device_id)


def test_data_surrogates():
    """The NumPy surrogates draw the reference's arrays; ``minibatches``
    hands out the reference's batches as tensors on the device asked
    for; the token stream is seeded and restartable."""
    for jarr, tarr in zip(jdata.synthetic_mnist(256, 64, seed=3),
                          tdata.synthetic_mnist(256, 64, seed=3)):
        np.testing.assert_array_equal(tarr, jarr)
    for jarr, tarr in zip(jdata.synthetic_images((8, 8, 3), 5, 64, 16),
                          tdata.synthetic_images((8, 8, 3), 5, 64, 16)):
        np.testing.assert_array_equal(tarr, jarr)
    x, y = tdata.synthetic_mnist(256, 8)[:2]
    jit, tit = jdata.minibatches(x, y, 32, seed=1), \
        tdata.minibatches(x, y, 32, seed=1, device="cpu")
    for _ in range(10):                 # across an epoch boundary
        (jx, jy), (tx, ty) = next(jit), next(tit)
        assert tx.device.type == "cpu"
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    cfg = tdata.TokenStreamConfig(vocab_size=50, seq_len=9, batch_size=3)
    a = next(tdata.TokenStream(cfg, device="cpu").batches(4))
    b = next(tdata.TokenStream(cfg, device="cpu").batches(4))
    assert a["tokens"].shape == (3, 8) and a["labels"].shape == (3, 8)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert int(a["tokens"].max()) < 50 and int(a["tokens"].min()) >= 0
