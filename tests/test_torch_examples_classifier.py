"""The port's three classifier examples (``torch_quickstart``,
``torch_adaptive_serving``, ``torch_workload_balancing``) against the
reference's steps, replayed here through the reference's library at a
reduced size: 2048 training images and 32 SGD steps, two epochs (the
examples' own defaults are 8192 and 400), the test and calibration
splits as the examples cut them. Longer runs part: from the same
weights every step's gradient agrees to 7e-7 relative through step 40,
but step 33 amplifies the 3e-7 difference the two trajectories carry
to 1e-3, and it grows from there. Both sides start from the
reference's ``init_classifier(jax.random.key(0))`` weights, carried
across with ``params_from_numpy``; each package calibrates on its own.

Tolerances: the trained weights within 1e-4 relative of the
reference's (f32 SGD through two frameworks' matmuls); the served plans
(p, rounded bits), the adaptive sweep's set of distinct plans and the
balancer's partition points exactly; the executed accuracy within one
test example; the balancer's latencies within 5e-3 relative and payload
bits within 1e-2: each package calibrates its own energies, which agree
to 5e-3 (as ``test_torch_classifier.py`` allows), and the activation's
payload is priced at the continuous bits_x the water-filling derives
from them (9e-3 apart at worst here). With the reference's calibration
copied in, the payloads are equal exactly."""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.classifier import MNIST_MLP as J_MNIST
from repro.core import cost_model as jcm
from repro.core.quantizer import round_bits
from repro.data import pipeline as jdata
from repro.models import classifier as JC
from repro.serving.backends import ClassifierBackend as JBackend
from repro.serving.qpart_server import QPARTServer as JServer
from repro.serving.scheduler import WorkloadBalancer as JBalancer
from repro.serving.scheduler import total_latency as j_total_latency
from repro.serving.simulator import InferenceRequest as JRequest
from repro_torch.configs.classifier import MNIST_MLP as T_MNIST
from repro_torch.models import classifier as TC
from repro_torch.serving.qpart_server import QPARTServer as TServer
from tests._torch_parity import load_example, to_numpy

N_TRAIN, STEPS = 2048, 32
W_RTOL = 1e-4
CAL_RTOL = 5e-3     # calibration energies, as test_torch_classifier.py
PAYLOAD_RTOL = 1e-2     # an activation's bits_x under CAL_RTOL energies


@pytest.fixture(scope="module")
def trained():
    """The reference's training loop at the reduced size -> (its initial
    and trained weights as NumPy, the test split)."""
    x_tr, y_tr, x_te, y_te = jdata.synthetic_mnist(n_train=N_TRAIN,
                                                   n_test=4096)
    init = JC.init_classifier(jax.random.key(0), J_MNIST)

    def loss_fn(p, x, y):
        lg = JC.classifier_forward(p, J_MNIST, x)
        return -jnp.mean(jax.nn.log_softmax(lg)[jnp.arange(len(y)), y])

    @jax.jit
    def step(p, x, y):
        _, g = jax.value_and_grad(loss_fn)(p, x, y)
        return jax.tree.map(lambda a, b: a - 0.1 * b, p, g)

    params = init
    it = jdata.minibatches(x_tr, y_tr, 128)
    for _ in range(STEPS):
        params = step(params, *next(it))
    as_np = lambda t: jax.tree.map(np.asarray, t)      # noqa: E731
    return as_np(init), as_np(params), (x_te, y_te)


def _carried(init):
    return TC.params_from_numpy(init, T_MNIST, device="cpu")


def _quiet(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


def _jserver(params, x_te, y_te, server=None):
    srv = JServer(server)
    srv.register("mnist", JBackend(J_MNIST, jax.tree.map(jnp.asarray,
                                                         params)),
                 x_te[2048:3072], y_te[2048:3072])
    srv.calibrate("mnist")
    return srv


def _bits(plan):
    return tuple(int(b) for b in np.asarray(round_bits(plan.bits_w))) \
        if plan.p else ()


def test_quickstart(trained):
    init, want, (x_te, y_te) = trained
    qs = load_example("torch_quickstart")
    (params, (tx, ty), acc), text = _quiet(
        qs.train_stage, _carried(init), n_train=N_TRAIN, steps=STEPS,
        device="cpu")
    assert text.startswith("1) train the paper's MNIST MLP")
    np.testing.assert_array_equal(tx, x_te)
    for g, w in zip(params, want):
        for k in ("w", "b"):
            np.testing.assert_allclose(to_numpy(g[k]), w[k], rtol=W_RTOL,
                                       atol=W_RTOL * np.abs(w[k]).max())
    out, text = _quiet(qs.serve_stage, params, x_te, y_te)
    assert "partition point p =" in text and "measured accuracy" in text

    # the reference's steps 2-3
    srv = _jserver(want, x_te, y_te)
    dev, ch, w = jcm.DeviceProfile(), jcm.Channel(capacity_bps=2e6), \
        jcm.ObjectiveWeights()
    srv.build_store("mnist", dev, ch, w)
    dep = srv.serve(JRequest("mnist", accuracy_budget=0.01, device=dev,
                             channel=ch, weights=w, segment_cached=True))
    res = dep.execute(jnp.asarray(x_te[:2048]), y_te[:2048])
    tdep, tres = out["dep"], out["result"]
    assert tdep.plan.p == dep.plan.p
    assert _bits(tdep.plan) == _bits(dep.plan)
    assert int(np.ceil(tdep.plan.bits_x)) == int(np.ceil(dep.plan.bits_x))
    # the payloads' continuous bits follow the calibration energies
    np.testing.assert_allclose(
        [tdep.plan.payload_w_bits, tdep.payload_bits, tres.payload_bits],
        [dep.plan.payload_w_bits, dep.payload_bits, res.payload_bits],
        rtol=PAYLOAD_RTOL)
    assert abs(tres.accuracy - res.accuracy) <= 1 / 2048
    ref_acc = float(jnp.mean(jnp.argmax(JC.classifier_forward(
        jax.tree.map(jnp.asarray, want), J_MNIST, jnp.asarray(x_te[:2048])),
        -1) == y_te[:2048]))
    assert abs(acc - ref_acc) <= 1 / 2048


def test_adaptive_serving(trained, monkeypatch):
    """The 32 scenarios' plans; then again with the reference's
    calibration copied into the port's server, where every payload is
    the reference's exactly (so the calibration is all that moves it)."""
    init, want, (x_te, y_te) = trained
    ex = load_example("torch_adaptive_serving")
    mlp = load_example("torch_mnist_mlp")
    params, _ = mlp.train(_carried(init), n_train=N_TRAIN, steps=STEPS,
                          device="cpu")
    out, text = _quiet(ex.sweep, params, x_te, y_te)
    assert "distinct plans chosen" in text

    srv = _jserver(want, x_te, y_te)
    base_dev, base_ch, w = jcm.DeviceProfile(), jcm.Channel(), \
        jcm.ObjectiveWeights()
    srv.build_store("mnist", base_dev, base_ch, w)
    plans = []
    for cap, f_clk, budget, cached in ex.scenarios():
        dev = dataclasses.replace(base_dev, f_clock=f_clk)
        ch = dataclasses.replace(base_ch, capacity_bps=cap)
        res = srv.serve(JRequest("mnist", budget, dev, ch, w,
                                 segment_cached=cached))
        plans.append((res.plan.p, _bits(res.plan), res.payload_bits))
    assert len(ex.scenarios()) == 32
    assert [p[:2] for p in out["plans"]] == [p[:2] for p in plans]
    np.testing.assert_allclose([p[2] for p in out["plans"]],
                               [p[2] for p in plans], rtol=PAYLOAD_RTOL)
    assert out["distinct"] == {p[:2] for p in plans}

    ref = srv.models["mnist"]
    calibrate = TServer.calibrate

    def calibrate_as_the_reference(self, name, *args, **kwargs):
        calibrate(self, name, *args, **kwargs)
        for f in ("s_w", "s_x", "rho", "delta_table", "base_accuracy"):
            setattr(self.models[name], f, getattr(ref, f))

    monkeypatch.setattr(TServer, "calibrate", calibrate_as_the_reference)
    out, _ = _quiet(ex.sweep, params, x_te, y_te)
    assert [p[:3] for p in out["plans"]] == plans


def test_workload_balancing(trained):
    init, want, (x_te, y_te) = trained
    ex = load_example("torch_workload_balancing")
    mlp = load_example("torch_mnist_mlp")
    params, _ = mlp.train(_carried(init), n_train=N_TRAIN, steps=STEPS,
                          device="cpu")
    out, text = _quiet(ex.balance, params, x_te, y_te)
    assert "heterogeneous window of 12" in text

    shared = jcm.ServerProfile(f_clock=1e9)
    srv = _jserver(want, x_te, y_te, shared)
    dev, ch, w = jcm.DeviceProfile(), jcm.Channel(capacity_bps=2e6), \
        jcm.ObjectiveWeights()
    srv.build_store("mnist", dev, ch, w)
    reqs = [JRequest("mnist", 0.01, dev, ch, w, segment_cached=True)
            for _ in range(48)]
    results = JBalancer(shared, policy="fcfs").schedule(srv, reqs)
    assert out["ps"] == [r.result.plan.p for r in results]
    np.testing.assert_allclose(out["queue_delays"],
                               [r.queue_delay for r in results], rtol=CAL_RTOL)
    strong = dataclasses.replace(dev, f_clock=2e9)
    mixed = [JRequest("mnist", 0.01, strong if i % 2 else dev, ch, w,
                      segment_cached=True) for i in range(12)]
    for policy, key in (("fcfs", "fcfs_s"), ("balanced", "balanced_s")):
        t = j_total_latency(JBalancer(shared, policy=policy).schedule(srv,
                                                                      mixed))
        np.testing.assert_allclose(out[key], t, rtol=CAL_RTOL)
