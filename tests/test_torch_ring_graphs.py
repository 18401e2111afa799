"""The last of the reference's backend programs as graphs, on the CPU
lane, through the ``FakeGraph`` stand-in for ``StageGraph`` (it re-runs
the stage on its static inputs and copies the result into the capture's
outputs; the graphs themselves run only on the card,
``tests/test_torch_cuda.py`` and ``chip_smoke.py``):

  * the ring prefill (the reference's ``prefill_seg``) of a reduced
    Mamba2-1.3B, a reduced jamba (an SSM and an attention block with
    MoE) and the 4-layer smollm-8m with a window of 8 under a 12-token
    prompt, as the ``prefill_device`` / ``prefill_server`` stage pair:
    at p = 0, L/2 and L three fresh sessions on one backend give the
    reference's fresh sessions' tokens, each captures exactly the stage
    keys whose second use it makes (the third captures nothing), a
    replayed prefill is bitwise its ``graphs=False`` twin (token,
    first-token logits, both caches by bit pattern), and a 2-token
    prompt (shorter than the conv ring) adds its own prefill pair; a
    paged ring session; nothing on the ring prefill reads a tensor's
    value on the host;
  * the classifier's programs (``forward``, ``("from_layer", start)``,
    ``acts``, ``("prefix", p)``, ``("probe_all", bits)``) on the paper's
    MNIST MLP: bitwise the eager port (``forward_graphs=False``) at every
    start and p, within ``tests/test_torch_classifier.py``'s tolerances
    of the reference, values handed back intact by later replays; the
    port of the reference's ``test_classifier_segment_cache_keyed_by_p``;
    calibration, executions and the baselines bitwise their eager twin's
    through shared graphs; the CPU default eager and ``forward_graphs=
    True`` refused there.

Tokens are compared as integers, caches by bit pattern, energies and
logits of the graphed and eager port with ``equal``.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.classifier import MNIST_MLP as J_MNIST
from repro.core.solver import PartitionPlan as JPlan
from repro.serving.backends import ClassifierBackend as JCBackend
from repro.serving.backends import TransformerBackend as JBackend
from repro.serving.decode import DecodeSession as JSession
from repro_torch.configs import MNIST_MLP as T_MNIST
from repro_torch.core import cost_model as tcm
from repro_torch.core import noise as TN
from repro_torch.core import quantizer as TQ
from repro_torch.core.solver import PartitionPlan as TPlan
from repro_torch.models import classifier as TC
from repro_torch.models import transformer as TT
from repro_torch.models.common import as_bits
from repro_torch.serving import baselines as tbase
from repro_torch.serving.backends import ClassifierBackend as TCBackend
from repro_torch.serving.backends import TransformerBackend as TBackend
from repro_torch.serving.backends import graphs as graphs_lib
from repro_torch.serving.decode import DecodeSession as TSession
from repro_torch.serving.decode import pipeline
from repro_torch.serving.errors import ServingError
from repro_torch.serving.qpart_server import QPARTServer as TServer
from tests._torch_parity import (FakeGraph, lm_configs, lm_weights,
                                 no_host_reads, stage_graphs, to_numpy,
                                 zoo_configs)

SEQ, SHORT, MAX_LEN, GEN, PAGE = 12, 2, 24, 4, 4
ARCHS = ("mamba2-1.3b", "jamba-v0.1-52b", "window")


def _kw(p, bits=8.0):
    return dict(p=p, bits_w=np.full(p, bits), bits_x=8.0 if p else 16.0,
                objective=0.0, psi_total=0.0, payload_bits=0.0, breakdown={})


def _configs(arch):
    """(jax cfg, torch cfg): a reduced zoo arch, or ``window``, the
    smollm-8m with ``sliding_window=8`` (the prompt wraps its ring)."""
    if arch != "window":
        return zoo_configs(arch)
    return tuple(dataclasses.replace(c, sliding_window=8)
                 for c in lm_configs())


@pytest.fixture(scope="module", params=ARCHS)
def ring(request):
    """The port's config and params, a seeded prompt, the cuts (0, L/2,
    L) and the reference's fresh sessions' tokens at each cut, for the
    prompt and its first ``SHORT`` tokens, and its paged session at
    L/2 (tokens and held pages)."""
    jcfg, tcfg = _configs(request.param)
    tree = lm_weights(tcfg)
    prompt = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, SEQ)).astype(np.int32)
    L = tcfg.num_layers
    cuts = (0, L // 2, L)
    jb = JBackend(jcfg, jax.tree.map(jnp.asarray, tree), seq_len=SEQ,
                  decode_max_len=MAX_LEN)

    def ref(p, x, **kw):
        return JSession(jb, JPlan(**_kw(p)), max_len=MAX_LEN,
                        segment=segs[p], qkernels=False, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_KERNELS", "reference")
        # one device segment a cut, as a deployment's sessions share it
        segs = {p: jb.split(JPlan(**_kw(p))) if p else None for p in cuts}
        want = {(p, s): ref(p, prompt[:, :s]).generate(prompt[:, :s],
                                                       GEN).tokens
                for p in cuts for s in (SEQ, SHORT)}
        js = ref(cuts[1], prompt, paged=True, page_tokens=PAGE)
        paged = (js.generate(prompt, GEN).tokens, js.paged_kv.held_pages)
    params = TT.params_from_numpy(tree, tcfg, device="cpu")
    return tcfg, params, prompt, cuts, want, paged


class SlotGraph(FakeGraph):
    """``FakeGraph`` whose capture leaves the capturing session's cache
    slots as the stage's eager run left them, as a real capture (which
    launches nothing) does: an SSM step's state update is no idempotent
    write, and running it once more would advance the recurrence
    twice."""

    def __init__(self, fn, inputs, pool=None):
        sess = getattr(fn, "__self__", None)
        slots = () if sess is None else (sess._dev_slot, sess._srv_slot)
        leaves = [t for slot in slots if slot is not None
                  for tree in slot.caches for t in tree.values()]
        kept = [t.clone() for t in leaves]
        super().__init__(fn, inputs, pool)
        for t, k in zip(leaves, kept):
            t.copy_(k)


@pytest.fixture
def fake(monkeypatch):
    monkeypatch.setattr(pipeline, "StageGraph", SlotGraph)
    monkeypatch.setattr(graphs_lib, "StageGraph", FakeGraph)
    FakeGraph.log.clear()


def _graphed(be, p, **kw):
    """A CPU session through ``_stage``'s graph path (the constructor
    refuses ``graphs=True`` off the card)."""
    sess = TSession(be, TPlan(**_kw(p)), max_len=MAX_LEN, **kw)
    sess.graphs = True
    return sess


def _events() -> list:
    out = [what for what, _ in FakeGraph.log]
    FakeGraph.log.clear()
    return out


def _captured(be) -> set:
    """(stage, rows) of each graph captured since the log was cleared."""
    names = {id(g): (k[0], k[2]) for k, g in stage_graphs(be).items()}
    out = {names[id(g)] for what, g in FakeGraph.log if what == "capture"}
    FakeGraph.log.clear()
    return out


def _second_uses(uses: collections.Counter, sess) -> set:
    """(stage, rows) of the stage keys whose second use ``sess``'s
    stream made (``uses``: the backend's uses before it, updated)."""
    out = {(k[0], k[2]) for k, n in sess.graph_keys.items()
           if uses[k] < 2 <= uses[k] + n}
    uses.update(sess.graph_keys)
    return out


def _caches_bitwise(a, b) -> bool:
    return all(torch.equal(as_bits(x[k]), as_bits(y[k]))
               for x, y in zip(a, b) for k in x)


@pytest.mark.parametrize("cut", range(3), ids=["p0", "half", "pL"])
def test_ring_session_series(ring, fake, cut):
    """Three fresh sessions on one backend at one prompt length, then
    three at a 2-token prompt: each the reference's fresh session token
    for token; each captures exactly the stage keys whose second use it
    makes, so the third of a length replays every stage and the 2-token
    prompt's first session captures no prefill; the prefill pair is used
    at p > 0 and its server stage alone at p = 0. A prefill replayed in
    a fourth session is bitwise its ``graphs=False`` twin's: the first
    token, the first token's logits and both caches."""
    cfg, params, prompt, cuts, want, _ = ring
    p = cuts[cut]
    be = TBackend(cfg, params, seq_len=SEQ, decode_max_len=MAX_LEN)
    seg = be.split(TPlan(**_kw(p))) if p else None
    uses = collections.Counter()
    for s in (SEQ, SHORT):
        x = prompt[:, :s]
        for i in range(3):
            before = be.capture_count
            sess = _graphed(be, p, segment=seg)
            got = sess.generate(x, GEN)
            np.testing.assert_array_equal(got.tokens, want[p, s],
                                          err_msg=f"{s} tokens, {i}")
            new = _second_uses(uses, sess)
            assert _captured(be) == new, (s, i)
            assert be.capture_count - before == len(new)
            stages = {k[0] for k in sess.graph_keys if k[2] == s}
            assert stages == ({"prefill_server"} if p == 0 else
                              {"prefill_device", "prefill_server"})
            if i == 0:
                assert not any(rows == s for _, rows in new), (s, new)
            if i == 1:
                assert {("prefill_server", s)} <= new, (s, new)
            if i == 2:
                assert not new, (s, new)
        sess = _graphed(be, p, segment=seg)
        twin = TSession(be, TPlan(**_kw(p)), max_len=MAX_LEN, segment=seg,
                        graphs=False)
        _events()
        token = sess.prefill(x)
        assert set(_events()) == {"replay"}
        assert torch.equal(token, twin.prefill(x))
        assert torch.equal(sess.last_logits, twin.last_logits)
        assert _caches_bitwise(sess.srv_caches, twin.srv_caches)
        if p:
            assert _caches_bitwise(sess.dev_caches, twin.dev_caches)
        sess.sever()
    keys = {k[:3] for k in stage_graphs(be)}
    assert {("prefill_server", p, s) for s in (SEQ, SHORT)} <= keys
    assert be.capture_count == len(stage_graphs(be))


def test_paged_ring_session(ring, fake):
    """A paged ring session at L/2: three sessions give the reference's
    paged tokens and held pages, the third replaying both prefill
    stages, the device ring's pages ingested between them, and the
    pages' dense view bitwise the device ring."""
    cfg, params, prompt, cuts, _, (tokens, held) = ring
    be = TBackend(cfg, params, seq_len=SEQ, decode_max_len=MAX_LEN)
    seg = be.split(TPlan(**_kw(cuts[1])))
    for i in range(3):
        _events()
        sess = _graphed(be, cuts[1], segment=seg, paged=True,
                        page_tokens=PAGE)
        np.testing.assert_array_equal(sess.generate(prompt, GEN).tokens,
                                      tokens, err_msg=str(i))
        assert sess.paged_kv.held_pages == held
        assert _caches_bitwise(sess.paged_kv.to_dense(sess.dev_caches),
                               sess.dev_caches)
    assert set(_events()) == {"replay"}
    assert {("prefill_device", SEQ), ("prefill_server", SEQ)} <= \
        {(k[0], k[2]) for k in stage_graphs(be)}


def test_ring_prefill_reads_nothing_on_host(ring, monkeypatch):
    """The ring prefill's stages at every cut, at the prompt and at 2
    tokens, read no tensor on the host: a capture could not hold such a
    read, which on the card would also wait for the device."""
    cfg, params, prompt, cuts, want, _ = ring
    be = TBackend(cfg, params, seq_len=SEQ, decode_max_len=MAX_LEN)
    mode = no_host_reads(monkeypatch)
    for p in cuts:
        for s in (SEQ, SHORT):
            sess = TSession(be, TPlan(**_kw(p)), max_len=MAX_LEN)
            with mode:
                token = sess.prefill(prompt[:, :s])
            np.testing.assert_array_equal(token.numpy(), want[p, s][:, 0])


# ---------------------------------------------------------------------------
# The classifier's programs

CLS_TOL = 1e-4       # f32 logits: 1e-4 of the largest (test_torch_classifier)
CLS_ETOL = 5e-3      # calibration energies, relative (test_torch_classifier)


def _close(got, want, rel=CLS_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(to_numpy(got), want, rtol=0,
                               atol=rel * max(1.0, np.abs(want).max()))


def _mlp_draws():
    """(weights, images): the MNIST MLP's seeded weights (the reference's
    init scale, small nonzero biases) and the next 16 uniform images
    from their generator."""
    rng = np.random.default_rng(0)
    weights = [{"w": (rng.standard_normal((s.in_dim, s.out_dim))
                      / s.in_dim ** 0.5).astype(np.float32),
                "b": (0.01 * rng.standard_normal(s.out_dim))
                .astype(np.float32)} for s in J_MNIST.layers]
    return weights, rng.uniform(0, 1, (16, 28, 28)).astype(np.float32)


@pytest.fixture(scope="module")
def mlp():
    """The MNIST MLP on the weights and 16 images of
    ``tests/test_torch_classifier.py``'s fixture, the port's eager
    backend, the reference's programs' outputs and the reference's
    backend. (The images that follow the weights in their generator put
    probe codes on a rounding boundary:
    ``test_classifier_probe_gap_is_boundary_codes``.)"""
    weights, _ = _mlp_draws()
    x = np.random.default_rng(1).uniform(0, 1, (16, 28, 28)).astype(
        np.float32)
    jb = JCBackend(J_MNIST, jax.tree.map(jnp.asarray, weights))
    jx = jnp.asarray(x)
    L = J_MNIST.num_layers
    acts, logits = jb.layer_activations(jx)
    ref = {"forward": np.asarray(jb.forward(jx)),
           "acts": [np.asarray(a) for a in acts] + [np.asarray(logits)],
           "from_layer": [np.asarray(jb.forward_from_layer(acts[l], l))
                          for l in range(L)],
           "prefix": [np.asarray(jb.run_prefix(jx, p)) if p else None
                      for p in range(L + 1)],
           "probes": tuple(np.asarray(a) for a in jb.calibrate_probes(jx))}
    eager = TCBackend(T_MNIST, TC.params_from_numpy(weights, T_MNIST,
                                                    device="cpu"),
                      forward_graphs=False)
    return eager, x, ref, jb


def _graphed_cls(eager):
    """A backend on ``eager``'s params with no graph yet, through the
    graphs on the CPU (the constructor refuses ``forward_graphs=True``
    off the card)."""
    be = TCBackend(eager.cfg, eager.params)
    be.forward_graphs = True
    return be


def _program_args(L) -> dict:
    """Program -> its arguments: every start, every p of a device
    segment (1..L), or None."""
    return {"forward": [None], "from_layer": list(range(L)),
            "acts": [None], "prefix": list(range(1, L + 1)),
            "probe_all": [None]}


def _call(be, program, arg, x, acts) -> list:
    """``program`` at ``arg`` on ``be`` over the images ``x`` (``acts``:
    the activations entering each layer of ``x``) -> its outputs."""
    if program == "forward":
        return [be.forward(x)]
    if program == "from_layer":
        return [be.forward_from_layer(acts[arg], arg)]
    if program == "acts":
        out, logits = be.layer_activations(x)
        return [*out, logits]
    if program == "prefix":
        return [be.run_prefix(x, arg)]
    return list(be.calibrate_probes(x))


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return torch.equal(a, b)


@pytest.mark.parametrize("program", ["forward", "from_layer", "acts",
                                     "prefix", "probe_all"])
def test_classifier_program_bitwise_eager(mlp, fake, program):
    """Each program three times at each argument (eager, capture,
    replay): the eager port's bits, the reference's values within the
    classifier tests' tolerances; one capture per argument, of that
    program; what a replay handed back survives the next replay on
    other images."""
    eager, x, ref, _ = mlp
    gb = _graphed_cls(eager)
    xr = x[::-1].copy()
    acts, _ = eager.layer_activations(x)
    acts_r, _ = eager.layer_activations(xr)
    args = _program_args(gb.num_layers)[program]
    for arg in args:
        want = _call(eager, program, arg, x, acts)
        for _ in range(3):
            got = _call(gb, program, arg, x, acts)
            assert len(got) == len(want)
            assert all(_equal(g, w) for g, w in zip(got, want)), arg
        if program == "probe_all":
            _close(got[2], ref["probes"][2])
            for g, r in zip(got[:2], ref["probes"][:2]):
                assert g.dtype == np.float64
                np.testing.assert_allclose(g, r, rtol=CLS_ETOL)
        elif program == "acts":
            for g, r in zip(got, ref["acts"]):
                _close(g, r)
        else:
            _close(got[0], ref[program] if arg is None else
                   ref[program][arg])
        kept = [g.copy() if isinstance(g, np.ndarray) else g.clone()
                for g in got]
        other = _call(gb, program, arg, xr, acts_r)
        assert all(_equal(o, w) for o, w in
                   zip(other, _call(eager, program, arg, xr, acts_r)))
        assert all(_equal(g, k) for g, k in zip(got, kept)), arg
    names = {k[0] for k in stage_graphs(gb)}
    assert gb.capture_count == len(names) == len(args)
    assert all(n == program or n[0] == program for n in names)
    assert eager.capture_count == 0


def test_classifier_probe_gap_is_boundary_codes(mlp):
    """On the images that follow the weights in their generator, the
    port's f32 activation-probe energies part from the reference's by
    percents at some thread counts (at 1 torch thread ``e_x[1]`` by
    2.85%, at 8 by 4.5e-5), beyond ``test_torch_classifier``'s 5e-3.
    The cause is a probe code on a rounding boundary: a float64 witness
    of the port's own probes is the reference's to 5e-3; every 8-bit
    code where the port's f32 activation parts from the witness's lies
    within 1e-4 of a half step, so the matmul's summation order (which
    the thread count sets) picks its side; and with the witness's codes
    at those places the port's f32 probes are the reference's to 5e-3
    at every layer, as the port's own energies are wherever no code
    parts."""
    eager, _, _, jb = mlp
    _, x = _mlp_draws()
    je_w, je_x, _ = (np.asarray(a) for a in jb.calibrate_probes(
        jnp.asarray(x)))
    te_w, te_x, _ = eager.calibrate_probes(x)
    wb = TCBackend(eager.cfg, [{k: v.double() for k, v in lp.items()}
                               for lp in eager.params],
                   forward_graphs=False)
    x64 = torch.as_tensor(x, dtype=torch.float64)
    we_w, we_x, _ = wb.calibrate_probes(x64)
    for got in (we_w, te_w):
        np.testing.assert_allclose(got, je_w, rtol=CLS_ETOL)
    np.testing.assert_allclose(we_x, je_x, rtol=CLS_ETOL)
    acts, clean = eager.layer_activations(x)
    acts64, _ = wb.layer_activations(x64)
    bits = TN.PROBE_BITS
    for l in range(eager.num_layers):
        codes, scale, mu = TQ.quantize(acts[l], bits)
        codes64, scale64, mu64 = TQ.quantize(acts64[l], bits)
        parts = codes != codes64
        steps = ((acts64[l] - mu64) / scale64)[parts]
        assert torch.all((steps - steps.floor() - 0.5).abs() < 1e-4), l
        if not parts.any():
            np.testing.assert_allclose(te_x[l], je_x[l], rtol=CLS_ETOL)
        witness = TQ.dequantize(torch.where(parts, codes64, codes), scale,
                                mu, acts[l].dtype)
        d = eager.forward_from_layer(witness, l) - clean
        np.testing.assert_allclose(float(torch.sum(torch.square(d))),
                                   je_x[l], rtol=CLS_ETOL)


def test_classifier_segment_cache_keyed_by_p(mlp, fake):
    """The reference's ``TestCompileOnce.test_classifier_segment_cache_
    keyed_by_p`` on the port: after one ``forward``, three executions at
    p = 3 add exactly the captures of the ``("prefix", 3)`` and
    ``("from_layer", 3)`` keys (their second uses), each a new device
    segment of the same signature, and a fourth adds none."""
    eager, x, _, _ = mlp
    gb = _graphed_cls(eager)
    plan = TPlan(**_kw(3))
    gb.forward(x)
    n0 = gb.capture_count
    for _ in range(3):
        assert torch.equal(gb.execute_plan(plan, x),
                           eager.execute_plan(plan, x))
    n1 = gb.capture_count
    assert n1 - n0 == 2
    assert {k[0] for k in stage_graphs(gb)} == {("prefix", 3),
                                                ("from_layer", 3)}
    gb.execute_plan(plan, x)
    assert gb.capture_count == n1


def test_classifier_paths_share_graphs(mlp, fake):
    """``QPARTServer.calibrate`` (the probe program and ``calibrate_
    delta``'s forwards of perturbed lists, copied into the clean
    model's graph), a deployment's executions and the baselines at p =
    3, each through the graphs of their program and shape: bitwise the
    eager twin's calibration, logits, accuracies and degradations."""
    eager, x, _, _ = mlp
    gb = _graphed_cls(eager)
    y = np.argmax(to_numpy(eager.forward(x)), -1).astype(np.int32)
    y[::3] = (y[::3] + 1) % 10
    cal = {}
    for name, be in (("graphed", gb), ("eager", eager)):
        srv = TServer()
        srv.register("mnist", be, x, y)
        srv.calibrate("mnist")
        srv.calibrate("mnist")
        m = srv.models["mnist"]
        cal[name] = (m.s_w, m.s_x, m.rho, m.delta_table, m.base_accuracy)
    assert all(np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
               for a, b in zip(cal["graphed"], cal["eager"]))
    plan = TPlan(**_kw(3))
    execs = [be.device_executor(plan) for be in (gb, eager)]
    for _ in range(3):
        assert torch.equal(gb.execute_plan(plan, x, executor=execs[0]),
                           eager.execute_plan(plan, x, executor=execs[1]))
    ctx = (tcm.DeviceProfile(), tcm.ServerProfile(),
           tcm.Channel(capacity_bps=2e6), tcm.ObjectiveWeights())
    for _ in range(3):
        before = gb.capture_count
        got = [tbase.no_opt_offload(be, 3, *ctx, x, y, 0.9)
               for be in (gb, eager)]
        got += [tbase.AutoencoderBaseline().offload(be, 3, x, *ctx, x, y,
                                                    0.9)
                for be in (gb, eager)]
        got += [tbase.PruningBaseline().offload(be, 3, *ctx, x, y, 0.9)
                for be in (gb, eager)]
        for g, e in zip(got[::2], got[1::2]):
            assert (g.accuracy, g.accuracy_degradation) == \
                (e.accuracy, e.accuracy_degradation)
    assert gb.capture_count == before
    assert eager.capture_count == 0


def test_classifier_cpu_default_eager_and_graphs_refused(mlp):
    """On the CPU a classifier backend runs its programs eagerly by
    default (0 captures, no graph cached), and refuses
    ``forward_graphs=True``."""
    eager, x, _, _ = mlp
    be = TCBackend(eager.cfg, eager.params)
    assert not graphs_lib.graphed(be)
    for _ in range(3):
        be.forward(x)
        be.calibrate_probes(x)
    assert be.capture_count == 0 and not stage_graphs(be)
    with pytest.raises(ServingError):
        TCBackend(eager.cfg, eager.params, forward_graphs=True)
