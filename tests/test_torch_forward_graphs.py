"""The forward family's block graphs (``serving.backends.graphs``) on the
CPU lane, through the ``FakeGraph`` stand-in for ``StageGraph`` (it
re-runs the block on its static inputs and copies the result into the
capture's outputs, so a value handed back without being copied out
would be overwritten by the next replay; the graphs themselves run only
on the card, ``tests/test_torch_cuda.py`` and ``chip_smoke.py``):

  * graphed ``forward``, ``layer_activations``, ``forward_from_layer``
    (every start), ``execute_plan`` (every p) and ``calibrate_probes``
    bitwise the eager port (``forward_graphs=False``), and the JAX
    reference within the tolerances of ``tests/test_torch_serving.py``;
  * the port of the reference's ``TestCompileOnce``: the same exercise
    at depth 2 and 6 captures as often, at most once per period position
    and shape, and executing every p after one ``forward`` captures
    nothing;
  * a perturbed ``params=`` tree replays the same graph with its leaves
    copied in; a period of two block kinds (a reduced jamba) captures
    one graph per position; values handed back survive later replays;
  * on the CPU the default is eager (0 captures) and ``forward_graphs=
    True`` is refused.

The 4-layer f32 smollm-8m of ``tests/_torch_parity.py``, seeded tokens
in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.solver import PartitionPlan as JPlan
from repro.serving.backends import TransformerBackend as JBackend
from repro_torch.configs.base import get_config
from repro_torch.core.solver import PartitionPlan as TPlan
from repro_torch.models import transformer as TT
from repro_torch.serving.backends import TransformerBackend as TBackend
from repro_torch.serving.backends import graphs as graphs_lib
from repro_torch.serving.errors import ServingError
from tests._torch_parity import (FakeGraph, lm_configs, lm_weights,
                                 stage_graphs, to_numpy, zoo_configs)

SEQ, N, L = 16, 4, 4
TOL = 1e-4           # f32 logits against the reference (test_torch_serving)
ETOL = 5e-3          # the probe energies (test_torch_serving)


def _kw(p, bits=8.0):
    return dict(p=p, bits_w=np.full(p, bits), bits_x=bits if p else 16.0,
                objective=0.0, psi_total=0.0, payload_bits=0.0, breakdown={})


@pytest.fixture(scope="module")
def pair():
    """The reference's and the eager port's backends on one seeded tree,
    cycle-task tokens, and the reference's outputs of the family."""
    jcfg, tcfg = lm_configs()
    tree = lm_weights(tcfg)
    rng = np.random.default_rng(0)
    start = rng.integers(0, jcfg.vocab_size, (N, 1))
    seq = (start + np.arange(SEQ + 1)[None]) % jcfg.vocab_size
    x, y = seq[:, :SEQ].astype(np.int32), seq[:, SEQ].astype(np.int32)
    jb = JBackend(jcfg, jax.tree.map(jnp.asarray, tree), seq_len=SEQ)
    tb = TBackend(tcfg, TT.params_from_numpy(tree, tcfg, device="cpu"),
                  seq_len=SEQ, forward_graphs=False)
    jx = jnp.asarray(x)
    jacts, jlogits = jb.layer_activations(jx)
    ref = {"forward": np.asarray(jb.forward(jx)),
           "acts": [np.asarray(a) for a in jacts],
           "acts_logits": np.asarray(jlogits),
           "from": [np.asarray(jb.forward_from_layer(jacts[l], l))
                    for l in range(L)],
           "execute": {bits: [np.asarray(jb.execute_plan(
               JPlan(**_kw(p, bits)), jx)) for p in range(L + 1)]
               for bits in (8.0, 16.0)},
           "cut": [np.asarray(jb.run_device_segment(
               jb.split(JPlan(**_kw(p))), JPlan(**_kw(p)), jx))
               for p in range(1, L + 1)],
           "probes": jb.calibrate_probes(jx)}
    return tb, x, y, ref


@pytest.fixture
def fake(monkeypatch):
    monkeypatch.setattr(graphs_lib, "StageGraph", FakeGraph)
    FakeGraph.log.clear()


def _graphed(tb):
    """A backend on ``tb``'s params with no graph yet, through the block
    graphs on the CPU (the constructor refuses ``forward_graphs=True``
    off the card)."""
    be = TBackend(tb.cfg, tb.params, seq_len=tb.seq_len)
    be.forward_graphs = True
    return be


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(to_numpy(got), want, atol=tol, rtol=tol)


def _events() -> list:
    out = [what for what, _ in FakeGraph.log]
    FakeGraph.log.clear()
    return out


def test_forward_and_activations_bitwise_eager(pair, fake):
    """``forward`` three times (eager, capture, replay) and
    ``layer_activations``: the eager port's bits, the reference's values;
    one capture for the one block shape; each entering activation kept
    when later replays overwrite the graph's buffer."""
    tb, x, _, ref = pair
    gb = _graphed(tb)
    want = tb.forward(x)
    for _ in range(3):
        got = gb.forward(x)
        assert torch.equal(got, want)
    _close(got, ref["forward"])
    assert gb.capture_count == 1
    acts, logits = gb.layer_activations(x)
    wacts, wlogits = tb.layer_activations(x)
    gb.forward(x[::-1].copy())             # replays overwrite the buffer
    assert torch.equal(logits, wlogits)
    assert len(acts) == L
    for l in range(L):
        assert torch.equal(acts[l], wacts[l]), l
        _close(acts[l], ref["acts"][l])
    _close(logits, ref["acts_logits"])
    assert gb.capture_count == 1


def test_forward_from_every_layer_bitwise_eager(pair, fake):
    """Resuming at every start replays the one graph: the eager port's
    bits, the reference's values, no capture past the first."""
    tb, x, _, ref = pair
    gb = _graphed(tb)
    acts, _ = tb.layer_activations(x)
    gb.forward(x)
    gb.forward(x)
    for l in range(L):
        got = gb.forward_from_layer(acts[l], l)
        assert torch.equal(got, tb.forward_from_layer(acts[l], l)), l
        _close(got, ref["from"][l])
    assert gb.capture_count == 1


@pytest.mark.parametrize("bits", [8.0, 16.0])
def test_execute_every_plan_bitwise_eager(pair, fake, bits):
    """``execute_plan`` at every p (the quantized segment's trees copied
    into the clean model's graph): the eager port's logits, and the cut
    activation handed back intact by later replays. Against the
    reference: at 16 bits the logits within 1e-4; at 8 bits the cut
    activation's ``bits_x`` rounding flips a few elements by one step
    where the two packages' f32 sums differ in the last bit (the eager
    port did so before the graphs), so the cut activations agree but for
    such one-step flips and the server tail from the reference's cut
    activation gives the reference's logits within 1e-4."""
    tb, x, _, ref = pair
    gb = _graphed(tb)
    gb.forward(x)
    gb.forward(x)
    for p in range(L + 1):
        plan = TPlan(**_kw(p, bits))
        ex, tex = (be.device_executor(plan) if p else None
                   for be in (gb, tb))
        got = gb.execute_plan(plan, x, executor=ex)
        assert torch.equal(got, tb.execute_plan(plan, x, executor=tex)), p
        if bits == 16.0 or p == 0:
            _close(got, ref["execute"][bits][p])
        if not p:
            continue
        h = ex(x)
        keep = h.clone()
        gb.forward(x)
        assert torch.equal(h, keep)
        assert torch.equal(h, tex(x))
        if bits == 8.0:
            want = ref["cut"][p - 1]
            step = (want.max() - want.min()) / 255.0
            diff = np.abs(to_numpy(h) - want)
            flips = diff > 1e-5
            assert flips.mean() < 1e-3 and diff.max() <= 1.01 * step, p
            _close(gb.forward_from_layer(torch.from_numpy(want.copy()), p),
                   ref["execute"][bits][p])
    assert gb.capture_count == 1


def test_calibrate_probes_bitwise_eager(pair, fake):
    """The probes: energies and clean logits the eager port's bits (the
    eager port's are the scalar loop's, ``tests/test_torch_serving.py``),
    the reference's within 5e-3; the probed block and the suffixes
    replay the one graph, the perturbed leaves copied in."""
    tb, x, _, ref = pair
    gb = _graphed(tb)
    e_w, e_x, logits = gb.calibrate_probes(x)
    w_w, w_x, w_logits = tb.calibrate_probes(x)
    assert np.array_equal(e_w, w_w) and np.array_equal(e_x, w_x)
    assert e_w.dtype == e_x.dtype == np.float64
    assert torch.equal(logits, w_logits)
    je_w, je_x, jl = ref["probes"]
    _close(logits, np.asarray(jl))
    np.testing.assert_allclose(e_w, je_w, rtol=ETOL)
    np.testing.assert_allclose(e_x, je_x, rtol=ETOL)
    assert gb.capture_count == 1


def test_perturbed_params_replay_the_graph(pair, fake):
    """A perturbed ``params=`` tree (one layer fake-quantized at 2 bits)
    replays the graph the clean model captured: its leaves are copied
    in (the logits move, bitwise the eager port's on the same tree) and
    nothing is captured."""
    tb, x, _, _ = pair
    gb = _graphed(tb)
    clean = gb.forward(x)
    gb.forward(x)
    _events()
    for l in range(L):
        noisy = tb.with_layer_quantized(l, 2)
        got = gb.forward(x, params=noisy)
        assert torch.equal(got, tb.forward(x, params=noisy)), l
        assert not torch.equal(got, clean), l
    assert gb.capture_count == 1
    assert set(_events()) == {"replay"}
    assert len(stage_graphs(gb)) == 1


def _compile_once_exercise(cfg, seed: int = 0) -> int:
    """The reference's ``TestCompileOnce._exercise`` on the port:
    ``forward``, ``layer_activations``, ``forward_from_layer`` at every
    start and ``execute_plan`` at every p, on one graphed backend."""
    params = TT.init_params(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")
    rng = np.random.default_rng(seed)
    x = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    eager = TBackend(cfg, params, seq_len=8)
    be = _graphed(eager)
    be.forward(x)
    acts, _ = be.layer_activations(x)
    for l in range(cfg.num_layers):
        assert torch.equal(be.forward_from_layer(acts[l], l),
                           eager.forward_from_layer(acts[l], l))
    for p in range(1, cfg.num_layers + 1):
        plan = TPlan(**_kw(p))
        assert torch.equal(be.execute_plan(plan, x),
                           eager.execute_plan(plan, x))
    assert eager.capture_count == 0
    return be.capture_count


def _cal_config(layers: int):
    """The reference's ``tests/test_calibration.py`` ``lm_config``."""
    return dataclasses.replace(
        get_config("smollm-135m").reduced(), name=f"smollm-cal-L{layers}",
        num_layers=layers, d_model=64, num_heads=2, num_kv_heads=1,
        head_dim=32, d_ff=128, vocab_size=32, tp_pad=1, dtype="float32")


def test_capture_count_depth_independent(fake):
    """Every start and every partition point from one capture per
    period position and shape — the same count at depth 2 and 6."""
    counts = {layers: _compile_once_exercise(_cal_config(layers))
              for layers in (2, 6)}
    plen = TT.period_len(_cal_config(2))
    assert counts[2] == counts[6] <= plen * 1, counts


def test_executing_every_p_adds_no_capture(pair, fake):
    """After one ``forward`` pair captured the block's graph, executing
    every p (each a new quantized tree) captures nothing."""
    tb, x, _, _ = pair
    gb = _graphed(tb)
    gb.forward(x)
    gb.forward(x)
    before = gb.capture_count
    for p in range(1, L + 1):
        gb.execute_plan(TPlan(**_kw(p, bits=16.0)), x)
    assert gb.capture_count == before == 1


def test_period_positions_capture_once_each(fake):
    """A reduced jamba (an attention and a Mamba2 block per period):
    one graph per period position and shape, whatever the calls; its
    forward, activations and probes bitwise the eager port's."""
    _, cfg = zoo_configs("jamba-v0.1-52b")
    params = TT.params_from_numpy(lm_weights(cfg), cfg, device="cpu")
    x = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    eager = TBackend(cfg, params, seq_len=8)
    gb = _graphed(eager)
    for _ in range(3):
        assert torch.equal(gb.forward(x), eager.forward(x))
    got, want = gb.calibrate_probes(x), eager.calibrate_probes(x)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert torch.equal(got[2], want[2])
    plen = TT.period_len(cfg)
    assert plen == 2 and gb.capture_count == plen
    assert {k[1] for k in stage_graphs(gb)} == set(range(plen))


def test_cpu_default_is_eager_and_graphs_refused(pair):
    """On the CPU a backend runs its forward family eagerly by default
    (0 captures, no graph cached), and refuses ``forward_graphs=True``."""
    tb, x, _, _ = pair
    be = TBackend(tb.cfg, tb.params, seq_len=SEQ)
    assert not graphs_lib.graphed(be)
    be.forward(x)
    be.calibrate_probes(x)
    assert be.capture_count == 0 and not stage_graphs(be)
    with pytest.raises(ServingError):
        TBackend(tb.cfg, tb.params, seq_len=SEQ, forward_graphs=True)
