"""The speculative round at the device position, on the CPU lane: the
port's speculative sessions against the reference's at p in {0, 1, L}
and k in {1, 3} (tokens, rounds, drafts proposed and accepted), the
round's two stages at a host-int round start bitwise the same stages at
a 0-d int32 / int64 position tensor, and the graph bookkeeping of
``DecodeSession`` through a stand-in for ``StageGraph`` that re-runs the
stage on its static inputs: the first round at the draft length eager,
the second capturing both stages, later ones replaying, smaller-k tail
rounds eager, a new prefill dropping the graphs. The graphs themselves
run only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Exact throughout: the same f32 4-layer smollm-8m and seeded prompt in
both packages, greedy ids compared as integers, caches by bit pattern.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.solver import PartitionPlan as JPlan
from repro.serving.backends import TransformerBackend as JBackend
from repro.serving.decode import DecodeSession as JSession
from repro_torch.core.solver import PartitionPlan as TPlan
from repro_torch.models import transformer as TT
from repro_torch.serving.backends import TransformerBackend as TBackend
from repro_torch.serving.decode import DecodeSession as TSession
from repro_torch.serving.decode import pipeline
from tests._torch_parity import lm_configs, lm_weights

SEQ, MAX_LEN, PAGE, L = 12, 48, 4, 4


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = lm_configs()
    tree = lm_weights(tcfg)
    jb = JBackend(jcfg, jax.tree.map(jnp.asarray, tree), seq_len=SEQ,
                  decode_max_len=MAX_LEN)
    tb = TBackend(tcfg, TT.params_from_numpy(tree, tcfg, device="cpu"),
                  seq_len=SEQ, decode_max_len=MAX_LEN)
    prompt = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, SEQ)).astype(np.int32)
    return jb, tb, prompt


def _kw(p):
    return dict(p=p, bits_w=np.full(p, 8.0), bits_x=8.0 if p else 16.0,
                objective=0.0, psi_total=0.0, payload_bits=0.0, breakdown={})


def _bits(t):
    return t.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


def _caches_bitwise(a, b) -> bool:
    return all(torch.equal(_bits(x[k]), _bits(y[k]))
               for x, y in zip(a, b) for k in x)


@pytest.mark.parametrize("p,k,paged", [(0, 1, False), (0, 3, False),
                                       (1, 1, False), (1, 3, False),
                                       (L, 1, False), (L, 3, False),
                                       (1, 2, True)],
                         ids=["p0-k1", "p0-k3", "p1-k1", "p1-k3", "pL-k1",
                              "pL-k3", "p1-k2-paged"])
def test_spec_session_matches_reference(pair, p, k, paged):
    """A CPU speculative session runs its rounds at the device position
    (eagerly, no graph captured) and gives the reference session's
    tokens, rounds and draft counts; at p == L every draft is
    accepted."""
    jb, tb, prompt = pair
    kw = dict(max_len=MAX_LEN, draft_tokens=k)
    if paged:
        kw.update(paged=True, page_tokens=PAGE, prefill_chunk_tokens=PAGE)
    before = tb.capture_count
    ts = TSession(tb, TPlan(**_kw(p)), **kw)
    got = ts.generate(prompt, 10)
    want = JSession(jb, JPlan(**_kw(p)), **kw).generate(prompt, 10)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert (got.rounds, got.drafts_proposed, got.drafts_accepted) == \
        (want.rounds, want.drafts_proposed, want.drafts_accepted)
    assert not ts.graphs and ts._graphs == {}
    assert tb.capture_count == before
    assert ts._spec_rounds >= 1
    if p == L:
        assert got.accept_rate == 1.0


@pytest.mark.parametrize("p", [0, 1, L], ids=["p0", "p1", "pL"])
def test_round_at_host_int_bitwise_device_position(pair, p):
    """The round's device stage (k + 1 segment steps, k draft heads) and
    server stage (``verify_segment``) from a host-int round start give
    the same hop rows, drafts, verified tokens and caches, bit for bit,
    as from a 0-d int32 or int64 position tensor (wire structs and a
    float8 device cache past p = 0)."""
    _, tb, prompt = pair
    k = 3
    runs = []
    for pos in (None, torch.int32, torch.int64):
        sess = TSession(tb, TPlan(**_kw(p)), max_len=MAX_LEN, qkernels=True,
                        draft_tokens=k)
        tok = sess.prefill(prompt).reshape(-1, 1)
        start = sess.pos if pos is None else torch.tensor(sess.pos,
                                                          dtype=pos)
        hh, drafts = sess._spec_device(tok, k, start)
        g = sess._spec_server(hh, start)
        runs.append((hh, drafts, g, sess))
    (hh, drafts, g, sess), rest = runs[0], runs[1:]
    assert hh.shape == (2, k + 1, tb.cfg.d_model)
    assert drafts.shape == (2, k) and g.shape == (2, k + 1)
    for hh_t, drafts_t, g_t, sess_t in rest:
        assert torch.equal(_bits(hh_t), _bits(hh))
        assert torch.equal(drafts_t, drafts) and torch.equal(g_t, g)
        assert _caches_bitwise(sess_t.srv_caches, sess.srv_caches)
        if p:
            assert _caches_bitwise(sess_t.dev_caches, sess.dev_caches)


class FakeGraph:
    """``StageGraph`` on the CPU: ``fn`` run on its static inputs when
    captured and again at every replay, its results copied into the
    capture's outputs (a real capture launches nothing; the stages are
    idempotent, each writing the same cache slots from the same
    inputs). Every capture and replay is logged."""

    log = []

    def __init__(self, fn, inputs, pool=None):
        self.fn, self.inputs, self.pool = fn, tuple(inputs), pool
        self.outputs = fn(*self.inputs)
        self.graph = types.SimpleNamespace(pool=lambda: self)
        self.log.append(("capture", self))

    def replay(self, *inputs):
        for static, x in zip(self.inputs, inputs):
            if x is not static:
                static.copy_(x)
        new = self.fn(*self.inputs)
        outs = self.outputs if isinstance(self.outputs, tuple) \
            else (self.outputs,)
        for o, n in zip(outs, new if isinstance(new, tuple) else (new,)):
            o.copy_(n)
        self.log.append(("replay", self))
        return self.outputs


def _graphed(tb, p, **kw):
    """A CPU session stepping through ``_stage``'s graph path (a CUDA
    session's default; the constructor refuses it off the card)."""
    sess = TSession(tb, TPlan(**_kw(p)), max_len=MAX_LEN, **kw)
    sess.graphs = True
    return sess


def _rounds(sess, prompt, n):
    """Each decode round's (drafts proposed, logged graph events by
    stage name), and the stream's tokens."""
    names = {}
    out, toks = [], []
    for i, emitted in enumerate(sess.round_stream(prompt, n)):
        toks.extend(emitted)
        if i:
            names.update({id(g): name for name, g in sess._graphs.items()})
            out.append((sess.drafts_proposed - proposed,
                        [(what, names[id(g)]) for what, g in FakeGraph.log]))
        FakeGraph.log.clear()
        proposed = sess.drafts_proposed
    return out, np.stack(toks, axis=1)


@pytest.mark.parametrize("p", [1, L], ids=["p1", "pL"])
def test_spec_graph_bookkeeping(pair, p, monkeypatch):
    """Round 1 at the draft length runs eagerly, round 2 captures
    ``spec_device`` then ``spec_server`` (in a pool of their own, the
    second in the first's) and replays both, later rounds replay them;
    rounds at a smaller k and the plain tail step run eagerly. The tokens
    and counts are the eager session's; the stream captures 2 graphs,
    and a new prefill drops them."""
    monkeypatch.setattr(pipeline, "StageGraph", FakeGraph)
    _, tb, prompt = pair
    k = 2
    n = 12 if p == L else 10     # at p == L: 3 rounds of 3 tokens, 1 of 2
    eager = TSession(tb, TPlan(**_kw(p)), max_len=MAX_LEN, draft_tokens=k)
    want = eager.generate(prompt, n)
    sess = _graphed(tb, p, draft_tokens=k)
    before = tb.capture_count
    rounds, tokens = _rounds(sess, prompt, n)
    np.testing.assert_array_equal(tokens, want.tokens)
    assert (len(rounds), sess.drafts_proposed, sess.drafts_accepted) == \
        (want.rounds, want.drafts_proposed, want.drafts_accepted)
    at_k = [events for proposed, events in rounds if proposed == k]
    assert len(at_k) >= 3
    assert at_k[0] == []
    assert at_k[1] == [("capture", "spec_device"), ("replay", "spec_device"),
                       ("capture", "spec_server"), ("replay", "spec_server")]
    assert all(e == [("replay", "spec_device"), ("replay", "spec_server")]
               for e in at_k[2:])
    assert all(events == [] for proposed, events in rounds
               if proposed != k)
    if p == L:
        assert [proposed for proposed, _ in rounds] == [2, 2, 2, 1]
    assert tb.capture_count - before == 2
    dev, srv = sess._graphs["spec_device"], sess._graphs["spec_server"]
    assert set(sess._graphs) == {"spec_device", "spec_server"}
    assert dev.pool is None and srv.pool is dev
    assert srv.inputs[0] is dev.outputs[0]
    sess.prefill(prompt)
    assert sess._graphs == {} and sess._spec_rounds == 0


def test_plain_step_graph_bookkeeping(pair, monkeypatch):
    """The plain step through the same ``_stage``: step 1 eager, step 2
    captures ``device`` then ``server`` (the server in the device's pool,
    reading its output), later steps replay; the eager session's
    tokens."""
    monkeypatch.setattr(pipeline, "StageGraph", FakeGraph)
    _, tb, prompt = pair
    want = TSession(tb, TPlan(**_kw(1)), max_len=MAX_LEN).generate(prompt, 6)
    sess = _graphed(tb, 1)
    rounds, tokens = _rounds(sess, prompt, 6)
    np.testing.assert_array_equal(tokens, want.tokens)
    assert [events for _, events in rounds] == [
        [], [("capture", "device"), ("replay", "device"),
             ("capture", "server"), ("replay", "server")]] + \
        [[("replay", "device"), ("replay", "server")]] * 3
    dev, srv = sess._graphs["device"], sess._graphs["server"]
    assert dev.pool is None and srv.pool is dev
    assert srv.inputs[0] is dev.outputs
