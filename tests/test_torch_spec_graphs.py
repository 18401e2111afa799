"""The speculative round at the device position, on the CPU lane: the
port's speculative sessions against the reference's at p in {0, 1, L}
and k in {1, 3} (tokens, rounds, drafts proposed and accepted), the
round's two stages at a host-int round start bitwise the same stages at
a 0-d int32 / int64 position tensor, and the graph bookkeeping of
``DecodeSession`` through a stand-in for ``StageGraph`` that re-runs the
stage on its static inputs: each stage key's first use eager, its
second eager and captured, later uses replaying — in the stream and in
later sessions of the backend, a third of which captures nothing — and
a new prefill of the session replaying the chunk graphs on the same
slots. The graphs
themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Exact throughout: the same f32 4-layer smollm-8m and seeded prompt in
both packages, greedy ids compared as integers, caches by bit pattern.
"""
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
from tests._torch_parity import (FakeGraph, lm_configs, lm_weights,
                                 stage_graphs)

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
    assert not ts.graphs and ts._held == []     # its own caches, no slot
    assert tb.capture_count == before
    assert ts.drafts_proposed >= k
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


def _graphed(tb, p, **kw):
    """A CPU session stepping through ``_stage``'s graph path (a CUDA
    session's default; the constructor refuses it off the card)."""
    sess = TSession(tb, TPlan(**_kw(p)), max_len=MAX_LEN, **kw)
    sess.graphs = True
    return sess


def _fresh(tb):
    """A backend on ``tb``'s params with no stage graph or cache slot."""
    return TBackend(tb.cfg, tb.params, seq_len=SEQ, decode_max_len=MAX_LEN)


def _rounds(sess, prompt, n):
    """The prefill's and each decode round's (drafts proposed, logged
    graph events by stage name), and the stream's tokens."""
    out, toks, proposed = [], [], 0
    FakeGraph.log.clear()
    for emitted in sess.round_stream(prompt, n):
        toks.extend(emitted)
        names = {id(g): key[0] for key, g in stage_graphs(sess.backend).items()}
        out.append((sess.drafts_proposed - proposed,
                    [(what, names[id(g)]) for what, g in FakeGraph.log]))
        FakeGraph.log.clear()
        proposed = sess.drafts_proposed
    return out, np.stack(toks, axis=1)


def _captured(*names):
    return [("capture", name) for name in names]


def _replayed(*names):
    return [("replay", name) for name in names]


PAIR = {"extend": ("extend_device", "extend_server"),
        "spec": ("spec_device", "spec_server"), "plain": ("device", "server")}


@pytest.mark.parametrize("p", [1, L], ids=["p1", "pL"])
def test_spec_graph_bookkeeping(pair, p, monkeypatch):
    """Three sessions of one shape on a backend with no graphs. A stage
    key's first use runs eagerly, its second eagerly and then captures
    the pair (the server stage in the device stage's pool, reading its
    output), later uses replay. Stream 1: the prefill chunk (no server
    stage at p == L), the first round at the draft length and each
    smaller-k tail round or plain tail step eager, the second round at k
    capturing, later ones replaying. Stream 2 captures what stream 1 ran
    once and replays the rest; stream 3 replays every stage in the same
    order, and a new prefill of it replays the chunk's graphs on the
    same slots. Tokens and counts are the eager session's throughout."""
    monkeypatch.setattr(pipeline, "StageGraph", FakeGraph)
    _, tb, prompt = pair
    k = 2
    n = 12 if p == L else 10     # at p == L: 3 rounds of 3 tokens, 1 of 2
    eager = TSession(tb, TPlan(**_kw(p)), max_len=MAX_LEN, draft_tokens=k)
    want = eager.generate(prompt, n)
    be = _fresh(tb)
    seg = be.split(TPlan(**_kw(p)))
    streams, sessions = [], []
    for _ in range(3):
        sessions.append(_graphed(be, p, draft_tokens=k, segment=seg))
        rounds, tokens = _rounds(sessions[-1], prompt, n)
        np.testing.assert_array_equal(tokens, want.tokens)
        assert (len(rounds) - 1, sessions[-1].drafts_proposed,
                sessions[-1].drafts_accepted) == \
            (want.rounds, want.drafts_proposed, want.drafts_accepted)
        streams.append(rounds)
    first, second, third = streams
    extend = PAIR["extend"][:1 if p == L else 2]
    assert first[0] == (0, [])
    at_k = [events for proposed, events in first[1:] if proposed == k]
    assert len(at_k) >= 3
    assert at_k[0] == []
    assert at_k[1] == _captured(*PAIR["spec"])
    assert all(e == _replayed(*PAIR["spec"]) for e in at_k[2:])
    tail = [proposed for proposed, _ in first[1:] if proposed != k]
    assert tail and all(events == [] for proposed, events in first[1:]
                        if proposed != k)
    if p == L:
        assert [proposed for proposed, _ in first[1:]] == [2, 2, 2, 1]
    assert second[0] == (0, _captured(*extend))
    assert [events for _, events in second[1:]] == [
        _replayed(*PAIR["spec"]) if proposed == k
        else _captured(*PAIR["spec" if proposed else "plain"])
        for proposed, _ in first[1:]]
    graphs = stage_graphs(be)
    assert be.capture_count == len(graphs) == len(extend) + 2 + 2 * len(tail)
    assert [[("replay", name) for _, name in events]
            for _, events in second] == [events for _, events in third]
    keys = {key[0:1] + key[2:3]: g for key, g in graphs.items()}
    dev, srv = keys[("spec_device", k + 1)], keys[("spec_server", k + 1)]
    assert dev.pool is None and srv.pool is dev
    assert srv.inputs[0] is dev.outputs[0]
    last = sessions[-1]
    assert (last._dev_slot, last._srv_slot) == \
        (sessions[0]._dev_slot, sessions[0]._srv_slot)
    FakeGraph.log.clear()
    last.prefill(prompt)
    assert [(what, key[0]) for what, g in FakeGraph.log
            for key, h in graphs.items() if h is g] == _replayed(*extend)
    assert len(last._held) == 2 and be.capture_count == len(graphs)
    last.sever()
    assert last._held == [] and not sessions[0]._srv_slot.held


def test_plain_step_graph_bookkeeping(pair, monkeypatch):
    """The plain step through the same ``_stage``: in stream 1 the
    prefill chunk and step 1 run eagerly, step 2 captures ``device`` /
    ``server`` (the server in the device's pool, reading its output),
    later steps replay; stream 2 captures the prefill chunk's pair
    ``extend_device`` / ``extend_server`` on its second use and replays
    the steps; stream 3 replays all of it. The eager session's
    tokens."""
    monkeypatch.setattr(pipeline, "StageGraph", FakeGraph)
    _, tb, prompt = pair
    want = TSession(tb, TPlan(**_kw(1)), max_len=MAX_LEN).generate(prompt, 6)
    be = _fresh(tb)
    seg = be.split(TPlan(**_kw(1)))
    streams = []
    for _ in range(3):
        rounds, tokens = _rounds(_graphed(be, 1, segment=seg), prompt, 6)
        np.testing.assert_array_equal(tokens, want.tokens)
        streams.append([events for _, events in rounds])
    assert streams[0] == [[], [], _captured(*PAIR["plain"])] + \
        [_replayed(*PAIR["plain"])] * 3
    assert streams[1] == [_captured(*PAIR["extend"])] + \
        [_replayed(*PAIR["plain"])] * 5
    assert streams[2] == [_replayed(*PAIR["extend"])] + \
        [_replayed(*PAIR["plain"])] * 5
    graphs = {key[0]: g for key, g in stage_graphs(be).items()}
    for first, second in (PAIR["plain"], PAIR["extend"]):
        dev, srv = graphs[first], graphs[second]
        assert dev.pool is None and srv.pool is dev
        assert srv.inputs[0] is dev.outputs
    assert be.capture_count == 4
