"""The decode session's stage graphs and caches owned by the backend, on
the CPU lane, through the ``FakeGraph`` stand-in for ``StageGraph`` (it
re-runs the stage on its static inputs; the graphs themselves run only
on the card, ``tests/test_torch_cuda.py`` and ``chip_smoke.py``):

  * ``segment_extend`` at a 0-d tensor offset bitwise the host int's,
    chunk by chunk (outputs and caches, float8 device caches included);
  * a series of graphed sessions on one backend — plain, chunked and
    speculative, three sessions of each shape, then a shorter prompt on
    the slots the longer streams used — giving the reference's fresh
    sessions' tokens; each session captures exactly the stage keys
    whose second use it makes, so the third of a shape captures nothing;
  * a new cut or a new chunk length adds exactly its keys once they are
    used twice, a smaller-k tail round is captured on its second use and
    then replayed;
  * the backend keeps only the keys used last, whatever the number of
    prompt lengths, and an evicted key comes back eagerly;
  * two live sessions hold two slots; slots go back when a stream ends
    (``generate``, a closed ``round_stream``, ``sever``, collection), a
    session whose stream has ended steps no more, and an evicted slot or
    ``qstacked_for`` tree takes its graphs with it.

Exact throughout: the f32 4-layer smollm-8m and seeded prompts in both
packages, greedy ids compared as integers, caches by bit pattern.
"""
import collections
import gc

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
from repro_torch.models.common import as_bits
from repro_torch.serving.backends import TransformerBackend as TBackend
from repro_torch.serving.backends import base as base_lib
from repro_torch.serving.decode import DecodeSession as TSession
from repro_torch.serving.decode import graphs as graphs_lib
from repro_torch.serving.decode import pipeline
from repro_torch.serving.errors import ServingError
from tests._torch_parity import (FakeGraph, lm_configs, lm_weights,
                                 stage_graphs)

SEQ, SHORT, MAX_LEN, L = 12, 8, 40, 4


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = lm_configs()
    tree = lm_weights(tcfg)
    jb = JBackend(jcfg, jax.tree.map(jnp.asarray, tree), seq_len=SEQ,
                  decode_max_len=MAX_LEN)
    tb = TBackend(tcfg, TT.params_from_numpy(tree, tcfg, device="cpu"),
                  seq_len=SEQ, decode_max_len=MAX_LEN)
    prompt = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, SEQ)).astype(np.int32)
    return jb, tb, prompt


@pytest.fixture
def fake(monkeypatch):
    monkeypatch.setattr(pipeline, "StageGraph", FakeGraph)
    FakeGraph.log.clear()


def _kw(p, bits=8.0):
    return dict(p=p, bits_w=np.full(p, bits), bits_x=8.0 if p else 16.0,
                objective=0.0, psi_total=0.0, payload_bits=0.0, breakdown={})


def _fresh(tb):
    """A backend on ``tb``'s params with no stage graph or cache slot."""
    return TBackend(tb.cfg, tb.params, seq_len=SEQ, decode_max_len=MAX_LEN)


def _graphed(be, p, seg=None, **kw):
    """A CPU session through ``_stage``'s graph path (the constructor
    refuses ``graphs=True`` off the card)."""
    sess = TSession(be, TPlan(**_kw(p)), max_len=MAX_LEN, segment=seg, **kw)
    sess.graphs = True
    return sess


def _keys(be) -> set:
    """The captured keys by (stage, cut, rows)."""
    return {k[:3] for k in stage_graphs(be)}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float8_e4m3fn],
                         ids=["f32", "float8"])
@pytest.mark.parametrize("pos_dtype", [torch.int32, torch.int64])
def test_extend_at_tensor_offset_bitwise_host_int(pair, dtype, pos_dtype):
    """Chunk by chunk (4, 4 and 4 rows of the prompt through blocks [0,
    2) and [2, 4)), ``segment_extend`` at a 0-d integer tensor offset
    gives the host-int offset's rows and ring contents bit for bit (the
    ``index_copy_`` of the rows' slots is a pure copy either way)."""
    _, tb, prompt = pair
    cfg = tb.cfg
    emb = tb.embed(prompt)
    host = TT.init_cache(cfg, 2, MAX_LEN, dtype, "cpu")
    dev = TT.init_cache(cfg, 2, MAX_LEN, dtype, "cpu")
    offset = torch.zeros((), dtype=pos_dtype)
    for lo, hi in TSession.chunk_bounds(SEQ, 4):
        offset.fill_(lo)
        for start, stop in ((0, 2), (2, L)):
            want, _ = TT.segment_extend(tb.params, cfg, emb[:, lo:hi], host,
                                        lo, start, stop)
            got, _ = TT.segment_extend(tb.params, cfg, emb[:, lo:hi], dev,
                                       offset, start, stop)
            assert torch.equal(got, want), (lo, start)
        assert _caches_bitwise(dev, host), lo
    assert torch.equal(as_bits(dev[0]["k"][:, :, SEQ:]),
                       torch.zeros_like(as_bits(dev[0]["k"][:, :, SEQ:])))


MODES = {"plain": {}, "chunk4": dict(prefill_chunk_tokens=4),
         "draft2": dict(draft_tokens=2)}


def test_session_series_matches_reference(pair, fake):
    """On ONE backend, per mode (monolithic, chunks of 4, drafting 2) at
    p = 1: three sessions, then one on a shorter prompt, each the
    reference's fresh session token for token (and in rounds and
    drafts), all on the same slots. Each session captures exactly the
    stage keys whose second use it makes (a key's first use runs
    eagerly), so the third captures nothing and replays every stage; the
    first shorter prompt's prefill runs eagerly and is not captured; the
    shorter stream found its slots zeroed (every slot past it is 0)."""
    jb, tb, prompt = pair
    be = _fresh(tb)
    seg = be.split(TPlan(**_kw(1)))
    short = prompt[:, :SHORT]
    uses = collections.Counter()
    for name, kw in MODES.items():
        want = {s: JSession(jb, JPlan(**_kw(1)), max_len=MAX_LEN,
                            **kw).generate(x, 9)
                for s, x in ((SEQ, prompt), (SHORT, short))}
        slots, events = [], []
        for length, x in ((SEQ, prompt),) * 3 + ((SHORT, short),):
            before = be.capture_count
            sess = _graphed(be, 1, seg, **kw)
            got = sess.generate(x, 9)
            events.append([what for what, _ in FakeGraph.log])
            captured = _captured(be)
            assert captured == _second_uses(uses, sess), (name, length)
            assert be.capture_count - before == len(captured)
            np.testing.assert_array_equal(got.tokens, want[length].tokens,
                                          err_msg=f"{name} {length}")
            assert (got.rounds, got.drafts_proposed, got.drafts_accepted) \
                == (want[length].rounds, want[length].drafts_proposed,
                    want[length].drafts_accepted), name
            slots.append((sess._dev_slot, sess._srv_slot))
        assert len(set(slots)) == 1, name
        assert set(events[2]) == {"replay"}, name
        if name == "plain":           # the short prefill's first use
            assert not any(stage.startswith("extend") and rows == SHORT
                           for stage, rows in _keys_of(be))
        for slot in slots[3]:
            tail = [as_bits(c[k][:, :, SHORT + 9:]) for c in slot.caches
                    for k in c]
            assert all(not t.any() for t in tail), name


def _keys_of(be) -> set:
    """(stage, rows) of each cached graph."""
    return {(k[0], k[2]) for k in stage_graphs(be)}


def test_new_cut_and_chunk_length_add_their_keys(pair, fake):
    """A new cut captures its own stage pairs (the same shapes at p = 2),
    a new chunk length only its chunk pairs once used twice (chunks of 5
    over 12 tokens: 5, 5, 2, so the 2-row pair waits for a second
    stream), and a smaller-k tail round is captured on its second use,
    in a later stream, and replayed after."""
    _, tb, prompt = pair
    be = _fresh(tb)
    segs = {p: be.split(TPlan(**_kw(p))) for p in (1, 2)}
    uses = collections.Counter()

    def run(p, c):
        sess = _graphed(be, p, segs[p], prefill_chunk_tokens=c)
        sess.generate(prompt, 4)
        return _second_uses(uses, sess)

    run(1, 4)
    assert _keys(be) == {("extend_device", 1, 4), ("extend_server", 1, 4),
                         ("device", 1, 1), ("server", 1, 1)}
    run(2, 4)
    assert be.capture_count == 8
    assert {k for k in _keys(be) if k[1] == 2} == {
        ("extend_device", 2, 4), ("extend_server", 2, 4), ("device", 2, 1),
        ("server", 2, 1)}
    chunk5 = {(f"extend_{s}", 1, r) for s in ("device", "server")
              for r in (4, 5)}
    assert run(1, 5) == {("extend_device", 5), ("extend_server", 5)}
    assert be.capture_count == 10
    assert {k for k in _keys(be) if k[1] == 1 and k[0].startswith("ext")} \
        == chunk5
    assert run(1, 5) == {("extend_device", 2), ("extend_server", 2)}
    assert be.capture_count == 12
    assert {k for k in _keys(be) if k[1] == 1 and k[0].startswith("ext")} \
        == chunk5 | {(f"extend_{s}", 1, 2) for s in ("device", "server")}
    _events()
    # 9 tokens at k = 3: rounds of k = 3 (accepting 0 or more), then a
    # smaller k or a plain step where fewer tokens remain
    for stream in range(3):
        before = be.capture_count
        sess = _graphed(be, 1, segs[1], draft_tokens=3)
        seen = []
        for out in sess.round_stream(prompt, 9):
            seen.append(_events())
        tails = {k for k in sess.graph_keys if k[0] == "spec_device"
                 and k[2] != 4}
        assert tails and all(sess.graph_keys[k] == 1 for k in tails)
        new = _second_uses(uses, sess)
        assert be.capture_count - before == len(new)
        if stream == 0:       # the rounds at k = 3 alone, from round 2 on
            assert new == {("spec_device", 4), ("spec_server", 4)}
            assert seen[0] == [] and seen[1] == []
        elif stream == 1:     # the tail rounds and the monolithic prefill
            assert {(k[0], k[2]) for k in tails} <= new
            assert ("extend_device", SEQ) in new
        else:
            assert not new and all(set(ev) <= {"replay"} for ev in seen)
    assert be.capture_count == len(stage_graphs(be))


def test_stage_graph_keys_are_bounded(pair, fake, monkeypatch):
    """The backend keeps its ``_STAGE_GRAPH_KEYS`` keys used last (3
    here): streams at five prompt lengths, each twice, capture each
    length's prefill pair on its second use and evict the oldest keys as
    new ones come (the plain step's key, used by every stream, stays);
    an evicted length comes back eagerly, and every stream gives the
    eager session's tokens."""
    monkeypatch.setattr(base_lib, "_STAGE_GRAPH_KEYS", 3)
    _, tb, prompt = pair
    be = _fresh(tb)
    seg = be.split(TPlan(**_kw(1)))
    lengths = (5, 6, 7, 8, 9)
    for length in lengths + lengths[:1]:
        x = prompt[:, :length]
        want = TSession(be, TPlan(**_kw(1)), max_len=MAX_LEN,
                        segment=seg).generate(x, 4).tokens
        for _ in range(2):
            _events()
            got = _graphed(be, 1, seg).generate(x, 4)
            np.testing.assert_array_equal(got.tokens, want)
            assert len(be.__dict__["_stage_graphs"]) <= 3
        assert ("extend_device", 1, length) in _keys(be)
        assert ("device", 1, 1) in _keys(be)
    assert not {("extend_device", 1, n) for n in lengths[1:3]} & _keys(be)
    assert be.capture_count == 2 * (len(lengths) + 1) + 2


def test_ended_stream_steps_no_more(pair, fake):
    """A graphed session whose stream has ended (``generate`` returned,
    ``sever``, a closed ``round_stream``) or not begun raises on
    ``step`` and on a round instead of writing slots another stream may
    hold; a new ``prefill`` starts a stream it steps again. A session
    with its own caches (``graphs=False``) goes on stepping."""
    _, tb, prompt = pair
    be = _fresh(tb)
    seg = be.split(TPlan(**_kw(1)))
    sess = _graphed(be, 1, seg, draft_tokens=2)
    tok = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ServingError, match="no live stream"):
        sess.step(tok)
    sess.generate(prompt, 4)
    for run in (lambda: sess.step(tok), lambda: sess._spec_round(tok, 2)):
        with pytest.raises(ServingError, match="no live stream"):
            run()
    other = _graphed(be, 1, seg)
    held = other.prefill(prompt)
    kept = [as_bits(v).clone() for c in other.srv_caches for v in c.values()]
    with pytest.raises(ServingError):
        sess.step(tok)
    assert all(torch.equal(a, as_bits(v)) for a, v in
               zip(kept, (v for c in other.srv_caches for v in c.values())))
    other.step(held)
    other.sever()
    with pytest.raises(ServingError, match="no live stream"):
        other.step(held)
    stream = other.round_stream(prompt, 4)
    next(stream)
    stream.close()
    with pytest.raises(ServingError, match="no live stream"):
        other.step(held)
    sess.step(sess.prefill(prompt))
    own = TSession(be, TPlan(**_kw(1)), max_len=MAX_LEN, segment=seg)
    own.generate(prompt, 3)
    own.step(tok)


def test_two_live_sessions_hold_distinct_slots(pair, fake):
    """Two live sessions of one shape hold two slots each (device,
    server), step side by side to the same tokens, and give them back
    when their streams end; the pool keeps ``_IDLE_SLOTS`` idle slots a
    shape, the first made, and drops the graphs on a slot it evicts. A
    closed ``round_stream`` and a collected session release theirs."""
    _, tb, prompt = pair
    be = _fresh(tb)
    seg = be.split(TPlan(**_kw(1)))
    a, b = _graphed(be, 1, seg), _graphed(be, 1, seg)
    ta, tb_ = a.prefill(prompt), b.prefill(prompt)
    assert len(a._held) == len(b._held) == 2
    assert not set(a._held) & set(b._held)
    for _ in range(3):
        ta, tb_ = a.step(ta), b.step(tb_)
        assert torch.equal(ta, tb_)
    assert _caches_bitwise(a.srv_caches, b.srv_caches)
    c = _graphed(be, 1, seg)
    tc = c.prefill(prompt)                    # a third slot of each shape
    c.step(c.step(tc))                        # its step pair captured
    gone = {c._dev_slot, c._srv_slot}
    assert any(x in gone for k in stage_graphs(be) for x in k)
    for sess in (a, b, c):
        sess.sever()
    pool = be.__dict__["_cache_slots"]
    assert [len(slots) for slots in pool.values()] == \
        [graphs_lib._IDLE_SLOTS] * 2
    assert not any(s.held or s in gone for slots in pool.values()
                   for s in slots)
    assert not any(x in gone for k in stage_graphs(be) for x in k)
    d = _graphed(be, 1, seg)
    d.prefill(prompt)         # the prefill's second use on a's slots
    assert (d._dev_slot, d._srv_slot) == (a._dev_slot, a._srv_slot)
    stream = _graphed(be, 1, seg).round_stream(prompt, 5)
    next(stream)
    stream.close()
    assert sum(s.held for slots in pool.values() for s in slots) == 2
    d.sever()
    # a session that only replays: the stand-in graphs keep the session
    # whose stages they captured (a real graph keeps no session)
    e = _graphed(be, 1, seg)
    e.prefill(prompt)
    assert sum(s.held for slots in pool.values() for s in slots) == 2
    del e
    gc.collect()
    assert not any(s.held for slots in pool.values() for s in slots)


def test_qstacked_eviction_drops_graphs(pair, fake):
    """Graphed sessions on the wire-struct segment (``qkernels``) of five
    plans: the bounded ``qstacked_for`` cache evicts the first plan's
    tree, and the graphs that read it go with it; ``clear_qstacked``
    drops the rest."""
    _, tb, prompt = pair
    be = _fresh(tb)
    trees = []

    def readers(tree) -> list:
        return [e for e in be.__dict__["_stage_graphs"].values()
                if e.reads[0] is tree]

    for p, bits in ((1, 8.0), (1, 4.0), (2, 8.0), (2, 4.0), (3, 8.0)):
        plan = TPlan(**_kw(p, bits))
        sess = TSession(be, plan, max_len=MAX_LEN, qkernels=True)
        sess.graphs = True
        sess.generate(prompt, 3)
        trees.append(sess.dev_params)
        assert any(e.graphs for e in readers(sess.dev_params))
    assert not readers(trees[0])
    assert all(any(e.graphs for e in readers(t)) for t in trees[1:])
    be.clear_qstacked()
    assert not any(readers(t) for t in trees)
