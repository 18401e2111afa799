"""The rest of the port's decode session against the JAX package, on the
4-layer f32 smollm-8m of ``tests/_torch_parity.py``: speculative decode,
chunked prefill, paged KV, the page ledger, the continuous-batching
state and sliding-window configs (the cases of ``test_spec_decode.py``
and ``test_paged_kv.py``).

Exact: speculative tokens against the port's plain greedy tokens, rounds
and acceptance against the reference's, paged ``to_dense`` against the
dense ring (bit patterns), page counts and resident bytes, batcher
order, error messages, and every token stream compared with the
reference's. Chunked tokens equal the port's monolithic ones; chunked
caches are held to the reference's MONOLITHIC session at 1e-4 of the
largest value (f32 products summed in another order through 4 layers,
as ``test_torch_launch.py``), not to its chunked one, whose bitwise
chunked == monolithic claim does not hold on this tree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.solver import PartitionPlan as JPlan
from repro.serving.backends import TransformerBackend as JBackend
from repro.serving.decode import DecodeBatcher as JBatcher
from repro.serving.decode import DecodeSession as JSession
from repro.serving.decode import DecodeStream as JStream
from repro.serving.decode.cache import PageLedger as JLedger
from repro.serving.errors import ServingError as JServingError
from repro_torch.core import cost_model as tcm
from repro_torch.core.solver import PartitionPlan as TPlan
from repro_torch.models import transformer as TT
from repro_torch.serving.backends import TransformerBackend as TBackend
from repro_torch.serving.decode import DecodeBatcher as TBatcher
from repro_torch.serving.decode import DecodeSession as TSession
from repro_torch.serving.decode import DecodeStream as TStream
from repro_torch.serving.decode.cache import (KVPagePool, PageLedger,
                                              segment_page_pool)
from repro_torch.serving.errors import ServingError
from repro_torch.serving.qpart_server import QPARTServer as TServer
from repro_torch.serving.simulator import InferenceRequest as TRequest
from tests._torch_parity import lm_configs, lm_weights, to_numpy

SEQ, MAX_LEN, PAGE, L = 16, 48, 4, 4
TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = lm_configs()
    tree = lm_weights(tcfg)
    jb = JBackend(jcfg, jax.tree.map(jnp.asarray, tree), seq_len=SEQ,
                  decode_max_len=MAX_LEN)
    tb = TBackend(tcfg, TT.params_from_numpy(tree, tcfg, device="cpu"),
                  seq_len=SEQ, decode_max_len=MAX_LEN)
    return jb, tb


def _plans(p, bits=8.0):
    kw = dict(p=p, bits_w=np.full(p, float(bits)), bits_x=float(bits),
              objective=0.0, psi_total=0.0, payload_bits=0.0, breakdown={})
    return JPlan(**kw), TPlan(**kw)


def _prompt(s=12, b=2, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


def _bits(t):
    return t.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


def _trees_bitwise(a, b) -> bool:
    return all(torch.equal(_bits(x[k]), _bits(y[k]))
               for x, y in zip(a, b) for k in x)


@pytest.mark.parametrize("p", [1, 3, L])
def test_speculative_equals_plain_greedy(pair, p):
    """Draft lengths 1 and 3 emit the port's plain greedy tokens bit for
    bit (which are the reference's), in the reference's rounds at its
    acceptance rate; at p == L every draft is accepted."""
    jb, tb = pair
    jplan, tplan = _plans(p)
    prompt = _prompt()
    plain = TSession(tb, tplan, max_len=MAX_LEN).generate(prompt, 10)
    np.testing.assert_array_equal(
        plain.tokens,
        JSession(jb, jplan, max_len=MAX_LEN).generate(prompt, 10).tokens)
    assert plain.accept_rate is None and plain.rounds == 9
    for k in (1, 3):
        out = TSession(tb, tplan, max_len=MAX_LEN,
                       draft_tokens=k).generate(prompt, 10)
        ref = JSession(jb, jplan, max_len=MAX_LEN,
                       draft_tokens=k).generate(prompt, 10)
        np.testing.assert_array_equal(out.tokens, plain.tokens)
        assert (out.rounds, out.drafts_proposed, out.drafts_accepted) == \
            (ref.rounds, ref.drafts_proposed, ref.drafts_accepted)
        assert out.accept_rate == ref.accept_rate
        assert len(out.per_token_s) == out.new_tokens - 1
        if p == L:
            assert out.accept_rate == 1.0 and out.rounds < 9


def test_speculative_on_wire_structs(pair):
    """The draft head reads the quantized cut hidden under the device's
    wire-struct tree (``qstacked_for``, int8 and int4): still the plain
    greedy tokens of the same tree, bit for bit."""
    _, tb = pair
    prompt = _prompt(seed=4)
    for bits in (8.0, 4.0):
        _, tplan = _plans(L, bits)
        plain = TSession(tb, tplan, max_len=MAX_LEN,
                         qkernels=True).generate(prompt, 8)
        out = TSession(tb, tplan, max_len=MAX_LEN, qkernels=True,
                       draft_tokens=3).generate(prompt, 8)
        np.testing.assert_array_equal(out.tokens, plain.tokens)
        assert out.accept_rate == 1.0


def test_chunk_bounds_are_the_reference():
    assert TSession.chunk_bounds(10, 4) == [(0, 4), (4, 8), (8, 10)]
    for s in range(1, 20):
        for c in range(2, 8):
            assert TSession.chunk_bounds(s, c) == JSession.chunk_bounds(s, c)


@pytest.mark.parametrize("chunk", [2, 4, 5])
def test_chunked_prefill(pair, chunk):
    """Chunked tokens equal the port's monolithic ones (at 8 bits, float8
    device cache); at 32 bits (lossless caches) the chunked first token
    is the reference monolithic session's and both segments' caches lie
    within 1e-4 of its caches."""
    jb, tb = pair
    prompt = _prompt(s=11, seed=3)
    _, tplan = _plans(1)
    mono = TSession(tb, tplan, max_len=MAX_LEN).generate(prompt, 8)
    out = TSession(tb, tplan, max_len=MAX_LEN,
                   prefill_chunk_tokens=chunk).generate(prompt, 8)
    np.testing.assert_array_equal(out.tokens, mono.tokens)
    assert out.prefill_chunks == len(TSession.chunk_bounds(11, chunk))
    assert mono.prefill_chunks == 1
    jplan, tplan = _plans(1, 32.0)
    js = JSession(jb, jplan, max_len=MAX_LEN)
    ts = TSession(tb, tplan, max_len=MAX_LEN, prefill_chunk_tokens=chunk)
    np.testing.assert_array_equal(to_numpy(ts.prefill(prompt)),
                                  np.asarray(js.prefill(prompt)))
    for jc, tc in ((js.dev_caches, ts.dev_caches),
                   (js.srv_caches, ts.srv_caches)):
        for jl, tl in zip(jc, tc):
            for k in ("k", "v"):
                want = np.asarray(jl[k])
                np.testing.assert_allclose(
                    to_numpy(tl[k]), want, rtol=0,
                    atol=TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("p", [1, L])
def test_paged_chunked_speculative(pair, p):
    """Paged KV under chunked prefill + speculative decode: the tokens of
    the plain session and of the reference's paged session; ``to_dense``
    bitwise the live dense ring (float8 pages); held pages, resident
    bytes and pool pages equal the reference's; severing frees them."""
    jb, tb = pair
    jplan, tplan = _plans(p)
    prompt = _prompt(s=12, seed=2)
    kw = dict(max_len=MAX_LEN, paged=True, page_tokens=PAGE,
              prefill_chunk_tokens=PAGE, draft_tokens=2)
    ts, js = TSession(tb, tplan, **kw), JSession(jb, jplan, **kw)
    out, ref = ts.generate(prompt, 9), js.generate(prompt, 9)
    np.testing.assert_array_equal(out.tokens, ref.tokens)
    np.testing.assert_array_equal(
        out.tokens,
        TSession(tb, tplan, max_len=MAX_LEN).generate(prompt, 9).tokens)
    assert ts.dev_dtype == torch.float8_e4m3fn
    assert _trees_bitwise(ts.paged_kv.to_dense(ts.dev_caches), ts.dev_caches)
    rebuilt = ts.paged_kv.to_dense(
        TT.init_cache(tb.cfg, 2, MAX_LEN, ts.dev_dtype, "cpu"))
    for pos, per in ts.paged_kv.attn_layers.values():
        for k in ("k", "v"):
            assert torch.equal(_bits(rebuilt[pos][k][per]),
                               _bits(ts.dev_caches[pos][k][per]))
    assert (ts.paged_kv.held_pages, ts.page_pool.used_pages,
            out.device_cache_bytes) == (js.paged_kv.held_pages,
                                        js.page_pool.used_pages,
                                        ref.device_cache_bytes)
    dense = TSession(tb, tplan, max_len=MAX_LEN).generate(prompt, 9)
    assert out.device_cache_bytes < dense.device_cache_bytes
    assert ts.sever() == js.sever() > 0
    assert ts.page_pool.used_pages == 0 and ts.paged_kv.resident_bytes == 0


def test_shared_pool_and_exhaustion(pair):
    """Two streams over one pool interleave pages and sever clean; an
    exhausted pool raises ``ServingError``; a recycled page is zeroed."""
    _, tb = pair
    _, tplan = _plans(L)
    pool = segment_page_pool(tb.cfg, 0, L, 1, MAX_LEN, torch.float8_e4m3fn,
                             page_tokens=PAGE, streams=2, device="cpu")
    ses = [TSession(tb, tplan, max_len=MAX_LEN, paged=True, page_tokens=PAGE,
                    page_pool=pool) for _ in range(2)]
    for s in ses:
        s.generate(_prompt(b=1), 6)
    assert pool.used_pages == sum(s.paged_kv.held_pages for s in ses) > 0
    for s in ses:
        s.sever()
    assert pool.used_pages == 0
    small = KVPagePool(2, 4, kvp=1, hd=8, dtype=torch.float32, device="cpu")
    a, _ = small.alloc(), small.alloc()
    assert small.used_bytes == 2 * small.page_bytes == 2 * 2 * 4 * 8 * 4
    with pytest.raises(ServingError, match="exhausted"):
        small.alloc()
    small.data[a] = 7.0
    small.release(a)
    assert small.alloc() == a and torch.all(small.data[a] == 0)
    too_small = KVPagePool(3, PAGE, 2, 64, torch.float8_e4m3fn, "cpu")
    with pytest.raises(ServingError, match="exhausted"):
        TSession(tb, tplan, max_len=MAX_LEN, paged=True, page_tokens=PAGE,
                 page_pool=too_small).generate(_prompt(b=1), 2)


def test_page_ledger_accounting():
    """The fleet's residency twin: the reference's bytes, pages, peak and
    alloc/free counts after the same opens, grows and closes."""
    ops = [("open", 0, 100.0, 2), ("open", 1, 50.0, 1), ("grow", 0, 150.0, 3),
           ("grow", 0, 120.0, 2), ("grow", 7, 10.0, 1), ("open", 1, 80.0, 2),
           ("close", 0), ("grow", 1, 200.0, 4), ("close", 1), ("close", 1)]
    jl, tl = JLedger(), PageLedger()
    for op in ops:
        res = [getattr(led, op[0])(*op[1:]) for led in (jl, tl)]
        assert res[0] == res[1]
        assert (tl.resident_bytes, tl.resident_pages, tl.peak_bytes,
                tl.open_streams, tl.total_page_allocs,
                tl.total_page_frees) == (
            jl.resident_bytes, jl.resident_pages, jl.peak_bytes,
            jl.open_streams, jl.total_page_allocs, jl.total_page_frees)
    assert tl.resident_bytes == 0 and tl.open_streams == 0


def test_knob_errors_are_the_reference(pair):
    """Bad knobs and windowed chunking / speculation raise the
    reference's ``ServingError`` with its message."""
    jb, tb = pair
    jplan, tplan = _plans(1)
    wj = dataclasses.replace(jb, cfg=dataclasses.replace(jb.cfg,
                                                         sliding_window=8))
    wt = dataclasses.replace(tb, cfg=dataclasses.replace(tb.cfg,
                                                         sliding_window=8))
    cases = [(jb, tb, dict(draft_tokens=-1)),
             (jb, tb, dict(prefill_chunk_tokens=1)),
             (jb, tb, dict(paged=True, page_tokens=PAGE,
                           prefill_chunk_tokens=PAGE + 1)),
             (wj, wt, dict(draft_tokens=2)),
             (wj, wt, dict(prefill_chunk_tokens=4))]
    for jback, tback, kw in cases:
        with pytest.raises(JServingError) as jerr:
            JSession(jback, jplan, max_len=MAX_LEN, **kw)
        with pytest.raises(ServingError) as terr:
            TSession(tback, tplan, max_len=MAX_LEN, **kw)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("p", [0, 1, L])
def test_sliding_window_config(pair, p):
    """Window 8, a 13-token prompt (the ring wraps during the prefill):
    the reference's tokens, dense and paged, and paged held pages equal
    to the reference's."""
    jb, tb = pair
    wj = dataclasses.replace(jb, cfg=dataclasses.replace(jb.cfg,
                                                         sliding_window=8))
    wt = dataclasses.replace(tb, cfg=dataclasses.replace(tb.cfg,
                                                         sliding_window=8))
    jplan, tplan = _plans(p)
    prompt = _prompt(s=13, seed=1)
    ref = JSession(wj, jplan, max_len=MAX_LEN).generate(prompt, 12)
    out = TSession(wt, tplan, max_len=MAX_LEN).generate(prompt, 12)
    np.testing.assert_array_equal(out.tokens, ref.tokens)
    if p:
        js = JSession(wj, jplan, max_len=MAX_LEN, paged=True,
                      page_tokens=PAGE)
        ts = TSession(wt, tplan, max_len=MAX_LEN, paged=True,
                      page_tokens=PAGE)
        np.testing.assert_array_equal(ts.generate(prompt, 6).tokens,
                                      js.generate(prompt, 6).tokens)
        assert ts.paged_kv.held_pages == js.paged_kv.held_pages
        assert _trees_bitwise(ts.paged_kv.to_dense(ts.dev_caches),
                              ts.dev_caches)


def test_decode_batcher_order():
    """Continuous batching: the same adds, re-arms and removals give the
    reference's joiners, in its order, and its next round times."""
    jb, tb = JBatcher(), TBatcher()
    rng = np.random.default_rng(0)
    for step in range(60):
        op, idx = rng.integers(4), int(rng.integers(12))
        t = float(rng.uniform(0, 10))
        for b, S in ((jb, JStream), (tb, TStream)):
            if op == 0:
                b.add(S(idx, (idx, 0), f"d{idx}", 5, t, 1.0, 2.0, 0.1))
            elif op == 1:
                b.rearm(idx, t)
            elif op == 2:
                b.remove(idx)
            else:
                b.busy_until = t / 2
        assert [s.index for s in tb.due(t)] == [s.index for s in jb.due(t)]
        assert tb.next_time() == jb.next_time()


def test_deployment_passes_the_knobs(pair):
    """``Deployment.generate(prefill_chunk_tokens=, draft_tokens=)``: the
    served plan's plain tokens, with the rounds, acceptance and chunk
    count in ``measured_decode``."""
    _, tb = pair
    srv = TServer()
    x = _prompt(s=SEQ, b=8, seed=9)
    srv.register("lm", tb, x, x[:, -1])
    m = srv.models["lm"]
    m.s_w, m.s_x, m.rho = np.ones(L), np.ones(L), np.full(L, 0.1)
    m.delta_table = {a: a * 50 for a in srv.levels}
    ctx = (tcm.DeviceProfile(memory_bytes=2e9),
           tcm.Channel(capacity_bps=2e6), tcm.ObjectiveWeights())
    srv.build_store("lm", *ctx)
    dep = srv.serve(TRequest("lm", 0.05, *ctx))
    plain = dep.generate(x[:2, :9], 7)
    out = dep.generate(x[:2, :9], 7, prefill_chunk_tokens=4, draft_tokens=2)
    np.testing.assert_array_equal(out.tokens, plain.tokens)
    meas = dep.result.extra["measured_decode"]
    assert (meas["draft_tokens"], meas["prefill_chunks"], meas["rounds"],
            meas["accept_rate"]) == (2, 2, out.rounds, out.accept_rate)
    srv.record_decode(dep)
    assert srv.ledger.mean_accept_rate == out.accept_rate
