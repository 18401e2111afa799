"""The decode position on the device, on the CPU lane: the plain decode
attention and ``attention_decode`` with a 0-d position tensor bitwise
their host-int calls, and a ``DecodeSession`` — whose plain steps now
run at the device position, the body its CUDA graphs capture on the card
— giving the reference session's greedy tokens at p in {0, 1, L} with
no graph captured. The graphs themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerance against the reference's decode attention: bf16 probabilities
and values, 2e-2, as in tests/test_torch_kernels.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.solver import PartitionPlan as JPlan
from repro.kernels import ref as jref
from repro.serving.backends import TransformerBackend as JBackend
from repro.serving.decode import DecodeSession as JSession
from repro_torch.core.solver import PartitionPlan as TPlan
from repro_torch.kernels import ops
from repro_torch.models import transformer as TT
from repro_torch.models.attention import attention_decode, init_kv_cache
from repro_torch.serving.backends import TransformerBackend as TBackend
from repro_torch.serving.decode import DecodeSession as TSession
from repro_torch.serving.errors import ServingError
from tests._torch_parity import lm_configs, lm_weights, to_numpy, to_torch

BUF = 64
TOL_BF16 = 2e-2
SEQ, MAX_LEN = 12, 32


def _pos_tensors(pos):
    return [torch.tensor(pos, dtype=dt) for dt in (torch.int32, torch.int64)]


@pytest.mark.parametrize("cache", ["bfloat16", "float8_e4m3fn"])
@pytest.mark.parametrize("pos", [0, 14, 15, 16, BUF - 2, BUF - 1,
                                 3 * BUF + 5],
                         ids=["n1", "n15", "n16", "n17", "buf-1", "buf",
                              "wrapped"])
def test_decode_attention_tensor_pos_bitwise_host_int(cache, pos):
    """``ops.decode_attention`` with a 0-d int32 / int64 position tensor
    is bitwise the host-int call at n_valid = pos + 1 (and on a wrapped
    ring), and within 2e-2 of the reference's decode attention."""
    rng = np.random.default_rng(pos)
    q = jnp.asarray(rng.standard_normal((2, 2, 4, 64)), jnp.bfloat16)
    kv = rng.standard_normal((2, 2, BUF, 2, 64))
    ck, cv = (jnp.asarray(a, jnp.float32).astype(cache) for a in kv)
    tq, tk, tv = to_torch(q), to_torch(ck), to_torch(cv)
    want = ops.decode_attention(tq, tk, tv, pos)
    for pos_t in _pos_tensors(pos):
        assert torch.equal(ops.decode_attention(tq, tk, tv, pos_t), want)
    np.testing.assert_allclose(
        to_numpy(want), np.asarray(jref.decode_attention_ref(q, ck, cv, pos),
                                   np.float32), atol=TOL_BF16, rtol=TOL_BF16)


@pytest.mark.parametrize("cache", [torch.float32, torch.float8_e4m3fn])
def test_attention_decode_tensor_pos_bitwise_host_int(cache):
    """``attention_decode`` at a 0-d int64 position gives the host-int
    call's output and ring contents bit for bit, step after step on an
    8-slot ring, before and after it wraps (the device slot's
    ``index_copy_`` is a pure copy, as the host slot's store)."""
    _, cfg = lm_configs()
    params = TT.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    attn = TT.block_at(params, cfg, 0)[0]["attn"]
    host = init_kv_cache(cfg, 2, 8, cache, device="cpu")
    dev = init_kv_cache(cfg, 2, 8, cache, device="cpu")
    pos_t = torch.zeros((), dtype=torch.int64)
    gen = torch.Generator().manual_seed(2)
    for pos in range(19):
        x = torch.randn(2, 1, cfg.d_model, generator=gen)
        pos_t.fill_(pos)
        want, _ = attention_decode(attn, cfg, x, host, pos)
        got, _ = attention_decode(attn, cfg, x, dev, pos_t)
        assert torch.equal(got, want), pos
        for name in ("k", "v"):
            assert torch.equal(dev[name].view(torch.uint8),
                               host[name].view(torch.uint8)), (pos, name)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = lm_configs()
    tree = lm_weights(tcfg)
    jb = JBackend(jcfg, jax.tree.map(jnp.asarray, tree), seq_len=SEQ,
                  decode_max_len=MAX_LEN)
    tb = TBackend(tcfg, TT.params_from_numpy(tree, tcfg, device="cpu"),
                  seq_len=SEQ, decode_max_len=MAX_LEN)
    prompt = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (2, SEQ)).astype(np.int32)
    return jb, tb, prompt


@pytest.mark.parametrize("where", ["p0", "p1", "pL"])
def test_session_at_device_position_matches_reference(pair, where,
                                                      monkeypatch):
    """A CPU session steps eagerly at its device position (no graphs)
    and streams the reference session's tokens on the same 8-bit plan
    through the quantized-kernel segment; no graph is captured."""
    monkeypatch.setenv("REPRO_KERNELS", "reference")
    jb, tb, prompt = pair
    L = tb.num_layers
    p = {"p0": 0, "p1": 1, "pL": L}[where]
    kw = dict(p=p, bits_w=np.full(p, 8.0), bits_x=8.0 if p else 16.0,
              objective=0.0, psi_total=0.0, payload_bits=0.0, breakdown={})
    js = JSession(jb, JPlan(**kw), max_len=MAX_LEN, qkernels=True)
    ts = TSession(tb, TPlan(**kw), max_len=MAX_LEN, qkernels=True)
    want, got = js.generate(prompt, 6), ts.generate(prompt, 6)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert not ts.graphs and ts._held == []     # its own caches, no slot
    assert tb.capture_count == 0
    assert int(ts._pos_t) == ts.pos - 1 == SEQ + 4
    assert ts.last_logits.shape == (2, tb.cfg.padded_vocab())


def test_cpu_session_refuses_graphs(pair):
    """Graphs are the CUDA lane's: a CPU session asked for them raises
    instead of stepping eagerly."""
    _, tb, _ = pair
    plan = TPlan(p=0, bits_w=np.zeros(0), bits_x=16.0, objective=0.0,
                 psi_total=0.0, payload_bits=0.0, breakdown={})
    with pytest.raises(ServingError, match="CUDA graphs"):
        TSession(tb, plan, max_len=MAX_LEN, graphs=True)


def test_step_tokens_are_not_aliased(pair):
    """``step`` hands back a token no later step overwrites (on the card
    the graph's argmax buffer is), and the session's position tensor
    follows ``pos``."""
    _, tb, prompt = pair
    plan = TPlan(p=1, bits_w=np.full(1, 16.0), bits_x=16.0, objective=0.0,
                 psi_total=0.0, payload_bits=0.0, breakdown={})
    sess = TSession(tb, plan, max_len=MAX_LEN)
    toks = [sess.prefill(prompt)]
    for _ in range(4):
        toks.append(sess.step(toks[-1]))
    kept = [t.clone() for t in toks]
    sess.step(toks[-1])
    assert all(torch.equal(a, b) for a, b in zip(toks, kept))
    assert len({t.data_ptr() for t in toks[1:]}) == 4
    assert int(sess._pos_t) == sess.pos - 1


def test_backend_capture_count_starts_at_zero():
    """``capture_count``, the counterpart of the reference's
    ``trace_count``, lives on every backend and is 0 before any
    capture."""
    _, cfg = lm_configs()
    tb = TBackend(dataclasses.replace(cfg), None, seq_len=SEQ)
    assert tb.capture_count == 0
    tb.count_capture()
    assert tb.capture_count == 1
