"""The CUDA kernels against their plain versions on the card, at edge
shapes the smoke run does not reach: ragged M/N/K, float32 activations,
head dim 128, odd sequence lengths, a ring of one slot; for the quantize
kernels ragged rows and columns, a single row, N = 2 packed, grouped
(G, N) metadata and every bit width, bit for bit. The tensor-core route
of flash attention (bf16) runs over ragged S, both head dims and three
GQA groupings; the skinny split-K route of qmatmul and qmatmul4 (M <=
16) over ragged K and N and unaligned codes, with M = 17 crossing into
the tiled route; the tiled tensor-core route (M > 16, bf16 x) at every
projection shape of smollm-135m and ragged ones, unaligned codes and x,
and each output row the same bits at every M; decode attention's cluster
split over every change of
its CTA count up to a 4096-slot ring, wrapped and not; its ring-shard
variant over every shard of four rings (bf16 and float8 shards on the
tensor cores at Gp 1, 4, 7, 16 and hd 64, 128, 256; f32 shards on the
CUDA-core kernel), the position from the host and from the card, and
captured in a CUDA graph; the flash
backward kernel (with the forward's row log-sum-exp) over ragged S,
both head dims, both dtypes and three GQA groupings, zero gradients on
masked keys and zeroed heads, and autograd through the kernel pair.
Each gives the same bits on every call, in one launch. Beside the
kernels: the decode session's page pool on the card (bf16 and float8
pages, the CPU's bits), speculative decode through the kernels, bitwise
plain greedy, and ``lm_loss``'s gradients on the card against the CPU's
plain versions, remat included. The model zoo: qmatmul / qmatmul4 at
OLMoE-1B-7B's K = N = 2048, both attention kernels at its KV 16 x G 1 x
hd 128 heads, and every assigned arch at ``.reduced()`` (MoE, SSM,
hybrid and frontend blocks) in f32 on the card against the CPU. The
decode step's CUDA graphs: decode attention reading its position on the
card bitwise the host-int launch, graphed sessions bitwise eager ones
(tokens and logits) at three cuts, at most 2 captures per stream
whatever its length, launch counters advanced by replays as by eager
steps, and a capture that cannot succeed raising. The speculative
round's graphs: graphed speculative sessions bitwise their eager twins
(tokens, each round's drafts and verified tokens, both caches, launches)
at four cuts and three draft lengths, paged and on a reduced OLMoE, 2
captures per stream whatever its length. The forward family's block
graphs: ``forward``, activations, every start, every p and the
calibration probes bitwise the ``forward_graphs=False`` twin with equal
launches, one capture per block shape at depth 2 and 6, MoE and SSD
blocks in the capture, and a block that cannot be captured raising. The
ring prefill's stage pair (reduced Mamba2 and jamba, a window of 8) at
three cuts over a series of requests at two prompt lengths, bitwise the
``graphs=False`` twin with equal launches (``flash_attention`` and the
tiled ``qmatmul`` inside the captures), captures on a key's second use
only, paged, and a prefill that cannot be captured raising; the
classifier's programs (the MNIST MLP) bitwise their eager twin, one
capture per program and argument, the reference's segment cache keyed
by p, and a program that cannot be captured raising. The host mesh's
train step at one rank over NCCL, its all-reduces inside the captured
graph, bitwise the ungrouped graphed step (dense and MoE); on two cards
or more, the rank programs (the in-place train step over the model axis
and under the FSDP layout, ``generate``'s decode step) graphed on NCCL
ranks, bitwise their eager twins.

Needs an NVIDIA Hopper GPU and nvcc; skips elsewhere. On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import functools
import hashlib
import time

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels import quantize as qk
from repro_torch.kernels.qmatmul import qmatmul4_cuda, qmatmul_cuda
from repro_torch.models.attention import _blocked_causal_attention

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _err(a, b):
    torch.cuda.synchronize()
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("m,k,n", [(1, 7, 2), (3, 33, 130), (65, 100, 66),
                                   (17, 1536, 576)])
@pytest.mark.parametrize("per_col", [False, True])
def test_qmatmul_ragged_f32(gen, packed, m, k, n, per_col):
    """f32 in and out: only the summation order differs (2e-5 of the
    largest output, a few ulp of a K-term f32 sum)."""
    x = torch.randn(m, k, generator=gen, device="cuda")
    codes = torch.randint(0, 16 if packed else 256, (k, n), generator=gen,
                          device="cuda", dtype=torch.uint8)
    shape = (1, n) if per_col else (1, 1)
    scale = torch.rand(shape, generator=gen, device="cuda") * 0.01 + 1e-3
    mu = -torch.rand(shape, generator=gen, device="cuda")
    if packed:
        codes = ref.pack_int4_ref(codes)
    fn = qmatmul4_cuda if packed else qmatmul_cuda
    plain = ref.qmatmul4_ref if packed else ref.qmatmul_ref
    got = fn(x, codes, scale, mu, torch.float32)
    want = plain(x, codes, scale, mu, torch.float32)
    assert _err(got, want) <= 2e-5 * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16,
                                   torch.float8_e4m3fn])
@pytest.mark.parametrize("buf,pos", [(1, 0), (1, 9), (50, 0), (50, 31),
                                     (50, 77)])
def test_decode_attention_edges(gen, dtype, cache, buf, pos):
    q = torch.randn(3, 2, 3, 64, generator=gen, device="cuda").to(dtype)
    ck = torch.randn(3, buf, 2, 64, generator=gen, device="cuda").to(cache)
    cv = torch.randn(3, buf, 2, 64, generator=gen, device="cuda").to(cache)
    tol = 1e-4 if (dtype, cache) == (torch.float32, torch.float32) else 2e-2
    assert _err(decode_attention_cuda(q, ck, cv, pos),
                ref.decode_attention_ref(q, ck, cv, pos)) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,hd", [(1, 64), (63, 64), (65, 128), (200, 64)])
def test_flash_attention_edges(gen, dtype, s, hd):
    q = torch.randn(2, s, 2, 3, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(2, s, 2, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(2, s, 2, hd, generator=gen, device="cuda").to(dtype)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert _err(flash_attention_cuda(q, k, v),
                _blocked_causal_attention(q, k, v, s, s)) <= tol


@pytest.mark.parametrize("kvh,grp", [(1, 1), (4, 4), (2, 8)])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("s", [1, 63, 65, 100, 128, 200])
def test_flash_attention_bf16_tensor_cores(gen, s, hd, kvh, grp):
    """The mma.sync route: within 2e-2 of the plain version (bf16 outputs,
    bf16 probabilities in both), and bitwise the same on a second call."""
    q = torch.randn(2, s, kvh, grp, hd, generator=gen, device="cuda").to(
        torch.bfloat16)
    k = torch.randn(2, s, kvh, hd, generator=gen, device="cuda").to(
        torch.bfloat16)
    v = torch.randn(2, s, kvh, hd, generator=gen, device="cuda").to(
        torch.bfloat16)
    got = flash_attention_cuda(q, k, v)
    assert _err(got, _blocked_causal_attention(q, k, v, s, s)) <= 2e-2
    assert torch.equal(got, flash_attention_cuda(q, k, v))


def _quant_weight(gen, k, n, per_col, levels):
    """A (K, N) weight quantized on a per-tensor or per-column grid of
    ``levels`` steps: uint8 codes and (1, 1) / (1, N) scale and mu."""
    w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
    dims = (0,) if per_col else (0, 1)
    mu = torch.amin(w, dim=dims, keepdim=True).reshape(1, -1)
    scale = ((torch.amax(w, dim=dims, keepdim=True).reshape(1, -1) - mu)
             / levels).clamp(min=1e-12)
    codes = torch.clamp(torch.round((w - mu) / scale), 0,
                        levels).to(torch.uint8)
    return codes, scale.contiguous(), mu.contiguous()


def _int4_weight(gen, k, n, per_col):
    codes, scale, mu = _quant_weight(gen, k, n, per_col, 15)
    return ref.pack_int4_ref(codes), scale, mu


def _held_skinny(fn, plain, x, codes, scale, mu):
    """f32 out within 1e-3 and bf16 out within one bf16 step of the
    largest output, one launch per call, bitwise the same on a second
    call."""
    for out_dtype in (torch.float32, torch.bfloat16):
        before = fn.launches
        got = fn(x, codes, scale, mu, out_dtype)
        assert fn.launches == before + 1
        want = plain(x, codes, scale, mu, out_dtype)
        tol = 1e-3 if out_dtype == torch.float32 else \
            2 ** -7 * want.float().abs().max().item()
        assert _err(got, want) <= tol
        assert torch.equal(got, fn(x, codes, scale, mu, out_dtype))


@pytest.mark.parametrize("per_col", [False, True])
@pytest.mark.parametrize("n", [2, 130, 256, 1536])
@pytest.mark.parametrize("k", [7, 33, 576, 1536])
@pytest.mark.parametrize("m", [1, 2, 4, 16, 17])
def test_qmatmul4_skinny(gen, m, k, n, per_col):
    """M <= 16 runs the split-K cluster route, M = 17 the tiled one: f32
    out within 1e-3 and bf16 out within one bf16 step of the largest
    output, one launch per call, and bitwise the same on a second call."""
    packed, scale, mu = _int4_weight(gen, k, n, per_col)
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    _held_skinny(qmatmul4_cuda, ref.qmatmul4_ref, x, packed, scale, mu)


@pytest.mark.parametrize("per_col", [False, True])
@pytest.mark.parametrize("n", [2, 130, 256, 576, 1536])
@pytest.mark.parametrize("k", [7, 33, 576, 1536])
@pytest.mark.parametrize("m", [1, 2, 4, 16, 17])
def test_qmatmul_skinny(gen, m, k, n, per_col):
    """int8 codes: M <= 16 runs the split-K cluster route (16 codes a
    16-byte vector; N = 2 and 130 load byte by byte, N = 576 ends in a
    ragged tile), M = 17 the tiled one; held as ``test_qmatmul4_skinny``."""
    codes, scale, mu = _quant_weight(gen, k, n, per_col, 255)
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    _held_skinny(qmatmul_cuda, ref.qmatmul_ref, x, codes, scale, mu)


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("per_col", [False, True])
@pytest.mark.parametrize("m,k,n", [(1, 33, 256), (4, 576, 1536),
                                   (16, 1536, 576)])
def test_qmatmul_skinny_unaligned_codes(gen, packed, per_col, m, k, n):
    """Codes one byte past a 16-byte boundary (an N whose rows are whole
    vectors) take the byte-by-byte load of the same kernel."""
    codes, scale, mu = _quant_weight(gen, k, n, per_col, 15 if packed else
                                     255)
    if packed:
        codes = ref.pack_int4_ref(codes)
    store = torch.empty(codes.numel() + 1, dtype=torch.uint8, device="cuda")
    shifted = store[1:].view(codes.shape)
    shifted.copy_(codes)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 1
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    fn, plain = ((qmatmul4_cuda, ref.qmatmul4_ref) if packed else
                 (qmatmul_cuda, ref.qmatmul_ref))
    _held_skinny(fn, plain, x, shifted, scale, mu)


# every projection shape of smollm-135m (wq, wk = wv, wo, w_up = w_gate,
# w_down) and the ragged K / N of the tests above
TILED_SHAPES = [(576, 1024), (576, 256), (1024, 576), (576, 1536),
                (1536, 576), (7, 2), (33, 130), (100, 66)]


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("per_col", [False, True])
@pytest.mark.parametrize("k,n", TILED_SHAPES)
@pytest.mark.parametrize("m", [17, 31, 32, 64, 128, 256, 257])
def test_qmatmul_tiled(gen, m, k, n, per_col, packed):
    """M > 16 with bf16 x runs the tensor-core route (hi/lo bf16 halves of
    each dequantized weight, K split over a cluster): held as the skinny
    route, f32 out within 1e-3 and bf16 out within one bf16 step of the
    largest output, one launch per call, bitwise the same on a second
    call."""
    codes, scale, mu = _quant_weight(gen, k, n, per_col, 15 if packed else
                                     255)
    if packed:
        codes = ref.pack_int4_ref(codes)
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    fn, plain = ((qmatmul4_cuda, ref.qmatmul4_ref) if packed else
                 (qmatmul_cuda, ref.qmatmul_ref))
    _held_skinny(fn, plain, x, codes, scale, mu)


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("per_col", [False, True])
@pytest.mark.parametrize("k,n", [(576, 1536), (1536, 576)])
@pytest.mark.parametrize("m", [32, 128])
@pytest.mark.parametrize("shifted", ["codes", "x"])
def test_qmatmul_tiled_unaligned(gen, shifted, m, k, n, per_col, packed):
    """Codes one byte, or x one element, past a 16-byte boundary take the
    element-by-element loads of the tiled route's same kernel."""
    codes, scale, mu = _quant_weight(gen, k, n, per_col, 15 if packed else
                                     255)
    if packed:
        codes = ref.pack_int4_ref(codes)
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    moved = codes if shifted == "codes" else x
    store = torch.empty(moved.numel() + 1, dtype=moved.dtype, device="cuda")
    off = store[1:].view(moved.shape)
    off.copy_(moved)
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    if shifted == "codes":
        codes = off
    else:
        x = off
    fn, plain = ((qmatmul4_cuda, ref.qmatmul4_ref) if packed else
                 (qmatmul_cuda, ref.qmatmul_ref))
    _held_skinny(fn, plain, x, codes, scale, mu)


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("k,n", TILED_SHAPES)
def test_qmatmul_tiled_rows_independent_of_m(gen, k, n, packed):
    """The tiled route's K split and summation order depend on (K, N)
    alone, so the rows of an M = 32 call are bitwise those rows of an
    M = 128 call (chunked prefill then equals the monolithic one)."""
    codes, scale, mu = _quant_weight(gen, k, n, True, 15 if packed else 255)
    if packed:
        codes = ref.pack_int4_ref(codes)
    fn = qmatmul4_cuda if packed else qmatmul_cuda
    x = torch.randn(128, k, generator=gen, device="cuda").to(torch.bfloat16)
    for out_dtype in (torch.float32, torch.bfloat16):
        whole = fn(x, codes, scale, mu, out_dtype)
        for r0 in (0, 32, 96):
            part = fn(x[r0:r0 + 32].contiguous(), codes, scale, mu,
                      out_dtype)
            assert torch.equal(part, whole[r0:r0 + 32])


@functools.cache
def _split_boundaries(max_slots=4096):
    """Live-slot counts on both sides of every change of the kernel's CTA
    count per head, and 1, 31, 96 and ``max_slots``."""
    from repro_torch.kernels import build
    ctas = build.launcher("decode_attention", "decode_attention_split", "i")
    counts = [ctas(n) for n in range(1, max_slots + 1)]
    edges = {n for n in range(2, max_slots + 1)
             if counts[n - 1] != counts[n - 2]}
    return sorted(edges | {n - 1 for n in edges} | {1, 31, 96, max_slots})


@pytest.mark.parametrize("b,kvp,gp", [(b, kvp, gp) for b in (1, 2, 4)
                                      for kvp in (1, 4) for gp in (3, 4)])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16,
                                   torch.float8_e4m3fn])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_split(gen, dtype, cache, hd, b, kvp, gp):
    """The cluster split over the live slots at every change of its CTA
    count up to a 4096-slot ring: on an unwrapped 4096-slot ring (n live
    slots at pos n - 1) and on a wrapped ring of n slots, within the
    tolerances of ``test_decode_attention_edges``, one launch per call and
    bitwise the same on a second call."""
    ring = 4096
    q = torch.randn(b, kvp, gp, hd, generator=gen, device="cuda").to(dtype)
    ck = torch.randn(b, ring, kvp, hd, generator=gen, device="cuda").to(cache)
    cv = torch.randn(b, ring, kvp, hd, generator=gen, device="cuda").to(cache)
    tol = 1e-4 if (dtype, cache) == (torch.float32, torch.float32) else 2e-2
    for n in _split_boundaries(ring):
        wrapped = (ck[:, :n].contiguous(), cv[:, :n].contiguous(), 3 * n + 2)
        for k_, v_, pos in ((ck, cv, n - 1), wrapped):
            before = decode_attention_cuda.launches
            got = decode_attention_cuda(q, k_, v_, pos)
            assert decode_attention_cuda.launches == before + 1
            err = _err(got, ref.decode_attention_ref(q, k_, v_, pos))
            assert err <= tol, (n, pos, k_.shape[1], err)
            assert torch.equal(got, decode_attention_cuda(q, k_, v_, pos)), \
                (n, pos)


@pytest.mark.parametrize("bits,n", [(8, 768), (5, 768), (3, 33)])
@pytest.mark.parametrize("per_channel", [True, False])
def test_bf16_leaf_quantizes_as_the_cpu(gen, bits, n, per_channel):
    """A bf16 leaf on quantize_stacked's int8-code branch: the kernel
    rounds x - mu and the quotient to bf16, equal to its plain version
    and to the CPU's build byte for byte."""
    from repro_torch.core.quantizer import quantize_stacked
    leaf = (torch.randn(4, 256, n, generator=gen, device="cuda")
            * 0.05).to(torch.bfloat16)
    got = quantize_stacked(leaf, bits, per_channel=per_channel)
    want = quantize_stacked(leaf.cpu(), bits, per_channel=per_channel)
    assert set(got) == set(want) and "codes" in got
    for key in want:
        assert torch.equal(got[key].cpu(), want[key]), key
    flat = leaf.reshape(-1, n)
    s2 = got["scale"].reshape(4, -1)
    m2 = got["mu"].reshape(4, -1)
    assert torch.equal(qk.quantize_cuda(flat, s2, m2, bits, in_x_dtype=True),
                       qk.quantize_plain(flat, s2, m2, bits, in_x_dtype=True))


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    x = torch.randn(2, 8, device="cuda")
    codes = torch.zeros(8, 4, dtype=torch.uint8, device="cuda")
    one = torch.ones(1, 1, device="cuda")
    with pytest.raises(ValueError):
        qmatmul_cuda(x.t(), codes, one, one)                 # not contiguous
    with pytest.raises(ValueError):
        qmatmul_cuda(x, codes.float(), one, one)             # not uint8
    with pytest.raises(ValueError):
        flash_attention_cuda(torch.zeros(1, 4, 1, 1, 32, device="cuda"),
                             torch.zeros(1, 4, 1, 32, device="cuda"),
                             torch.zeros(1, 4, 1, 32, device="cuda"))


def test_decode_attention_rejects_what_the_kernel_does_not_take(gen):
    cache = torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="Gp"):          # Gp > 16
        decode_attention_cuda(torch.zeros(1, 1, 17, 64, device="cuda"),
                              cache, cache, 3)
    odd = torch.zeros(1, 8, 1, 48, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="hd"):          # hd % 32 != 0
        decode_attention_cuda(torch.zeros(1, 1, 4, 48, device="cuda"),
                              odd, odd, 3)
    store = torch.zeros(8 * 64 + 1, dtype=torch.bfloat16, device="cuda")
    shifted = store[1:].view(1, 8, 1, 64)                # 2 bytes off
    with pytest.raises(ValueError, match="aligned"):
        decode_attention_cuda(torch.zeros(1, 1, 4, 64, device="cuda"),
                              shifted, shifted, 3)


def _grid(gen, x, groups, per_col, levels):
    """(G, N) or (G, 1) min/max grid of x (R, N) over groups of rows."""
    r, n = x.shape
    xg = x.float().reshape(groups, r // groups, n)
    dims = (1,) if per_col else (1, 2)
    mu = torch.amin(xg, dim=dims).reshape(groups, -1)
    phi = torch.amax(xg, dim=dims).reshape(groups, -1)
    scale = torch.clamp((phi - mu) / levels, min=1e-12)
    return scale.contiguous(), mu.contiguous()


QUANT_SHAPES = [(1, 2), (1, 7), (3, 2), (5, 130), (33, 66), (64, 1538),
                (577, 1538)]


@pytest.mark.parametrize("r,n", QUANT_SHAPES)
@pytest.mark.parametrize("groups", [1, "rows"])
@pytest.mark.parametrize("per_col", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kernels_bitwise(gen, r, n, groups, per_col, dtype):
    """quantize at 2..8 bits and quantize_pack4 (even N) equal their plain
    versions byte for byte; ``groups="rows"`` gives every row its own
    metadata row (G = R)."""
    g = r if groups == "rows" else 1
    x = (torch.randn(r, n, generator=gen, device="cuda") * 3).to(dtype)
    for bits in range(2, 9):
        scale, mu = _grid(gen, x, g, per_col, (1 << bits) - 1)
        got = qk.quantize_cuda(x, scale, mu, bits)
        assert torch.equal(got, qk.quantize_plain(x, scale, mu, bits))
    if n % 2 == 0:
        scale, mu = _grid(gen, x, g, per_col, 15)
        got = qk.quantize_pack4_cuda(x, scale, mu)
        assert got.shape == (r, n // 2)
        assert torch.equal(got, qk.quantize_pack4_plain(x, scale, mu))


def test_quantize_kernel_rounds_half_to_even(gen):
    """Exact ties (x - mu) / scale = k + 1/2 go to the even k."""
    x = (torch.arange(-8, 120, device="cuda", dtype=torch.float32)
         * 0.5).reshape(2, 64)
    one, zero = torch.ones(1, 1, device="cuda"), torch.zeros(1, 1,
                                                            device="cuda")
    got = qk.quantize_cuda(x, one, zero, 5)
    assert torch.equal(got, qk.quantize_plain(x, one, zero, 5))
    assert got[0, 9].item() == 0 and got[0, 11].item() == 2 \
        and got[0, 13].item() == 2


@pytest.mark.parametrize("r,n", QUANT_SHAPES)
@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("per_col", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_dequantize_kernel_bitwise(gen, r, n, groups, per_col, out_dtype):
    g = groups if r % groups == 0 else 1
    codes = torch.randint(0, 256, (r, n), generator=gen, device="cuda",
                          dtype=torch.uint8)
    scale, mu = _grid(gen, torch.randn(r, n, generator=gen, device="cuda"),
                      g, per_col, 255)
    got = qk.dequantize_cuda(codes, scale, mu, out_dtype)
    assert got.dtype == out_dtype
    assert torch.equal(got, qk.dequantize_plain(codes, scale, mu, out_dtype))


def test_quantize_stacked_leaf_in_one_launch(gen):
    """A stacked (P, K, N) leaf: (P, N) metadata, one launch, the same
    bytes as quantizing each period on its own."""
    from repro_torch.core.quantizer import quantize_stacked
    leaf = torch.randn(5, 96, 130, generator=gen, device="cuda") * 0.05
    for bits, key, fn in ((8, "codes", qk.quantize_cuda),
                          (4, "codes_packed", qk.quantize_pack4_cuda)):
        before = fn.launches
        q = quantize_stacked(leaf, bits)
        assert fn.launches == before + 1
        for p in range(5):
            one = quantize_stacked(leaf[p:p + 1], bits)
            assert torch.equal(q[key][p], one[key][0])


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("per_channel", [True, False])
def test_card_quantizes_as_the_cpu(gen, bits, per_channel):
    """Grids and codes built on the card are the CPU's byte for byte. A
    CUDA tensor divided by a Python number is multiplied by its
    reciprocal instead (an ulp off the quotient in places), so the grid
    step divides by a tensor on the device."""
    from repro_torch.core.quantizer import grid_step, quantize, \
        quantize_stacked
    leaf = torch.randn(6, 96, 130, generator=gen, device="cuda") * 0.05
    got = quantize_stacked(leaf, bits, per_channel=per_channel)
    want = quantize_stacked(leaf.cpu(), bits, per_channel=per_channel)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k
    for a, b in zip(quantize(leaf[0], bits), quantize(leaf[0].cpu(), bits)):
        assert torch.equal(a.cpu(), b)
    span = torch.rand(1 << 16, generator=gen, device="cuda")
    exact = grid_step(span, 255)
    assert torch.equal(exact.cpu(), grid_step(span.cpu(), 255))
    assert (span / 255 != exact).any()       # the reciprocal product


def test_quantize_wrappers_reject_what_the_kernels_do_not_take(gen):
    x = torch.randn(4, 6, device="cuda")
    one, zero = torch.ones(1, 1, device="cuda"), torch.zeros(1, 1,
                                                            device="cuda")
    with pytest.raises(ValueError, match="odd"):
        qk.quantize_pack4_cuda(torch.randn(4, 5, device="cuda"), one, zero)
    with pytest.raises(ValueError):
        qk.quantize_cuda(x.t(), one, zero)                    # not contiguous
    with pytest.raises(ValueError):
        qk.quantize_cuda(x, torch.ones(3, 1, device="cuda"),  # 3 !| 4 rows
                         torch.zeros(3, 1, device="cuda"))
    with pytest.raises(ValueError):
        qk.dequantize_cuda(x, one, zero)                      # not uint8


def _small_lm(seed=0):
    """A 4-layer bf16 smollm-135m cut to d_model 256 on the card."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.backends import TransformerBackend
    cfg = dataclasses.replace(get_config("smollm-135m"), name="smollm-8m",
                              num_layers=4, d_model=256, num_heads=4,
                              num_kv_heads=2, head_dim=64, d_ff=768,
                              vocab_size=256, tp_pad=1)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    return TransformerBackend(cfg, params, seq_len=32, decode_max_len=96)


def _bits(t):
    return t.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn],
                         ids=["bf16", "f8"])
def test_page_pool_on_card_bitwise(gen, dtype):
    """The device-resident page pool: chunk ingests, decode-step appends
    and ring wraparound (a window of 20 over 8-slot pages, the last one
    partial) copy the dense ring's bits into pages on the card, equal to
    the same copies on the CPU; ``to_dense`` rebuilds the ring bit for
    bit."""
    import dataclasses
    from repro_torch.models import transformer as T
    from repro_torch.models.common import to_storage
    from repro_torch.serving.decode.cache import (PagedKVCache,
                                                  segment_page_pool)
    cfg = dataclasses.replace(_small_lm().cfg, sliding_window=20)
    caches = T.init_cache(cfg, 2, 96, dtype, "cuda")
    for c in caches:
        for k in c:
            c[k].copy_(to_storage(torch.randn(c[k].shape, generator=gen,
                                              device="cuda") * 4, dtype))
    twins = []
    for dev, tree in (("cuda", caches),
                      ("cpu", [{k: v.cpu() for k, v in c.items()}
                               for c in caches])):
        pool = segment_page_pool(cfg, 0, 3, 2, 96, dtype, page_tokens=8,
                                 device=dev)
        paged = PagedKVCache(pool, cfg, 0, 3, 2, 96)
        paged.ingest_range(tree, 0, 6)
        paged.ingest_range(tree, 6, 13)
        for pos in range(13, 31):               # wraps the 20-slot ring
            paged.append_step(tree, pos)
        twins.append((pool, paged, tree))
    (pool, paged, tree), (cpu_pool, cpu_paged, _) = twins
    assert paged.held_pages == cpu_paged.held_pages == 3 * 2 * 3
    assert torch.equal(_bits(pool.data).cpu(), _bits(cpu_pool.data))
    rebuilt = paged.to_dense(tree)
    assert all(torch.equal(_bits(a[k]), _bits(b[k]))
               for a, b in zip(rebuilt, tree) for k in a)


def test_speculative_equals_plain_on_card():
    """On the card (int8 wire structs through qmatmul, float8 device
    cache through decode attention): speculative tokens are plain greedy
    bit for bit at 2 and 3 drafts, paged KV included, and ``to_dense``
    equals the dense ring bit for bit."""
    import numpy as np
    from repro_torch.core.solver import PartitionPlan
    from repro_torch.kernels import ops
    from repro_torch.serving.decode import DecodeSession
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    backend = _small_lm()
    prompt = np.random.default_rng(0).integers(0, 256, (2, 24)).astype(
        np.int32)
    for p in (2, 4):
        plan = PartitionPlan(p=p, bits_w=np.full(p, 8.0), bits_x=8.0,
                             objective=0.0, psi_total=0.0, payload_bits=0.0,
                             breakdown={})
        before = ops.KERNELS["qmatmul"].launches
        plain = DecodeSession(backend, plan, max_len=96).generate(prompt, 12)
        assert ops.KERNELS["qmatmul"].launches > before
        for k in (2, 3):
            out = DecodeSession(backend, plan, max_len=96,
                                draft_tokens=k).generate(prompt, 12)
            assert np.array_equal(out.tokens, plain.tokens)
        sess = DecodeSession(backend, plan, max_len=96, paged=True,
                             page_tokens=8, draft_tokens=2)
        out = sess.generate(prompt, 12)
        assert np.array_equal(out.tokens, plain.tokens)
        rebuilt = sess.paged_kv.to_dense(sess.dev_caches)
        assert all(torch.equal(_bits(a[k]), _bits(b[k]))
                   for a, b in zip(rebuilt, sess.dev_caches) for k in a)
        if p == 4:
            assert out.accept_rate == 1.0


def test_fleet_executes_admitted_deployment_on_card():
    """A 20-stream LM fleet over a server calibrated on the card: every
    request terminal, an admitted deployment executes (flash attention)
    and generates (decode attention) through the kernels, its fenced
    stage times fit the calibrated provider, and the fleet prices the
    same trace again from the fitted rates."""
    import dataclasses
    import numpy as np
    from repro_torch.core.cost_model import (Channel, DeviceProfile,
                                             ObjectiveWeights, ServerProfile)
    from repro_torch.kernels import ops
    from repro_torch.serving.qpart_server import QPARTServer
    from repro_torch.serving.testing import poisson_trace
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    backend = _small_lm()
    start = np.random.default_rng(0).integers(0, 256, (8, 1))
    seq = (start + np.arange(33)[None]) % 256
    x, y = seq[:, :32].astype(np.int32), seq[:, 32].astype(np.int32)
    srv = QPARTServer()
    srv.register("lm", backend, x, y)
    srv.calibrate("lm")
    dev, w = DeviceProfile(), ObjectiveWeights()
    srv.build_store("lm", dev, Channel(capacity_bps=2e6), w)
    trace = [dataclasses.replace(r, max_new_tokens=8) for r in poisson_trace(
        "lm", 20, 50.0, [dev], [Channel(capacity_bps=2e6),
                                Channel(capacity_bps=2e8)], w,
        budgets=(0.01, 0.02), deadlines=(0.5, 2.0), device_pool=5, seed=0)]
    kw = dict(servers=[ServerProfile()] * 2, policy="edf", slo="observe",
              epoch_interval=0.01)
    metrics = srv.fleet(**kw).run(trace)
    metrics.assert_terminal()
    dep = metrics.completed()[0].deployment
    names = ("flash_attention", "decode_attention")
    before = {k: ops.KERNELS[k].launches for k in names}
    res = dep.execute(x, y)
    out = dep.generate(x[:2, :16], 8)
    for k in names:
        assert ops.KERNELS[k].launches > before[k], k
    assert out.tokens.shape == (2, 8) and np.isfinite(res.accuracy)
    assert ((out.tokens >= 0) & (out.tokens < 256)).all()
    srv.record_execution(dep)
    srv.record_decode(dep)
    cal = srv.calibrated_provider()
    again = srv.fleet(provider=cal, **kw).run(trace)
    again.assert_terminal()
    assert again.summary()["completed"] == len(trace)


def _attn_grad_inputs(gen, s, kvh, grp, hd, dtype, b=2):
    q = torch.randn(b, s, kvh, grp, hd, generator=gen, device="cuda")
    k = torch.randn(b, s, kvh, hd, generator=gen, device="cuda")
    v = torch.randn(b, s, kvh, hd, generator=gen, device="cuda")
    do = torch.randn(b, s, kvh, grp, hd, generator=gen, device="cuda")
    return tuple(t.to(dtype) for t in (q, k, v, do))


def _rel_err(got, want):
    """max |got - want| over the larger of 1 and max |want| (a gradient
    that cancels to ~0, as dk at S = 1, is held absolutely)."""
    return _err(got, want) / max(1.0, want.float().abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("s", [1, 31, 64, 65, 100, 128, 200])
@pytest.mark.parametrize("kvh,grp", [(1, 1), (2, 3), (4, 4)])
def test_flash_attention_bwd(gen, dtype, hd, s, kvh, grp):
    """The forward's row log-sum-exp within 1e-4 of the plain one; the
    backward kernel within 1e-4 (f32) or one bf16 step, 2^-7 (bf16), of
    the plain backward on the same out and lse, within 1e-4 (f32) or
    2^-6 (bf16) of torch autograd of the plain forward, one launch per
    call, and bitwise the same on a second call. S = 64 and 128 end the
    64-row and 64-key tiles exactly; at S = 200, KV 4, G 4 the bf16 dK/dV
    kernel splits each key block's walk over two cluster ranks."""
    _held_bwd(gen, 2, s, kvh, grp, hd, dtype)


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_bwd_training_shape(gen, hd):
    """As above at smollm-135m's training shape (B 8, S 256, KV 4, G 4
    after tp_pad, bf16), where the dK/dV kernel splits each key block's
    walk over a cluster of ranks and sums their partials."""
    _held_bwd(gen, 8, 256, 4, 4, hd, torch.bfloat16)


# sha256 of the float32 backward's dq, dk, dv bytes on the case below,
# as the CUDA-core kernels gave them before the bfloat16 route moved to
# the tensor cores (H100, CUDA 12.8); ``chip_smoke.py --profile-flash``
# prints the same digest for any tree
F32_BWD_SHA256 = (
    "cf5fae4fb4627856a1d7d6670c3791b3d286871d638c37d1804009d1de2a7720")


def test_flash_attention_bwd_f32_route_unchanged(gen):
    """The float32 route (the CUDA-core kernels) on a fixed case from
    NumPy's generator: its output bits are those it gave before the
    bfloat16 route's redesign (a digest), within 1e-4 of the plain
    backward, and the same on every call."""
    import hashlib

    import numpy as np
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    rng = np.random.default_rng(19)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).cuda() for shape in (
            (2, 100, 4, 4, 64), (2, 100, 4, 64), (2, 100, 4, 64),
            (2, 100, 4, 4, 64)))
    out, lse = flash_attention_cuda(q, k, v, with_lse=True)
    got = flash_attention_bwd_cuda(q, k, v, out, lse, do)
    assert hashlib.sha256(b"".join(t.cpu().numpy().tobytes()
                                   for t in got)).hexdigest() == \
        F32_BWD_SHA256
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do)
    for g_, w in zip(got, want):
        assert _rel_err(g_, w) <= 1e-4
    for _ in range(3):
        again = flash_attention_bwd_cuda(q, k, v, out, lse, do)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def _held_bwd(gen, b, s, kvh, grp, hd, dtype):
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    q, k, v, do = _attn_grad_inputs(gen, s, kvh, grp, hd, dtype, b=b)
    out, lse = flash_attention_cuda(q, k, v, with_lse=True)
    assert torch.equal(out, flash_attention_cuda(q, k, v))
    assert _rel_err(lse, ref.flash_attention_lse_ref(q, k)) <= 1e-4
    before = flash_attention_bwd_cuda.launches
    got = flash_attention_bwd_cuda(q, k, v, out, lse, do)
    assert flash_attention_bwd_cuda.launches == before + 1
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert _rel_err(g, w) <= tol
    # autograd of the plain forward rounds nothing the kernels round
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    auto = torch.autograd.grad(_blocked_causal_attention(*leaves, s, s),
                               leaves, do)
    auto_tol = 1e-4 if dtype == torch.float32 else 2 ** -6
    for g, w in zip(got, auto):
        assert _rel_err(g, w) <= auto_tol
    again = flash_attention_bwd_cuda(q, k, v, out, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_masked_and_padded_heads(gen, dtype):
    """A head whose output gradient is zero (a padded head, zeroed after
    attention by the model's mask) gets exactly zero dq; the last key,
    which only the last position's rows see, exactly zero dk and dv once
    those rows' gradient is zero."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    q, k, v, do = _attn_grad_inputs(gen, 70, 2, 4, 64, dtype)
    do[:, :, :, 3] = 0
    do[:, -1] = 0
    out, lse = flash_attention_cuda(q, k, v, with_lse=True)
    dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert (dq[:, :, :, 3] == 0).all()
    assert (dk[:, -1] == 0).all() and (dv[:, -1] == 0).all()
    assert dq.abs().amax() > 0 and dk.abs().amax() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_on_card(gen, dtype):
    """``ops.flash_attention`` on leaves that want a gradient: the forward
    kernel (with its lse) and then the backward kernel, once each, and
    the gradients those of torch autograd through the plain version on
    the card."""
    from repro_torch.kernels import ops
    q, k, v, do = _attn_grad_inputs(gen, 96, 2, 2, 64, dtype)
    fwd, bwd = ops.KERNELS["flash_attention"], ops.KERNELS[
        "flash_attention_bwd"]
    before = (fwd.launches, bwd.launches)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*leaves, 96, 96), leaves,
                              do)
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(_blocked_causal_attention(*plain, 96, 96),
                               plain, do)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= tol


def test_flash_attention_bwd_rejects_what_the_kernel_does_not_take(gen):
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    q, k, v, do = _attn_grad_inputs(gen, 8, 1, 2, 64, torch.float32)
    out, lse = flash_attention_cuda(q, k, v, with_lse=True)
    with pytest.raises(ValueError, match="lse"):             # lse dtype
        flash_attention_bwd_cuda(q, k, v, out, lse.bfloat16(), do)
    with pytest.raises(ValueError, match="lse"):             # lse shape
        flash_attention_bwd_cuda(q, k, v, out, lse[:, :4], do)
    with pytest.raises(ValueError):                          # d_out dtype
        flash_attention_bwd_cuda(q, k, v, out, lse, do.bfloat16())
    with pytest.raises(ValueError):                          # not contiguous
        flash_attention_bwd_cuda(q, k, v, out, lse,
                                 torch.cat([do, do], dim=-1)[..., :64])
    with pytest.raises(ValueError):                          # head dim 32
        flash_attention_bwd_cuda(q[..., :32].contiguous(),
                                 k[..., :32].contiguous(),
                                 v[..., :32].contiguous(),
                                 out[..., :32].contiguous(), lse,
                                 do[..., :32].contiguous())
    with pytest.raises(ValueError):                          # on the CPU
        flash_attention_bwd_cuda(q.cpu(), k.cpu(), v.cpu(), out.cpu(),
                                 lse.cpu(), do.cpu())


def test_lm_gradients_on_card_match_cpu():
    """The 4-layer f32 smollm-8m with padded heads (tp_pad=16): every
    leaf's gradient of ``lm_loss`` through the kernels on the card within
    1e-3 of its largest magnitude of the plain versions' on the CPU;
    with remat, the forward kernel launches twice per layer and the
    gradients are the same bits as without."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.train.train_loop import value_and_grad
    from repro_torch.tree import tree_leaves, tree_map
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg = dataclasses.replace(
        get_config("smollm-135m"), name="smollm-8m", num_layers=4,
        d_model=256, num_heads=4, num_kv_heads=2, head_dim=64, d_ff=768,
        vocab_size=250, tp_pad=16, dtype="float32")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=g,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (l_cpu, _), g_cpu = value_and_grad(params, cfg, batch, False)
    on_card = tree_map(lambda t: t.cuda(), params)
    card_batch = {k: t.cuda() for k, t in batch.items()}
    fwd, bwd = ops.KERNELS["flash_attention"], ops.KERNELS[
        "flash_attention_bwd"]
    counts = []
    grads = []
    for remat in (False, True):
        before = (fwd.launches, bwd.launches)
        (loss, _), gr = value_and_grad(on_card, cfg, card_batch, remat)
        torch.cuda.synchronize()
        counts.append((fwd.launches - before[0], bwd.launches - before[1]))
        grads.append(gr)
        assert abs(loss.item() - l_cpu.item()) <= 1e-4 * abs(l_cpu.item())
    L = cfg.num_layers
    assert counts == [(L, L), (2 * L, L)]
    for a, b, c in zip(tree_leaves(grads[0]), tree_leaves(grads[1]),
                       tree_leaves(g_cpu)):
        assert torch.equal(a, b)
        assert _err(a.cpu(), c) <= 1e-3 * max(c.abs().max().item(), 1e-12)


# ---------------------------------------------------------------------------
# The model zoo's shapes on the card: OLMoE-1B-7B's attention (K = N = 2048
# projections, KV 16 x G 1 at head dim 128), and every assigned arch at
# .reduced() against the CPU.

@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("per_col", [False, True])
@pytest.mark.parametrize("m", [1, 2, 4, 16, 17, 128, 256])
def test_qmatmul_olmoe_projection(gen, m, per_col, packed):
    """wq = wk = wv = wo of OLMoE-1B-7B (K = N = 2048): decode M on the
    skinny route, prefill M on the tiled one, held as
    ``test_qmatmul_skinny``."""
    k = n = 2048
    codes, scale, mu = _quant_weight(gen, k, n, per_col, 15 if packed else
                                     255)
    if packed:
        codes = ref.pack_int4_ref(codes)
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    fn, plain = ((qmatmul4_cuda, ref.qmatmul4_ref) if packed else
                 (qmatmul_cuda, ref.qmatmul_ref))
    _held_skinny(fn, plain, x, codes, scale, mu)


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("m", [2, 4, 17, 128, 256])
def test_qmatmul_olmoe_projection_f32(gen, m, packed):
    """f32 x at K = N = 2048 (the skinny route to M = 16, the CUDA-core
    tiled route above): held as ``test_qmatmul_ragged_f32``."""
    k = n = 2048
    codes, scale, mu = _quant_weight(gen, k, n, True, 15 if packed else 255)
    if packed:
        codes = ref.pack_int4_ref(codes)
    x = torch.randn(m, k, generator=gen, device="cuda")
    fn, plain = ((qmatmul4_cuda, ref.qmatmul4_ref) if packed else
                 (qmatmul_cuda, ref.qmatmul_ref))
    got = fn(x, codes, scale, mu, torch.float32)
    want = plain(x, codes, scale, mu, torch.float32)
    assert _err(got, want) <= 2e-5 * max(1.0, want.abs().max().item())
    assert torch.equal(got, fn(x, codes, scale, mu, torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s", [(4, 1), (4, 64), (2, 100), (16, 128)])
def test_flash_attention_olmoe_heads(gen, dtype, b, s):
    """KV 16, G 1, hd 128 (OLMoE's heads: no grouping), within the
    tolerances of ``test_flash_attention_edges``, bitwise the same on a
    second call."""
    q = torch.randn(b, s, 16, 1, 128, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, s, 16, 128, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, s, 16, 128, generator=gen, device="cuda").to(dtype)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    got = flash_attention_cuda(q, k, v)
    assert _err(got, _blocked_causal_attention(q, k, v, s, s)) <= tol
    assert torch.equal(got, flash_attention_cuda(q, k, v))


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16,
                                   torch.float8_e4m3fn])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_olmoe_heads(gen, dtype, cache):
    """B 4, KVp 16, Gp 1, hd 128 on the launcher's 96-slot ring, filled
    and wrapped, within the tolerances of ``test_decode_attention_edges``,
    one launch per call, bitwise the same on a second call."""
    q = torch.randn(4, 16, 1, 128, generator=gen, device="cuda").to(dtype)
    ck = torch.randn(4, 96, 16, 128, generator=gen, device="cuda").to(cache)
    cv = torch.randn(4, 96, 16, 128, generator=gen, device="cuda").to(cache)
    tol = 1e-4 if (dtype, cache) == (torch.float32, torch.float32) else 2e-2
    for pos in (0, 63, 94, 95, 126):
        before = decode_attention_cuda.launches
        got = decode_attention_cuda(q, ck, cv, pos)
        assert decode_attention_cuda.launches == before + 1
        assert _err(got, ref.decode_attention_ref(q, ck, cv, pos)) <= tol
        assert torch.equal(got, decode_attention_cuda(q, ck, cv, pos))


@pytest.mark.parametrize("arch", ["smollm-135m", "olmoe-1b-7b", "qwen3-14b",
                                  "musicgen-medium", "mamba2-1.3b",
                                  "qwen2-vl-72b", "dbrx-132b", "chatglm3-6b",
                                  "qwen1.5-4b", "jamba-v0.1-52b"])
def test_reduced_zoo_on_card_matches_cpu(gen, arch):
    """Each assigned arch at ``.reduced()`` in f32 through the kernels on
    the card against the plain versions on the CPU, same weights:
    ``forward`` logits and router aux, ``prefill`` logits and four
    ``decode_step``s (frontend archs through ``embeds=``, qwen2-vl with
    M-RoPE triples). Logits within 1e-3 of the largest, aux within 1e-4
    relative; every attention arch launches both attention kernels."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.frontend import mrope_positions, stub_embeddings
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    cpu = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    b, s = 2, 16
    if cfg.frontend != "none":
        inp = {"embeds": stub_embeddings(g, cfg, b, s, torch.float32)}
        steps = [stub_embeddings(g, cfg, b, 1, torch.float32)
                 for _ in range(4)]
    else:
        inp = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                       generator=g, dtype=torch.int32)}
        steps = [torch.randint(0, cfg.vocab_size, (b, 1), generator=g,
                               dtype=torch.int32) for _ in range(4)]
    if cfg.rope == "mrope":
        inp["positions"] = mrope_positions(b, s, (2, 2), device="cpu")

    def run(params, device):
        kw = {k: v.to(device) for k, v in inp.items()}
        tokens = kw.pop("tokens", None)
        logits, aux = T.forward(params, cfg, tokens, **kw)
        pre, caches, _ = T.prefill(params, cfg, tokens, max_len=s + 4,
                                   cache_dtype=torch.float32, **kw)
        outs = [logits, pre]
        for i, x in enumerate(steps):
            lg, caches = T.decode_step(params, cfg, x.to(device), caches,
                                       s + i)
            outs.append(lg)
        return [o.cpu() for o in outs], aux

    want, want_aux = run(cpu, "cpu")
    before = {k: ops.KERNELS[k].launches for k in ("flash_attention",
                                                   "decode_attention")}
    got, got_aux = run(tree_map(lambda t: t.cuda(), cpu), "cuda")
    top = max(w.abs().max().item() for w in want)
    for a, w in zip(got, want):
        assert _err(a, w) <= 1e-3 * top
    for k in want_aux:
        assert abs(float(got_aux[k]) - float(want_aux[k])) <= \
            1e-4 * max(abs(float(want_aux[k])), 1e-30), k
    ran = {k: ops.KERNELS[k].launches - n for k, n in before.items()}
    assert all(ran.values()) == (cfg.attn_every != 0), ran


@pytest.mark.parametrize("quant", [0, 8])
def test_decode_step_within_its_counted_roofline(gen, quant):
    """The dry run's count of one decode step (full-width smollm-135m,
    batch 4, a 96-slot cache at position 72) beside the real step on the
    card: the counted FLOPs and bytes over the data-sheet rates, divided
    by the step's measured device-busy and wall time, never exceed 1.05
    — a higher share would mean the count holds work the card did not
    do."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_config
    from repro_torch.core.quantizer import quantize_params_for_serving
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.roofline import op_cost
    from repro_torch.roofline.analysis import analyze
    cfg = get_config("smollm-135m")
    batch, cache_len, pos, reps = 4, 96, 72, 8
    params = T.init_params(cfg, gen, device="cuda")
    fake = steps.param_specs(cfg)
    mode = steps.fake_mode_of(fake)
    if quant:
        params = quantize_params_for_serving(params, quant)
        with mode:
            fake = quantize_params_for_serving(fake, quant)
    serve = steps.make_serve_step(cfg)
    caches = T.init_cache(cfg, batch, cache_len, device="cuda")
    token = torch.zeros((batch, 1), dtype=torch.int32, device="cuda")
    serve(params, token, caches, pos)                       # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            serve(params, token, caches, pos)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    busy_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA) \
        / reps / 1e3
    f_caches = steps.cache_specs(cfg, batch, cache_len, mode=mode)
    with mode:
        f_token = torch.empty((batch, 1), dtype=torch.int32)
    summary = op_cost.count(lambda p, t, c: serve(p, t, c, pos), fake,
                            f_token, f_caches)
    roof = analyze(summary, arch=cfg.name, shape="decode")
    assert summary.kernel_calls["decode_attention"] == cfg.num_layers
    assert busy_ms > 0
    for term in (roof.t_compute, roof.t_memory):
        for ms in (busy_ms, wall_ms):
            assert 0 < term * 1e3 / ms <= 1.05, (term, busy_ms, wall_ms)


@pytest.mark.parametrize("ring,cache", [(256, torch.bfloat16),
                                        (256, torch.float8_e4m3fn),
                                        (2048, torch.bfloat16),
                                        (4096, torch.float8_e4m3fn)])
@pytest.mark.parametrize("hd", [64, 128])
def test_decode_attention_device_pos_bitwise_host_int(gen, ring, cache, hd):
    """The position read by the kernel from a 0-d int32 / int64 tensor on
    the card gives the host-int launch's bits at every change of the CTA
    count up to the ring and on the wrapped ring, one launch per call;
    the plain version with a tensor position gives its int call's bits;
    and the kernel stays within ``test_decode_attention_edges``' 2e-2 of
    the plain version."""
    b, kvp, gp = 2, 4, 4
    q = torch.randn(b, kvp, gp, hd, generator=gen, device="cuda").to(
        torch.bfloat16)
    ck = torch.randn(b, ring, kvp, hd, generator=gen, device="cuda").to(cache)
    cv = torch.randn(b, ring, kvp, hd, generator=gen, device="cuda").to(cache)
    positions = [n - 1 for n in _split_boundaries(ring)] + [3 * ring + 5]
    for pos in positions:
        want = decode_attention_cuda(q, ck, cv, pos)
        plain = ref.decode_attention_ref(q, ck, cv, pos)
        for dt in (torch.int32, torch.int64):
            pos_t = torch.tensor(pos, dtype=dt, device="cuda")
            before = decode_attention_cuda.launches
            got = decode_attention_cuda(q, ck, cv, pos_t)
            assert decode_attention_cuda.launches == before + 1
            assert torch.equal(got, want), (pos, dt)
            assert torch.equal(ref.decode_attention_ref(q, ck, cv, pos_t),
                               plain), (pos, dt)
        assert _err(want, plain) <= 2e-2, pos


def _plan(p, bits=8.0):
    import numpy as np
    from repro_torch.core.solver import PartitionPlan
    return PartitionPlan(p=p, bits_w=np.full(p, bits), bits_x=bits,
                         objective=0.0, psi_total=0.0, payload_bits=0.0,
                         breakdown={})


def _prompt(b=2, s=24):
    import numpy as np
    return np.random.default_rng(0).integers(0, 256, (b, s)).astype(np.int32)


# stage keys a graphed plain stream runs at p = 0 / 2 / 4 of the 4-layer
# model: the prefill chunk's pair (no device stage at p = 0, no server
# stage at p = L) and the step's pair (no device stage at p = 0); the
# first stream captures the step's stages (used more than once), the
# second the prefill chunk's
STREAM_KEYS = {0: 2, 2: 4, 4: 3}
FIRST_STREAM_CAPTURES = {0: 1, 2: 2, 4: 2}


def _second_uses(uses, sess) -> int:
    """How many stage keys ``sess``'s stream used for the second time —
    what it captured (a key's first use runs eagerly, its second
    captures); ``uses``, the backend's uses of each key before the
    stream, is updated."""
    n = sum(1 for key, c in sess.graph_keys.items()
            if uses[key] < 2 <= uses[key] + c)
    uses.update(sess.graph_keys)
    return n


@pytest.mark.parametrize("p", [0, 2, 4])
def test_graphed_decode_bitwise_eager(gen, p):
    """At three cuts of the 4-layer model (int8 wire structs, float8
    device cache): the graphed session's first token, tokens and its
    logits at every step (the server graph's static output) bitwise the
    eager session's on the same plan; the step's stages captured on
    their second use. Later graphed ``generate`` calls on the slots it
    gave back give the eager tokens: the second captures the prefill
    chunk's stages, the third nothing."""
    import numpy as np
    from repro_torch.serving.decode import DecodeSession
    backend = _small_lm()
    plan, prompt = _plan(p), _prompt()
    eager = DecodeSession(backend, plan, max_len=96, graphs=False)
    graphed = DecodeSession(backend, plan, max_len=96)
    assert graphed.graphs and not eager.graphs
    before = backend.capture_count
    te, tg = eager.prefill(prompt), graphed.prefill(prompt)
    assert torch.equal(te, tg)
    for i in range(6):
        te, tg = eager.step(te), graphed.step(tg)
        assert torch.equal(te, tg), i
        assert torch.equal(eager.last_logits, graphed.last_logits), i
    assert backend.capture_count - before == FIRST_STREAM_CAPTURES[p]
    assert len(graphed.graph_keys) == STREAM_KEYS[p]
    graphed.sever()
    want = DecodeSession(backend, plan, max_len=96,
                         graphs=False).generate(prompt, 12)
    counts = []
    for _ in range(2):
        before = backend.capture_count
        again = DecodeSession(backend, plan, max_len=96)
        got = again.generate(prompt, 12)
        assert np.array_equal(got.tokens, want.tokens)
        counts.append(backend.capture_count - before)
        assert again.graph_keys.keys() == graphed.graph_keys.keys()
    assert counts == [STREAM_KEYS[p] - FIRST_STREAM_CAPTURES[p], 0]


def test_capture_count_does_not_grow_with_tokens(gen):
    """A 6-token generation at a cut captures the step's 2 stage graphs
    (on the step's second use), a 64-token one after it on the same
    backend the prefill chunk's 2 (the chunk's second use), and another
    64-token one none: compile once, replay per token and per
    session."""
    from repro_torch.serving.decode import DecodeSession
    backend = _small_lm()
    plan, prompt = _plan(2), _prompt()
    counts = []
    for n in (6, 64, 64):
        before = backend.capture_count
        DecodeSession(backend, plan, max_len=96).generate(prompt, n)
        counts.append(backend.capture_count - before)
    assert counts == [2, 2, 0]


def test_graphed_launch_counters_equal_eager(gen):
    """Replays advance the kernels' launch counters, and a watched
    stand-in's, by what the captured step launched: a graphed
    ``generate`` counts the eager one's launches exactly."""
    from repro_torch.kernels import ops
    from repro_torch.serving.decode import DecodeSession

    class Watched:
        launches = 0

    watched = Watched()
    ops.watch_counter(watched)
    wrapped = ops.decode_attention_cuda

    def counting(*args, **kwargs):
        watched.launches += 1
        return wrapped(*args, **kwargs)

    ops.decode_attention_cuda = counting
    try:
        backend = _small_lm()
        plan, prompt = _plan(2), _prompt()
        runs = []
        for graphs in (False, True):
            torch.cuda.synchronize()
            before = {k: f.launches for k, f in ops.KERNELS.items()}
            w0 = watched.launches
            DecodeSession(backend, plan, max_len=96,
                          graphs=graphs).generate(prompt, 16)
            runs.append(({k: f.launches - before[k]
                          for k, f in ops.KERNELS.items()},
                         watched.launches - w0))
    finally:
        ops.decode_attention_cuda = wrapped
        ops.COUNTERS.remove((watched, "launches"))
    assert runs[0] == runs[1]
    assert runs[0][0]["decode_attention"] == runs[0][1] > 0
    assert runs[0][0]["qmatmul"] > 0


def test_capture_that_cannot_succeed_raises(gen, monkeypatch):
    """A step that reads the card from the host cannot be captured: its
    first use runs eagerly, its second too, then the server stage's
    capture raises (the session does not carry on eagerly) and puts the
    launch counters back, so they hold the eager step's launches; the
    device stage's graph stays cached, the server stage's is not."""
    from repro_torch.kernels import ops
    from repro_torch.serving.decode import DecodeSession
    backend = _small_lm()
    twin = DecodeSession(backend, _plan(2), max_len=96, graphs=False)
    tok = twin.prefill(_prompt())
    before = {k: f.launches for k, f in ops.KERNELS.items()}
    twin.step(tok)
    eager = {k: f.launches - before[k] for k, f in ops.KERNELS.items()}
    sess = DecodeSession(backend, _plan(2), max_len=96)
    hidden_logits = backend.hidden_logits

    def synced(h, params=None):
        float(h.float().sum())              # a host read inside the step
        return hidden_logits(h, params)

    monkeypatch.setattr(backend, "hidden_logits", synced)
    tok = sess.prefill(_prompt())       # the unembed runs outside graphs
    tok = sess.step(tok)                # the first use: eager
    before = {k: f.launches for k, f in ops.KERNELS.items()}
    with pytest.raises(RuntimeError):
        sess.step(tok)
    torch.cuda.synchronize()
    assert {k: f.launches - before[k] for k, f in ops.KERNELS.items()} == \
        eager
    cached = {name for entry in backend.__dict__["_stage_graphs"].values()
              for name in entry.graphs}
    assert cached == {"device"}


def _small_moe(seed=0):
    """OLMoE-1B-7B at ``.reduced()`` (2 layers, 4 experts top-2, bf16) on
    the card."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.backends import TransformerBackend
    cfg = get_config("olmoe-1b-7b").reduced()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    return TransformerBackend(cfg, params, seq_len=32, decode_max_len=96)


def _spec_twins(backend, plan, k, n=16, **kw):
    """A speculative session run eagerly (``graphs=False``) and graphed on
    one prompt: per session its result, every round's drafts and verified
    tokens (``_round_ids``' host copies), launches per kernel and
    captures."""
    from repro_torch.kernels import ops
    from repro_torch.serving.decode import DecodeSession
    prompt = _prompt()
    runs = []
    for graphs in (False, True):
        sess = DecodeSession(backend, plan, max_len=96, draft_tokens=k,
                             graphs=graphs, **kw)
        seen, ids = [], sess._round_ids
        sess._round_ids = lambda d, g: seen.append(ids(d, g)) or seen[-1]
        torch.cuda.synchronize()
        before = {name: f.launches for name, f in ops.KERNELS.items()}
        captured = backend.capture_count
        out = sess.generate(prompt, n)
        torch.cuda.synchronize()
        runs.append({"sess": sess, "out": out, "rounds": seen,
                     "launches": {name: f.launches - before[name]
                                  for name, f in ops.KERNELS.items()},
                     "captures": backend.capture_count - captured})
    return runs


def _assert_twins_bitwise(eager, graphed, k, uses=None):
    """Tokens, each round's drafts and verified tokens, both caches and
    the launches of the graphed session equal its eager twin's; the
    graphed stream ran its two round stages at each k it drafted and
    captured the keys it used for the second time (``uses``: the
    backend's uses before it; none on a fresh backend), the eager
    none."""
    import collections
    import numpy as np
    assert np.array_equal(graphed["out"].tokens, eager["out"].tokens)
    assert len(graphed["rounds"]) == len(eager["rounds"])
    for (dg, gg), (de, ge) in zip(graphed["rounds"], eager["rounds"]):
        assert np.array_equal(dg, de) and np.array_equal(gg, ge)
    for side in ("dev_caches", "srv_caches"):
        a, b = getattr(graphed["sess"], side), getattr(eager["sess"], side)
        if a is not None:
            assert all(torch.equal(_bits(x[n]), _bits(y[n]))
                       for x, y in zip(a, b) for n in x), side
    assert graphed["launches"] == eager["launches"]
    keys = graphed["sess"].graph_keys
    assert eager["captures"] == 0
    assert graphed["captures"] == _second_uses(
        collections.Counter() if uses is None else uses, graphed["sess"])
    assert {"spec_device", "spec_server"} <= {key[0] for key in keys}
    assert {key[2] - 1 for key in keys if key[0] == "spec_device"} == \
        {d.shape[1] for d, _ in graphed["rounds"]}


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("p", [0, 1, 2, 4])
def test_graphed_speculative_bitwise_eager(gen, p, k):
    """At p = 0, 1, L/2 and L of the 4-layer model (int8 wire structs,
    float8 device cache) and k = 1, 2, 3: the graphed speculative
    session (each stage key captured on its first use, replayed after)
    gives its ``graphs=False`` twin's tokens, drafts and verified tokens
    per round, both caches bit for bit and the same launches, one
    capture per key used twice; at p = L every draft is accepted."""
    eager, graphed = _spec_twins(_small_lm(), _plan(p), k)
    _assert_twins_bitwise(eager, graphed, k)
    if p == 4:
        assert graphed["out"].accept_rate == 1.0


@pytest.mark.parametrize("case", ["paged", "moe"])
def test_graphed_speculative_paged_and_moe(gen, case):
    """Paged KV (8-token pages, chunked prefill, draft 2; the pages
    ingested between the two stages, ``to_dense`` bitwise the ring) and
    a reduced OLMoE (MoE blocks in the captured rounds, draft 3, p = 1):
    the graphed session bitwise its eager twin, and both plain greedy."""
    import numpy as np
    from repro_torch.serving.decode import DecodeSession
    if case == "paged":
        backend, p, k = _small_lm(), 2, 2
        kw = dict(paged=True, page_tokens=8, prefill_chunk_tokens=8)
    else:
        backend, p, k, kw = _small_moe(), 1, 3, {}
    eager, graphed = _spec_twins(backend, _plan(p), k, n=20, **kw)
    _assert_twins_bitwise(eager, graphed, k)
    if case == "paged":
        sess = graphed["sess"]
        rebuilt = sess.paged_kv.to_dense(sess.dev_caches)
        assert all(torch.equal(_bits(a[n]), _bits(b[n]))
                   for a, b in zip(rebuilt, sess.dev_caches) for n in a)
        assert sess.paged_kv.held_pages == eager["sess"].paged_kv.held_pages
    plain = DecodeSession(backend, _plan(p), max_len=96,
                          **kw).generate(_prompt(), 20)
    assert np.array_equal(graphed["out"].tokens, plain.tokens)


def test_speculative_captures_do_not_grow_with_tokens(gen):
    """Speculative streams of 8, 64, 64 and 64 tokens on one backend:
    each captures only the keys it uses for the second time (the first
    its rounds at k, later ones the prefill and the tail rounds), the
    fourth none; replays advance the launch counters as eager rounds
    do."""
    import collections
    backend, plan = _small_lm(), _plan(2)
    counts, uses = [], collections.Counter()
    for n in (8, 64, 64, 64):
        eager, graphed = _spec_twins(backend, plan, 2, n=n)
        assert graphed["launches"] == eager["launches"]
        assert graphed["launches"]["decode_attention"] > 0
        assert np.array_equal(graphed["out"].tokens, eager["out"].tokens)
        assert graphed["captures"] == _second_uses(uses, graphed["sess"])
        counts.append(graphed["captures"])
    assert counts[0] > 0 and counts[3] == 0


def test_extend_device_offset_bitwise_host_int(gen):
    """On the card, chunk by chunk (8-row chunks of a 24-token prompt:
    the skinny qmatmul route at M = 16; the whole prompt: the tiled one
    at M = 48), the device segment's extend from wire structs into a
    float8 cache and the server's into a bf16 cache at a 0-d int64
    offset give the host-int offset's rows and caches bit for bit."""
    from repro_torch.models import transformer as T
    backend = _small_lm()
    plan = _plan(2)
    dev_params = backend.qstacked_for(backend.split(plan), plan)
    emb = backend.embed(_prompt())
    for bounds in ([(0, 8), (8, 16), (16, 24)], [(0, 24)]):
        for params, (start, stop), dt in (
                (dev_params, (0, 2), torch.float8_e4m3fn),
                (backend.params, (2, 4), torch.bfloat16)):
            host = T.init_cache(backend.cfg, 2, 96, dt, "cuda")
            dev = T.init_cache(backend.cfg, 2, 96, dt, "cuda")
            offset = torch.zeros((), dtype=torch.int64, device="cuda")
            for lo, hi in bounds:
                offset.fill_(lo)
                want, _ = T.segment_extend(params, backend.cfg,
                                           emb[:, lo:hi], host, lo, start,
                                           stop)
                got, _ = T.segment_extend(params, backend.cfg,
                                          emb[:, lo:hi], dev, offset, start,
                                          stop)
                assert torch.equal(_bits(got), _bits(want)), (lo, start)
                assert all(torch.equal(_bits(a[n]), _bits(b[n]))
                           for a, b in zip(dev, host) for n in a)


@pytest.mark.parametrize("chunk", [None, 8], ids=["monolithic", "chunk8"])
def test_graphed_prefill_bitwise_eager(gen, chunk):
    """The graphed prefill (the monolithic one, captured by the second
    session and replayed by the third, or 8-token chunks with the chunk
    offset on the card, captured at the second chunk and replayed from
    the third) gives the eager prefill's first token, its logits and
    both caches bit for bit with the same launches; the last graphed
    session of the shape replays every chunk and captures nothing."""
    from repro_torch.kernels import ops
    from repro_torch.serving.decode import DecodeSession
    backend, plan, prompt = _small_lm(), _plan(2), _prompt()
    runs = {}
    for graphs in (False, True, True, True):
        sess = DecodeSession(backend, plan, max_len=96, graphs=graphs,
                             prefill_chunk_tokens=chunk)
        torch.cuda.synchronize()
        before = {k: f.launches for k, f in ops.KERNELS.items()}
        captured = backend.capture_count
        seen = []
        hidden_logits = backend.hidden_logits
        backend.hidden_logits = lambda h, params=None: seen.append(
            hidden_logits(h, params)) or seen[-1]
        try:
            tok = sess.prefill(prompt)
        finally:
            del backend.hidden_logits
        torch.cuda.synchronize()
        runs.setdefault(graphs, []).append(dict(
            sess=sess, tok=tok, logits=seen[-1],
            launches={k: f.launches - before[k]
                      for k, f in ops.KERNELS.items()},
            captures=backend.capture_count - captured))
        if graphs:
            sess.sever()
    (eager,), graphed = runs[False], runs[True]
    # one chunk length either way: one pair of stage graphs, on its
    # second use
    assert [r["captures"] for r in [eager] + graphed] == \
        ([0, 0, 2, 0] if chunk is None else [0, 2, 0, 0])
    for got in graphed:
        assert torch.equal(got["tok"], eager["tok"])
        assert torch.equal(got["logits"], eager["logits"])
        assert got["launches"] == eager["launches"]
        for side in ("dev_caches", "srv_caches"):
            assert all(torch.equal(_bits(a[n]), _bits(b[n])) for a, b in
                       zip(getattr(got["sess"], side),
                           getattr(eager["sess"], side)) for n in a), side
    assert eager["launches"]["qmatmul"] > 0


def test_session_series_on_one_backend(gen):
    """QPART's request loop on one backend, one fresh session per
    request: per mode (plain, chunks of 8, drafting 2) three graphed
    requests of 24 tokens and one of 16, each bitwise its
    ``graphs=False`` twin (a session with caches of its own) with the
    same launches, on the same slots; each captures the stage keys it
    uses for the second time, so request 3 captures nothing. Then two
    live sessions hold distinct slots and step to the twin's tokens."""
    import collections
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serving.decode import DecodeSession
    backend, plan = _small_lm(), _plan(2)
    long, short = _prompt(), _prompt(s=16)
    modes = {"plain": {}, "chunk8": dict(prefill_chunk_tokens=8),
             "draft2": dict(draft_tokens=2)}
    uses = collections.Counter()
    for name, kw in modes.items():
        slots = set()
        for i, prompt in enumerate((long, long, long, short)):
            out = {}
            for graphs in (False, True):
                sess = DecodeSession(backend, plan, max_len=96,
                                     graphs=graphs, **kw)
                torch.cuda.synchronize()
                before = {k: f.launches for k, f in ops.KERNELS.items()}
                captured = backend.capture_count
                res = sess.generate(prompt, 16)
                torch.cuda.synchronize()
                out[graphs] = (res, {k: f.launches - before[k]
                                     for k, f in ops.KERNELS.items()},
                               backend.capture_count - captured, sess)
            (want, la, ca, _), (got, lb, cb, sess) = out[False], out[True]
            assert np.array_equal(got.tokens, want.tokens), (name, i)
            assert la == lb and ca == 0, (name, i)
            assert cb == _second_uses(uses, sess), (name, i)
            if i == 2:
                assert cb == 0, (name, i)
            slots.add((sess._dev_slot, sess._srv_slot))
        assert len(slots) == 1, name
    a, b = (DecodeSession(backend, plan, max_len=96) for _ in range(2))
    twin = DecodeSession(backend, plan, max_len=96, graphs=False)
    ta, tb_, tt = (s.prefill(long) for s in (a, b, twin))
    assert not set(a._held) & set(b._held)
    for _ in range(4):
        ta, tb_, tt = a.step(ta), b.step(tb_), twin.step(tt)
        assert torch.equal(ta, tt) and torch.equal(tb_, tt)


def _launcher(quant, b=4, s=24, seed=0):
    """The 4-layer model of ``_small_lm`` as the serving launcher serves
    it (``--quant`` 0 / 8 / 4) and a seeded (b, s) prompt on the card."""
    from repro_torch.core.quantizer import quantize_params_for_serving
    backend = _small_lm(seed)
    params = backend.params
    if quant:
        params = quantize_params_for_serving(params, quant)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    prompt = torch.randint(0, backend.cfg.vocab_size, (b, s), generator=g,
                           device="cuda", dtype=torch.int32)
    return backend.cfg, params, prompt


@pytest.mark.parametrize("quant,temperature", [(0, 0.0), (8, 0.0),
                                               (4, 0.0), (8, 1.0)],
                         ids=["q0", "q8", "q4", "q8-sampled"])
def test_launcher_graphed_bitwise_eager(gen, quant, temperature):
    """``launch.serve.generate`` replaying its one whole-model graph
    gives the eager call's tokens bit for bit (sampled: with generators
    of one seed), and its last step, a replayed one, the eager step's
    logits at the same position; 1 capture against 0."""
    from repro_torch.launch import serve
    cfg, params, prompt = _launcher(quant)
    out = {}
    for graphs in (False, True):
        stats = {}
        g = torch.Generator(device="cuda").manual_seed(7)
        toks = serve.generate(params, cfg, prompt, max_len=40, gen=12,
                              temperature=temperature, generator=g,
                              stats=stats, graphs=graphs)
        out[graphs] = (toks, stats)
    (te, se), (tg, sg) = out[False], out[True]
    assert torch.equal(te, tg)
    assert torch.equal(se["last_logits"], sg["last_logits"])
    assert (se["captures"], sg["captures"]) == (0, 1)
    # the default on the card is the graph
    stats = {}
    serve.generate(params, cfg, prompt, max_len=40, gen=4, stats=stats)
    assert stats["captures"] == 1


def test_launcher_captures_do_not_grow_with_tokens(gen):
    """A 6-token and a 64-token launcher generation each capture one
    graph: compile once per call, replay per token."""
    from repro_torch.launch import serve
    cfg, params, prompt = _launcher(8)
    counts = []
    for n in (6, 64):
        stats = {}
        serve.generate(params, cfg, prompt, max_len=24 + n, gen=n,
                       stats=stats)
        counts.append(stats["captures"])
    assert counts == [1, 1]


def test_launcher_graphed_counters_equal_eager(gen):
    """A graphed launcher ``generate`` counts the eager one's launches
    kernel by kernel, a watched stand-in's included."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    class Watched:
        launches = 0

    watched = Watched()
    ops.watch_counter(watched)
    wrapped = ops.qmatmul_cuda

    def counting(*args, **kwargs):
        watched.launches += 1
        return wrapped(*args, **kwargs)

    ops.qmatmul_cuda = counting
    try:
        cfg, params, prompt = _launcher(8)
        runs = []
        for graphs in (False, True):
            torch.cuda.synchronize()
            before = {k: f.launches for k, f in ops.KERNELS.items()}
            w0 = watched.launches
            serve.generate(params, cfg, prompt, max_len=40, gen=16,
                           graphs=graphs)
            runs.append(({k: f.launches - before[k]
                          for k, f in ops.KERNELS.items()},
                         watched.launches - w0))
    finally:
        ops.qmatmul_cuda = wrapped
        ops.COUNTERS.remove((watched, "launches"))
    assert runs[0] == runs[1]
    assert runs[0][0]["qmatmul"] == runs[0][1] > 0
    assert runs[0][0]["decode_attention"] > 0


def test_launcher_capture_that_cannot_succeed_raises(gen, monkeypatch):
    """A serve step that reads the card from the host cannot be
    captured: ``generate`` raises at its second step, nothing runs it
    eagerly instead, and the counters hold the eager prefill's and first
    step's launches only."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg, params, prompt = _launcher(8)
    unembed = T._unembed

    def synced(params, cfg, x, **kw):
        float(x.float().sum())              # a host read inside the step
        return unembed(params, cfg, x, **kw)

    monkeypatch.setattr(T, "_unembed", synced)
    counts = []
    for graphs, n in ((False, 2), (True, 8)):
        torch.cuda.synchronize()
        before = {k: f.launches for k, f in ops.KERNELS.items()}
        if graphs:
            with pytest.raises(RuntimeError):
                serve.generate(params, cfg, prompt, max_len=40, gen=n,
                               graphs=True)
        else:
            serve.generate(params, cfg, prompt, max_len=40, gen=n,
                           graphs=False)
        torch.cuda.synchronize()
        counts.append({k: f.launches - before[k]
                       for k, f in ops.KERNELS.items()})
    assert counts[0] == counts[1]


def _forward_twins(backend):
    """``backend`` with its forward family graphed (the default on the
    card) and a ``forward_graphs=False`` twin on the same params."""
    import dataclasses
    graphed = dataclasses.replace(backend)
    eager = dataclasses.replace(backend, forward_graphs=False)
    return graphed, eager


def _counted(fn):
    """``fn()`` and the kernels' launches it made."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    before = {k: f.launches for k, f in ops.KERNELS.items()}
    out = fn()
    torch.cuda.synchronize()
    return out, {k: f.launches - before[k] for k, f in ops.KERNELS.items()}


def test_forward_family_graphed_bitwise_eager(gen):
    """The forward family through the block graphs on the card (bf16,
    the flash kernel inside the capture): ``forward`` three times,
    ``layer_activations``, ``forward_from_layer`` at every start,
    ``execute_plan`` at every p and ``calibrate_probes`` bitwise the
    ``forward_graphs=False`` twin, with equal launches; one capture for
    the one (B, S), none after it."""
    backend = _small_lm()
    graphed, eager = _forward_twins(backend)
    x = _prompt(4, 32)
    for _ in range(3):
        got, n_got = _counted(lambda: graphed.forward(x))
        want, n_want = _counted(lambda: eager.forward(x))
        assert torch.equal(got, want) and n_got == n_want
    assert n_got["flash_attention"] == 4
    assert graphed.capture_count == 1 and eager.capture_count == 0
    acts, logits = graphed.layer_activations(x)
    wacts, wlogits = eager.layer_activations(x)
    assert torch.equal(logits, wlogits)
    assert all(torch.equal(a, w) for a, w in zip(acts, wacts))
    for l in range(4):
        assert torch.equal(graphed.forward_from_layer(acts[l], l),
                           eager.forward_from_layer(wacts[l], l)), l
    for p in range(5):
        got, n_got = _counted(lambda: graphed.execute_plan(_plan(p), x))
        want, n_want = _counted(lambda: eager.execute_plan(_plan(p), x))
        assert torch.equal(got, want) and n_got == n_want, p
    (e_w, e_x, lg), n_got = _counted(lambda: graphed.calibrate_probes(x))
    (w_w, w_x, wl), n_want = _counted(lambda: eager.calibrate_probes(x))
    assert np.array_equal(e_w, w_w) and np.array_equal(e_x, w_x)
    assert torch.equal(lg, wl) and n_got == n_want
    assert graphed.capture_count == 1


def test_forward_graphs_depth_independent(gen):
    """``TestCompileOnce`` on the card: forward, activations, every
    start and every p at depth 2 and 6 capture once each."""
    import dataclasses
    from repro_torch.models import transformer as T
    from repro_torch.serving.backends import TransformerBackend
    counts = {}
    for layers in (2, 6):
        cfg = dataclasses.replace(_small_lm().cfg, num_layers=layers)
        params = T.init_params(cfg, torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
        be = TransformerBackend(cfg, params, seq_len=32)
        x = _prompt(2, 32)
        be.forward(x)
        acts, _ = be.layer_activations(x)
        for l in range(layers):
            be.forward_from_layer(acts[l], l)
        for p in range(1, layers + 1):
            be.execute_plan(_plan(p), x)
        counts[layers] = be.capture_count
    assert counts[2] == counts[6] == 1, counts


@pytest.mark.parametrize("arch", ["olmoe", "mamba2"])
def test_forward_graphs_moe_and_ssm(gen, arch):
    """A MoE block (reduced OLMoE) and an SSD block (reduced Mamba2) in
    the capture: ``forward`` and ``calibrate_probes`` bitwise the eager
    twin, one capture."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.backends import TransformerBackend
    if arch == "olmoe":
        backend = _small_moe()
    else:
        cfg = get_config("mamba2-1.3b").reduced()
        params = T.init_params(cfg, torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
        backend = TransformerBackend(cfg, params, seq_len=32)
    graphed, eager = _forward_twins(backend)
    x = _prompt(2, 32)
    for _ in range(3):
        assert torch.equal(graphed.forward(x), eager.forward(x))
    got, want = graphed.calibrate_probes(x), eager.calibrate_probes(x)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert torch.equal(got[2], want[2])
    assert graphed.capture_count == 1


def test_forward_capture_that_cannot_succeed_raises(gen, monkeypatch):
    """A block that reads the card from the host cannot be captured: the
    key's second use raises (nothing runs it eagerly instead)."""
    from repro_torch.models import transformer as T
    backend = _small_lm()
    apply_block = T.apply_block

    def synced(bp, cfg, pos, x, positions, **kw):
        float(x.float().sum())              # a host read inside the block
        return apply_block(bp, cfg, pos, x, positions, **kw)

    monkeypatch.setattr(T, "apply_block", synced)
    with pytest.raises(RuntimeError):
        backend.forward(_prompt(2, 32))
    assert backend.capture_count == 0


def _ring_backend(arch):
    """A ring-prefill stack on the card: Mamba2-1.3B or jamba at
    ``.reduced()`` (bf16; jamba's layer 0 an SSD block, layer 1
    attention with MoE), or the small LM with a window of 8."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.backends import TransformerBackend
    if arch == "window":
        backend = _small_lm()
        return dataclasses.replace(backend, cfg=dataclasses.replace(
            backend.cfg, sliding_window=8))
    cfg = get_config({"mamba2": "mamba2-1.3b",
                      "jamba": "jamba-v0.1-52b"}[arch]).reduced()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        0), device="cuda")
    return TransformerBackend(cfg, params, seq_len=32, decode_max_len=96)


def _prefill_run(backend, plan, prompt, graphs, seg, n=8):
    """One request on a fresh session: its prefill, then ``n - 1``
    steps -> the prefill's token, its logits and both caches after it
    (copies), the tokens, each kernel's launches, the captures and the
    session (its stream ended)."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serving.decode import DecodeSession
    sess = DecodeSession(backend, plan, max_len=96, graphs=graphs,
                         segment=seg)
    torch.cuda.synchronize()
    before = {k: f.launches for k, f in ops.KERNELS.items()}
    captured = backend.capture_count
    tok = sess.prefill(prompt)
    logits = sess.last_logits.clone()
    caches = [{k: _bits(v).clone() for k, v in tree.items()}
              for side in (sess.dev_caches or [], sess.srv_caches)
              for tree in side]
    tokens = [tok.cpu().numpy()]
    for _ in range(n - 1):
        tokens.append(sess.step(torch.from_numpy(tokens[-1]).cuda())
                      .cpu().numpy())
    sess.sever()
    torch.cuda.synchronize()
    return dict(tok=tok, logits=logits, caches=caches,
                tokens=np.stack(tokens, 1),
                launches={k: f.launches - before[k]
                          for k, f in ops.KERNELS.items()},
                captures=backend.capture_count - captured, sess=sess)


@pytest.mark.parametrize("cut", ["p0", "half", "pL"])
@pytest.mark.parametrize("arch", ["mamba2", "jamba", "window"])
def test_graphed_ring_prefill_bitwise_eager(gen, arch, cut):
    """The ring prefill's stage pair on the card (QPART's loop: a fresh
    session per request on one backend, 8-bit plan, wire-struct device
    segment): four requests at 24 tokens, then three at 2 (shorter than
    the conv ring), each bitwise its ``graphs=False`` twin (the first
    token, its logits, both caches after the prefill, the tokens) with
    the same launches — jamba's attention runs ``flash_attention``
    inside the server prefill graph, and at p = L the tiled ``qmatmul``
    inside the device one; each request captures exactly the stage keys
    it uses for the second time, so requests 3-4 of a length capture
    nothing."""
    import collections
    import numpy as np
    backend = _ring_backend(arch)
    L = backend.num_layers
    p = {"p0": 0, "half": L // 2, "pL": L}[cut]
    plan = _plan(p)
    seg = backend.split(plan) if p else None
    uses = collections.Counter()
    for i, s in enumerate((24,) * 4 + (2,) * 3):
        prompt = _prompt(s=s)
        want = _prefill_run(backend, plan, prompt, False, seg)
        got = _prefill_run(backend, plan, prompt, True, seg)
        assert torch.equal(got["tok"], want["tok"]), (i, s)
        assert torch.equal(got["logits"], want["logits"]), (i, s)
        assert all(torch.equal(a[k], b[k]) for a, b in
                   zip(got["caches"], want["caches"]) for k in a), (i, s)
        assert np.array_equal(got["tokens"], want["tokens"]), (i, s)
        assert got["launches"] == want["launches"], (i, s)
        assert want["captures"] == 0
        assert got["captures"] == _second_uses(uses, got["sess"]), (i, s)
        if i in (2, 3, 6):
            assert got["captures"] == 0, (i, s)
    if arch == "jamba":
        assert want["launches"]["flash_attention"] > 0
        if p == L:
            assert want["launches"]["qmatmul"] > 0


def test_graphed_ring_prefill_paged(gen):
    """A paged ring session (the window's ring at p = 2): three requests
    bitwise the eager session's tokens and pages, the third replaying
    both prefill stages."""
    import numpy as np
    from repro_torch.serving.decode import DecodeSession
    backend = _ring_backend("window")
    plan, prompt = _plan(2), _prompt(s=24)
    seg = backend.split(plan)
    want = DecodeSession(backend, plan, max_len=96, graphs=False,
                         segment=seg, paged=True, page_tokens=8)
    want_tokens = want.generate(prompt, 8).tokens
    for i in range(3):
        sess = DecodeSession(backend, plan, max_len=96, segment=seg,
                             paged=True, page_tokens=8)
        before = backend.capture_count
        assert np.array_equal(sess.generate(prompt, 8).tokens, want_tokens)
        assert sess.paged_kv.held_pages == want.paged_kv.held_pages
        if i == 2:
            assert backend.capture_count == before


def _mnist_backend():
    """The paper's MNIST MLP (784-512-256-128-64-32-10, f32) on the card,
    seeded."""
    from repro_torch.configs.classifier import MNIST_MLP
    from repro_torch.models.classifier import init_classifier
    from repro_torch.serving.backends import ClassifierBackend
    params = init_classifier(MNIST_MLP, torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    return ClassifierBackend(MNIST_MLP, params)


def test_classifier_graphs_bitwise_eager(gen):
    """The classifier's programs through their graphs on the card:
    ``forward``, ``layer_activations``, ``forward_from_layer`` at every
    start, ``run_prefix`` at every p and ``calibrate_probes``, three
    times each, bitwise the ``forward_graphs=False`` twin; one capture
    per (program, argument), none after; no kernel launches (plain
    PyTorch)."""
    import dataclasses
    import numpy as np
    backend = _mnist_backend()
    graphed = dataclasses.replace(backend)
    eager = dataclasses.replace(backend, forward_graphs=False)
    L = backend.num_layers
    x = np.random.default_rng(0).uniform(0, 1, (64, 28, 28)).astype(
        np.float32)
    acts, _ = eager.layer_activations(x)
    calls = [lambda b: [b.forward(x)],
             lambda b: (lambda a: [*a[0], a[1]])(b.layer_activations(x)),
             *[lambda b, l=l: [b.forward_from_layer(acts[l], l)]
               for l in range(L)],
             *[lambda b, p=p: [b.run_prefix(x, p)] for p in range(1, L + 1)],
             lambda b: list(b.calibrate_probes(x))]
    for call in calls:
        for _ in range(3):
            got, n_got = _counted(lambda: call(graphed))
            want, n_want = _counted(lambda: call(eager))
            assert not any(n_got.values()) and not any(n_want.values())
            for g, w in zip(got, want):
                assert (np.array_equal(g, w) if isinstance(g, np.ndarray)
                        else torch.equal(g, w))
    assert graphed.capture_count == 2 * L + 3
    assert eager.capture_count == 0


def test_classifier_segment_cache_keyed_by_p_on_card(gen):
    """The reference's ``test_classifier_segment_cache_keyed_by_p`` on
    the card: after one ``forward``, three executions at p = 3 capture
    the ``("prefix", 3)`` and ``("from_layer", 3)`` programs, bitwise
    the eager twin's, and a fourth captures nothing; a capture that
    cannot succeed raises."""
    import dataclasses
    import numpy as np
    from repro_torch.serving.backends import classifier as cls
    backend = _mnist_backend()
    eager = dataclasses.replace(backend, forward_graphs=False)
    x = np.random.default_rng(1).uniform(0, 1, (32, 28, 28)).astype(
        np.float32)
    backend.forward(x)
    n0 = backend.capture_count
    for _ in range(3):
        assert torch.equal(backend.execute_plan(_plan(3), x),
                           eager.execute_plan(_plan(3), x))
    assert backend.capture_count - n0 == 2
    backend.execute_plan(_plan(3), x)
    assert backend.capture_count - n0 == 2
    flat_input = cls.flat_input

    def synced(a, cfg):
        float(a.sum())                      # a host read inside a program
        return flat_input(a, cfg)

    cls.flat_input = synced
    try:
        backend.run_prefix(x, 2)
        with pytest.raises(RuntimeError):
            backend.run_prefix(x, 2)
    finally:
        cls.flat_input = flat_input
    assert backend.capture_count - n0 == 2


def test_ring_capture_that_cannot_succeed_raises(gen, monkeypatch):
    """A ring prefill whose server stage reads the card from the host
    cannot be captured: the key's first use runs eagerly, its second
    too, then the server stage's capture raises (nothing runs it
    eagerly instead) and puts the launch counters back, so they hold
    the eager prefill's launches; the device stage's graph stays
    cached, the server stage's is not."""
    from repro_torch.kernels import ops
    from repro_torch.serving.decode import DecodeSession
    backend, plan, prompt = _ring_backend("jamba"), _plan(1), _prompt(s=24)
    seg = backend.split(plan)
    twin = DecodeSession(backend, plan, max_len=96, segment=seg,
                         graphs=False)
    _, eager = _counted(lambda: twin.prefill(prompt))
    hidden_logits = backend.hidden_logits

    def synced(h, params=None):
        float(h.float().sum())              # a host read inside the stage
        return hidden_logits(h, params)

    monkeypatch.setattr(backend, "hidden_logits", synced)
    first = DecodeSession(backend, plan, max_len=96, segment=seg)
    first.prefill(prompt)                   # the first use: eager
    first.sever()
    sess = DecodeSession(backend, plan, max_len=96, segment=seg)
    torch.cuda.synchronize()
    before = {k: f.launches for k, f in ops.KERNELS.items()}
    with pytest.raises(RuntimeError):
        sess.prefill(prompt)
    torch.cuda.synchronize()
    assert {k: f.launches - before[k] for k, f in ops.KERNELS.items()} == \
        eager
    assert eager["flash_attention"] == 1
    cached = {name for entry in backend.__dict__["_stage_graphs"].values()
              for name in entry.graphs}
    assert cached == {"prefill_device"}


# ---------------------------------------------------------------------------
# The training programs as CUDA graphs: the donated step and the sampler

def _train_case(kind, b=4, s=64, group=None):
    """(step, params, opt state, batches) of a small bf16 train step on
    the card: a 2-layer smollm-135m, a reduced OLMoE, a reduced MusicGen
    fed through ``embeds=``, remat, ``accum_steps=2``; the step
    all-reduces over ``group`` when one is given."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.frontend import stub_embeddings
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step
    arch = {"moe": "olmoe-1b-7b", "embeds": "musicgen-medium"}.get(
        kind, "smollm-135m")
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=2)
    g = torch.Generator(device="cuda").manual_seed(3)
    params = T.init_params(cfg, g, device="cuda")
    batches = []
    for _ in range(6):
        toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g,
                             device="cuda", dtype=torch.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if kind == "embeds":
            batch = {"embeds": stub_embeddings(g, cfg, b, s),
                     "labels": batch["labels"]}
        batches.append(batch)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2,
                                            total_steps=8),
                           remat=kind == "remat",
                           accum_steps=2 if kind == "accum2" else 1,
                           group=group)
    return step, params, init_opt_state(params), batches


def _train_run(step, params, opt_state, batches, n):
    """``n`` steps of ``step`` -> (each step's metrics copied, the final
    trees, the launches by kernel)."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    before = {k: f.launches for k, f in ops.KERNELS.items()}
    metrics = []
    for batch in batches[:n]:
        params, opt_state, m = step(params, opt_state, batch)
        metrics.append({k: v.clone() for k, v in m.items()})
    torch.cuda.synchronize()
    return metrics, (params, opt_state), {
        k: f.launches - before[k] for k, f in ops.KERNELS.items()}


def _trees_equal(a, b):
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("kind", ["dense", "moe", "embeds", "remat",
                                  "accum2"])
def test_train_step_graphed_bitwise_eager(gen, kind):
    """Four steps through ``DonatedStep`` (eager, capture + replay, two
    replays) give the plain step's metrics, params, moments and ``step``
    bit for bit, launch the flash kernels as often (through the replays'
    counters), capture once, and hand back the trees they were handed
    from the capture on."""
    from repro_torch.train.graphs import DonatedStep
    from repro_torch.tree import tree_map
    step, params, opt_state, batches = _train_case(kind)
    eager = _train_run(step, params, opt_state, batches, 4)
    donated = DonatedStep(step)
    start = tree_map(torch.clone, (params, opt_state))
    graphed = _train_run(donated, *start, batches, 4)
    assert donated.captures == 1
    for me, mg in zip(eager[0], graphed[0]):
        assert _trees_equal(me, mg)
    assert _trees_equal(eager[1], graphed[1])
    assert eager[2] == graphed[2] and eager[2]["flash_attention_bwd"] > 0


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_train_step_one_nccl_rank_bitwise_ungrouped(gen, kind):
    """The host mesh's step at one rank over NCCL (``make_train_step
    (group=)`` through ``DonatedStep``: eager, then captured with its
    all-reduces inside, then replays) gives the ungrouped graphed step's
    metrics, params, moments and ``step`` bit for bit, with one capture
    and the same launches."""
    from repro_torch.launch import distributed
    from repro_torch.train.graphs import DonatedStep
    step, params, opt_state, batches = _train_case(kind)
    ungrouped = DonatedStep(step)
    want = _train_run(ungrouped, params, opt_state, batches, 4)
    with distributed.process_group("cuda") as group:
        step, params, opt_state, batches = _train_case(kind, group=group)
        grouped = DonatedStep(step)
        got = _train_run(grouped, params, opt_state, batches, 4)
    assert (ungrouped.captures, grouped.captures) == (1, 1)
    for mw, mg in zip(want[0], got[0]):
        assert _trees_equal(mw, mg)
    assert _trees_equal(want[1], got[1])
    assert want[2] == got[2] and got[2]["flash_attention_bwd"] > 0


def test_rank_programs_graphed_bitwise_eager_on_nccl(gen):
    """On two cards or more, one NCCL rank a card (two ranks): the
    in-place train step over the model axis and under the FSDP layout,
    graphed through ``DonatedStep`` with its collectives inside, gives
    its eager twin's metrics and every leaf bit for bit, captures once,
    copies nothing back and launches the flash kernels as often (through
    the replays' counters); ``generate``'s graphed decode step gives the
    ``graphs=False`` tokens and last logits, one capture a call."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: NCCL takes one rank a card")
    from repro_torch.launch import distributed
    import _torch_fsdp_ranks as ranks
    for by_program in distributed.spawn(ranks.graphed_twins, 2, "cuda"):
        for name, rec in by_program.items():
            eager, graphed = rec["launches"]
            assert rec["metrics_bitwise"] and rec["state_bitwise"], name
            assert rec["captures"] == 1 and rec["write_back"] == [0], name
            assert eager == graphed and graphed["flash_attention_bwd"] > 0
            assert rec["tokens_bitwise"] and rec["logits_bitwise"], name
            assert rec["generate_captures"] == 1, name


def test_train_step_captures_once_per_key(gen):
    """Six steps capture once; another batch shape is another key, eager
    on its first use and captured on its second; the first key's graph
    replays on after it."""
    from repro_torch.train.graphs import DonatedStep
    step, params, opt_state, batches = _train_case("dense")
    donated = DonatedStep(step)
    for batch in batches:
        params, opt_state, _ = donated(params, opt_state, batch)
    assert donated.captures == 1
    short = {k: v[:, :32] for k, v in batches[0].items()}
    for n in (1, 2, 3):
        params, opt_state, _ = donated(params, opt_state, short)
        assert donated.captures == (1 if n == 1 else 2)
    params, opt_state, _ = donated(params, opt_state, batches[0])
    assert donated.captures == 2 and int(opt_state["step"]) == 10


def test_train_capture_that_cannot_succeed_raises(gen, monkeypatch):
    """A step that reads the card from the host cannot be captured: the
    second call raises (nothing runs it eagerly instead), the donated
    state has not moved, and the counters hold the first call's
    launches only."""
    from repro_torch.kernels import ops
    from repro_torch.train import train_loop
    from repro_torch.train.graphs import DonatedStep
    from repro_torch.tree import tree_map
    step, params, opt_state, batches = _train_case("dense")
    lm_loss = train_loop.lm_loss

    def synced(*args, **kwargs):
        total, metrics = lm_loss(*args, **kwargs)
        float(total)                        # a host read inside the step
        return total, metrics

    monkeypatch.setattr(train_loop, "lm_loss", synced)
    donated = DonatedStep(step)
    torch.cuda.synchronize()
    before = {k: f.launches for k, f in ops.KERNELS.items()}
    params, opt_state, _ = donated(params, opt_state, batches[0])
    torch.cuda.synchronize()
    first = {k: f.launches - before[k] for k, f in ops.KERNELS.items()}
    kept = tree_map(torch.clone, (params, opt_state))
    with pytest.raises(RuntimeError):
        donated(params, opt_state, batches[1])
    torch.cuda.synchronize()
    assert {k: f.launches - before[k] for k, f in ops.KERNELS.items()} == \
        first
    assert _trees_equal((params, opt_state), kept)
    assert donated.captures == 0


def test_sampler_graphed_bitwise_eager(gen):
    """The token stream's sampler as one CUDA graph: three batches and a
    resume (``batches(start_step)``) bitwise the eager stream's, one
    capture per stream, each batch the caller's own tensor."""
    from repro_torch.data.pipeline import TokenStream, TokenStreamConfig
    cfg = TokenStreamConfig(vocab_size=4096, seq_len=65, batch_size=4,
                            seed=5)
    for start in (0, 7):
        graphed = TokenStream(cfg, device="cuda")
        eager = TokenStream(cfg, device="cuda", graphs=False)
        got = [b for _, b in zip(range(3), graphed.batches(start))]
        want = [b for _, b in zip(range(3), eager.batches(start))]
        assert all(_trees_equal(a, b) for a, b in zip(got, want))
        assert (graphed.captures, eager.captures) == (1, 0)
        assert not any(a["tokens"].data_ptr() == b["tokens"].data_ptr()
                       for a in got for b in got if a is not b)


def test_draw_is_multinomials_on_the_card(gen):
    from repro_torch.data.pipeline import draw
    for shape in ((1, 7), (8, 49152)):
        for seed in (0, 123):
            probs = torch.softmax(torch.randn(shape, generator=gen,
                                              device="cuda") * 8, -1)
            want = torch.multinomial(probs, 1, generator=torch.Generator(
                device="cuda").manual_seed(seed))[:, 0]
            got = draw(probs, torch.Generator(device="cuda").manual_seed(
                seed))
            assert torch.equal(got, want)


def test_launch_train_graphed_bitwise_eager(gen):
    """``launch.train.main`` on a reduced smollm on the card, graphed (the
    default) and ``graphs=False``: every step's metrics and the final
    trees bit for bit; captures 1 / 1 against 0 / 0."""
    from repro_torch.launch import train
    argv = ["--reduced", "--steps", "5", "--batch", "4", "--seq", "64",
            "--log-every", "100"]
    runs = []
    for graphs in (None, False):
        stats = {}
        train.main(argv, graphs=graphs, stats=stats)
        runs.append(stats)
    g, e = runs
    assert g["metrics"] == e["metrics"]
    assert _trees_equal((g["params"], g["opt_state"]),
                        (e["params"], e["opt_state"]))
    assert g["captures"] == {"step": 1, "sampler": 1}
    assert e["captures"] == {"step": 0, "sampler": 0}


def _row3_takes(ring, gp, hd, cache):
    """Whether row 3's kernel launches over a ring of ``ring`` slots at Gp,
    hd: its leader holds every rank's (Gp, hd) partial in shared memory,
    which at Gp 16, hd 256 over 2048 slots passes the card's limit (the
    tensor-core shard kernel keeps one partial a CTA and takes it)."""
    from repro_torch.kernels import build
    smem = build.launcher("decode_attention", "decode_attention_smem",
                          "iiii")(ring, gp, hd, build.DTYPE_CODES[cache])
    limit = getattr(torch.cuda.get_device_properties(0),
                    "shared_memory_per_block_optin", 232448)
    return 0 <= smem <= limit


# (cache, Gp, hd): every cache dtype at the first shape; bf16 and float8
# shards (the tensor-core route) at every query group and three head dims
SHARD_HEADS = [(c, 3, 64) for c in (torch.float32, torch.bfloat16,
                                     torch.float8_e4m3fn)] + \
    [(c, gp, hd) for c in (torch.bfloat16, torch.float8_e4m3fn)
     for gp in (1, 4, 7, 16) for hd in (64, 128, 256)]


@pytest.mark.parametrize("cache,gp,hd", SHARD_HEADS,
                         ids=[f"{str(c)[6:]}-gp{gp}-hd{hd}"
                              for c, gp, hd in SHARD_HEADS])
@pytest.mark.parametrize("n,ring", [(1, 4), (16, 64), (48, 96),
                                    (512, 2048)])
def test_decode_attention_shard(gen, cache, gp, hd, n, ring):
    """The ring-shard launch over every shard of a ring, at positions
    before, at and past its wrap (shards partly live, wholly live, past
    the position, on a wrapped ring): out and row log-sum-exp within the
    tolerances of ``test_decode_attention_edges`` of the plain version, a
    shard past the position zeros and -inf exactly, one launch a call,
    the same bits on a second call and with the position on the card.
    With slot0 = 0 and the ring its own: for f32 caches (row 3's kernel)
    the out of ``decode_attention_cuda`` on the same f32 query, bit for
    bit; for bf16 and float8 caches (the tensor-core kernel) within the
    same tolerance of it."""
    from repro_torch.kernels.decode_attention import \
        decode_attention_shard_cuda
    q = torch.randn(2, 2, gp, hd, generator=gen, device="cuda")
    kv = torch.randn(2, 2, ring, 2, hd, generator=gen, device="cuda").to(
        cache)
    tol = 1e-4 if cache == torch.float32 else 2e-2
    for pos in (0, n // 2, ring - 1, ring + n // 3, 5 * ring + 1):
        pos_t = torch.tensor(pos, dtype=torch.int64, device="cuda")
        for slot0 in range(0, ring, n):
            ck = kv[0, :, slot0:slot0 + n].contiguous()
            cv = kv[1, :, slot0:slot0 + n].contiguous()
            before = decode_attention_shard_cuda.launches
            out, lse = decode_attention_shard_cuda(q, ck, cv, pos, slot0,
                                                   ring)
            assert decode_attention_shard_cuda.launches == before + 1
            w_out, w_lse = ref.decode_attention_shard_ref(q, ck, cv, pos,
                                                          slot0, ring)
            live = torch.isfinite(w_lse)
            assert torch.equal(torch.isfinite(lse), live)
            assert _err(out, w_out) <= tol, (pos, slot0)
            if live.any():
                assert _err(lse[live], w_lse[live]) <= tol, (pos, slot0)
            assert torch.all(out[~live] == 0)
            for again in (decode_attention_shard_cuda(q, ck, cv, pos, slot0,
                                                      ring),
                          decode_attention_shard_cuda(q, ck, cv, pos_t,
                                                      slot0, ring)):
                assert torch.equal(again[0], out) and \
                    torch.equal(again[1], lse)
        whole = decode_attention_shard_cuda(q, kv[0], kv[1], pos, 0, ring)[0]
        if not _row3_takes(ring, gp, hd, cache):
            with pytest.raises(RuntimeError, match="cudaError_t"):
                decode_attention_cuda(q, kv[0], kv[1], pos)
            continue
        row3 = decode_attention_cuda(q, kv[0], kv[1], pos)
        if cache == torch.float32:
            assert torch.equal(whole, row3)
        else:
            assert _err(whole, row3) <= tol, pos


@pytest.mark.parametrize("cache", [torch.bfloat16, torch.float8_e4m3fn])
def test_decode_attention_shard_graph_replay(gen, cache):
    """The tensor-core shard launch captured in a CUDA graph with its
    position on the card (chatglm3-6b's head shape, KVp 2, Gp 16, hd 128,
    a 64-slot shard at slot 64 of a 256-slot ring), replayed at positions
    where the shard is partly live, past the ring's wrap and not yet
    live: out and lse bit for bit the eager launch's at each; a replay
    launches no kernel through the wrapper, so the counter stays."""
    from repro_torch.kernels.decode_attention import \
        decode_attention_shard_cuda
    ring, n, slot0 = 256, 64, 64
    q = torch.randn(2, 2, 16, 128, generator=gen, device="cuda")
    ck, cv = (torch.randn(2, n, 2, 128, generator=gen, device="cuda").to(
        cache) for _ in range(2))
    pos_t = torch.zeros((), dtype=torch.int64, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm-up off the capture
        decode_attention_shard_cuda(q, ck, cv, pos_t, slot0, ring)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, lse = decode_attention_shard_cuda(q, ck, cv, pos_t, slot0, ring)
    launches = decode_attention_shard_cuda.launches
    for pos in (100, 3 * ring + 10, 30):
        pos_t.fill_(pos)
        graph.replay()
        want_out, want_lse = decode_attention_shard_cuda(q, ck, cv, pos,
                                                         slot0, ring)
        torch.cuda.synchronize()
        assert torch.equal(out, want_out) and torch.equal(lse, want_lse), pos
        assert torch.isfinite(lse).all() == (pos >= slot0), pos
    assert decode_attention_shard_cuda.launches == launches + 3


def test_refused_launch_leaves_no_error(gen):
    """A launch the card refuses (row 3's kernel at Gp 16, hd 256 over a
    2048-slot ring: its partials pass the shared-memory limit) raises,
    and the next launches, of that kernel and of another, run: the
    refusal is not reported again by their error checks."""
    from repro_torch.kernels.decode_attention import \
        decode_attention_shard_cuda
    q = torch.randn(1, 1, 16, 256, generator=gen, device="cuda")
    kv = torch.randn(2, 1, 2048, 1, 256, generator=gen, device="cuda").to(
        torch.bfloat16)
    assert not _row3_takes(2048, 16, 256, torch.bfloat16)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        decode_attention_cuda(q, kv[0], kv[1], 100)
    out, _ = decode_attention_shard_cuda(q, kv[0], kv[1], 100, 0, 2048)
    small = decode_attention_cuda(
        *(t.contiguous() for t in (q[..., :64], kv[0, :, :64, :, :64],
                                   kv[1, :, :64, :, :64])), 30)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(small).all()


@pytest.mark.parametrize("cache", [torch.bfloat16, torch.float8_e4m3fn])
def test_decode_attention_head_block(gen, cache):
    """Row 3's launch over the KV heads ``[kv0, kv0 + KVp)`` of a ring
    holding more (the ring every rank holds where its slots do not
    split), read in place: the launch over a copy of those heads, bit
    for bit, before and past the wrap; a block past the ring's heads
    raises."""
    q = torch.randn(2, 1, 4, 64, generator=gen, device="cuda")
    kv = torch.randn(2, 2, 40, 3, 64, generator=gen, device="cuda").to(
        cache)
    for kv0 in range(3):
        block = [t[:, :, kv0:kv0 + 1].contiguous() for t in kv]
        for pos in (5, 39, 47):
            got = decode_attention_cuda(q, kv[0], kv[1], pos, kv0)
            assert torch.equal(got, decode_attention_cuda(q, *block, pos))
    with pytest.raises(ValueError, match="KV head"):
        decode_attention_cuda(q, kv[0], kv[1], 3, 3)


def test_model_axis_on_one_card_matches_cpu(gen):
    """The serving steps' rank program at two ``gloo`` ranks on this card
    (the kernels on each rank's shards; the ring-shard launch for the
    one-KV-head config, row 3 over its KV head of the whole ring at an
    odd ring) against the one-card program on the CPU, same
    weights: the prefill's and every decode step's gathered logits within
    1e-3 of the largest, the greedy tokens equal, the ranks bitwise."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.launch import distributed
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    import _torch_model_parallel_ranks as ranks
    base = get_config("smollm-135m")
    cfgs = {"kv": dataclasses.replace(
                base, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
                head_dim=64, d_ff=768, vocab_size=250, tp_pad=16,
                dtype="float32"),
            "seq": dataclasses.replace(
                base, num_layers=2, d_model=256, num_heads=4, num_kv_heads=1,
                head_dim=64, d_ff=256, vocab_size=256, tp_pad=1,
                dtype="float32"),
            "moe": dataclasses.replace(get_config("olmoe-1b-7b").reduced(),
                                       dtype="float32")}
    rng = np.random.default_rng(0)
    cases = {}
    for name, cfg in cfgs.items():
        tree = tree_map(lambda t: t.numpy(), T.init_params(
            cfg, torch.Generator().manual_seed(1), device="cpu"))
        cases[name] = (cfg, tree, 0, rng.integers(
            0, cfg.vocab_size, (2, 12)).astype(np.int32), 22, 6)
    cases["rep"] = cases["seq"][:4] + (21, 6)
    two = distributed.spawn(ranks.run_cases, 2, "cuda", cases, "cuda",
                            backend="gloo")
    one = ranks.run_cases(0, 1, None, cases)
    for name in cases:
        got, want = two[0][name], one[name]
        for g, w in zip([got["prefill"], *got["steps"]],
                        [want["prefill"], *want["steps"]]):
            assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max(), name
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(two[1][name]["tokens"], got["tokens"])
        np.testing.assert_array_equal(two[1][name]["prefill"], got["prefill"])
