"""The CUDA kernels against their plain versions on the card, at edge
shapes the smoke run does not reach: ragged M/N/K, float32 activations,
head dim 128, odd sequence lengths, a ring of one slot.

Needs an NVIDIA Hopper GPU and nvcc; skips elsewhere. On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
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
