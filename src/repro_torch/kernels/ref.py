"""Plain PyTorch versions of every kernel (the allclose targets, and the
CPU lane of ``kernels.ops``). The causal flash-attention kernel's plain
version is ``models.attention._blocked_causal_attention``; its row
log-sum-exp and its backward kernels are held to
:func:`flash_attention_lse_ref` and :func:`flash_attention_bwd_ref`,
which rounds P and dS to the input dtype before the products that take
them, as the bfloat16 (tensor-core) route does."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def quantize_ref(x, scale, mu, bits: int, in_x_dtype: bool = False):
    """Asymmetric uniform quantization to uint8 codes (bits <= 8). The
    difference and the quotient are f32; with ``in_x_dtype`` each is
    rounded to ``x``'s dtype instead, as the reference's int8-code branch
    of ``quantize_stacked`` computes a leaf in its own dtype (``scale``
    and ``mu`` then hold values of that dtype)."""
    levels = (1 << bits) - 1
    if in_x_dtype:
        q = (x - mu.to(x.dtype)) / scale.to(x.dtype)
    else:
        q = (x.float() - mu) / scale
    codes = torch.clamp(torch.round(q), 0, levels)
    return codes.to(torch.uint8 if bits <= 8 else torch.int32)


def dequantize_ref(codes, scale, mu, dtype=torch.bfloat16):
    return (codes.float() * scale + mu).to(dtype)


def qmatmul_ref(x, w_codes, scale, mu, out_dtype=torch.float32):
    """x (M,K) x dequant(w_codes (K,N)) -> (M,N), f32 accumulation."""
    w = w_codes.float() * scale + mu
    return (x.float() @ w).to(out_dtype)


def pack_int4_ref(codes):
    """(..., N) codes in [0,15] -> (..., N//2) bytes (low nibble = even
    column)."""
    lo = codes[..., 0::2].to(torch.uint8)
    hi = codes[..., 1::2].to(torch.uint8)
    return lo | (hi << 4)


def unpack_int4_ref(packed):
    lo = (packed & 0xF).to(torch.int32)
    hi = ((packed >> 4) & 0xF).to(torch.int32)
    return torch.stack([lo, hi], dim=-1).reshape(
        packed.shape[:-1] + (packed.shape[-1] * 2,))


def quantize_pack4_ref(x, scale, mu):
    return pack_int4_ref(quantize_ref(x, scale, mu, 4))


def qmatmul4_ref(x, packed, scale, mu, out_dtype=torch.float32):
    w = unpack_int4_ref(packed).float() * scale + mu
    return (x.float() @ w).to(out_dtype)


def decode_attention_ref(q, ck, cv, pos):
    """Single-token decode attention over a ring-buffer KV cache.

    q (B, KVp, Gp, hd) the post-RoPE query of ONE token; ck/cv
    (B, buf, KVp, hd) the cache AFTER the token's K/V were written at
    slot ``pos % buf`` (any storage dtype); ``pos`` the absolute
    position, a host int or a 0-d integer tensor on q's device (the
    validity mask is then built there, with no read on the host). Scores
    and PV accumulate in f32; probabilities and V are rounded to the
    query dtype first, as the reference does. Returns (B, KVp, Gp, hd)
    in the query dtype."""
    hd = q.shape[-1]
    buf = ck.shape[1]
    if not torch.is_tensor(pos):
        pos = int(pos)
    sc = torch.einsum("bkgd,bskd->bkgs", q.float(),
                      ck.to(q.dtype).float()) * hd ** -0.5
    # wrapped ring (pos+1 >= buf): every slot live; else slots 0..pos%buf
    idx = torch.arange(buf, device=q.device)
    valid = (pos + 1 >= buf) | (idx <= pos % buf)
    sc = torch.where(valid, sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(q.dtype).float(),
                       cv.to(q.dtype).float())
    return out.to(q.dtype)


def decode_attention_shard_ref(q, ck, cv, pos, slot0: int, ring: int):
    """Single-token decode attention over a SHARD of a ring-buffer KV
    cache: ck/cv (B, n, KVp, hd) hold the global slots ``[slot0, slot0 +
    n)`` of a ring of ``ring`` slots, after the token's write; q (B, KVp,
    Gp, hd) and ``pos`` as :func:`decode_attention_ref` takes them. A
    global slot is live as there (every slot once the ring has wrapped,
    else slots 0 .. pos % ring). Scores, the softmax and PV in f32, the
    probabilities rounded to the query dtype before PV. Returns (out
    (B, KVp, Gp, hd) f32, lse (B, KVp, Gp) f32): the attention over the
    shard's live slots and the natural log-sum-exp of their scaled
    scores; a shard with no live slot gives zeros and -inf."""
    hd = q.shape[-1]
    n = ck.shape[1]
    if not torch.is_tensor(pos):
        pos = int(pos)
    sc = torch.einsum("bkgd,bskd->bkgs", q.float(),
                      ck.to(q.dtype).float()) * hd ** -0.5
    idx = slot0 + torch.arange(n, device=q.device)
    valid = (pos + 1 >= ring) | (idx <= pos % ring)
    sc = torch.where(valid, sc, torch.full_like(sc, -torch.inf))
    lse = torch.logsumexp(sc, dim=-1)
    live = torch.isfinite(lse)[..., None]
    p = torch.where(live, torch.exp(sc - torch.where(
        live, lse[..., None], torch.zeros_like(lse[..., None]))),
        torch.zeros_like(sc))
    out = torch.einsum("bkgs,bskd->bkgd", p.to(q.dtype).float(),
                       cv.to(q.dtype).float())
    return out, lse


def _compute_dtype(dtype):
    """float32 for the storage dtypes, float64 kept (the f64 gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def _causal_scores(q, k):
    """Scaled scores (B, KV, G, Sq, Sk) of q (B, S, KV, G, hd) against k
    (B, S, KV, hd) in the compute dtype, and the causal mask (Sq, Sk)."""
    ct = _compute_dtype(q.dtype)
    s = q.shape[1]
    sc = torch.einsum("bqkgd,bskd->bkgqs", q.to(ct), k.to(ct)) \
        * q.shape[-1] ** -0.5
    pos = torch.arange(s, device=q.device)
    return sc, pos[:, None] >= pos[None, :]


def flash_attention_lse_ref(q, k):
    """Row log-sum-exp of causal attention: for each query row, the
    natural log of sum_j exp(hd^-0.5 q.k_j) over keys j <= its position
    -> (B, S, KV, G), float32 (float64 for float64 inputs)."""
    sc, mask = _causal_scores(q, k)
    sc = torch.where(mask, sc, torch.full_like(sc, -torch.inf))
    return torch.logsumexp(sc, dim=-1).permute(0, 3, 1, 2)


def flash_attention_bwd_ref(q, k, v, out, lse, d_out):
    """The gradient of causal attention, written out: P = exp(scale q.k -
    lse) on the causal keys, dV = P^T dO with P rounded to the value
    dtype first (as the forward rounds it before PV), dP = dO V^T, D =
    rowsum(dO * O), dS = P (dP - D), dQ = scale dS K, dK = scale dS^T Q
    with dS rounded to the input dtype first (as the bfloat16 kernels
    round it into their tensor-core operands; a no-op for float32 and
    float64). Layouts as the forward's (q, out, d_out (B, S, KV, G, hd);
    k, v (B, S, KV, hd); lse (B, S, KV, G)); products in float32
    (float64 for float64 inputs) -> (dq, dk, dv) in the input dtypes."""
    ct = _compute_dtype(q.dtype)
    scale = q.shape[-1] ** -0.5
    sc, mask = _causal_scores(q, k)
    lse_r = lse.to(ct).permute(0, 2, 3, 1)[..., None]       # (B,KV,G,S,1)
    p = torch.where(mask, torch.exp(sc - lse_r), torch.zeros_like(sc))
    do, o = d_out.to(ct), out.to(ct)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p.to(v.dtype).to(ct), do)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do, v.to(ct))
    delta = (do * o).sum(-1).permute(0, 2, 3, 1)[..., None]
    ds = (p * (dp - delta)).to(q.dtype).to(ct)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.to(ct)) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, q.to(ct)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
