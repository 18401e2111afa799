"""GQA attention: projections, blocked causal attention, sliding windows,
qk-norm, RoPE variants and a ring-buffer KV cache for decode.

TP layout kept from the reference: query-side weights are stored flat
over a head dim padded to the model-axis size — ``wq (D, H_pad, hd)``,
``wo (H_pad, hd, D)`` with ``H_pad = KV_pad * G_pad``
(``ModelConfig.padded_heads``). Padded heads are masked to exact zero
before the output projection, so the computed function IS the unpadded
architecture.

Prefill attention goes through ``kernels.ops.flash_attention`` (the CUDA
kernel on the card, ``_blocked_causal_attention`` on the CPU); each
decode step through ``kernels.ops.decode_attention``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import rope as rope_lib
from repro_torch.models.common import (as_bits, dense_init, headnorm,
                                       to_storage)

NEG_INF = -1e30
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512


# ---------------------------------------------------------------------------
# Params

def attn_init(cfg, generator: torch.Generator, device="cuda", lead=()):
    """``lead`` prepends stacking axes (the period axis) to every leaf."""
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    kvp, gp = cfg.padded_heads()
    n = len(lead)
    p = {
        "wq": dense_init(lead + (d, kvp * gp, hd), generator, n, device=device),
        "wk": dense_init(lead + (d, kvp, hd), generator, n, device=device),
        "wv": dense_init(lead + (d, kvp, hd), generator, n, device=device),
        "wo": dense_init(lead + (kvp * gp, hd, d), generator, n + 1,
                         device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (kvp * gp, hd), device=device)
        p["bk"] = torch.zeros(lead + (kvp, hd), device=device)
        p["bv"] = torch.zeros(lead + (kvp, hd), device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (hd,), device=device)
        p["k_norm"] = torch.ones(lead + (hd,), device=device)
    return p


def _head_mask(cfg, dtype, device):
    """(KV_pad, G_pad, 1) 1.0 on real heads, 0.0 on padding (or None)."""
    kv = cfg.num_kv_heads
    g = max(cfg.num_heads // max(kv, 1), 1)
    kvp, gp = cfg.padded_heads()
    if (kvp, gp) == (kv, g):
        return None
    mask = torch.zeros((kvp, gp, 1), dtype=dtype, device=device)
    mask[:kv, :g] = 1.0
    return mask


def _qkv_proj(x, w):
    """One QKV projection: dense, or the dequantize-fused qmatmul kernel
    when the weight arrives as a quantized wire struct."""
    if ops.is_wire_struct(w):
        return ops.qdense(x, w)                    # (B,S,*w.shape[1:])
    return torch.tensordot(x, w.to(x.dtype), dims=([2], [0]))


def _project_qkv(params, cfg, x):
    """x (B,S,D) -> q (B,S,KVp,Gp,hd), k/v (B,S,KVp,hd)."""
    dt = x.dtype
    kvp, gp = cfg.padded_heads()
    b, s, _ = x.shape
    q = _qkv_proj(x, params["wq"])
    k = _qkv_proj(x, params["wk"])
    v = _qkv_proj(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if cfg.qk_norm:
        q = headnorm(params["q_norm"], q)
        k = headnorm(params["k_norm"], k)
    return q.reshape(b, s, kvp, gp, q.shape[-1]), k, v


def _out_proj(params, cfg, out, dtype):
    """out (B,S,KVp,Gp,hd) -> (B,S,D). Padded heads are zero-masked
    first so they never contribute."""
    mask = _head_mask(cfg, out.dtype, out.device)
    if mask is not None:
        out = out * mask
    b, s, kvp, gp, hd = out.shape
    out = out.reshape(b, s, kvp * gp, hd)
    if ops.is_wire_struct(params["wo"]):
        return ops.qdense(out, params["wo"], n_contract=2, out_dtype=dtype)
    return torch.tensordot(out, params["wo"].to(dtype), dims=([2, 3], [0, 1]))


# ---------------------------------------------------------------------------
# Blocked causal attention: the flash kernel's plain version.

def _blocked_causal_attention(q, k, v, block_q, block_k):
    """q (B,S,KV,G,hd), k/v (B,S,KV,hd) -> (B,S,KV,G,hd). Causal.

    Online softmax over k blocks; q block i visits only the k blocks
    that start at or before its last row (the rest are fully masked and
    contribute exp(-inf) = 0). Scores and the accumulator are f32;
    probabilities are rounded to the value dtype before the PV product,
    as in the reference."""
    b, s, kvh, g, hd = q.shape
    scale = hd ** -0.5
    nq = s // block_q
    pos = torch.arange(s, device=q.device)
    outs = []
    for i in range(nq):
        rows = slice(i * block_q, (i + 1) * block_q)
        qblk = q[:, rows].float()
        qp = pos[rows]
        acc = torch.zeros((b, kvh, g, block_q, hd), device=q.device)
        m = torch.full((b, kvh, g, block_q), NEG_INF, device=q.device)
        l = torch.zeros((b, kvh, g, block_q), device=q.device)
        for j in range(((i + 1) * block_q - 1) // block_k + 1):
            cols = slice(j * block_k, (j + 1) * block_k)
            sc = torch.einsum("bqkgd,bskd->bkgqs", qblk,
                              k[:, cols].float()) * scale
            mask = qp[:, None] >= pos[cols][None, :]
            sc = torch.where(mask, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(),
                              v[:, cols].float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))     # (B,BQ,KV,G,hd)
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# Sliding-window blocked attention: per query block only a slice of K/V of
# size (window + block_q) is touched -> O(S * window) compute.

def _windowed_attention(q, k, v, window, block_q):
    b, s, kvh, g, hd = q.shape
    scale = hd ** -0.5
    span = window + block_q
    # pad K/V on the left of the sequence axis so every slice is in bounds
    kp = F.pad(k, (0, 0, 0, 0, span - block_q, 0))
    vp = F.pad(v, (0, 0, 0, 0, span - block_q, 0))
    ar_q = torch.arange(block_q, device=q.device)
    ar_k = torch.arange(span, device=q.device)
    outs = []
    for idx in range(s // block_q):
        start = idx * block_q
        qblk = q[:, start:start + block_q].float()
        kblk = kp[:, start:start + span]
        vblk = vp[:, start:start + span]
        qpos = start + ar_q
        kpos = start - (span - block_q) + ar_k
        sc = torch.einsum("bqkgd,bskd->bkgqs", qblk, kblk.float()) * scale
        mask = (qpos[:, None] >= kpos[None, :]) & \
            (qpos[:, None] - kpos[None, :] < window) & (kpos[None, :] >= 0)
        sc = torch.where(mask, sc, NEG_INF)
        p = torch.softmax(sc, dim=-1)
        outs.append(torch.einsum("bkgqs,bskd->bqkgd",
                                 p.to(vblk.dtype).float(), vblk.float()))
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# Public entry points.

def attention_forward(params, cfg, x, positions, block_q=DEFAULT_BLOCK_Q,
                      block_k=DEFAULT_BLOCK_K):
    """Full-context (prefill) attention. x (B,S,D) -> (B,S,D)."""
    s = x.shape[1]
    q, k, v = _project_qkv(params, cfg, x)
    q = rope_lib.apply_rope(cfg.rope, q, positions, cfg.rope_theta)
    k = rope_lib.apply_rope(cfg.rope, k, positions, cfg.rope_theta)
    bq, bk = min(block_q, s), min(block_k, s)
    if cfg.sliding_window is not None and s > cfg.sliding_window:
        out = _windowed_attention(q, k, v, cfg.sliding_window, bq)
    else:
        out = ops.flash_attention(q, k, v, bq, bk)
    return _out_proj(params, cfg, out, x.dtype)


def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cuda", lead=()):
    """Ring-buffer KV cache for one layer (``lead`` prepends stacking
    axes). Sliding-window configs hold only ``window`` entries."""
    hd = cfg.resolved_head_dim()
    kvp, _ = cfg.padded_heads()
    buf = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = lead + (batch, buf, kvp, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _decode_rows(pos, b: int, device):
    """The (B, 1) RoPE positions of a decode step at ``pos``."""
    if torch.is_tensor(pos):
        return pos.expand(b, 1)
    return torch.full((b, 1), pos, dtype=torch.int32, device=device)


def _write_ring(cache, k, v, pos) -> None:
    """Write the token's post-RoPE K/V (B, 1, KVp, hd) into ring slot
    ``pos % buf`` of ``cache`` in place; a device position's slot is
    computed and written on the device (the same bits)."""
    slot = pos % cache["k"].shape[1]
    for name, new in (("k", k), ("v", v)):
        ring = cache[name]
        if torch.is_tensor(pos):
            as_bits(ring).index_copy_(1, slot.long().reshape(1),
                                      as_bits(to_storage(new, ring.dtype)))
        else:
            ring[:, slot] = to_storage(new[:, 0], ring.dtype)


def attention_decode(params, cfg, x, cache, pos):
    """One-token decode. x (B,1,D); ``pos`` the absolute position (same
    for the batch): a host int, or a 0-d integer tensor on x's device
    that is never read on the host (the RoPE positions, the ring slot and
    the kernel's live slots all come from it on the device, so one CUDA
    graph serves every position). Writes the token's K/V into ``cache``
    IN PLACE at slot ``pos % buf`` (post-RoPE, so the ring needs no
    re-rotation) and returns (out (B,1,D), cache)."""
    positions = _decode_rows(pos, x.shape[0], x.device)
    q, k, v = _project_qkv(params, cfg, x)
    q = rope_lib.apply_rope(cfg.rope, q, positions, cfg.rope_theta)
    k = rope_lib.apply_rope(cfg.rope, k, positions, cfg.rope_theta)
    _write_ring(cache, k, v, pos)
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], pos)
    out = out[:, None].to(x.dtype)                 # (B,1,KVp,Gp,hd)
    return _out_proj(params, cfg, out, x.dtype), cache
