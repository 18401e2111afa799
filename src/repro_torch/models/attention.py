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

Over a model axis (``launch.model_parallel``, ``axis=``) a rank holds the
shards ``launch.sharding`` lays out: its block of the padded query heads
(``wq``, ``bq``, ``wo``'s rows; :func:`head_layout`), and either its
block of the KV heads, where they divide the axis (``kv_sharded``), or
all of them, replicated. ``wo`` is row-parallel: its partial outputs are
summed over the axis. The decode ring (:func:`ring_of`) follows the
KV heads where they split; else it is split on its slots where they
divide the axis ("seq": each rank holds a contiguous block, the rank
that owns the token's slot writes it, and the ranks merge their shards'
attention by the rows' log-sum-exp), else every rank holds all of it
("rep"). A rank's query heads must lie in whole KV groups or inside one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.launch import model_parallel as mp
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


def kv_sharded(cfg, axis=None) -> bool:
    """True where the padded KV heads divide the model axis (always, on
    one card): ``wk`` / ``wv`` and the ring split by heads."""
    return cfg.padded_heads()[0] % mp.size(axis) == 0


def head_layout(cfg, axis=None) -> tuple:
    """(kv0, nkv, g0, ng): the rank's block of the padded query heads,
    flat head ``kv * G_pad + g`` split in contiguous blocks over the axis
    as ``wq`` is, as KV heads ``[kv0, kv0 + nkv)`` x groups ``[g0, g0 +
    ng)``. Raises where a rank's heads would straddle KV groups."""
    kvp, gp = cfg.padded_heads()
    m, r = mp.size(axis), mp.index(axis)
    if m == 1:
        return 0, kvp, 0, gp
    if (kvp * gp) % m:
        raise ValueError(f"{kvp * gp} padded heads do not split over a "
                         f"model axis of {m}")
    h = kvp * gp // m
    if h % gp == 0:
        return r * (h // gp), h // gp, 0, gp
    if gp % h:
        raise ValueError(f"a rank's {h} query heads straddle KV groups of "
                         f"{gp} at a model axis of {m}")
    return r * h // gp, 1, r * h % gp, h


def ring_slots(cfg, axis) -> int:
    """The global slots of the program's decode rings (``axis.max_len``,
    or the window under a sliding window)."""
    if axis.max_len is None:
        raise ValueError("a model axis over a ring that does not split by "
                         "KV heads needs the caches' max_len "
                         "(model_parallel.with_len)")
    return min(axis.max_len, cfg.sliding_window) if cfg.sliding_window \
        else axis.max_len


def ring_of(cfg, axis=None) -> str:
    """How the program's decode rings lie over the axis, as
    ``cache_pspecs`` lays them out: ``"kv"`` split by KV heads wherever
    those split (one card included), else ``"seq"`` split on their
    slots where :func:`ring_slots` divide the axis, else ``"rep"`` held
    whole by every rank."""
    if kv_sharded(cfg, axis):
        return "kv"
    return "seq" if ring_slots(cfg, axis) % axis.size == 0 else "rep"


def cache_ring(cfg, axis, cache) -> str:
    """:func:`ring_of` for a step over ``cache`` (one layer's ring), held
    to the ring's slots: split on its slots, the ring holds
    :func:`ring_slots` / m of them; held whole, all of them. Raises where
    ``axis.max_len`` is not the length the cache was built for."""
    layout = ring_of(cfg, axis)
    if layout == "kv":
        return layout
    want = ring_slots(cfg, axis) // (axis.size if layout == "seq" else 1)
    if cache["k"].shape[1] != want:
        raise ValueError(f"a ring of {cache['k'].shape[1]} slots a rank, "
                         f"where a model axis of {axis.size} at max_len "
                         f"{axis.max_len} lays out {want} ({layout})")
    return layout


def _head_mask(cfg, dtype, device, axis=None):
    """(KV heads, groups, 1) 1.0 on real heads, 0.0 on padding (or None),
    over the rank's block of heads."""
    kv = cfg.num_kv_heads
    g = max(cfg.num_heads // max(kv, 1), 1)
    kvp, gp = cfg.padded_heads()
    if (kvp, gp) == (kv, g):
        return None
    mask = torch.zeros((kvp, gp, 1), dtype=dtype, device=device)
    mask[:kv, :g] = 1.0
    if mp.active(axis):
        kv0, nkv, g0, ng = head_layout(cfg, axis)
        mask = mask[kv0:kv0 + nkv, g0:g0 + ng]
    return mask


def _qkv_proj(x, w):
    """One QKV projection: dense, or the dequantize-fused qmatmul kernel
    when the weight arrives as a quantized wire struct."""
    if ops.is_wire_struct(w):
        return ops.qdense(x, w)                    # (B,S,*w.shape[1:])
    return torch.tensordot(x, w.to(x.dtype), dims=([2], [0]))


def _project_qkv(params, cfg, x, axis=None):
    """x (B,S,D) -> q (B,S,KVp,Gp,hd), k/v (B,S,KVp,hd); over a model
    axis q the rank's heads (:func:`head_layout`), k/v its KV heads or
    all of them (replicated). The replicated ``x`` enters the rank's own
    products through ``mp.to_ranks`` (the ranks' cotangents summed), the
    replicated products of replicated ``wk`` / ``wv`` directly; the
    replicated norm scales meet rank-specific heads through it too."""
    dt = x.dtype
    _, kvp, _, gp = head_layout(cfg, axis)
    split_kv = kv_sharded(cfg, axis)
    b, s, _ = x.shape
    xr = mp.to_ranks(x, axis)
    q = _qkv_proj(xr, params["wq"])
    k = _qkv_proj(xr if split_kv else x, params["wk"])
    v = _qkv_proj(xr if split_kv else x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if cfg.qk_norm:
        q = headnorm(mp.to_ranks(params["q_norm"], axis), q)
        k = headnorm(mp.to_ranks(params["k_norm"], axis) if split_kv
                     else params["k_norm"], k)
    return q.reshape(b, s, kvp, gp, q.shape[-1]), k, v


def _out_proj(params, cfg, out, dtype, axis=None):
    """out (B,S,KVp,Gp,hd) -> (B,S,D). Padded heads are zero-masked
    first so they never contribute. Row-parallel over a model axis: the
    ranks' partial outputs, in f32, are summed and rounded once."""
    mask = _head_mask(cfg, out.dtype, out.device, axis)
    if mask is not None:
        out = out * mask
    b, s, kvp, gp, hd = out.shape
    out = out.reshape(b, s, kvp * gp, hd)
    pd = mp.partial_dtype(axis, dtype)
    if ops.is_wire_struct(params["wo"]):
        y = ops.qdense(out, params["wo"], n_contract=2, out_dtype=pd)
    else:
        w = params["wo"].to(dtype)
        if pd != dtype:
            out, w = out.to(pd), w.to(pd)
        y = torch.tensordot(out, w, dims=([2, 3], [0, 1]))
    return mp.sum_partials(y, axis, dtype)


def _attention_kv(cfg, axis, k, v):
    """The KV heads the rank's query heads read: k/v themselves where
    they are the rank's own, else its heads' slice of the replicated
    ones (``mp.to_ranks``: ranks that share a KV head both add to its
    cotangent, and every rank gets the whole one)."""
    if kv_sharded(cfg, axis):
        return k, v
    kv0, nkv, _, _ = head_layout(cfg, axis)
    return (mp.to_ranks(k, axis, 2, kv0, nkv),
            mp.to_ranks(v, axis, 2, kv0, nkv))


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
                      block_k=DEFAULT_BLOCK_K, axis=None):
    """Full-context (prefill) attention. x (B,S,D) -> (B,S,D)."""
    s = x.shape[1]
    q, k, v = _project_qkv(params, cfg, x, axis)
    k, v = _attention_kv(cfg, axis, k, v)
    q = rope_lib.apply_rope(cfg.rope, q, positions, cfg.rope_theta)
    k = rope_lib.apply_rope(cfg.rope, k, positions, cfg.rope_theta)
    bq, bk = min(block_q, s), min(block_k, s)
    if cfg.sliding_window is not None and s > cfg.sliding_window:
        out = _windowed_attention(q, k, v, cfg.sliding_window, bq)
    else:
        out = ops.flash_attention(q, k, v, bq, bk)
    return _out_proj(params, cfg, out, x.dtype, axis)


def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cuda", lead=(), axis=None):
    """Ring-buffer KV cache for one layer (``lead`` prepends stacking
    axes). Sliding-window configs hold only ``window`` entries. Over a
    model axis, the rank's part of the ring (:func:`ring_of`)."""
    hd = cfg.resolved_head_dim()
    kvp, _ = cfg.padded_heads()
    buf = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    if mp.active(axis):
        layout = ring_of(cfg, mp.with_len(axis, max_len))
        if layout == "kv":
            kvp //= axis.size
        elif layout == "seq":
            buf //= axis.size
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


def _write_ring_shard(cache, k, v, pos, first: int, ring: int) -> None:
    """Write the token's K/V (B, 1, KVp, hd) into global slot ``pos %
    ring`` of a ring split on its slots, where this rank's shard
    ``cache`` holds slots ``[first, first + n)``: the owning rank writes,
    the others leave their shard as it was (a device position: every
    rank writes its clamped slot, the old bits kept unless it owns it)."""
    n = cache["k"].shape[1]
    slot = pos % ring
    for name, new in (("k", k), ("v", v)):
        shard = cache[name]
        if torch.is_tensor(pos):
            local = slot.long().reshape(1) - first
            at = local.clamp(0, n - 1)
            owned = ((local >= 0) & (local < n)).reshape(1, 1, 1, 1)
            bits = torch.where(owned,
                               as_bits(to_storage(new, shard.dtype)),
                               as_bits(shard).index_select(1, at))
            as_bits(shard).index_copy_(1, at, bits)
        elif first <= slot < first + n:
            shard[:, slot - first] = to_storage(new[:, 0], shard.dtype)


def combine_shards(outs, lses):
    """The attention over a whole ring from its shards' (m, ..., hd) f32
    outputs and (m, ...) f32 log-sum-exps, merged in rank
    order: each output weighted by exp(its lse - the largest), over the
    weights' sum. The shard holding slot 0 always has a live slot, so
    the largest is finite."""
    top = lses.amax(dim=0)
    num = den = None
    for o, l in zip(outs, lses):
        w = torch.exp(l - top)
        num = w[..., None] * o if num is None else num + w[..., None] * o
        den = w if den is None else den + w
    return num / den[..., None]


def _ring_shard_decode(cfg, axis, q, k, v, cache, pos):
    """The decode attention of the rank's heads over a ring split on its
    slots: the token's K/V written by the owning rank, the queries of
    every head gathered, the shard kernel run over this rank's slots for
    all of them, each rank's block of heads of the shards' (out, lse)
    sent to it (one all-to-all, the lse as out's last column) and merged
    in rank order -> (B, nkv, ng, hd) f32."""
    b, hd = q.shape[0], q.shape[-1]
    m, n = axis.size, cache["k"].shape[1]
    ring, first = n * m, n * axis.index
    _write_ring_shard(cache, k, v, pos, first, ring)
    kvp, gp = cfg.padded_heads()
    qa = mp.all_gather(q[:, 0].reshape(b, -1, hd), axis, dim=1)
    out, lse = ops.decode_attention_shard(qa.reshape(b, kvp, gp, hd),
                                          cache["k"], cache["v"], pos, first,
                                          ring)
    h = kvp * gp // m
    part = torch.cat([out.reshape(b, m, h, hd),
                      lse.reshape(b, m, h, 1)], -1).transpose(0, 1)
    got = mp.all_to_all(part, axis)                # (m, B, h, hd + 1)
    mine = combine_shards(got[..., :hd], got[..., hd])
    _, nkv, _, ng = head_layout(cfg, axis)
    return mine.reshape(b, nkv, ng, hd)


def attention_decode(params, cfg, x, cache, pos, axis=None):
    """One-token decode. x (B,1,D); ``pos`` the absolute position (same
    for the batch): a host int, or a 0-d integer tensor on x's device
    that is never read on the host (the RoPE positions, the ring slot and
    the kernel's live slots all come from it on the device, so one CUDA
    graph serves every position). Writes the token's K/V into ``cache``
    IN PLACE at slot ``pos % buf`` (post-RoPE, so the ring needs no
    re-rotation) and returns (out (B,1,D), cache). Over a model axis the
    ring is the rank's part (:func:`ring_of`): split by KV heads, the
    step is the one-card step on the rank's heads; split on its slots,
    :func:`_ring_shard_decode`; held whole, the rank's heads attend its
    KV heads' slice of it."""
    positions = _decode_rows(pos, x.shape[0], x.device)
    q, k, v = _project_qkv(params, cfg, x, axis)
    q = rope_lib.apply_rope(cfg.rope, q, positions, cfg.rope_theta)
    k = rope_lib.apply_rope(cfg.rope, k, positions, cfg.rope_theta)
    layout = cache_ring(cfg, axis, cache)
    if layout == "seq":
        out = _ring_shard_decode(cfg, axis, q, k, v, cache, pos)
    else:
        _write_ring(cache, k, v, pos)
        kv0 = head_layout(cfg, axis)[0] if layout == "rep" else None
        out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], pos, kv0)
    out = out[:, None].to(x.dtype)                 # (B,1,KVp,Gp,hd)
    return _out_proj(params, cfg, out, x.dtype, axis), cache
