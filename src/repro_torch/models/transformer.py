"""Decoder-stack assembly for every assigned architecture: attention
or Mamba2 (SSM) mixers, each followed by a dense MLP, a mixture of
experts or nothing (``ModelConfig.block_kind`` / ``uses_moe``).

Parameters keep the reference's stacked layout: ``num_periods``
repetitions of a ``period`` of blocks, each period position's leaves
stacked over periods on a leading axis, so layer ``l`` is period
``l // period_len`` at position ``l % period_len``. Weights cross from
the JAX package as NumPy arrays through ``params_from_numpy``.

The reference runs a segment ``[start, stop)`` as one masked
``lax.scan`` over every block (inactive blocks are exact identities) so
that one compiled program serves every cut. PyTorch runs eagerly, so
here a segment is a Python loop over exactly the layers ``[start,
stop)`` — the same function without the masked work. Caches are updated
IN PLACE: the segment functions write each layer's K/V into its slice of
the stacked cache tree and return that same tree.

The whole-model ``forward`` / ``prefill`` / ``decode_step`` (what the
serving launcher calls) run the same blocks over ``[0, L)`` between the
embedding (token ids, or a frontend's precomputed ``embeds``) and the
unembedding, and sum the MoE router losses over the blocks.

The serving paths (``prefill``, ``decode_step``, ``segment_forward``,
``segment_prefill``, ``segment_decode_step`` and the blocks under them)
and the trainer's ``forward`` take ``axis=``, a rank's model axis
(``launch.model_parallel``): the params and caches are then that rank's
shards as ``launch.sharding`` lays them out, every mixer and
feed-forward block sums its row-parallel output over the axis, the
embedding is vocab-parallel (a masked gather of the rank's rows, summed
over the axis) and the logits are the rank's block of vocab columns.
Each crossing from replicated to rank-specific tensors is
``mp.to_ranks`` and each sum over the ranks ``mp.from_ranks``, so the
backward gives every replicated tensor its whole cotangent on every
rank. With no axis, or one of size 1, they compute what they computed
before, bit for bit.

``forward``, ``prefill`` and ``decode_step`` (and ``block_at`` and the
segment functions under the last two) also take ``fsdp=``, a rank's
FSDP layout (``launch.model_parallel.Fsdp``): the params are then also
split over the data axis as ``launch.sharding.param_pspecs(fsdp=True)``
lays them out, and each leaf is gathered whole over that axis where the
model reads it — a block's leaves in :func:`block_at`, after the period
select, so one block's weights are whole at a time (under remat the
checkpointed forward gathers them again in the backward); ``embed``,
``lm_head`` and ``final_norm`` in the embedding and the unembedding (a
tied head at both, whose two gradients autograd sums); a block leaf the
layout splits on its period axis whole, once per call
(:func:`_whole_periods`). The gathers' backward gives each rank its
shard's gradient (``mp.gather``). A layout over a data axis of size 1
gathers nothing, bit for bit.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch import model_parallel as mp
from repro_torch.models import rope as rope_lib
from repro_torch.models.attention import (NEG_INF, DEFAULT_BLOCK_K,
                                          DEFAULT_BLOCK_Q, _attention_kv,
                                          _out_proj, _project_qkv,
                                          _windowed_attention,
                                          attention_decode, attention_forward,
                                          attn_init, init_kv_cache,
                                          cache_ring)
from repro_torch.models.common import (as_bits, embed_init, norm_apply,
                                       norm_init, to_storage)
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.ssm import (init_ssm_cache, ssm_decode, ssm_forward,
                                    ssm_init, ssm_prefill)
from repro_torch.tree import tree_leaves, tree_map


def period_len(cfg: ModelConfig) -> int:
    a = cfg.attn_every if cfg.attn_every > 1 else 1
    m = cfg.moe.every if cfg.moe is not None else 1
    return math.lcm(a, m)


def num_periods(cfg: ModelConfig) -> int:
    p = period_len(cfg)
    assert cfg.num_layers % p == 0, (cfg.num_layers, p)
    return cfg.num_layers // p


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Params

def _block_init(cfg: ModelConfig, generator: torch.Generator, device,
                pos: int):
    """Period position ``pos``'s weights, stacked over the periods."""
    lead = (num_periods(cfg),)

    def stacked_norm():
        return tree_map(lambda t: t.expand(lead + t.shape).clone(),
                        norm_init(cfg.norm, cfg.d_model, device))

    p = {"norm1": stacked_norm()}
    if cfg.block_kind(pos) == ATTN:
        p["attn"] = attn_init(cfg, generator, device, lead=lead)
    else:
        p["ssm"] = ssm_init(cfg, generator, device, lead=lead)
    if cfg.uses_moe(pos):
        p["norm2"] = stacked_norm()
        p["moe"] = moe_init(cfg, generator, device, lead=lead)
    elif cfg.d_ff:
        p["norm2"] = stacked_norm()
        p["mlp"] = mlp_init(cfg, generator, device, lead=lead)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda"):
    """Seeded random weights in the stacked layout (f32, as the
    reference keeps them; activations run in ``cfg.dtype``).
    ``generator`` must live on ``device``."""
    vp, d = cfg.padded_vocab(), cfg.d_model
    params = {"embed": embed_init((vp, d), generator, device=device),
              "final_norm": norm_init(cfg.norm, d, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init((d, vp), generator, device=device)
    params["blocks"] = [_block_init(cfg, generator, device, pos)
                        for pos in range(period_len(cfg))]
    return params


def param_shapes(cfg: ModelConfig, mode=None):
    """The ``init_params`` tree as fake CPU tensors of ``mode`` (a
    ``FakeTensorMode``; a new one when None): shapes and dtypes, nothing
    allocated (for the dry run). The tree is built on ``meta`` and each
    leaf remade as a fake CPU tensor, so that no ``meta`` tensor — which
    stands in for a device tensor — ever reaches a step or a kernel
    entry point (``trunc_normal_`` with a generator cannot run under the
    fake mode itself)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = mode or FakeTensorMode()
    tree = init_params(cfg, None, device="meta")
    with mode:
        return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), tree)


def params_from_numpy(tree, cfg: ModelConfig, device="cuda"):
    """Carry a reference ``init_params`` tree across as tensors on
    ``device``: NumPy leaves, stacked periods, the reference layouts
    (``wq (D, H_pad, hd)``, ``wo (H_pad, hd, D)``, MoE expert stacks
    ``(E, D, F)``, the SSM mixers' leaves)."""
    params = tree_map(lambda a: torch.from_numpy(np.array(a)).to(device),
                      tree)
    nper = num_periods(cfg)
    if len(params["blocks"]) != period_len(cfg) or any(
            t.shape[0] != nper for t in tree_leaves(params["blocks"])):
        raise ValueError(f"params do not stack {nper} periods of "
                         f"{period_len(cfg)} blocks for {cfg.name}")
    return params


def block_at(params, cfg: ModelConfig, layer: int, fsdp=None):
    """(block param tree, period position) of global block ``layer``:
    the period slice of the stacked tree, or, for a layer below
    ``len(params["segment_blocks"])``, that list's own tree (a
    quantized device segment, ``TransformerBackend.stacked_for``).
    Under an FSDP layout (``mp.Fsdp``) each leaf split over the data
    axis is gathered whole after the period select (a leaf split on its
    period axis, whole before it)."""
    per, pos = divmod(layer, period_len(cfg))
    seg = params.get("segment_blocks", ())
    if layer < len(seg):
        if mp.fsdp_active(fsdp):
            raise ValueError("a quantized device segment has no FSDP layout")
        return seg[layer], pos
    if not mp.fsdp_active(fsdp):
        return tree_map(lambda t: t[per], params["blocks"][pos]), pos

    def take(t, d):
        if d == 0:
            return mp.gather(t, fsdp, 0)[per]
        return mp.gather(t[per], fsdp, None if d is None else d - 1)

    return tree_map(take, params["blocks"][pos],
                    fsdp.dims["blocks"][pos]), pos


def _whole_periods(params, fsdp):
    """(params, fsdp) with every block leaf that ``fsdp`` splits on its
    period axis gathered whole, and its split dropped from the layout:
    gathered once for a call that reads it at every period."""
    if not mp.fsdp_active(fsdp):
        return params, fsdp
    dims = fsdp.dims["blocks"]
    if 0 not in tree_leaves(dims):
        return params, fsdp
    blocks = tree_map(lambda t, d: mp.gather(t, fsdp, 0) if d == 0 else t,
                      params["blocks"], dims)
    dims = tree_map(lambda d: None if d == 0 else d, dims)
    return dict(params, blocks=blocks), dataclasses.replace(
        fsdp, dims=dict(fsdp.dims, blocks=dims))


def _top(params, name: str, fsdp):
    """The top-level leaf (or norm dict) ``name`` of ``params``, gathered
    whole over an FSDP layout's data axis where split."""
    if not mp.fsdp_active(fsdp):
        return params[name]
    return mp.gather_tree(params[name], fsdp.dims[name], fsdp)


# ---------------------------------------------------------------------------
# Caches

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda", axis=None):
    """Per-period-position stacked caches (leading axis = periods): a KV
    ring for an attention position, the carried state and conv ring for
    an SSM one; over a model axis, the rank's shapes of
    ``cache_pspecs``."""
    lead = (num_periods(cfg),)
    return [init_kv_cache(cfg, batch, max_len, dtype, device, lead=lead,
                          axis=axis)
            if cfg.block_kind(pos) == ATTN
            else init_ssm_cache(cfg, batch, dtype, device, lead=lead,
                                axis=axis)
            for pos in range(period_len(cfg))]


def _cache_at(caches, cfg: ModelConfig, layer: int):
    """Layer ``layer``'s slice of a stacked cache tree — views, so writes
    land in the tree."""
    per, pos = divmod(layer, period_len(cfg))
    return {k: v[per] for k, v in caches[pos].items()}


# ---------------------------------------------------------------------------
# Block application

# matmul-weight keys with a dequantize-fused kernel route: wire structs at
# these positions pass through _dequant_block intact and execute via
# ops.qdense (the qmatmul/qmatmul4 kernels) inside attention/mlp. Every
# other struct (MoE expert stacks, SSM mixers) dequantizes at block entry.
KERNEL_ROUTED = {"attn": ("wq", "wk", "wv", "wo"),
                 "mlp": ("w_gate", "w_up", "w_down")}


def _local_meta(node, axis):
    """A wire struct's ``scale`` / ``mu`` over its rank's columns: the
    reference replicates them whole, so a per-column grid of a leaf split
    on its columns holds ``size`` times the rank's columns and the rank
    takes its block."""
    cols = node["codes"].shape[-1] if "codes" in node \
        else 2 * node["codes_packed"].shape[-1]
    out = dict(node)
    for k in ("scale", "mu"):
        n = node[k].shape[-1]
        if n not in (1, cols):
            if n != cols * axis.size:
                raise ValueError(f"wire struct {k} of {n} columns over "
                                 f"{cols} local code columns")
            out[k] = node[k][..., axis.index * cols:
                             (axis.index + 1) * cols]
    return out


def _dequant_block(bp, cfg, axis=None):
    """Block weights may arrive as int8/int4 wire structs {codes |
    codes_packed, scale, mu}. Structs under ``KERNEL_ROUTED`` stay packed
    for the qmatmul kernels; any other struct dequantizes here. Over a
    model axis they are the rank's shards, whose per-column grids are
    first cut to the rank's columns (``_local_meta``)."""
    dt = model_dtype(cfg)

    def dequant(node):
        if "codes" in node:
            codes = node["codes"].float()
        else:
            p = node["codes_packed"]              # int4: two codes per byte
            codes = torch.stack([(p & 0xF), (p >> 4) & 0xF], dim=-1).reshape(
                p.shape[:-1] + (p.shape[-1] * 2,)).float()
        return (codes * node["scale"] + node["mu"]).to(dt)

    def walk(node, parent=None):
        if isinstance(node, dict):
            if ops.is_wire_struct(node) and "scale" in node:
                if mp.active(axis):
                    node = _local_meta(node, axis)
                return node if parent == "routed" else dequant(node)
            return {k: walk(v, "routed" if parent in KERNEL_ROUTED
                            and k in KERNEL_ROUTED[parent] else k)
                    for k, v in node.items()}
        return node

    return walk(bp)


def _feed_forward(bp, cfg, x, axis=None):
    """The block's second half on the residual ``x``: MoE, dense MLP or
    nothing. Returns (x, router aux dict or None)."""
    if "moe" in bp:
        out, aux = moe_apply(bp["moe"], cfg,
                             norm_apply(cfg.norm, bp["norm2"], x),
                             axis=axis)
        return x + out, aux
    if "mlp" in bp:
        return x + mlp_apply(bp["mlp"], cfg,
                             norm_apply(cfg.norm, bp["norm2"], x),
                             axis=axis), None
    return x, None


def _block_apply(bp, cfg, pos, x, positions, *, cache=None,
                 decode_pos=None, axis=None):
    """One block. Returns (x, aux, cache): ``aux`` the router losses of
    a MoE block (else None); ``cache``, when given (decode), updated in
    place."""
    bp = _dequant_block(bp, cfg, axis)
    h = norm_apply(cfg.norm, bp["norm1"], x)
    if cfg.block_kind(pos) == ATTN:
        if cache is not None:
            mixed, cache = attention_decode(bp["attn"], cfg, h, cache,
                                            decode_pos, axis=axis)
        else:
            mixed = attention_forward(bp["attn"], cfg, h, positions,
                                      axis=axis)
    elif cache is not None:
        mixed, cache = ssm_decode(bp["ssm"], cfg, h, cache, axis=axis)
    else:
        mixed = ssm_forward(bp["ssm"], cfg, h, axis=axis)
    x, aux = _feed_forward(bp, cfg, x + mixed, axis)
    return x, aux, cache


def _zero_aux(device) -> dict:
    """The router-loss dict of a stack without MoE blocks."""
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("lb_loss", "z_loss", "dropped_frac")}


def _acc_aux(acc, aux):
    """``acc + aux`` leaf by leaf; None (no MoE block yet) on either
    side adds nothing, so a dense stack launches no additions."""
    if aux is None:
        return acc
    if acc is None:
        return aux
    return {k: acc[k] + aux[k] for k in acc}


def _embed(params, cfg, tokens=None, embeds=None, axis=None, fsdp=None):
    """Token rows of ``embed`` (or a frontend's ``embeds``) in the model
    dtype. Vocab-parallel over a model axis: the rank gathers the rows it
    holds, zeros the others, and the ranks' rows are summed in the table's
    dtype (one of them is not zero), then cast. Under an FSDP layout the
    table is gathered over the data axis first."""
    if embeds is not None:
        return embeds.to(model_dtype(cfg))
    table = _top(params, "embed", fsdp)
    if not mp.active(axis):
        return table[tokens.long()].to(model_dtype(cfg))
    rows = table.shape[0]
    local = tokens.long() - axis.index * rows
    mine = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)]
    return mp.from_ranks(torch.where(mine[..., None], x, 0),
                         axis).to(model_dtype(cfg))


def _unembed(params, cfg, x, axis=None, fsdp=None):
    """Final norm and logits (..., V_pad), padded vocab columns masked;
    over a model axis the rank's block of vocab columns (``lm_head``'s,
    or the tied head's: ``embed``'s rows, transposed); under an FSDP
    layout the norm and the head gathered over the data axis first."""
    x = mp.to_ranks(norm_apply(cfg.norm, _top(params, "final_norm", fsdp),
                               x), axis)
    head = _top(params, "embed", fsdp).T if cfg.tie_embeddings \
        else _top(params, "lm_head", fsdp)
    logits = x @ head.to(x.dtype)
    vp = cfg.padded_vocab()
    if vp != cfg.vocab_size:                  # mask padded vocab columns
        n = logits.shape[-1]
        first = mp.index(axis) * n
        col = torch.arange(first, first + n, device=x.device)
        logits = torch.where(col < cfg.vocab_size, logits, -1e30)
    return logits


embed_tokens = _embed
unembed = _unembed
apply_block = _block_apply


# ---------------------------------------------------------------------------
# Segment forward (partitioned execution)

def segment_forward(params, cfg: ModelConfig, h, start: int, stop: int, *,
                    positions=None, collect: bool = False, axis=None):
    """Apply blocks ``[start, stop)`` to hidden state ``h`` (B, S, D).

    ``collect=True`` additionally returns the activation ENTERING every
    block of the stack, shape (L, B, S, D) — the Alg. 1 calibration's
    ``acts`` (blocks outside the segment pass their input through).
    Returns ``h_out`` or ``(h_out, acts)``."""
    b, s, _ = h.shape
    if positions is None:
        positions = rope_lib.text_positions(b, s, device=h.device)
    acts = []
    for layer in range(cfg.num_layers if collect else stop):
        if collect:
            acts.append(h)
        if start <= layer < stop:
            bp, pos = block_at(params, cfg, layer)
            h, _, _ = _block_apply(bp, cfg, pos, h, positions, axis=axis)
    if collect:
        return h, torch.stack(acts)
    return h


def segment_logits(params, cfg: ModelConfig, h, start: int, stop: int, *,
                   positions=None):
    """``segment_forward`` + unembed at the LAST position -> (B, V)."""
    h = segment_forward(params, cfg, h, start, stop, positions=positions)
    return _unembed(params, cfg, h[:, -1:, :])[:, -1, :]


# ---------------------------------------------------------------------------
# Segment prefill / extend / decode (cut-point-partitioned KV cache)

def _fill_ring_shard(cache, kr, v, first: int, ring: int) -> None:
    """The prompt's ring write on a ring split on its slots: this rank's
    shard (global slots ``[first, first + n)`` of ``ring``) gets exactly
    the slots the whole ring's write would give it."""
    s, n = kr.shape[1], cache["k"].shape[1]
    take = min(s, ring)
    for name, t in (("k", kr), ("v", v)):
        w = to_storage(t[:, s - take:], cache[name].dtype)
        if take == ring:
            # global slot j of the rolled ring holds row (j - shift) % ring
            rows = (torch.arange(n, device=w.device) + first
                    - (s - take) % ring) % ring
            as_bits(cache[name])[:] = as_bits(w).index_select(1, rows)
        else:
            held = min(max(take - first, 0), n)
            if held:
                cache[name][:, :held] = w[:, first:first + held]


def _attn_prefill_with_cache(ap, cfg, h, positions, cache, axis=None):
    """Full-context attention over ``h`` that also writes the last
    min(s, buf) keys/values into the ring ``cache`` (in place; over a
    model axis, the rank's part of it)."""
    s = h.shape[1]
    q, k, v = _project_qkv(ap, cfg, h, axis)
    qr = rope_lib.apply_rope(cfg.rope, q, positions, cfg.rope_theta)
    kr = rope_lib.apply_rope(cfg.rope, k, positions, cfg.rope_theta)
    ka, va = _attention_kv(cfg, axis, kr, v)
    bq, bk = min(DEFAULT_BLOCK_Q, s), min(DEFAULT_BLOCK_K, s)
    if cfg.sliding_window is not None and s > cfg.sliding_window:
        out = _windowed_attention(qr, ka, va, cfg.sliding_window, bq)
    else:
        out = ops.flash_attention(qr, ka, va, bq, bk)
    out = _out_proj(ap, cfg, out, h.dtype, axis)
    if cache_ring(cfg, axis, cache) == "seq":
        n = cache["k"].shape[1]
        _fill_ring_shard(cache, kr, v, n * axis.index, n * axis.size)
        return out, cache
    buf = cache["k"].shape[1]
    take = min(s, buf)
    for name, t in (("k", kr), ("v", v)):
        w = to_storage(t[:, s - take:], cache[name].dtype)
        if take == buf:
            # ring layout: position pos0 + i lands in slot (pos0 + i) % buf;
            # rolled as bit patterns (CUDA's roll takes no float8)
            as_bits(cache[name])[:] = torch.roll(as_bits(w),
                                                 (s - take) % buf, dims=1)
        else:
            cache[name][:, :take] = w
    return out, cache


def _prefill_blocks(params, cfg: ModelConfig, h, caches, start: int,
                    stop: int, positions, axis=None, fsdp=None):
    """Blocks ``[start, stop)`` over the prompt ``h``, filling their
    cache slices in place -> (h_out, caches, summed router aux or
    None)."""
    aux = None
    for layer in range(start, stop):
        bp, pos = block_at(params, cfg, layer, fsdp)
        bp = _dequant_block(bp, cfg, axis)
        hh = norm_apply(cfg.norm, bp["norm1"], h)
        cache = _cache_at(caches, cfg, layer)
        if cfg.block_kind(pos) == ATTN:
            mixed, _ = _attn_prefill_with_cache(bp["attn"], cfg, hh,
                                                positions, cache, axis)
        else:
            mixed, _ = ssm_prefill(bp["ssm"], cfg, hh, cache, axis=axis)
        h, a = _feed_forward(bp, cfg, h + mixed, axis)
        aux = _acc_aux(aux, a)
    return h, caches, aux


def segment_prefill(params, cfg: ModelConfig, h, caches, start: int,
                    stop: int, *, positions=None, axis=None):
    """Blocks ``[start, stop)`` over the prompt ``h`` (B, S, D), filling
    their slices of the stacked ``caches`` (an ``init_cache`` tree) in
    place: K/V rings, SSM states and conv rings. Returns ``(h_out,
    caches)``; router aux losses are dropped, as in the reference. Over
    a model axis whose rings split on their slots, ``axis.max_len``
    must be the caches' length."""
    b, s, _ = h.shape
    if positions is None:
        positions = rope_lib.text_positions(b, s, device=h.device)
    h, caches, _ = _prefill_blocks(params, cfg, h, caches, start, stop,
                                   positions, axis)
    return h, caches


def _attn_extend_with_cache(ap, cfg, h, positions, cache):
    """Multi-token attention against a PARTIALLY POPULATED ring cache:
    project/RoPE the ``s`` incoming rows at absolute ``positions``, write
    their K/V into the ring slots at those positions (in place, an
    ``index_copy_`` on the device, so no position is read on the host),
    then attend every row against the whole ring under a per-row validity
    mask (ring index <= row position), reading K/V back through the
    cache's storage dtype. Callers guarantee the last position < buf
    (slot == position)."""
    buf = cache["k"].shape[1]
    q, k, v = _project_qkv(ap, cfg, h)
    qr = rope_lib.apply_rope(cfg.rope, q, positions, cfg.rope_theta)
    kr = rope_lib.apply_rope(cfg.rope, k, positions, cfg.rope_theta)
    slots = positions[0].long()
    for name, new in (("k", kr), ("v", v)):
        as_bits(cache[name]).index_copy_(
            1, slots, as_bits(to_storage(new, cache[name].dtype)))
    hd = qr.shape[-1]
    kb = cache["k"].to(qr.dtype).float()
    vb = cache["v"].to(qr.dtype)
    mask = positions[0][:, None] >= torch.arange(buf, device=h.device)[None]
    sc = torch.einsum("bqkgd,bskd->bkgqs", qr.float(), kb) * hd ** -0.5
    sc = torch.where(mask, sc, NEG_INF)
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(vb.dtype).float(),
                      vb.float())
    out = pv / torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).to(qr.dtype)
    return _out_proj(ap, cfg, out, h.dtype), cache


def _attention_only(cfg: ModelConfig, what: str) -> None:
    """The reference's refusal of a stack with non-attention blocks in
    the paths that resume or roll back mid-stream: SSM state is a
    running reduction, not position-addressable."""
    for pos in range(period_len(cfg)):
        if cfg.block_kind(pos) != ATTN:
            raise NotImplementedError(
                f"{what} supports attention blocks only: "
                f"block kind at period position {pos} is not ATTN")


def segment_extend(params, cfg: ModelConfig, h, caches, pos0,
                   start: int, stop: int):
    """Blocks ``[start, stop)`` over ``s`` NEW rows ``h`` (B, S, D)
    entering at absolute position ``pos0``, extending their ring caches
    in place (the monolithic prefill of a decode session is one such
    extend from ``pos0 = 0``). ``pos0`` is a host int or a 0-d integer
    tensor on the device, never read on the host (the reference's
    dynamic ``pos0``: a CUDA graph of a chunk serves every chunk offset),
    and both give the same bits. Attention blocks only. Returns
    ``(h_out, caches)``."""
    _attention_only(cfg, "segment_extend")
    b, s, _ = h.shape
    positions = rope_lib.text_positions(b, s, offset=pos0, device=h.device)
    for layer in range(start, stop):
        bp, _ = block_at(params, cfg, layer)
        bp = _dequant_block(bp, cfg)
        mixed, _ = _attn_extend_with_cache(
            bp["attn"], cfg, norm_apply(cfg.norm, bp["norm1"], h),
            positions, _cache_at(caches, cfg, layer))
        h, _ = _feed_forward(bp, cfg, h + mixed)
    return h, caches


def segment_decode_step(params, cfg: ModelConfig, x, caches, pos,
                        start: int, stop: int, axis=None, fsdp=None):
    """One decode step over blocks ``[start, stop)``: ``x`` (B, 1, D) the
    hidden state entering block ``start``, ``pos`` the token's absolute
    position, a host int or a 0-d integer tensor on x's device
    (``attention_decode``). Updates the caches in place; returns
    ``(x_out, caches)``. Over a model axis whose rings split on their
    slots, ``axis.max_len`` must be the caches' length."""
    for layer in range(start, stop):
        bp, p = block_at(params, cfg, layer, fsdp)
        x, _, _ = _block_apply(bp, cfg, p, x, None,
                               cache=_cache_at(caches, cfg, layer),
                               decode_pos=pos, axis=axis)
    return x, caches


def segment_verify(params, cfg: ModelConfig, xs, caches, pos0,
                   start: int, stop: int):
    """Speculative-decode verification: run the ``s`` hidden rows ``xs``
    (B, S, D) — the cut-point activations of a drafted token batch at
    positions ``pos0 .. pos0 + s - 1`` — through blocks ``[start, stop)``
    and unembed EVERY row. ``pos0`` is a host int or a 0-d integer
    tensor on the device, whose row positions ``pos0 + j`` are computed
    there (a CUDA graph of the round serves every round start). Returns
    ``(logits (B, S, V), caches)``.

    The rows run one at a time through the EXACT ``segment_decode_step``
    + unembed of a plain decode step, so each row's logits are bitwise
    those of a plain step. A single multi-row forward would not be: its
    projections would run the quantized matmul at M = B * S (another
    kernel route above M = 16, another reduction order) and its
    attention another kernel. No cache rollback is needed on rejection:
    a stale slot past the acceptance point is rewritten before any later
    query reads it (slot == position). Attention blocks only: an SSM
    state cannot be rolled back to the acceptance point."""
    _attention_only(cfg, "segment_verify")
    rows = []
    for j in range(xs.shape[1]):
        x, caches = segment_decode_step(params, cfg, xs[:, j:j + 1], caches,
                                        pos0 + j, start, stop)
        rows.append(_unembed(params, cfg, x)[:, -1, :])
    return torch.stack(rows, dim=1), caches


# ---------------------------------------------------------------------------
# Whole model (the serving launcher's and the trainer's entry points)

def forward(params, cfg: ModelConfig, tokens=None, *, embeds=None,
            positions=None, remat: bool = False, axis=None, fsdp=None):
    """tokens (B, S), or a frontend's ``embeds`` (B, S, D) -> (logits
    (B, S, V), aux: the router losses summed over the blocks).
    ``remat`` checkpoints each period, as the reference's
    ``jax.checkpoint`` over its scan body: the backward pass runs the
    period's forward again (its flash attention kernel included)
    instead of keeping its activations. Over a model ``axis``, one
    rank's program on its shards, its block of vocab columns out, and
    differentiable: the boundaries are ``mp.to_ranks`` /
    ``mp.from_ranks``, and remat recomputes a period's collectives
    inside the backward, in the same order on every rank. Under an FSDP
    layout (``fsdp``) each block's leaves are gathered where it runs, so
    remat gathers them again in the backward."""
    params, fsdp = _whole_periods(params, fsdp)
    h = _embed(params, cfg, tokens, embeds, axis, fsdp)
    if positions is None:
        positions = rope_lib.text_positions(h.shape[0], h.shape[1],
                                            device=h.device)
    plen = period_len(cfg)

    def period_fn(h, per):
        acc = None
        for pos in range(plen):
            bp, _ = block_at(params, cfg, per * plen + pos, fsdp)
            h, a, _ = _block_apply(bp, cfg, pos, h, positions, axis=axis)
            acc = _acc_aux(acc, a)
        return h, acc

    aux = None
    for per in range(num_periods(cfg)):
        if remat:
            h, a = torch.utils.checkpoint.checkpoint(period_fn, h, per,
                                                     use_reentrant=False)
        else:
            h, a = period_fn(h, per)
        aux = _acc_aux(aux, a)
    return _unembed(params, cfg, h, axis=axis, fsdp=fsdp), \
        aux or _zero_aux(h.device)


def prefill(params, cfg: ModelConfig, tokens=None, *, embeds=None,
            positions=None, max_len: int, cache_dtype=torch.bfloat16,
            axis=None, fsdp=None):
    """Forward over the prompt (``tokens`` (B, S) or ``embeds`` (B, S,
    D)) that also builds fresh ``max_len``-slot decode caches ->
    (logits (B, S, V), caches, aux). Over a model axis: the rank's
    shards of the params in, its shards of the caches and its block of
    vocab columns out; under an FSDP layout, the params' data-axis
    shards gathered where read and the rank's rows of the batch."""
    axis = mp.with_len(axis, max_len)
    params, fsdp = _whole_periods(params, fsdp)
    h = _embed(params, cfg, tokens, embeds, axis, fsdp)
    b, s, _ = h.shape
    if positions is None:
        positions = rope_lib.text_positions(b, s, device=h.device)
    caches = init_cache(cfg, b, max_len, cache_dtype, device=h.device,
                        axis=axis)
    h, caches, aux = _prefill_blocks(params, cfg, h, caches, 0,
                                     cfg.num_layers, positions, axis, fsdp)
    return _unembed(params, cfg, h, axis=axis, fsdp=fsdp), caches, \
        aux or _zero_aux(h.device)


def decode_step(params, cfg: ModelConfig, token, caches, pos, axis=None,
                fsdp=None):
    """token (B, 1) ids, or a frontend's embedding (B, 1, D), at
    absolute position ``pos`` -> (logits (B, 1, V), caches), the caches
    updated in place. ``pos`` is a host int or a 0-d int32 / int64
    tensor on the token's device, never read on the host (the serving
    launcher's compile-once step fills one and replays a CUDA graph).
    Over a model axis, as :func:`prefill`; ``axis.max_len`` must be the
    caches' length where their rings split on their slots. Under an FSDP
    layout, as :func:`prefill`."""
    params, fsdp = _whole_periods(params, fsdp)
    x = _embed(params, cfg, token, axis=axis, fsdp=fsdp) \
        if token.dim() == 2 else token.to(model_dtype(cfg))
    x, caches = segment_decode_step(params, cfg, x, caches, pos, 0,
                                    cfg.num_layers, axis, fsdp)
    return _unembed(params, cfg, x, axis=axis, fsdp=fsdp), caches
