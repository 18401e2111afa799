"""Public kernel entry points the models call, dispatched by DEVICE.

A tensor on the CPU runs the kernel's plain PyTorch version (the tests'
lane); any other tensor goes to the CUDA kernel's wrapper, which
launches it or raises — there is no fallback from a device tensor to the
plain version, and no environment variable picks the lane.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import quantize as qk
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_shard_cuda)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.qmatmul import qmatmul4_cuda, qmatmul_cuda

# every kernel wrapper of the package, for launch accounting
KERNELS = {"qmatmul": qmatmul_cuda, "qmatmul4": qmatmul4_cuda,
           "decode_attention": decode_attention_cuda,
           "decode_attention_shard": decode_attention_shard_cuda,
           "flash_attention": fa.flash_attention_cuda,
           "flash_attention_bwd": fa.flash_attention_bwd_cuda,
           "quantize": qk.quantize_cuda,
           "quantize_pack4": qk.quantize_pack4_cuda,
           "dequantize": qk.dequantize_cuda}

# (object, attribute) of every launch counter: the wrappers' ``launches``
# and any stand-in's counter added by ``watch_counter``. A CUDA graph's
# replay calls no wrapper, so ``serving.decode.graphs`` puts each counter
# back after a capture and adds its change over the capture on every
# replay.
COUNTERS = [(fn, "launches") for fn in KERNELS.values()]


def watch_counter(obj, attr: str = "launches") -> None:
    """Keep ``obj.<attr>`` with the kernels' own counters (``COUNTERS``),
    so that graph replays advance it as the eager calls would."""
    if not any(o is obj and a == attr for o, a in COUNTERS):
        COUNTERS.append((obj, attr))


def _plain(t) -> bool:
    return t.device.type == "cpu"


def decode_attention(q, ck, cv, pos, kv0=None):
    """Single-token decode attention over a ring-buffer cache. q (B, KVp,
    Gp, hd); ck/cv (B, buf, KVp, hd) post-write; ``pos`` the absolute
    position -> (B, KVp, Gp, hd). Given ``kv0``, ck/cv may hold more
    heads and q reads their heads ``[kv0, kv0 + KVp)``, in place."""
    if _plain(q):
        if kv0 is not None:
            kvp = q.shape[1]
            ck, cv = ck[:, :, kv0:kv0 + kvp], cv[:, :, kv0:kv0 + kvp]
        return ref.decode_attention_ref(q, ck, cv, pos)
    if kv0 is None:
        return decode_attention_cuda(q.contiguous(), ck, cv, pos)
    return decode_attention_cuda(q.contiguous(), ck, cv, pos, kv0=kv0)


def decode_attention_shard(q, ck, cv, pos, slot0: int, ring: int):
    """Decode attention over the global slots ``[slot0, slot0 + n)`` of a
    ring of ``ring`` slots (ck/cv (B, n, KVp, hd), post-write), the query
    taken in f32 -> (out (B, KVp, Gp, hd) f32, lse (B, KVp, Gp) f32);
    the ranks of a sequence-sharded ring merge their shards by ``lse``
    (``models.attention``)."""
    q = q.float()
    if _plain(q):
        return ref.decode_attention_shard_ref(q, ck, cv, pos, slot0, ring)
    return decode_attention_shard_cuda(q.contiguous(), ck, cv, pos, slot0,
                                       ring)


def flash_attention(q, k, v, block_q: int, block_k: int):
    """Causal attention, q (B, S, KV, G, hd), k/v (B, S, KV, hd). The
    blocks shape the plain version's loop only; the kernel tiles itself.
    On the CPU autograd differentiates the plain version; on the card,
    when a gradient is wanted, ``flash_attention.FlashAttention`` runs
    the forward kernel with the row log-sum-exp and the backward kernel,
    else the forward kernel alone (the serving launch)."""
    if _plain(q):
        from repro_torch.models.attention import _blocked_causal_attention
        return _blocked_causal_attention(q, k, v, block_q, block_k)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return fa.FlashAttention.apply(q, k, v)
    return fa.flash_attention_cuda(q, k, v)


def is_wire_struct(w) -> bool:
    """True for a quantized wire struct ({codes|codes_packed, scale, mu})."""
    return isinstance(w, dict) and ("codes" in w or "codes_packed" in w)


def qdense(x, w, n_contract: int = 1, out_dtype=None):
    """Quantized dense contraction: trailing axes of ``x`` against the
    ``n_contract`` leading axes of wire-struct ``w`` through the
    dequantize-fused qmatmul/qmatmul4 kernels.

    ``w`` is {codes (K..., N...) uint8 | codes_packed (..., N/2), scale,
    mu} with per-tensor (size-1) or per-output-column metadata. The
    trailing axes of ``x`` whose product equals prod(K...) are the
    contraction; output is x-batch-axes + (N...) in ``out_dtype``
    (default ``x.dtype``)."""
    out_dtype = out_dtype or x.dtype
    x2, codes2, scale, mu, out_shape = qdense_operands(x, w, n_contract)
    packed = "codes_packed" in w
    if _plain(x):
        out = (ref.qmatmul4_ref(x2, codes2, scale, mu, out_dtype) if packed
               else ref.qmatmul_ref(x2, codes2, scale, mu, out_dtype))
    else:
        fn = qmatmul4_cuda if packed else qmatmul_cuda
        out = fn(x2.contiguous(), codes2.contiguous(), scale.contiguous(),
                 mu.contiguous(), out_dtype)
    return out.reshape(out_shape)


def qdense_operands(x, w, n_contract: int):
    """:func:`qdense`'s 2-D operands: x (M, K), codes (K, N) or packed
    (K, N/2), scale and mu (1, 1) or (1, N), and the output's shape."""
    packed = "codes_packed" in w
    codes = w["codes_packed"] if packed else w["codes"]
    k = math.prod(codes.shape[:n_contract])
    out_tail = list(codes.shape[n_contract:])
    if packed:
        out_tail[-1] *= 2
    # peel trailing x axes until they cover the contraction size
    i, tail = x.dim(), 1
    while tail < k:
        i -= 1
        tail *= x.shape[i]
    if tail != k:
        raise ValueError(f"qdense: x {tuple(x.shape)} cannot contract with "
                         f"codes {tuple(codes.shape)} over {n_contract} axes")
    # a contraction axis of size 1 (one head of a rank's shard) is one of
    # the n_contract axes, not a batch axis
    while x.dim() - i < n_contract and i > 0 and x.shape[i - 1] == 1:
        i -= 1
    batch = tuple(x.shape[:i])
    x2 = x.reshape(-1, k)
    codes2 = codes.reshape(k, -1)
    n = codes2.shape[1] * (2 if packed else 1)

    def _meta2d(v):
        """scale/mu -> the (1, 1) / (1, N) layout qmatmul expects: size-1
        metadata is per tensor; otherwise drop the contraction axes and
        broadcast over the flattened output columns."""
        if v.numel() == 1:
            return v.reshape(1, 1)
        v = v[(0,) * n_contract]
        return v.broadcast_to(tuple(out_tail)).reshape(1, n)

    return (x2, codes2, _meta2d(w["scale"]), _meta2d(w["mu"]),
            batch + tuple(out_tail))


def _quant_meta(a, scale, mu):
    """scale/mu of a 2-D operand ``a`` (R, N) -> one float32 (G, N) or
    (G, 1) layout, contiguous on ``a``'s device. Each may be a number or
    a tensor of 1 value (per tensor), N values (per column), or 2-D (G, N)
    / (G, 1) with G dividing R (one metadata row per R/G rows)."""
    if a.dim() != 2:
        raise ValueError(f"quantize/dequantize take a 2-D operand, got "
                         f"{tuple(a.shape)}")
    r, n = a.shape

    def norm(v, what):
        v = torch.as_tensor(v, dtype=torch.float32, device=a.device)
        if v.dim() == 2 and v.shape[1] in (1, n) and v.shape[0] >= 1 \
                and r % v.shape[0] == 0:
            return v
        if v.numel() in (1, n):
            return v.reshape(1, -1)
        raise ValueError(f"{what} {tuple(v.shape)} does not fit a ({r}, {n}) "
                         f"operand")

    s, m = norm(scale, "scale"), norm(mu, "mu")
    shape = torch.broadcast_shapes(s.shape, m.shape)
    if r % shape[0]:
        raise ValueError(f"scale {tuple(s.shape)} / mu {tuple(m.shape)} do "
                         f"not share a row grouping of {r} rows")
    return s.expand(shape).contiguous(), m.expand(shape).contiguous()


def quantize_tensor(x, scale, mu, bits: int = 8, in_x_dtype: bool = False):
    """x (R, N) float -> uint8 codes clip(round((x - mu) / scale), 0,
    2^bits - 1), bits <= 8; metadata as :func:`_quant_meta` takes it.
    ``in_x_dtype`` rounds ``x - mu`` and the quotient to ``x``'s dtype
    (``ref.quantize_ref``)."""
    scale, mu = _quant_meta(x, scale, mu)
    if not 1 <= bits <= 8:
        raise ValueError(f"quantize_tensor: bits must be in 1..8, got {bits}")
    if _plain(x):
        return qk.quantize_plain(x, scale, mu, bits, in_x_dtype)
    return qk.quantize_cuda(x.contiguous(), scale, mu, bits, in_x_dtype)


def dequantize_tensor(codes, scale, mu, out_dtype=torch.bfloat16):
    """codes (R, N) uint8 -> codes * scale + mu in ``out_dtype``."""
    scale, mu = _quant_meta(codes, scale, mu)
    if _plain(codes):
        return qk.dequantize_plain(codes, scale, mu, out_dtype)
    return qk.dequantize_cuda(codes.contiguous(), scale, mu, out_dtype)


def quantize_pack4(x, scale, mu):
    """Fused quantize + int4 packing: x (R, N) float, N even -> (R, N/2)
    uint8, two 4-bit codes per byte (low nibble = even column)."""
    scale, mu = _quant_meta(x, scale, mu)
    if x.shape[1] % 2:
        raise ValueError(f"quantize_pack4: int4 packing pairs adjacent "
                         f"columns, N = {x.shape[1]} is odd")
    if _plain(x):
        return qk.quantize_pack4_plain(x, scale, mu)
    return qk.quantize_pack4_cuda(x.contiguous(), scale, mu)


def pack_int4(codes):
    """(..., N) codes in [0, 15] -> (..., N/2) bytes, plain ops on every
    device (the reference has no kernel for it either)."""
    return ref.pack_int4_ref(codes)
