"""Single-query decode attention over a ring-buffer KV cache — wrapper of
``csrc/decode_attention.cu``, the port of
``repro/kernels/decode_attention.py``.

The kernel splits the live ring slots over a thread-block cluster per
(batch row, kv head) and combines the partial softmax results in one
launch. The position may stay on the card, as the Pallas kernel's
scalar-prefetch ``pos``: the launch is then the same for every position
and a CUDA graph replays it. CUDA tensors only; the plain version is
``kernels.ref.decode_attention_ref`` and ``kernels.ops.decode_attention``
picks by device. ``decode_attention_cuda.launches`` counts launches.

:func:`decode_attention_shard_cuda` runs over a shard of a ring (the
model-parallel rank program's sequence-sharded ring,
``models.attention``): the global slots ``[slot0, slot0 + n)`` of a ring
of ``ring`` slots, returning the f32 output and each row's f32
log-sum-exp, by which the ranks merge their shards. Its route follows
the cache's dtype: bf16 and float8_e4m3fn shards run
``decode_shard_tc_kernel`` on the tensor cores (the query group as the
MMA's 16 rows, the f32 query and probabilities as bf16 hi/lo pairs, each
CTA's partial combined over the cluster column by column); f32 shards
keep the CUDA-core kernel of :func:`decode_attention_cuda`, since one
bf16 product cannot form an f32 K's scores exactly and no path on the
card shards an f32 ring. Its plain version is
``kernels.ref.decode_attention_shard_ref``; it counts its own launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def _position(pos, q):
    """(device pointer or None, is int64, host value) of a decode
    position: a host int, or a 0-d int32 / int64 tensor on q's card."""
    if torch.is_tensor(pos):
        if pos.dim() != 0 or pos.device != q.device or \
                pos.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"decode attention: a tensor pos must be a 0-d "
                             f"int32 / int64 tensor on {q.device}, got "
                             f"{pos.dtype} {tuple(pos.shape)} on "
                             f"{pos.device}")
        return pos.data_ptr(), int(pos.dtype == torch.int64), 0
    if int(pos) < 0:
        raise ValueError(f"decode attention: pos {int(pos)} < 0")
    return None, 0, int(pos)


def _check(q, ck, cv, q_dtypes, kv0=None):
    if q.device.type != "cuda":
        raise ValueError(f"decode attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    if q.dim() != 4 or ck.dim() != 4 or ck.shape != cv.shape:
        raise ValueError(f"decode attention: q {tuple(q.shape)}, ck "
                         f"{tuple(ck.shape)}, cv {tuple(cv.shape)}")
    b, kvp, gp, hd = q.shape
    heads = ck.shape[2] == kvp if kv0 is None else \
        0 <= kv0 and kv0 + kvp <= ck.shape[2]
    if (ck.shape[0], ck.shape[3]) != (b, hd) or not heads:
        raise ValueError(f"decode attention: cache {tuple(ck.shape)} does "
                         f"not match q {tuple(q.shape)} at KV head {kv0}")
    if q.dtype not in q_dtypes or \
            ck.dtype not in build.DTYPE_CODES or cv.dtype != ck.dtype:
        raise ValueError(f"decode attention: q {q.dtype}, cache {ck.dtype}/"
                         f"{cv.dtype}")
    for t in (q, ck, cv):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("decode attention: q/ck/cv must be contiguous "
                             "on one device")
    if not 1 <= gp <= 16 or hd % 32 or not 32 <= hd <= 256:
        raise ValueError(f"decode attention: the kernel takes Gp <= 16 and "
                         f"hd a multiple of 32 up to 256, got Gp {gp}, hd "
                         f"{hd}")
    if ck.data_ptr() % 16 or cv.data_ptr() % 16:
        raise ValueError("decode attention: the cache must be 16-byte "
                         "aligned (16-byte row loads)")


def decode_attention_shard_cuda(q, ck, cv, pos, slot0: int, ring: int):
    """q (B, KVp, Gp, hd) f32 post-RoPE query; ck/cv (B, n, KVp, hd) the
    global slots ``[slot0, slot0 + n)`` of a ring of ``ring`` slots AFTER
    the step's K/V write (f32, bf16 or float8_e4m3fn); ``pos`` as for
    :func:`decode_attention_cuda`. -> (out (B, KVp, Gp, hd) f32, lse
    (B, KVp, Gp) f32): the attention over the shard's live slots and the
    natural log-sum-exp of their scaled scores (zeros and -inf where the
    shard holds none)."""
    _check(q, ck, cv, (torch.float32,))
    b, kvp, gp, hd = q.shape
    n = ck.shape[1]
    if slot0 < 0 or slot0 + n > ring:
        raise ValueError(f"decode attention shard: slots [{slot0}, "
                         f"{slot0 + n}) outside a ring of {ring}")
    pos_dev, pos_is64, pos_host = _position(pos, q)
    out = torch.empty_like(q)
    lse = torch.empty((b, kvp, gp), dtype=torch.float32, device=q.device)
    fn = build.launcher("decode_attention", "decode_attention_shard_launch",
                        "pppppiiiiiiipilfip")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), ck.data_ptr(), cv.data_ptr(), out.data_ptr(),
                lse.data_ptr(), b, n, kvp, gp, hd, int(slot0), int(ring),
                pos_dev, pos_is64, pos_host, hd ** -0.5,
                build.DTYPE_CODES[ck.dtype], build.stream_handle(q))
    build.check(rc, "decode attention shard")
    decode_attention_shard_cuda.launches += 1
    return out, lse


decode_attention_shard_cuda.launches = 0


def decode_attention_cuda(q, ck, cv, pos, kv0=None):
    """q (B, KVp, Gp, hd) f32/bf16 post-RoPE query; ck/cv (B, buf, KVp,
    hd) the cache AFTER the step's K/V write, in f32, bf16 or
    float8_e4m3fn; ``pos`` the absolute position, a host int or a 0-d
    int32 / int64 tensor on q's card, which the kernel reads there (it is
    never read on the host). -> (B, KVp, Gp, hd) in the query dtype.
    Given ``kv0``, the cache may hold more heads, (B, buf, KVc, hd), and
    the query's KVp heads read its heads ``[kv0, kv0 + KVp)`` in place:
    the rank program's ring held whole by every rank."""
    _check(q, ck, cv, (torch.float32, torch.bfloat16), kv0)
    b, kvp, gp, hd = q.shape
    buf, heads = ck.shape[1], ck.shape[2]
    at = (kv0 or 0) * hd * ck.element_size()     # the block's first head
    pos_dev, pos_is64, pos_host = _position(pos, q)
    out = torch.empty_like(q)
    fn = build.launcher("decode_attention", "decode_attention_launch",
                        "ppppiiiiiipilfiip")
    with torch.cuda.device(q.device):     # launch on the tensors' card
        rc = fn(q.data_ptr(), ck.data_ptr() + at, cv.data_ptr() + at,
                out.data_ptr(), b, buf, kvp, heads, gp, hd, pos_dev,
                pos_is64, pos_host, hd ** -0.5,
                build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[ck.dtype],
                build.stream_handle(q))
    build.check(rc, "decode attention")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
