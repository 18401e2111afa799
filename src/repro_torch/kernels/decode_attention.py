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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def decode_attention_cuda(q, ck, cv, pos):
    """q (B, KVp, Gp, hd) f32/bf16 post-RoPE query; ck/cv (B, buf, KVp,
    hd) the cache AFTER the step's K/V write, in f32, bf16 or
    float8_e4m3fn; ``pos`` the absolute position, a host int or a 0-d
    int32 / int64 tensor on q's card, which the kernel reads there (it is
    never read on the host). -> (B, KVp, Gp, hd) in the query dtype."""
    if q.device.type != "cuda":
        raise ValueError(f"decode attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    if q.dim() != 4 or ck.dim() != 4 or ck.shape != cv.shape:
        raise ValueError(f"decode attention: q {tuple(q.shape)}, ck "
                         f"{tuple(ck.shape)}, cv {tuple(cv.shape)}")
    b, kvp, gp, hd = q.shape
    buf = ck.shape[1]
    if (ck.shape[0], ck.shape[2], ck.shape[3]) != (b, kvp, hd):
        raise ValueError(f"decode attention: cache {tuple(ck.shape)} does "
                         f"not match q {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
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
    if torch.is_tensor(pos):
        if pos.dim() != 0 or pos.device != q.device or \
                pos.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"decode attention: a tensor pos must be a 0-d "
                             f"int32 / int64 tensor on {q.device}, got "
                             f"{pos.dtype} {tuple(pos.shape)} on "
                             f"{pos.device}")
        pos_dev, pos_is64, pos_host = (pos.data_ptr(),
                                       int(pos.dtype == torch.int64), 0)
    else:
        pos_dev, pos_is64, pos_host = None, 0, int(pos)
        if pos_host < 0:
            raise ValueError(f"decode attention: pos {pos_host} < 0")
    out = torch.empty_like(q)
    fn = build.launcher("decode_attention", "decode_attention_launch",
                        "ppppiiiiipilfiip")
    with torch.cuda.device(q.device):     # launch on the tensors' card
        rc = fn(q.data_ptr(), ck.data_ptr(), cv.data_ptr(), out.data_ptr(), b,
                buf, kvp, gp, hd, pos_dev, pos_is64, pos_host, hd ** -0.5,
                build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[ck.dtype],
                build.stream_handle(q))
    build.check(rc, "decode attention")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
