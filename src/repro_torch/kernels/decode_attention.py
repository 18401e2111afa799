"""Single-query decode attention over a ring-buffer KV cache — wrapper of
``csrc/decode_attention.cu``, the port of
``repro/kernels/decode_attention.py``.

The kernel splits the live ring slots over a thread-block cluster per
(batch row, kv head) and combines the partial softmax results in one
launch. CUDA tensors only; the plain version is
``kernels.ref.decode_attention_ref`` and ``kernels.ops.decode_attention``
picks by device. ``decode_attention_cuda.launches`` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def decode_attention_cuda(q, ck, cv, pos: int):
    """q (B, KVp, Gp, hd) f32/bf16 post-RoPE query; ck/cv (B, buf, KVp,
    hd) the cache AFTER the step's K/V write, in f32, bf16 or
    float8_e4m3fn; ``pos`` the absolute position. -> (B, KVp, Gp, hd) in
    the query dtype."""
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
    pos = int(pos)
    if pos < 0:
        raise ValueError(f"decode attention: pos {pos} < 0")
    # live ring slots: all once wrapped, else 0 .. pos % buf
    n_valid = buf if pos + 1 >= buf else pos % buf + 1
    out = torch.empty_like(q)
    fn = build.launcher("decode_attention", "decode_attention_launch",
                        "ppppiiiiiifiip")
    with torch.cuda.device(q.device):     # launch on the tensors' card
        rc = fn(q.data_ptr(), ck.data_ptr(), cv.data_ptr(), out.data_ptr(), b,
                buf, kvp, gp, hd, n_valid, hd ** -0.5,
                build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[ck.dtype],
                build.stream_handle(q))
    build.check(rc, "decode attention")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
