"""Causal flash attention (forward) — wrapper of
``csrc/flash_attention.cu``, the port of
``repro/kernels/flash_attention.py``.

CUDA tensors only; the plain version is
``models.attention._blocked_causal_attention`` and
``kernels.ops.flash_attention`` picks by device. The kernel routes by
dtype: bfloat16 runs on the tensor cores (mma.sync), float32 on the CUDA
cores; both are launched here, neither falls back to the other.
``flash_attention_cuda.launches`` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

HEAD_DIMS = (64, 128)


def flash_attention_cuda(q, k, v):
    """q (B, S, KV, G, hd), k/v (B, S, KV, hd), one dtype (f32/bf16), hd
    64 or 128 -> (B, S, KV, G, hd) causal attention. Any S."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    if q.dim() != 5 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, s, kvh, g, hd = q.shape
    if tuple(k.shape) != (b, s, kvh, hd):
        raise ValueError(f"flash attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous() or \
                t.data_ptr() % 16:
            raise ValueError("flash attention: q/k/v must be contiguous, "
                             "16-byte aligned and on one device")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = build.launcher("flash_attention", "flash_attention_launch",
                        "ppppiiiiifip")
    with torch.cuda.device(q.device):     # launch on the tensors' card
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
                kvh, g, hd, hd ** -0.5, build.DTYPE_CODES[q.dtype],
                build.stream_handle(q))
    build.check(rc, "flash attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
