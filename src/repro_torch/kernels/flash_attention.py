"""Causal flash attention, forward and backward — wrappers of
``csrc/flash_attention.cu`` (the port of
``repro/kernels/flash_attention.py``) and ``csrc/flash_attention_bwd.cu``
(port-only: the reference's training gradient is XLA's autodiff of
``models/attention.py`` ``_blocked_causal_attention``).

CUDA tensors only; the plain versions are
``models.attention._blocked_causal_attention`` (forward) and
``kernels.ref.flash_attention_lse_ref`` / ``flash_attention_bwd_ref``,
and ``kernels.ops.flash_attention`` picks by device. Both kernels route
by dtype: bfloat16 runs on the tensor cores (mma.sync; the backward's
dK/dV kernel splits each key block's causal walk over a thread-block
cluster), float32 on the CUDA cores; both are launched here, neither
falls back to the other, and the backward is bitwise repeatable (no
atomics). :class:`FlashAttention` is the autograd function of the pair: its
forward launches the forward kernel with the row log-sum-exp, its
backward the backward kernel. ``flash_attention_cuda.launches`` and
``flash_attention_bwd_cuda.launches`` count launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

HEAD_DIMS = (64, 128)


def _check(what, q, k, v, *rest):
    """Shapes, dtypes and layout the kernels take: q and ``rest`` (B, S,
    KV, G, hd), k/v (B, S, KV, hd), one dtype (f32/bf16), hd 64 or 128,
    contiguous and 16-byte aligned on one CUDA device."""
    if q.device.type != "cuda":
        raise ValueError(f"{what} kernel needs CUDA tensors, got {q.device}")
    if q.dim() != 5 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, s, kvh, g, hd = q.shape
    if tuple(k.shape) != (b, s, kvh, hd):
        raise ValueError(f"{what}: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if any(t.shape != q.shape for t in rest):
        raise ValueError(f"{what}: {[tuple(t.shape) for t in rest]} do not "
                         f"match q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != q.dtype for t in (k, v, *rest)):
        raise ValueError(f"{what}: dtypes "
                         f"{[str(t.dtype) for t in (q, k, v, *rest)]}")
    for t in (q, k, v, *rest):
        if t.device != q.device or not t.is_contiguous() or \
                t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must be contiguous, 16-byte "
                             "aligned and on one device")
    return b, s, kvh, g, hd


def flash_attention_cuda(q, k, v, with_lse: bool = False):
    """q (B, S, KV, G, hd), k/v (B, S, KV, hd), one dtype (f32/bf16), hd
    64 or 128 -> (B, S, KV, G, hd) causal attention. Any S. With
    ``with_lse`` also the rows' log-sum-exp of the scaled scores (natural
    log, float32, (B, S, KV, G)) -> (out, lse)."""
    b, s, kvh, g, hd = _check("flash attention", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, s, kvh, g), dtype=torch.float32,
                      device=q.device) if with_lse else None
    if out.numel():
        fn = build.launcher("flash_attention", "flash_attention_launch",
                            "pppppiiiiifip")
        with torch.cuda.device(q.device):     # launch on the tensors' card
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr() if with_lse else None, b, s, kvh, g, hd,
                    hd ** -0.5, build.DTYPE_CODES[q.dtype],
                    build.stream_handle(q))
        build.check(rc, "flash attention")
        flash_attention_cuda.launches += 1
    return (out, lse) if with_lse else out


flash_attention_cuda.launches = 0


def flash_attention_bwd_cuda(q, k, v, out, lse, d_out):
    """The gradient of :func:`flash_attention_cuda`: q, out, d_out (B, S,
    KV, G, hd), k/v (B, S, KV, hd), one dtype, and the forward's ``lse``
    (float32, (B, S, KV, G)) -> (dq, dk, dv) in the input dtype, float32
    accumulation, bitwise the same on every call (no atomics)."""
    b, s, kvh, g, hd = _check("flash attention backward", q, k, v, out,
                              d_out)
    if lse.shape != (b, s, kvh, g) or lse.dtype != torch.float32 or \
            lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"flash attention backward: lse {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}, want float32 "
                         f"{(b, s, kvh, g)} on {q.device}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel():
        delta = torch.empty_like(lse)          # rowsum(dO * O), scratch
        fn = build.launcher("flash_attention_bwd",
                            "flash_attention_bwd_launch",
                            "ppppppppppiiiiifip")
        with torch.cuda.device(q.device):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), d_out.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), b, s, kvh,
                    g, hd, hd ** -0.5, build.DTYPE_CODES[q.dtype],
                    build.stream_handle(q))
        build.check(rc, "flash attention backward")
        flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


class FlashAttention(torch.autograd.Function):
    """Causal attention through the kernel pair: the forward saves q, k, v,
    out and the row log-sum-exp; the backward launches the backward
    kernel on them. Under ``torch.utils.checkpoint`` the forward runs
    again in the backward pass (and counts again)."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_cuda(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_attention_bwd_cuda(q, k, v, out, lse,
                                        d_out.contiguous())
