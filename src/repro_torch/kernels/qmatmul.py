"""Dequantize-fused matmul kernels (W8A16 / W4A16) — wrappers of
``csrc/qmatmul.cu``, the port of ``repro/kernels/qmatmul.py``. At M <=
16 both code widths run the split-K cluster kernel; above it bf16
activations run the tensor-core kernel (K split over a cluster, chosen
from K and N alone, so that a row's bits do not depend on M) and f32
ones the CUDA-core tiled kernel. Each is one launch per call and gives
the same bits on every call.

The wrappers take CUDA tensors only: they check device, dtype, shape
and contiguity, allocate the output, launch on PyTorch's current stream
and raise on a launch error. Their plain versions are
``kernels.ref.qmatmul_ref`` / ``qmatmul4_ref``; ``kernels.ops.qdense``
picks one or the other by the tensor's device. ``launches`` on each
wrapper counts its kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_ACT_DTYPES = (torch.float32, torch.bfloat16)


def _check_meta(v, n: int, device, what: str) -> bool:
    """scale/mu: f32, contiguous, 1 value (per tensor) or n (per column).
    Returns True when per column."""
    if v.device != device or v.dtype != torch.float32 or \
            not v.is_contiguous() or v.numel() not in (1, n):
        raise ValueError(f"{what}: need a contiguous float32 tensor of 1 or "
                         f"{n} values on {device}, got {v.dtype} "
                         f"{tuple(v.shape)} on {v.device}")
    return v.numel() == n and n > 1


def _launch(x, codes, scale, mu, out_dtype, packed: bool):
    if x.device.type != "cuda":
        raise ValueError(f"qmatmul kernel needs CUDA tensors, got {x.device}")
    if x.dim() != 2 or codes.dim() != 2 or not x.is_contiguous() or \
            not codes.is_contiguous():
        raise ValueError("qmatmul: x (M, K) and codes must be contiguous 2-D")
    if x.dtype not in _ACT_DTYPES or out_dtype not in _ACT_DTYPES:
        raise ValueError(f"qmatmul: x/out dtype must be float32 or bfloat16, "
                         f"got {x.dtype} -> {out_dtype}")
    if codes.dtype != torch.uint8 or codes.device != x.device:
        raise ValueError("qmatmul: codes must be uint8 on x's device")
    m, k = x.shape
    if codes.shape[0] != k:
        raise ValueError(f"qmatmul: x {tuple(x.shape)} vs codes "
                         f"{tuple(codes.shape)}")
    n = codes.shape[1] * (2 if packed else 1)
    per_s = _check_meta(scale, n, x.device, "scale")
    per_m = _check_meta(mu, n, x.device, "mu")
    if per_s != per_m:
        raise ValueError("qmatmul: scale and mu must share one granularity")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = build.launcher("qmatmul", "qmatmul_launch", "pppppiiiiiiip")
    with torch.cuda.device(x.device):     # launch on the tensors' card
        rc = fn(x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                mu.data_ptr(), out.data_ptr(), m, k, n,
                build.DTYPE_CODES[x.dtype], build.DTYPE_CODES[out_dtype],
                int(per_s), int(packed), build.stream_handle(x))
    build.check(rc, "qmatmul4" if packed else "qmatmul")
    (qmatmul4_cuda if packed else qmatmul_cuda).launches += 1
    return out


def qmatmul_cuda(x, codes, scale, mu, out_dtype=torch.bfloat16):
    """x (M, K) f32/bf16 @ dequant(codes (K, N) uint8) -> (M, N).
    scale/mu: f32 with 1 value or N (per output column)."""
    return _launch(x, codes, scale, mu, out_dtype, packed=False)


def qmatmul4_cuda(x, packed, scale, mu, out_dtype=torch.bfloat16):
    """x (M, K) @ dequant(packed (K, N/2) uint8, two nibbles per byte,
    low nibble = even column) -> (M, N). scale/mu indexed in unpacked
    column space."""
    return _launch(x, packed, scale, mu, out_dtype, packed=True)


qmatmul_cuda.launches = 0
qmatmul4_cuda.launches = 0
