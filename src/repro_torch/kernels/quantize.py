"""Quantize, fused quantize-and-pack-int4 and dequantize kernels —
wrappers of ``csrc/quantize.cu``, the port of ``repro/kernels/quantize.py``.

Every function here takes a 2-D operand ``(R, N)`` and metadata
``scale``/``mu`` as float32 ``(G, N)`` (per column) or ``(G, 1)`` (per
tensor) of one shape, ``G`` dividing ``R``: row ``r`` uses metadata row
``r // (R // G)``. ``G = 1`` is the reference's layout; the port's
``quantize_stacked`` passes ``G = P`` periods so that a whole stacked
leaf is one launch. ``kernels.ops`` normalises its callers' metadata to
this form.

The ``*_cuda`` wrappers take CUDA tensors only: they check device,
dtype, shape and contiguity, allocate the output, launch on PyTorch's
current stream and raise on a launch error; ``launches`` on each counts
its kernel launches. The ``*_plain`` functions are the plain PyTorch
versions of the same functions (``kernels.ref`` applied group by group);
``kernels.ops`` runs them for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

_X_DTYPES = (torch.float32, torch.bfloat16)
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _check(t, dtypes, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: the quantize kernels need CUDA tensors, "
                         f"got {t.device}")
    if t.dim() != 2 or not t.is_contiguous() or t.dtype not in dtypes:
        raise ValueError(f"{what}: need a contiguous 2-D tensor of "
                         f"{[str(d) for d in dtypes]}, got {t.dtype} "
                         f"{tuple(t.shape)}")


def _groups(a, scale, mu) -> tuple[int, int]:
    """(G, per_col) of the metadata of a (R, N) operand ``a``."""
    r, n = a.shape
    for v, what in ((scale, "scale"), (mu, "mu")):
        if v.device != a.device or v.dtype != torch.float32 or \
                v.dim() != 2 or not v.is_contiguous():
            raise ValueError(f"{what}: need a contiguous float32 (G, N) or "
                             f"(G, 1) tensor on {a.device}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")
    g, w = scale.shape
    if mu.shape != scale.shape or g < 1 or r % g or w not in (1, n):
        raise ValueError(f"scale {tuple(scale.shape)} / mu "
                         f"{tuple(mu.shape)} do not fit a ({r}, {n}) operand")
    return g, int(w == n and n > 1)


def _quantize(x, scale, mu, levels: int, pack4: bool, in_x_dtype=False):
    _check(x, _X_DTYPES, "x")
    r, n = x.shape
    if pack4 and n % 2:
        raise ValueError(f"quantize_pack4: int4 packing pairs adjacent "
                         f"columns, N = {n} is odd")
    g, per_col = _groups(x, scale, mu)
    out = torch.empty((r, n // 2 if pack4 else n), dtype=torch.uint8,
                      device=x.device)
    if out.numel() == 0:
        return out
    fn = build.launcher("quantize", "quantize_launch", "ppppiiiiiiiip")
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), scale.data_ptr(), mu.data_ptr(),
                out.data_ptr(), r, n, g, per_col, levels,
                build.DTYPE_CODES[x.dtype], int(pack4),
                int(in_x_dtype and x.dtype == torch.bfloat16),
                build.stream_handle(x))
    build.check(rc, "quantize_pack4" if pack4 else "quantize")
    (quantize_pack4_cuda if pack4 else quantize_cuda).launches += 1
    return out


def quantize_cuda(x, scale, mu, bits: int = 8, in_x_dtype: bool = False):
    """x (R, N) f32/bf16 -> uint8 codes clip(round((x - mu) / scale), 0,
    2^bits - 1), 1 <= bits <= 8. With ``in_x_dtype`` a bf16 ``x`` has
    ``x - mu`` and the quotient rounded to bf16, as
    ``ref.quantize_ref``."""
    if not 1 <= bits <= 8:
        raise ValueError(f"quantize: bits must be in 1..8, got {bits}")
    return _quantize(x, scale, mu, (1 << bits) - 1, pack4=False,
                     in_x_dtype=in_x_dtype)


def quantize_pack4_cuda(x, scale, mu):
    """x (R, N) f32/bf16, N even -> (R, N/2) uint8: 4-bit codes
    clip(round((x - mu) / scale), 0, 15), byte j = code[2j] | code[2j+1]
    << 4 (the qmatmul4 layout)."""
    return _quantize(x, scale, mu, 15, pack4=True)


def dequantize_cuda(codes, scale, mu, out_dtype=torch.bfloat16):
    """codes (R, N) uint8 -> codes * scale + mu in ``out_dtype`` (f32 or
    bf16), rounded after the product and after the sum."""
    _check(codes, (torch.uint8,), "codes")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"dequantize: out dtype must be float32 or "
                         f"bfloat16, got {out_dtype}")
    r, n = codes.shape
    g, per_col = _groups(codes, scale, mu)
    out = torch.empty((r, n), dtype=out_dtype, device=codes.device)
    if out.numel() == 0:
        return out
    fn = build.launcher("quantize", "dequantize_launch", "ppppiiiiip")
    with torch.cuda.device(codes.device):
        rc = fn(codes.data_ptr(), scale.data_ptr(), mu.data_ptr(),
                out.data_ptr(), r, n, g, per_col,
                build.DTYPE_CODES[out_dtype], build.stream_handle(codes))
    build.check(rc, "dequantize")
    dequantize_cuda.launches += 1
    return out


quantize_cuda.launches = 0
quantize_pack4_cuda.launches = 0
dequantize_cuda.launches = 0


def _grouped(fn, a, scale, mu, *args):
    """Apply the elementwise plain version ``fn`` to ``a`` (R, N) with
    (G, N|1) metadata by viewing ``a`` as (G, R/G, N)."""
    r, n = a.shape
    g = scale.shape[0]
    out = fn(a.reshape(g, r // g, n), scale.reshape(g, 1, -1),
             mu.reshape(g, 1, -1), *args)
    return out.reshape(r, -1)


def quantize_plain(x, scale, mu, bits: int = 8, in_x_dtype: bool = False):
    return _grouped(ref.quantize_ref, x, scale, mu, bits, in_x_dtype)


def quantize_pack4_plain(x, scale, mu):
    return _grouped(ref.quantize_pack4_ref, x, scale, mu)


def dequantize_plain(codes, scale, mu, out_dtype=torch.bfloat16):
    return _grouped(ref.dequantize_ref, codes, scale, mu, out_dtype)
