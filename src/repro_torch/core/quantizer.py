"""Uniform asymmetric quantizer (paper Eq. 9–10), on torch tensors.

Given a tensor c and bit-width b the quantization set is the uniform grid
``Q = [mu : (phi-mu)/(2^b - 1) : phi]`` and ``Q(c) = argmin_{q in Q} |c-q|``
— round-to-nearest onto the grid (``torch.round`` rounds half to even,
as the reference does). The optimizer's continuous bit-widths are NumPy
arrays and stay NumPy here (``round_bits``, ``payload_bits``).
"""
from __future__ import annotations

import numpy as np
import torch


def qrange(x):
    """Tensor range (mu, phi) used by the asymmetric quantizer."""
    return torch.amin(x), torch.amax(x)


def quantize(x, bits: int, mu=None, phi=None):
    """-> (codes int32, scale, mu). codes in [0, 2^bits - 1]. Either end
    of the grid may be pinned by the caller; the other defaults to the
    tensor's own range. Arithmetic stays in ``x``'s dtype."""
    if mu is None:
        mu = torch.amin(x)
    if phi is None:
        phi = torch.amax(x)
    levels = (1 << int(bits)) - 1
    scale = torch.clamp((phi - mu) / levels, min=1e-12)
    codes = torch.clamp(torch.round((x - mu) / scale), 0, levels)
    return codes.to(torch.int32), scale, mu


def dequantize(codes, scale, mu, dtype=torch.float32):
    return (codes.float() * scale + mu).to(dtype)


def fake_quant(x, bits: int):
    """Quantize-dequantize in ``x``'s dtype."""
    codes, scale, mu = quantize(x, bits)
    return dequantize(codes, scale, mu, x.dtype)


def quant_noise_energy(x, bits: int):
    """Measured ``||x - Q(x)||_2^2`` — the empirical LHS of Eq. 18/19."""
    err = x - fake_quant(x, bits)
    return torch.sum(torch.square(err.float()))


def round_bits(b, lo: int = 2, hi: int = 16) -> np.ndarray:
    """Continuous solver output -> deployable integer bit-widths."""
    return np.clip(np.ceil(np.asarray(b)), lo, hi).astype(np.int32)


def payload_bits(num_elements: int, bits):
    """Wire size in bits: Eq. 14 term ``b * z`` (+ f32 scale/zero header)."""
    return num_elements * bits + 2 * 32


def stacked_wire_bits(q) -> int:
    """EXACT wire/device size in bits of a quantized wire struct — codes
    plus the real scale/zero metadata."""
    codes = q["codes_packed"] if "codes_packed" in q else q["codes"]
    return int(codes.numel()) * 8 + 32 * (int(q["scale"].numel())
                                          + int(q["mu"].numel()))
