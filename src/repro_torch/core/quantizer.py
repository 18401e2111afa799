"""Uniform asymmetric quantizer (paper Eq. 9–10), on torch tensors.

Given a tensor c and bit-width b the quantization set is the uniform grid
``Q = [mu : (phi-mu)/(2^b - 1) : phi]`` and ``Q(c) = argmin_{q in Q} |c-q|``
— round-to-nearest onto the grid (``torch.round`` rounds half to even,
as the reference does). The optimizer's continuous bit-widths are NumPy
arrays and stay NumPy here (``round_bits``, ``payload_bits``).

``quantize_stacked`` / ``quantize_params_for_serving`` build the int8 /
int4 wire structs the serving launcher keeps on the card, through the
quantize and quantize-and-pack-int4 kernels (``kernels.ops``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.tree import tree_map


def qrange(x):
    """Tensor range (mu, phi) used by the asymmetric quantizer."""
    return torch.amin(x), torch.amax(x)


def grid_step(span, levels: int):
    """max(span / levels, 1e-12), the quotient rounded once. ``levels``
    divides as a tensor on ``span``'s device: PyTorch turns a CUDA tensor
    divided by a Python number into a product with its reciprocal, which
    misses the reference's (and the CPU's) quotient by an ulp."""
    lv = torch.full((), levels, dtype=span.dtype, device=span.device)
    return torch.clamp(span / lv, min=1e-12)


def quantize(x, bits: int, mu=None, phi=None):
    """-> (codes int32, scale, mu). codes in [0, 2^bits - 1]. Either end
    of the grid may be pinned by the caller; the other defaults to the
    tensor's own range. Arithmetic stays in ``x``'s dtype."""
    if mu is None:
        mu = torch.amin(x)
    if phi is None:
        phi = torch.amax(x)
    levels = (1 << int(bits)) - 1
    scale = grid_step(phi - mu, levels)
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


def analytic_noise_scale(x):
    """Analytic s such that ||sigma(b)||^2 ~= s * e^(-ln4 * b): uniform
    round-off noise over n elements of range R has energy n R^2 / 12 *
    4^-b, so s = n R^2 / 12."""
    mu, phi = qrange(x)
    return x.numel() * torch.square(phi - mu) / 12.0


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


def stacked_grid(leaf, bits: int, per_channel: bool = True) -> dict:
    """The quantization grid of a stacked (P, ...) leaf: float32 ``scale``
    and ``mu`` over every axis but the period axis and, per channel on a
    leaf of rank >= 3, the last one — computed in the leaf's dtype, as
    the reference does, then cast."""
    if leaf.dim() < 2:
        raise ValueError(f"quantize_stacked: need a stacked (P, ...) leaf "
                         f"of rank >= 2, got {tuple(leaf.shape)}")
    if per_channel and leaf.dim() >= 3:
        dims = tuple(range(1, leaf.dim() - 1))   # keep periods + channels
    else:
        dims = tuple(range(1, leaf.dim()))
    mu = torch.amin(leaf, dim=dims, keepdim=True)
    phi = torch.amax(leaf, dim=dims, keepdim=True)
    scale = grid_step(phi - mu, (1 << int(bits)) - 1)
    return {"scale": scale.float(), "mu": mu.float()}


def quantize_stacked(leaf, bits: int = 8, per_channel: bool = True):
    """Real int8/int4-code quantization of a stacked (num_periods, ...)
    weight -> the wire struct ``{"codes" | "codes_packed", "scale",
    "mu"}``. Granularity: per period and, by default, per output column
    — scale/mu keep the leading period axis and the trailing channel axis,
    e.g. (P, 1, N) for a (P, K, N) leaf; per tensor they are (P, 1, 1).

    At bits <= 4 with an even last dim, two codes share a byte (low nibble
    = even column, the qmatmul4 layout) under ``codes_packed``; otherwise
    ``codes`` are uint8 at 2^bits - 1 levels. The leaf, viewed as
    (P * rows, N), goes through ONE quantize-and-pack-int4 or quantize
    launch with (P, N) / (P, 1) metadata, whatever its shape.

    The reference's int8-code branch computes ``(leaf - mu) / scale`` in
    the leaf's dtype with the un-cast grid, so there a bfloat16 leaf has
    the difference and the quotient rounded to bfloat16 (the f32 metadata
    holds the grid's bfloat16 values exactly); the packed branch, as the
    reference's, computes in f32."""
    meta = stacked_grid(leaf, bits, per_channel)
    p, n = leaf.shape[0], leaf.shape[-1]
    flat = leaf.reshape(-1, n)
    s2, m2 = meta["scale"].reshape(p, -1), meta["mu"].reshape(p, -1)
    if bits <= 4 and n % 2 == 0:
        packed = ops.quantize_pack4(flat, s2, m2)
        return {"codes_packed": packed.reshape(leaf.shape[:-1] + (n // 2,)),
                **meta}
    codes = ops.quantize_tensor(flat, s2, m2, bits, in_x_dtype=True)
    return {"codes": codes.reshape(leaf.shape), **meta}


QUANTIZABLE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "w_z", "w_x", "w_out", "w_B", "w_C", "w_dt")


def quantize_params_for_serving(params, bits: int = 8,
                                per_channel: bool = True):
    """Quantize every big block weight (``QUANTIZABLE`` keys of rank >= 3
    under ``params["blocks"]``) of a transformer param tree to wire
    structs; everything else passes through as the same tensors."""
    def walk(node):
        if isinstance(node, dict):
            return {k: quantize_stacked(v, bits, per_channel=per_channel)
                    if k in QUANTIZABLE and isinstance(v, torch.Tensor)
                    and v.dim() >= 3 else walk(v)
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return {k: ([walk(b) for b in v] if k == "blocks" else v)
            for k, v in params.items()}


def quantize_tree(params, bits_per_leaf):
    """Fake-quantize a parameter tree with per-leaf bit-widths (an int, or
    a tree shaped like ``params``)."""
    if isinstance(bits_per_leaf, int):
        return tree_map(lambda x: fake_quant(x, bits_per_leaf), params)
    return tree_map(lambda x, b: fake_quant(x, int(b)), params,
                    bits_per_leaf)
