"""Rotary position embedding variants.

- ``rope``   : standard llama RoPE over the full head dim.
- ``rope2d`` : GLM-style partial rotary — only the first half of the head
               dims rotate, the second half is passthrough.
- ``mrope``  : Qwen2-VL multimodal RoPE — the head dim is split into three
               sections (t, h, w) each rotated by its own position stream;
               for text all three carry the same positions.

``positions`` are (B, S) int, or (3, B, S) for mrope.
"""
from __future__ import annotations

import torch

MROPE_SECTIONS = (1 / 4, 3 / 8, 3 / 8)   # t, h, w


def _freq(half: int, theta: float, device):
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def _angles(positions, dim: int, theta: float):
    """positions (..., S) -> angles (..., S, dim//2)."""
    return positions[..., None].float() * _freq(dim // 2, theta,
                                                positions.device)


def _rotate(x, ang):
    """x (..., S, *head_dims, D), ang (..., S, D//2): rotate the (first
    half, second half) pairs, broadcasting over the head dims between S
    and D."""
    dt = x.dtype
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    cos, sin = torch.cos(ang), torch.sin(ang)
    while cos.dim() < x1.dim():
        cos = cos[..., None, :]
        sin = sin[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(dt)


def apply_rope(kind: str, x, positions, theta: float):
    d = x.shape[-1]
    if kind == "none":
        return x
    if kind == "rope":
        return _rotate(x, _angles(positions, d, theta))
    if kind == "rope2d":
        half = d // 2
        rot = _rotate(x[..., :half], _angles(positions, half, theta))
        return torch.cat([rot, x[..., half:]], dim=-1)
    if kind == "mrope":
        if positions.dim() == 2:
            positions = positions[None].expand((3,) + tuple(positions.shape))
        half = d // 2
        sizes = [int(round(f * half)) for f in MROPE_SECTIONS]
        sizes[-1] = half - sizes[0] - sizes[1]
        seg = torch.cat([positions[i][..., None].expand(
            tuple(positions[i].shape) + (sizes[i],)) for i in range(3)],
            dim=-1)
        return _rotate(x, seg.float() * _freq(half, theta, x.device))
    raise ValueError(f"unknown rope kind {kind!r}")


def text_positions(batch: int, seq: int, offset=0, device="cuda"):
    """(batch, seq) int32 positions ``offset .. offset + seq - 1``;
    ``offset`` a host int or a 0-d integer tensor on ``device`` (added
    there, never read on the host)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] \
        + offset
    return pos.expand(batch, seq)
