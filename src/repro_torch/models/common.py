"""Shared model primitives: norms, initializers, activations."""
from __future__ import annotations

import torch


def dense_init(shape, generator: torch.Generator, in_axis: int = 0,
               dtype=torch.float32, device="cuda"):
    """Truncated-normal (±3 std) fan-in init."""
    std = shape[in_axis] ** -0.5
    t = torch.empty(shape, dtype=dtype, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return t * std


def embed_init(shape, generator: torch.Generator, dtype=torch.float32,
               device="cuda"):
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=device) * 0.02


# ---------------------------------------------------------------------------
# Norms. Params are dicts so quantization rules can address them.

def rmsnorm_init(dim: int, device="cuda"):
    return {"scale": torch.ones(dim, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * params["scale"]).to(dt)


def layernorm_init(dim: int, device="cuda"):
    return {"scale": torch.ones(dim, device=device),
            "bias": torch.zeros(dim, device=device)}


def layernorm(params, x, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * params["scale"] \
        + params["bias"]
    return out.to(dt)


def norm_init(kind: str, dim: int, device="cuda"):
    return rmsnorm_init(dim, device) if kind == "rmsnorm" \
        else layernorm_init(dim, device)


def norm_apply(kind: str, params, x):
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)


def headnorm(scale, x, eps: float = 1e-6):
    """Per-head RMSNorm over head_dim (qk-norm)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale).to(dt)


def silu(x):
    return x * torch.sigmoid(x)


# float8_e4m3fn has no infinity. The reference's cast rounds to nearest
# even and turns a magnitude that rounds past the largest finite value
# (448: everything above the 464 midpoint to the next step, 480, and
# +-inf) into nan, keeping the sign; torch's cast saturates to +-448.
_F8_ROUNDS_TO_NAN = 464.0


# same-width integer dtypes: copies through them move bits, whatever the
# float (index_copy_ has no float8 kernel)
_BITS_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def as_bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` viewed as the integer dtype of its element width."""
    return t.view(_BITS_VIEW[t.element_size()])


def to_storage(x, dtype):
    """Cast ``x`` to a cache storage dtype. Every write into a float8
    cache goes through here, so out-of-range K/V become nan exactly as in
    the reference instead of saturating."""
    y = x.to(dtype)
    if dtype != torch.float8_e4m3fn:
        return y
    bits = y.view(torch.uint8)
    nan = (bits & 0x80) | 0x7F
    return torch.where(x.abs() > _F8_ROUNDS_TO_NAN, nan, bits).view(dtype)
