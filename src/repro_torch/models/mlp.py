"""Dense feed-forward blocks: SwiGLU (llama-style) and GeLU (vanilla)."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, silu


def mlp_init(cfg, generator: torch.Generator, device="cuda", d_ff=None,
             lead=()):
    """``lead`` prepends stacking axes (the period axis) to every weight."""
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    names = ("w_gate", "w_up", "w_down") if cfg.mlp == "swiglu" \
        else ("w_up", "w_down")
    return {n: dense_init(lead + ((f, d) if n == "w_down" else (d, f)),
                          generator, in_axis=len(lead), device=device)
            for n in names}


def _ff(x, w):
    """x @ w: dense, or the dequantize-fused qmatmul kernel when the
    weight arrives as a quantized wire struct."""
    if ops.is_wire_struct(w):
        return ops.qdense(x, w)
    return x @ w.to(x.dtype)


def mlp_apply(params, cfg, x):
    if cfg.mlp == "swiglu":
        h = silu(_ff(x, params["w_gate"])) * _ff(x, params["w_up"])
    else:
        h = torch.nn.functional.gelu(_ff(x, params["w_up"]),
                                     approximate="tanh")
    return _ff(h, params["w_down"])
