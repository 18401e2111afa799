"""Dense feed-forward blocks: SwiGLU (llama-style) and GeLU (vanilla).

Over a model axis (``axis=``, ``launch.model_parallel``) a rank holds
column blocks of ``w_gate`` / ``w_up`` and the matching row block of
``w_down`` (Megatron's column -> row pair): the input enters through
``mp.to_ranks`` and the output is a partial sum, taken in f32, summed
over the axis (``mp.sum_partials``) and rounded once."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.launch import model_parallel as mp
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


def _ff(x, w, out_dtype=None):
    """x @ w: dense, or the dequantize-fused qmatmul kernel when the
    weight arrives as a quantized wire struct; in ``out_dtype`` (f32
    products of the operands in x's dtype) when it is not x's."""
    if ops.is_wire_struct(w):
        return ops.qdense(x, w, out_dtype=out_dtype)
    w = w.to(x.dtype)
    if out_dtype is None or out_dtype == x.dtype:
        return x @ w
    return x.to(out_dtype) @ w.to(out_dtype)


def mlp_apply(params, cfg, x, axis=None):
    x = mp.to_ranks(x, axis)
    if cfg.mlp == "swiglu":
        h = silu(_ff(x, params["w_gate"])) * _ff(x, params["w_up"])
    else:
        h = torch.nn.functional.gelu(_ff(x, params["w_up"]),
                                     approximate="tanh")
    y = _ff(h, params["w_down"], mp.partial_dtype(axis, h.dtype))
    return mp.sum_partials(y, axis, h.dtype)
