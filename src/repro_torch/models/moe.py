"""Top-k mixture-of-experts with capacity-based einsum dispatch.

The Mesh-TF / Switch-Transformer formulation of the reference: tokens
are split into groups, a dispatch one-hot of shape (G, GS, E, C) routes
each token to at most k expert-capacity slots, and two einsums move
activations to expert-major layout (E, G, C, D) and back. Tokens routed
past an expert's capacity are dropped (the residual path carries them).

Plain PyTorch on both devices: the reference computes dispatch, the
expert MLPs and combine in plain ``jnp`` outside any Pallas kernel, so
on the card they are cuBLAS batched matmuls and elementwise kernels.

Expert-parallel over a model axis (``axis=``, ``launch.model_parallel``):
a rank holds a contiguous block of E / m experts. The router and the
routing stay replicated, so every rank drops the same tokens; each rank
takes its experts' slice of ``dispatch`` / ``combine`` and of the
tokens' input (``mp.to_ranks``: in the backward the ranks' cotangents of
the gates and the tokens are summed, the router's own read of the tokens
not), and the ranks' partial outputs, in f32, are summed over the axis
and rounded once. The aux losses are the replicated routing's, counted
once.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.launch import model_parallel as mp
from repro_torch.models.common import dense_init, silu

DEFAULT_GROUP_SIZE = 128


def moe_init(cfg, generator: torch.Generator, device="cuda", lead=()):
    """Router (D, E) and expert stacks (E, D, F) / (E, F, D); ``lead``
    prepends stacking axes (the period axis) to every weight."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff, m.num_experts
    n = len(lead)
    p = {"w_router": dense_init(lead + (d, e), generator, n, device=device)}
    names = ("w_gate", "w_up", "w_down") if cfg.mlp == "swiglu" \
        else ("w_up", "w_down")
    for name in names:
        shape = (e, f, d) if name == "w_down" else (e, d, f)
        p[name] = dense_init(lead + shape, generator, n + 1, device=device)
    return p


def capacity_for(group_size: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    c = math.ceil(group_size * top_k / num_experts * capacity_factor)
    return max(top_k if group_size == 1 else 4, (c + 3) // 4 * 4)


def _route(logits, top_k: int, capacity: int):
    """logits (G, GS, E) -> dispatch (G, GS, E, C) bf16 one-hot, combine
    (G, GS, E, C) f32 gates, aux metrics. Top-k with per-expert slot
    assignment in token order, round by round; tokens over capacity are
    dropped."""
    g, gs, e = logits.shape
    dev = logits.device
    probs = torch.softmax(logits.float(), dim=-1)
    # jax.lax.top_k breaks ties by the lower index; torch.topk promises
    # no order among ties, a stable descending sort does
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_ids = gate_vals[..., :top_k], expert_ids[..., :top_k]
    # normalize the k gates (Mixtral/DBRX convention)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    dispatch = torch.zeros((g, gs, e, capacity), dtype=torch.bfloat16,
                           device=dev)
    combine = torch.zeros((g, gs, e, capacity), dtype=torch.float32,
                          device=dev)
    slots = torch.arange(capacity, device=dev)
    # running token count per (group, expert) across the k rounds
    counts = torch.zeros((g, e), dtype=torch.int64, device=dev)
    for kk in range(top_k):
        ids = expert_ids[..., kk]                                # (G,GS)
        eh = F.one_hot(ids, e)                                   # (G,GS,E)
        pos = torch.cumsum(eh, dim=1) - 1 + counts[:, None, :]   # slot idx
        counts = counts + eh.sum(dim=1)
        pos_tok = torch.gather(pos, -1, ids[..., None])[..., 0]  # (G,GS)
        keep = pos_tok < capacity
        # one-hot of the slot; a dropped token's slot is out of range and
        # its row all zeros, as jax.nn.one_hot gives it
        ph = (pos_tok[..., None] == slots).float()               # (G,GS,C)
        sel = eh.float() * keep[..., None].float()
        contrib = sel[..., None] * ph[..., None, :]              # (G,GS,E,C)
        dispatch = dispatch + contrib.to(torch.bfloat16)
        combine = combine + gate_vals[..., kk, None, None] * contrib

    # aux: Switch load-balance loss + router z-loss
    density = dispatch.sum(dim=(1, 3)) / gs                      # (G,E) bf16
    mean_prob = probs.mean(dim=1)                                # (G,E)
    lb_loss = e * torch.mean(torch.sum(density.float() * mean_prob, dim=-1))
    z_loss = torch.mean(torch.square(torch.logsumexp(logits.float(), dim=-1)))
    dropped = 1.0 - dispatch.float().sum() / (g * gs * top_k)
    aux = {"lb_loss": lb_loss, "z_loss": z_loss, "dropped_frac": dropped}
    return dispatch, combine, aux


def moe_apply(params, cfg, x, group_size: int = DEFAULT_GROUP_SIZE,
              axis=None):
    """x (B, S, D) -> (out, aux)."""
    m = cfg.moe
    b, s, d = x.shape
    dt = x.dtype
    gs = min(group_size, s) if s > 1 else 1
    xg = x.reshape(b * s // gs, gs, d)

    logits = xg @ params["w_router"].to(dt)                      # (G,GS,E)
    cap = capacity_for(gs, m.num_experts, m.top_k, m.capacity_factor)
    dispatch, combine, aux = _route(logits, m.top_k, cap)
    if mp.active(axis):                  # this rank's block of experts
        e = params["w_up"].shape[0]
        dispatch = mp.rank_block(dispatch, axis, 2, e)
        combine = mp.rank_block(combine, axis, 2, e)

    # the experts' input only: the router read xg whole on every rank
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch.to(dt),
                             mp.to_ranks(xg, axis))
    if cfg.mlp == "swiglu":
        h = silu(torch.einsum("egcd,edf->egcf", expert_in,
                              params["w_gate"].to(dt)))
        h = h * torch.einsum("egcd,edf->egcf", expert_in,
                             params["w_up"].to(dt))
    else:
        h = F.gelu(torch.einsum("egcd,edf->egcf", expert_in,
                                params["w_up"].to(dt)), approximate="tanh")
    expert_out = torch.einsum("egcf,efd->egcd", h, params["w_down"].to(dt))
    combine = combine.to(dt)
    if mp.active(axis):                  # the partial sums in f32
        expert_out, combine = expert_out.float(), combine.float()
    out = torch.einsum("egcd,gsec->gsd", expert_out, combine)
    return mp.sum_partials(out.reshape(b, s, d), axis, dt), aux
