"""AdamW, the warmup + cosine schedule and clipping by global norm, over
the port's parameter trees (``tree.py``) with plain tensor ops — the
reference's ``train/optimizer.py`` step for step, so both agree to f32
rounding (``torch.optim`` orders its arithmetic differently).

The moments are float32 trees and ``step`` an int32 scalar tensor, as
the reference keeps them; updates return new trees.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.launch import model_parallel as mp
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    min_lr_frac: float = 0.1


def cosine_lr(cfg: AdamWConfig, step):
    """Linear warmup to ``cfg.lr``, then cosine decay to ``min_lr_frac``
    of it; float32 scalar tensor on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params):
    zeros = lambda p: tree_map(
        lambda t: torch.zeros_like(t, dtype=torch.float32), p)
    device = tree_leaves(params)[0].device
    return {"mu": zeros(params), "nu": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree, axis=None, sharded=None):
    """The norm of every leaf of ``tree`` together. Over a model
    ``axis`` (``launch.model_parallel``) ``tree`` holds a rank's shards
    and ``sharded`` (a tree of bools of the same nesting) says which
    leaves the axis splits: their squares are summed over the axis, the
    replicated leaves' counted once, so every rank gets the same norm."""
    leaves = tree_leaves(tree)
    if not mp.active(axis):
        return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                              for t in leaves))
    squares = [torch.sum(torch.square(t.float())) for t in leaves]
    flags = tree_leaves(sharded)
    if len(flags) != len(squares):
        raise ValueError(f"{len(flags)} sharding flags for {len(squares)} "
                         f"leaves")
    split = torch.stack([q for q, f in zip(squares, flags) if f]).sum()
    whole = [q for q, f in zip(squares, flags) if not f]
    total = mp.all_reduce(split, axis)
    if whole:
        total = total + torch.stack(whole).sum()
    return torch.sqrt(total)


def adamw_update(cfg: AdamWConfig, params, grads, state, axis=None,
                 sharded=None):
    """Returns (new_params, new_state, metrics). Over a model ``axis``
    the trees are a rank's shards: the update is elementwise on them
    (weight decay on leaves of two dimensions or more, as on one card),
    the clipping norm :func:`global_norm`'s over the axis."""
    step = state["step"] + 1
    gnorm = global_norm(grads, axis, sharded)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    grads = tree_map(lambda g: g * scale, grads)

    b1, b2 = cfg.b1, cfg.b2
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                  state["mu"], grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                  state["nu"], grads)
    lr = cosine_lr(cfg, step)
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())

    def upd(p, m, v):
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, {"mu": mu, "nu": nu, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
