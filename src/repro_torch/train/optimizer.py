"""AdamW, the warmup + cosine schedule and clipping by global norm, over
the port's parameter trees (``tree.py``) with plain tensor ops — the
reference's ``train/optimizer.py`` step for step, so both agree to f32
rounding (``torch.optim`` orders its arithmetic differently).

The moments are float32 trees and ``step`` an int32 scalar tensor, as
the reference keeps them; updates return new trees (in place, the
trees they were handed).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.launch import model_parallel as mp
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


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


def global_norm(tree, axes=(), split=None):
    """The norm of every leaf of ``tree`` together. Over the rank axes
    ``axes`` (``launch.model_parallel`` axes, each with its ``name``:
    the model axis, the data axis) ``tree`` holds a rank's shards and
    ``split`` (a tree of the same nesting, ``launch.sharding.split_axes``)
    holds, for each leaf, the frozenset of the axis names that split it:
    each leaf's sum of squares is summed over exactly those axes (one
    all-reduce an axis, of the partial sums of every set that names it),
    so each element is counted once and every rank gets the same norm.
    With no active axis, the one-card norm."""
    leaves = tree_leaves(tree)
    axes = [a for a in axes if mp.active(a)]
    if not axes:
        return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                              for t in leaves))
    flags = tree_leaves(split)
    if len(flags) != len(leaves):
        raise ValueError(f"{len(flags)} sharding flags for {len(leaves)} "
                         f"leaves")
    names = {a.name for a in axes}
    sums = {}
    for t, f in zip(leaves, flags):
        key = frozenset(f) & names
        sums.setdefault(key, []).append(torch.sum(torch.square(t.float())))
    keys = sorted(sums, key=sorted)
    partial = {k: torch.stack(sums[k]).sum() for k in keys}
    for a in axes:
        mine = [k for k in keys if a.name in k]
        if mine:
            summed = mp.all_reduce(torch.stack([partial[k] for k in mine]),
                                   a)
            partial.update(zip(mine, summed.unbind()))
    return torch.sqrt(torch.stack([partial[k] for k in keys]).sum())


def adamw_update(cfg: AdamWConfig, params, grads, state, axes=(),
                 split=None, in_place: bool = False):
    """Returns (new_params, new_state, metrics). Over the rank ``axes``
    the trees are a rank's shards: the update is elementwise on them
    (weight decay on leaves of two dimensions or more, as on one card:
    a shard has its whole leaf's dimensions), the clipping norm
    :func:`global_norm`'s over the axes that split each leaf
    (``split``). Leaf by leaf: the clipped gradient, the moments and the
    new value of one leaf before the next, so no whole tree of clipped
    gradients is ever held. ``in_place`` writes the new params, moments
    and ``step`` into the trees it was given (the same ops, so the same
    bits) and returns those trees: the caller's old state is gone, and
    so is the memory a second copy of it would take."""
    step = state["step"].add_(1) if in_place else state["step"] + 1
    gnorm = global_norm(grads, axes, split)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
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

    def leaf(p, g, m, v):
        g = g * scale
        if in_place:
            m.mul_(b1).add_((1 - b1) * g.float())
            v.mul_(b2).add_((1 - b2) * torch.square(g.float()))
            return p.copy_(upd(p, m, v)), m, v
        m = b1 * m + (1 - b1) * g.float()
        v = b2 * v + (1 - b2) * torch.square(g.float())
        return upd(p, m, v), m, v

    new = [leaf(*x) for x in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state["mu"]),
        tree_leaves(state["nu"]), strict=True)]
    return tree_unflatten(params, [n[0] for n in new]), \
        {"mu": tree_unflatten(params, [n[1] for n in new]),
         "nu": tree_unflatten(params, [n[2] for n in new]), "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
