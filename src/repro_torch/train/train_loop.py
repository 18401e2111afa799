"""Training step: LM cross-entropy with the z-loss and the MoE router
losses, remat-able, with gradient accumulation over microbatches — the
reference's ``train/train_loop.py`` on the port's parameter trees.

Gradients come from ``torch.autograd.grad`` over the tree's leaves; on
the card every full-sequence attention runs the flash kernel forward
and its hand-written backward kernel (``kernels.flash_attention``). On
the host mesh (``launch.distributed``) each rank steps on its own rows
and the step all-reduces the gradients and the loss metrics over the
ranks before the update, as XLA does for the reference's batch sharded
over ``data``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models import transformer as T
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

METRICS = ("xent", "zloss", "dropped_frac")


def lm_loss(params, cfg, batch, remat: bool = True):
    """batch: {tokens (B, S) | embeds (B, S, D), labels (B, S)[,
    positions]} -> (total, metrics); ``embeds`` is the frontend-stub path
    (audio / VLM backbones), ``positions`` carries M-RoPE triples when
    present. Logits in f32; mean logsumexp cross-entropy plus a 1e-4
    z-loss on the log-partition, and on a MoE config the router's
    load-balance loss (``aux_loss_weight``) and its z-loss (1e-3)."""
    logits, aux = T.forward(params, cfg, batch.get("tokens"),
                            embeds=batch.get("embeds"),
                            positions=batch.get("positions"), remat=remat)
    logits = logits.float()
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    xent = torch.mean(logz - gold)
    zloss = 1e-4 * torch.mean(torch.square(logz))
    total = xent + zloss
    if cfg.moe is not None:
        total = total + cfg.moe.aux_loss_weight * aux["lb_loss"] \
            + 1e-3 * aux["z_loss"]
    metrics = {"xent": xent, "zloss": zloss,
               "dropped_frac": aux["dropped_frac"]}
    return total, metrics


def value_and_grad(params, cfg, batch, remat: bool = True):
    """((loss, metrics), grads) of :func:`lm_loss` with respect to every
    leaf of ``params``; the grads are a tree of the same nesting. A leaf
    the loss does not read (the token embedding of an ``embeds`` batch)
    gets a zero gradient, as JAX gives it."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = lm_loss(live, cfg, batch, remat)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), \
        tree_unflatten(params, grads)


def mean_over(group, loss, metrics, grads):
    """(loss, metrics, grads) with every gradient leaf and the loss and
    :data:`METRICS` replaced by their mean over ``group``'s ranks: a
    blocking all-reduce of each (the card's stream waits, the host does
    not), then one division by the group's size."""
    leaves = tree_leaves(grads)
    stacked = torch.stack([loss] + [metrics[k] for k in METRICS])
    for t in leaves + [stacked]:
        dist.all_reduce(t, group=group)
    torch._foreach_div_(leaves + [stacked], dist.get_world_size(group))
    loss, *rest = stacked.unbind()
    return loss, dict(zip(METRICS, rest)), grads


def make_train_step(cfg, opt_cfg: AdamWConfig, remat: bool = True,
                    accum_steps: int = 1, group=None):
    """accum_steps > 1 runs the microbatches in turn (the global batch
    must divide), accumulating the gradients in f32 and dividing by
    ``accum_steps``. The batch is split as the reference splits it:
    (B/A, A) with A moved to the front, so microbatch ``a`` holds rows
    ``a, a + A, a + 2A, ...``.

    ``group``, a ``torch.distributed`` process group whose ranks each
    hold their own rows of the global batch (the host mesh): after the
    gradients (accumulated, when ``accum_steps`` > 1, over the rank's
    own rows), :func:`mean_over` the group, before the update, so the
    global norm, the clipping and the update read the reduced gradients
    and every rank steps alike. A mean of the ranks' means is the global
    batch's mean when every rank holds as many rows (and so, in a MoE
    block, as many routing groups). ``None`` adds no collective."""
    def train_step(params, opt_state, batch):
        if accum_steps == 1:
            (loss, metrics), grads = value_and_grad(params, cfg, batch,
                                                    remat)
        else:
            a = accum_steps

            def split(t):
                t = t.reshape((t.shape[0] // a, a) + tuple(t.shape[1:]))
                return t.transpose(0, 1)

            micro = {k: split(v) for k, v in batch.items()
                     if k != "positions"}
            # positions (3, B, S) carry the batch on axis 1
            if "positions" in batch:
                pos = batch["positions"]
                pos = pos.reshape(3, pos.shape[1] // a, a, pos.shape[-1])
                micro["positions"] = pos.permute(2, 0, 1, 3)
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            device = tree_leaves(params)[0].device
            loss = torch.zeros((), dtype=torch.float32, device=device)
            metrics = {k: torch.zeros((), dtype=torch.float32,
                                      device=device) for k in METRICS}
            for i in range(a):
                mb = {k: v[i] for k, v in micro.items()}
                (l_i, m_i), g_i = value_and_grad(params, cfg, mb, remat)
                grads = tree_map(lambda acc, g: acc + g.float(), grads, g_i)
                loss = loss + l_i
                metrics = {k: metrics[k] + m_i[k] for k in METRICS}
            grads = tree_map(lambda g: g / a, grads)
            loss = loss / a
            metrics = {k: v / a for k, v in metrics.items()}
        if group is not None:
            loss, metrics, grads = mean_over(group, loss, metrics, grads)
        params, opt_state, opt_metrics = adamw_update(
            opt_cfg, params, grads, opt_state)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg):
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = lm_loss(params, cfg, batch, remat=False)
        return metrics

    return eval_step


def init_train_state(cfg, generator: torch.Generator, device="cuda"):
    """Seeded f32 master weights on ``device`` (``generator`` lives there)
    and a fresh optimizer state."""
    params = T.init_params(cfg, generator, device=device)
    return params, init_opt_state(params)
