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

Over a (data, model) mesh the step is one rank's program, as the
reference's dry run compiles it under ``param_pspecs`` / ``opt_pspecs``
/ ``batch_pspecs``: the forward and backward run on the rank's shards
over its model axis (``axis=``; ``models.transformer.forward``), the
loss is vocab-parallel (:func:`lm_loss`), the gradients are averaged
over the rank's data axis (``group=``, the ranks that share its model
index), the clipping norm sums the sharded leaves' squares over the
model axis (``optimizer.global_norm``) and AdamW updates the shards.

Under the FSDP layout (``fsdp=``, ``launch.model_parallel.Fsdp``; the
reference's ``param_pspecs(fsdp=True)`` / ``opt_pspecs``) the params and
both moments are also split over the data axis: the forward gathers
each leaf where it is read, the backward reduce-scatters its gradient
to the rank's shard, :func:`mean_over` all-reduces only the leaves the
layout leaves whole over the data axis (and the loss and metrics) and
divides every leaf once, the norm sums each leaf's squares over the
axes that split it and AdamW updates each shard where it lives.
"""
from __future__ import annotations

import torch

from repro_torch.launch import model_parallel as mp
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

METRICS = ("xent", "zloss", "dropped_frac")


def _log_partition(logits, labels, axis=None):
    """(logz, the label's logit) per row of f32 ``logits`` (..., V); over
    a model ``axis`` the rank's block of vocab columns (``_unembed``'s
    layout): the largest logit gathered over the axis (a constant of the
    gradient), the exponentials' sum and the label's logit, from the rank
    that holds it, summed over the axis (``mp.from_ranks``)."""
    if not mp.active(axis):
        logz = torch.logsumexp(logits, dim=-1)
        return logz, torch.gather(logits, -1, labels[..., None])[..., 0]
    v = logits.shape[-1]
    top = mp.all_gather(logits.detach().amax(-1, keepdim=True), axis,
                        -1).amax(-1)
    sumexp = mp.from_ranks(torch.sum(torch.exp(logits - top[..., None]),
                                     dim=-1), axis)
    local = labels - axis.index * v
    mine = (local >= 0) & (local < v)
    gold = torch.gather(logits, -1, local.clamp(0, v - 1)[..., None])[..., 0]
    return torch.log(sumexp) + top, \
        mp.from_ranks(torch.where(mine, gold, 0.0), axis)


def lm_loss(params, cfg, batch, remat: bool = True, axis=None,
            fsdp=None):
    """batch: {tokens (B, S) | embeds (B, S, D), labels (B, S)[,
    positions]} -> (total, metrics); ``embeds`` is the frontend-stub path
    (audio / VLM backbones), ``positions`` carries M-RoPE triples when
    present. Logits in f32; mean logsumexp cross-entropy plus a 1e-4
    z-loss on the log-partition, and on a MoE config the router's
    load-balance loss (``aux_loss_weight``) and its z-loss (1e-3). Over a
    model ``axis``, the cross-entropy over the rank's vocab block
    (:func:`_log_partition`); the total and the metrics are the same on
    every rank. Under an FSDP layout ``fsdp``, on the rank's shards and
    rows (``T.forward``)."""
    logits, aux = T.forward(params, cfg, batch.get("tokens"),
                            embeds=batch.get("embeds"),
                            positions=batch.get("positions"), remat=remat,
                            axis=axis, fsdp=fsdp)
    logits = logits.float()
    labels = batch["labels"].long()
    logz, gold = _log_partition(logits, labels, axis)
    xent = torch.mean(logz - gold)
    zloss = 1e-4 * torch.mean(torch.square(logz))
    total = xent + zloss
    if cfg.moe is not None:
        total = total + cfg.moe.aux_loss_weight * aux["lb_loss"] \
            + 1e-3 * aux["z_loss"]
    metrics = {"xent": xent, "zloss": zloss,
               "dropped_frac": aux["dropped_frac"]}
    return total, metrics


def value_and_grad(params, cfg, batch, remat: bool = True, axis=None,
                   fsdp=None):
    """((loss, metrics), grads) of :func:`lm_loss` with respect to every
    leaf of ``params``; the grads are a tree of the same nesting. A leaf
    the loss does not read (the token embedding of an ``embeds`` batch)
    gets a zero gradient, as JAX gives it. Over a model ``axis``,
    ``params`` are the rank's shards and so are the grads (a replicated
    leaf's, the whole gradient on every rank); under an FSDP layout a
    data-split leaf's gradient is its shard of the sum over the data
    axis's ranks (or, with ``fsdp.sums`` False, of the one batch)."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = lm_loss(live, cfg, batch, remat, axis, fsdp)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), \
        tree_unflatten(params, grads)


def mean_over(group, loss, metrics, grads, summed=None):
    """(loss, metrics, grads) with every gradient leaf and the loss and
    :data:`METRICS` replaced by their mean over the data axis ``group``
    (``mp.make_data_axis``): a blocking all-reduce of each through
    ``mp.all_reduce``, which the dry run counts (the card's stream waits,
    the host does not), then one division by the axis's size. ``summed``
    (bools in ``tree_leaves`` order) marks the leaves whose gradient is
    already summed over the axis (an FSDP layout's reduce-scattered
    shards): those are only divided."""
    leaves = tree_leaves(grads)
    summed = summed or [False] * len(leaves)
    stacked = torch.stack([loss] + [metrics[k] for k in METRICS])
    out = [t if s else mp.all_reduce(t, group)
           for t, s in zip(leaves, summed, strict=True)]
    out.append(mp.all_reduce(stacked, group))
    torch._foreach_div_(out, group.size)
    loss, *rest = out[-1].unbind()
    return loss, dict(zip(METRICS, rest)), tree_unflatten(grads, out[:-1])


def step_grads(params, cfg, batch, remat: bool = True,
               accum_steps: int = 1, group=None, axis=None, fsdp=None):
    """((loss, metrics), grads) as :func:`make_train_step`'s step takes
    them before its update: over ``accum_steps`` microbatches (an FSDP
    layout's shards summed), averaged over the data axis ``group`` where
    given, on a model ``axis``'s shards and an FSDP layout's."""
    # with no axis, value_and_grad's four-argument call of one card
    # (tests/test_torch_train.py's microbatch spy takes no more)
    on_axis = () if axis is None and fsdp is None else (axis, fsdp)
    if accum_steps == 1:
        (loss, metrics), grads = value_and_grad(params, cfg, batch, remat,
                                                *on_axis)
    else:
        a = accum_steps

        def split(t):
            t = t.reshape((t.shape[0] // a, a) + tuple(t.shape[1:]))
            return t.transpose(0, 1)

        micro = {k: split(v) for k, v in batch.items() if k != "positions"}
        # positions (3, B, S) carry the batch on axis 1
        if "positions" in batch:
            pos = batch["positions"]
            pos = pos.reshape(3, pos.shape[1] // a, a, pos.shape[-1])
            micro["positions"] = pos.permute(2, 0, 1, 3)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        device = tree_leaves(params)[0].device
        loss = torch.zeros((), dtype=torch.float32, device=device)
        metrics = {k: torch.zeros((), dtype=torch.float32, device=device)
                   for k in METRICS}
        for i in range(a):
            mb = {k: v[i] for k, v in micro.items()}
            (l_i, m_i), g_i = value_and_grad(params, cfg, mb, remat,
                                             *on_axis)
            grads = tree_map(lambda acc, g: acc + g.float(), grads, g_i)
            loss = loss + l_i
            metrics = {k: metrics[k] + m_i[k] for k in METRICS}
        grads = tree_map(lambda g: g / a, grads)
        loss = loss / a
        metrics = {k: v / a for k, v in metrics.items()}
    if group is not None:
        summed = None if not mp.fsdp_active(fsdp) else [
            d is not None for d in tree_leaves(fsdp.dims)]
        loss, metrics, grads = mean_over(group, loss, metrics, grads,
                                         summed)
    return (loss, metrics), grads


def make_train_step(cfg, opt_cfg: AdamWConfig, remat: bool = True,
                    accum_steps: int = 1, group=None, axis=None, fsdp=None,
                    in_place: bool = False):
    """accum_steps > 1 runs the microbatches in turn (the global batch
    must divide), accumulating the gradients in f32 and dividing by
    ``accum_steps``. The batch is split as the reference splits it:
    (B/A, A) with A moved to the front, so microbatch ``a`` holds rows
    ``a, a + A, a + 2A, ...``.

    ``group``, a data axis (``mp.make_data_axis``) whose ranks each hold
    their own rows of the global batch (the host mesh's, or a (data,
    model) mesh's ranks of one model index), or a process group, taken
    as the data axis of its ranks (``mp.group_axis``): after the gradients
    (accumulated, when ``accum_steps`` > 1, over the rank's own rows),
    :func:`mean_over` the axis, before the update, so the
    global norm, the clipping and the update read the reduced gradients
    and every rank steps alike. A mean of the ranks' means is the global
    batch's mean when every rank holds as many rows (and so, in a MoE
    block, as many routing groups). ``None`` adds no collective.

    ``axis``, a rank's model axis (``launch.model_parallel``): the step
    is that rank's program on its shards of the params, the optimizer
    state and the batch rows of its data index (module docstring). The
    leaves the axis
    splits are read from ``launch.sharding.param_pspecs`` at the first
    call. An axis of size 1 is no axis, bit for bit.

    ``fsdp``, the rank's FSDP layout (``mp.Fsdp``): the params and the
    optimizer state are its shards of ``param_pspecs(fsdp=True)`` /
    ``opt_pspecs`` (module docstring). Its data axis is ``group`` where
    the batch splits over it (``fsdp.sums``), else ``group`` is None and
    each replica steps on the whole batch. A layout over a data axis of
    size 1 is no layout, bit for bit.

    ``in_place``: the update writes the new params, moments and ``step``
    into the trees the step was handed and returns them (``adamw_update``), the
    same bits as a step that makes new trees: an eager rank program's
    donation, without a second copy of the state at its peak. A rank
    program graphed through ``train.graphs.DonatedStep`` should be made
    with it: a step that makes new trees has them copied back into the
    graph's buffers, so its private pool holds a second state."""
    split = []
    if group is not None and not isinstance(group, mp.ModelAxis):
        group = mp.group_axis(group)
    if mp.fsdp_active(fsdp) and fsdp.sums != (group is not None):
        raise ValueError("an FSDP layout sums its gradients over its data "
                         "axis exactly where the step averages over it "
                         f"(sums {fsdp.sums}, group {group})")
    axes = (axis, fsdp.axis if fsdp is not None else None)

    def train_step(params, opt_state, batch):
        if any(map(mp.active, axes)) and not split:
            from repro_torch.launch.sharding import split_axes
            split.append(split_axes(cfg, params, mp.size(axis),
                                    fsdp.dims if mp.fsdp_active(fsdp)
                                    else None))
        (loss, metrics), grads = step_grads(params, cfg, batch, remat,
                                            accum_steps, group, axis, fsdp)
        params, opt_state, opt_metrics = adamw_update(
            opt_cfg, params, grads, opt_state, axes,
            split[0] if split else None, in_place)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, opt_state, metrics

    train_step.axis, train_step.group, train_step.fsdp = axis, group, fsdp
    return train_step


def make_eval_step(cfg, axis=None, fsdp=None):
    """The loss metrics of a batch, no gradient; over a model ``axis``
    and an FSDP layout ``fsdp``, one rank's program on its shards (the
    leaves gathered as the train step's forward gathers them)."""
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = lm_loss(params, cfg, batch, remat=False, axis=axis,
                                 fsdp=fsdp)
        return metrics

    return eval_step


def init_train_state(cfg, generator: torch.Generator, device="cuda"):
    """Seeded f32 master weights on ``device`` (``generator`` lives there)
    and a fresh optimizer state."""
    params = T.init_params(cfg, generator, device=device)
    return params, init_opt_state(params)
