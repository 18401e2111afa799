"""Rank functions of ``tests/test_torch_fsdp.py``, run by
``repro_torch.launch.distributed.spawn`` in processes of their own. They
import torch and the port alone: a spawned rank starts from a fresh
import, and JAX has no place in it."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch import model_parallel as mp
from repro_torch.launch.mesh import coords, make_mesh
from repro_torch.launch.serve import generate
from repro_torch.launch.sharding import (batch_rows, fsdp_dims, param_pspecs,
                                         shard_tree)
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop
from repro_torch.tree import tree_map
from _torch_model_parallel_ranks import served_params


def _numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def _floats(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def _rank_layout(cfg, tree, mesh, rank, group, quant: int = 0):
    """(model axis, data axis, coords, FSDP layout, the rank's FSDP
    shards of the NumPy weights, int-N wire structs at ``quant`` 8 or 4,
    quantized whole before sharding) of rank ``rank`` on ``mesh``."""
    axis = mp.make_axis(mesh, rank, group)
    data_axis = mp.make_data_axis(mesh, rank, group)
    where = coords(mesh, rank)
    full = served_params(cfg, tree, quant)
    layout = mp.Fsdp(data_axis, fsdp_dims(cfg, full, mesh))
    params = shard_tree(full, param_pspecs(cfg, full, fsdp=True, mesh=mesh),
                        mesh, where)
    return axis, data_axis, where, layout, params


def _train(rank, world, group, case):
    """One training case: the rank's ``step_grads`` and one
    ``make_train_step`` step under the FSDP layout (AdamW at the case's
    keywords, and again at the default ``eps``)."""
    cfg, tree, opt, data, remat, accum, batch = case
    mesh = make_mesh(data, world // data)
    axis, data_axis, where, layout, params = _rank_layout(cfg, tree, mesh,
                                                          rank, group)
    rows = batch_rows(mesh, len(batch["labels"]), where["data"])
    b = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
    (loss, metrics), grads = tloop.step_grads(
        params, cfg, b, remat, accum, data_axis, axis, layout)
    step = tloop.make_train_step(cfg, topt.AdamWConfig(**opt), remat, accum,
                                 data_axis, axis, layout)
    new, state, m = step(params, topt.init_opt_state(params), b)
    step = tloop.make_train_step(
        cfg, topt.AdamWConfig(**dict(opt, eps=topt.AdamWConfig.eps)),
        remat, accum, data_axis, axis, layout)
    moved, _, _ = step(params, topt.init_opt_state(params), b)
    return {"loss": float(loss), "metrics": _floats(metrics),
            "grads": _numpy(grads), "step": _floats(m),
            "params": _numpy(new), "mu": _numpy(state["mu"]),
            "update": _numpy(tree_map(torch.sub, moved, params))}


def _serve(rank, world, group, case):
    """One serving case (its weights int-N wire structs at 8 or 4 bits:
    each leaf's codes gathered whole before they are dequantized or
    reach the quantized matmul): the rank's rows of the prompt through a
    prefill
    at ``cache_dtype=float32`` and greedy decode steps, and
    ``launch.serve.generate``, each leaf gathered over the data axis where
    read; the logits gathered over the model axis."""
    cfg, tree, prompt, max_len, steps, data, quant = case
    mesh = make_mesh(data, world // data)
    axis, _, where, layout, params = _rank_layout(cfg, tree, mesh, rank,
                                                  group, quant)
    rows = batch_rows(mesh, len(prompt), where["data"])
    p = torch.from_numpy(prompt[rows])
    logits, caches, _ = T.prefill(params, cfg, p, max_len=max_len,
                                  cache_dtype=torch.float32, axis=axis,
                                  fsdp=layout)
    rec = {"rows": [rows.start, rows.stop], "steps": [],
           "prefill": mp.all_gather(logits, axis, -1).numpy()}
    tok = mp.argmax(logits[:, -1:], axis).to(torch.int32)
    toks = [tok]
    step_axis = mp.with_len(axis, max_len)
    for i in range(steps):
        logits, caches = T.decode_step(params, cfg, tok, caches,
                                       p.shape[1] + i, axis=step_axis,
                                       fsdp=layout)
        rec["steps"].append(mp.all_gather(logits, axis, -1).numpy())
        tok = mp.argmax(logits, axis).to(torch.int32)
        toks.append(tok)
    rec["tokens"] = torch.cat(toks, 1).numpy()
    rec["generate"] = generate(params, cfg, p, max_len, steps + 1,
                               axis=axis, fsdp=layout).numpy()
    return rec


def norm_case(rank, world, group):
    """``optimizer.global_norm`` on a (2, 2) mesh over four leaves of one
    seeded tree: split on the data axis only, on the model axis only, on
    both and on neither; each rank holds its shards. -> (the norm, the
    whole tree's norm in f64)."""
    mesh = make_mesh(2, world // 2)
    axis = mp.make_axis(mesh, rank, group)
    data_axis = mp.make_data_axis(mesh, rank, group)
    rng = np.random.default_rng(7)
    whole = {"data": rng.standard_normal((4, 6)),
             "model": rng.standard_normal((6, 4)),
             "both": rng.standard_normal((4, 4)),
             "neither": rng.standard_normal(3)}
    di, mi = data_axis.index, axis.index
    local = {"data": whole["data"][2 * di:2 * di + 2],
             "model": whole["model"][:, 2 * mi:2 * mi + 2],
             "both": whole["both"][2 * di:2 * di + 2, 2 * mi:2 * mi + 2],
             "neither": whole["neither"]}
    split = {"data": frozenset({"data"}), "model": frozenset({"model"}),
             "both": frozenset({"data", "model"}), "neither": frozenset()}
    tree = {k: torch.from_numpy(v.astype(np.float32)) for k, v in
            local.items()}
    norm = topt.global_norm(tree, (axis, data_axis), split)
    want = np.sqrt(sum(np.sum(np.square(v.astype(np.float32)
                                         .astype(np.float64)))
                       for v in whole.values()))
    return float(norm), float(want)


def run_all(rank, world, group, train, serve, norm: bool = False):
    """Each training and serving case as rank ``rank`` of a (data,
    ``world`` / data) mesh, at one intra-op thread -> {"train": {case:
    {``loss`` and ``metrics`` of ``step_grads`` as floats, ``grads``: its
    gradient shards, ``step``: the train step's metrics, ``params``
    and ``mu``: the shards after it, ``update``: the step's change
    of the shards at AdamW's default ``eps``}}, "serve": {case: {``rows``
    of the prompt the rank holds, ``prefill`` and ``steps``: the logits
    gathered over the model axis, ``tokens``: the greedy tokens,
    ``generate``: ``launch.serve.generate``'s}}, "norm": ``norm_case``
    when ``norm``}, all NumPy. A training case is (torch cfg, NumPy
    weight tree, AdamW keywords, data, remat, accum_steps, NumPy batch),
    a serving case (torch cfg, NumPy weight tree, NumPy prompt (B, S),
    max_len, decode steps, data, int-N bits or 0)."""
    torch.set_num_threads(1)
    out = {"train": {name: _train(rank, world, group, case)
                     for name, case in train.items()},
           "serve": {name: _serve(rank, world, group, case)
                     for name, case in serve.items()}}
    if norm:
        out["norm"] = norm_case(rank, world, group)
    return out
