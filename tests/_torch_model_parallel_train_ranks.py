"""Rank functions of ``tests/test_torch_model_parallel_train.py``, run by
``repro_torch.launch.distributed.spawn`` in processes of their own. They
import torch and the port alone: a spawned rank starts from a fresh
import, and JAX has no place in it."""
from __future__ import annotations

import torch

from repro_torch.launch import model_parallel as mp
from repro_torch.launch.mesh import coords, make_mesh
from repro_torch.launch.sharding import batch_rows, param_pspecs, shard_tree
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop
from repro_torch.tree import tree_map


def _numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def _floats(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def run_cases(rank, world, group, cases):
    """Each case as rank ``rank`` of a (``data``, ``world`` / ``data``)
    mesh, at one intra-op thread: the rank's shards of the NumPy weights
    (``shard_tree`` of ``param_pspecs``), its rows of the batch
    (``batch_rows``), its model and data axes (``make_axis``,
    ``make_data_axis``) -> {case: {``loss`` and ``metrics`` of
    ``step_grads`` as floats, ``grads``: its gradient shards, ``step``:
    the train step's metrics, ``params`` and ``mu``: the shards after
    it, ``update``: the step's change of the shards at AdamW's default
    ``eps``}}, all NumPy. A case is (torch cfg, NumPy weight tree, AdamW
    keywords, data, remat, accum_steps, NumPy batch)."""
    torch.set_num_threads(1)
    out = {}
    for name, (cfg, tree, opt, data, remat, accum, batch) in cases.items():
        mesh = make_mesh(data, world // data)
        axis = mp.make_axis(mesh, rank, group)
        data_axis = mp.make_data_axis(mesh, rank, group)
        where = coords(mesh, rank)
        full = T.params_from_numpy(tree, cfg, device="cpu")
        params = shard_tree(full, param_pspecs(cfg, full, mesh=mesh), mesh,
                            where)
        rows = batch_rows(mesh, len(batch["labels"]), where["data"])
        b = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
        (loss, metrics), grads = tloop.step_grads(
            params, cfg, b, remat, accum, data_axis, axis)
        step = tloop.make_train_step(cfg, topt.AdamWConfig(**opt), remat,
                                     accum, data_axis, axis)
        new, state, m = step(params, topt.init_opt_state(params), b)
        step = tloop.make_train_step(
            cfg, topt.AdamWConfig(**dict(opt, eps=topt.AdamWConfig.eps)),
            remat, accum, data_axis, axis)
        moved, _, _ = step(params, topt.init_opt_state(params), b)
        out[name] = {"loss": float(loss), "metrics": _floats(metrics),
                     "grads": _numpy(grads), "step": _floats(m),
                     "params": _numpy(new), "mu": _numpy(state["mu"]),
                     "update": _numpy(tree_map(torch.sub, moved, params))}
    return out
