"""Rank functions of ``tests/test_torch_host_mesh.py``, run by
``repro_torch.launch.distributed.spawn`` in processes of their own. They
import torch and the port alone: a spawned rank starts from a fresh
import, and JAX has no place in it."""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sharding import batch_rows
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop
from repro_torch.tree import tree_map


def _copy(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def run_cases(rank, world, group, cases):
    """Each case's steps as rank ``rank`` of ``world`` on its rows of
    each batch (``group`` None: one process, the whole batch, no
    collective), at one intra-op thread -> {case: {``metrics``: each
    step's metrics as floats, ``first``: params and ``mu`` after the
    first step, ``last``: params and optimizer state after the last, as
    tensors, which ``torch.save`` writes raw}}. A case is (torch cfg,
    NumPy weight tree, AdamW keywords, accum_steps, NumPy batches)."""
    torch.set_num_threads(1)
    mesh = make_host_mesh(world)
    out = {}
    for name, (cfg, tree, opt, accum, batches) in cases.items():
        step = tloop.make_train_step(cfg, topt.AdamWConfig(**opt),
                                     remat=False, accum_steps=accum,
                                     group=group)
        params = T.params_from_numpy(tree, cfg, device="cpu")
        state = topt.init_opt_state(params)
        rec = {"metrics": []}
        for b in batches:
            rows = batch_rows(mesh, len(b["labels"]), rank)
            params, state, m = step(params, state, {
                k: torch.from_numpy(v[rows]) for k, v in b.items()})
            rec["metrics"].append({k: float(v) for k, v in m.items()})
            if "first" not in rec:
                rec["first"] = _copy({"p": params, "mu": state["mu"]})
        rec["last"] = _copy({"p": params, "opt": state})
        out[name] = rec
    return out


def fail_on_rank_1(rank, world, group):
    """Rank 1 raises while rank 0 waits for it in an all-reduce."""
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    torch.distributed.all_reduce(torch.ones(1), group=group)
