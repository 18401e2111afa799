"""Rank functions of ``tests/test_torch_model_parallel.py``, run by
``repro_torch.launch.distributed.spawn`` in processes of their own. They
import torch and the port alone: a spawned rank starts from a fresh
import, and JAX has no place in it."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantizer import quantize_params_for_serving
from repro_torch.launch import model_parallel as mp
from repro_torch.launch.mesh import coords, make_mesh
from repro_torch.launch.serve import generate
from repro_torch.launch.sharding import param_pspecs, shard_tree
from repro_torch.models import transformer as T
from repro_torch.tree import tree_map


def served_params(cfg, tree, quant: int, device="cpu"):
    """The NumPy weight tree as the port's params on ``device``, int-N
    wire structs at ``quant`` 8 or 4 (quantized whole, before
    sharding)."""
    params = T.params_from_numpy(tree, cfg, device=device)
    return quantize_params_for_serving(params, quant) if quant else params


def _numpy(tree):
    return tree_map(lambda t: t.detach().float().cpu().numpy().copy(), tree)


def _logits(logits, axis):
    """The logits gathered over the model axis, as f32 NumPy."""
    return mp.all_gather(logits, axis, -1).float().cpu().numpy()


def run_cases(rank, world, group, cases, device="cpu"):
    """Each case as rank ``rank`` of a (1, ``world``) mesh, at one intra-op
    thread -> {case: {``prefill``: the logits of a prefill at
    ``cache_dtype=float32`` gathered over the model axis, ``caches``: this
    rank's caches after it, ``steps``: the gathered logits of each greedy
    decode step from them, ``tokens``: that loop's greedy tokens,
    ``generate``: ``launch.serve.generate``'s tokens (bf16 caches)}}, all
    NumPy. A case is (torch cfg, NumPy weight tree, int-N bits or 0, NumPy
    prompt (B, S), max_len, decode steps[, NumPy tokens (B, steps) fed to
    the steps in place of the greedy ones, or None]). On a CUDA ``device``
    the ranks share its card(s), each launching the kernels."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _run_cases(rank, world, group, cases, device)
    finally:
        torch.set_num_threads(threads)


def _run_cases(rank, world, group, cases, device):
    mesh = make_mesh(1, world)
    axis = mp.make_axis(mesh, rank, group)
    out = {}
    for name, case in cases.items():
        cfg, tree, quant, prompt, max_len, steps, *forced = case
        forced = forced[0] if forced else None
        full = served_params(cfg, tree, quant, device)
        local = shard_tree(full, param_pspecs(cfg, full, mesh=mesh), mesh,
                           coords(mesh, rank))
        del full
        prompt = torch.from_numpy(prompt).to(device)
        logits, caches, _ = T.prefill(local, cfg, prompt, max_len=max_len,
                                      cache_dtype=torch.float32, axis=axis)
        rec = {"prefill": _logits(logits, axis),
               "caches": _numpy(caches), "steps": []}
        tok = mp.argmax(logits[:, -1:], axis).to(torch.int32)
        toks = [tok]
        step_axis = mp.with_len(axis, max_len)
        for i in range(steps):
            if forced is not None:
                tok = torch.from_numpy(forced[:, i:i + 1]).to(device)
            logits, caches = T.decode_step(local, cfg, tok, caches,
                                           prompt.shape[1] + i,
                                           axis=step_axis)
            rec["steps"].append(_logits(logits, axis))
            tok = mp.argmax(logits, axis).to(torch.int32)
            toks.append(tok)
        rec["tokens"] = torch.cat(toks, 1).cpu().numpy()
        rec["generate"] = generate(local, cfg, prompt, max_len, steps + 1,
                                   axis=axis).cpu().numpy()
        out[name] = rec
    return out


def data_rows(rank, world, group):
    """Rank ``rank`` of a (2, ``world`` / 2) mesh: its model axis's sum
    and gather of ``rank + 1`` (its subgroup the ranks of its data
    index) -> (index, size, the sum, the gathered values)."""
    axis = mp.make_axis(make_mesh(2, world // 2), rank, group)
    x = torch.tensor([float(rank + 1)])
    gathered = mp.all_gather(x, axis)
    return (axis.index, axis.size, float(mp.all_reduce(x.clone(), axis)),
            gathered.tolist())


def argmax_ties(rank, world, group, rows):
    """``model_parallel.argmax`` of NumPy logits ``rows`` (..., V) split
    over the (1, ``world``) mesh's model axis by contiguous blocks."""
    axis = mp.make_axis(make_mesh(1, world), rank, group)
    logits = torch.from_numpy(np.ascontiguousarray(rows))
    v = logits.shape[-1] // world
    return mp.argmax(logits[..., rank * v:(rank + 1) * v], axis).numpy()
