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
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop
from repro_torch.train.graphs import DonatedStep
from repro_torch.tree import tree_leaves, tree_map
from _torch_host_reads import no_host_reads
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


def _program(cfg, full, mesh, rank, group, fsdp: bool):
    """(model axis, data axis, coords, FSDP layout or None, the rank's
    shards of ``full``) of rank ``rank`` on ``mesh``: under the FSDP
    layout, or over the model axis alone (``param_pspecs``)."""
    axis = mp.make_axis(mesh, rank, group)
    data_axis = mp.make_data_axis(mesh, rank, group)
    where = coords(mesh, rank)
    layout = mp.Fsdp(data_axis, fsdp_dims(cfg, full, mesh)) if fsdp \
        else None
    params = shard_tree(full, param_pspecs(cfg, full, fsdp=fsdp, mesh=mesh),
                        mesh, where)
    return axis, data_axis, where, layout, params


def _raised(fn) -> str | None:
    """The message of the ``ValueError`` ``fn()`` raises, None if none."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _host_read(fn) -> str | None:
    """What ``fn()`` read on the host (``NoHostReads``), None if nothing."""
    try:
        with no_host_reads():
            fn()
    except AssertionError as e:
        return str(e)
    return None


def graph_case(rank, world, group, case):
    """A rank program as a CUDA graph takes it, on gloo CPU ranks: the
    in-place train step (``make_train_step(in_place=True)``) over the
    model axis, or under the FSDP layout with the batch split over the
    data axis, and the serve step. -> {``eager_bitwise``: two calls
    through ``DonatedStep`` (eager on CPU tensors) bitwise two of the
    plain step from the same start, metrics and trees; ``captures``;
    ``graphs_true``: the error ``DonatedStep(graphs=True)`` raises over
    gloo; ``train_host_read`` / ``serve_host_read``: what a train step
    after the first and a decode step read on the host (None: nothing);
    ``generate_graphs_true``: the error ``generate(graphs=True)``
    raises}. A case is (torch cfg, NumPy weight tree, AdamW keywords,
    data, NumPy batch, NumPy prompt (B, S), max_len, fsdp)."""
    cfg, tree, opt, data, batch, prompt, max_len, fsdp = case
    mesh = make_mesh(data, world // data)
    full = T.params_from_numpy(tree, cfg, device="cpu")
    axis, data_axis, where, layout, params = _program(cfg, full, mesh, rank,
                                                      group, fsdp)
    rows = batch_rows(mesh, len(batch["labels"]), where["data"])
    b = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
    step = tloop.make_train_step(cfg, topt.AdamWConfig(**opt), False, 1,
                                 data_axis, axis, layout, in_place=True)

    def fresh():
        p = tree_map(torch.clone, params)
        return p, topt.init_opt_state(p)

    donated = DonatedStep(step)
    (p, s), (q, t) = fresh(), fresh()
    same = True
    for _ in range(2):
        p, s, m = donated(p, s, b)
        q, t, n = step(q, t, b)
        same &= _floats(m) == _floats(n)
    same &= all(torch.equal(x, y) for x, y in zip(
        tree_leaves((p, s)), tree_leaves((q, t)), strict=True))
    out = {"eager_bitwise": same, "captures": donated.captures,
           "graphs_true": _raised(
               lambda: DonatedStep(step, graphs=True)(*fresh(), b)),
           "train_host_read": _host_read(lambda: step(q, t, b))}
    rows = batch_rows(mesh, len(prompt), where["data"])
    pr = torch.from_numpy(prompt[rows])
    logits, caches, _ = T.prefill(params, cfg, pr, max_len=max_len,
                                  axis=axis, fsdp=layout)
    tok = mp.argmax(logits[:, -1:], axis).to(torch.int32)
    pos = torch.tensor(pr.shape[1], dtype=torch.int32)
    serve_step = make_serve_step(cfg, mp.with_len(axis, max_len), layout)
    out["serve_host_read"] = _host_read(
        lambda: serve_step(params, tok, caches, pos))
    out["generate_graphs_true"] = _raised(
        lambda: generate(params, cfg, pr, max_len, 3, graphs=True,
                         axis=axis, fsdp=layout))
    return out


def run_all(rank, world, group, train, serve, norm: bool = False,
            graphs=None):
    """Each training and serving case as rank ``rank`` of a (data,
    ``world`` / data) mesh, at one intra-op thread -> {"train": {case:
    {``loss`` and ``metrics`` of ``step_grads`` as floats, ``grads``: its
    gradient shards, ``step``: the train step's metrics, ``params``
    and ``mu``: the shards after it, ``update``: the step's change
    of the shards at AdamW's default ``eps``}}, "serve": {case: {``rows``
    of the prompt the rank holds, ``prefill`` and ``steps``: the logits
    gathered over the model axis, ``tokens``: the greedy tokens,
    ``generate``: ``launch.serve.generate``'s}}, "norm": ``norm_case``
    when ``norm``, "graphs": {case: ``graph_case``'s} of the cases in
    ``graphs``}, all NumPy. A training case is (torch cfg, NumPy
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
    out["graphs"] = {name: graph_case(rank, world, group, case)
                     for name, case in (graphs or {}).items()}
    return out


def graphed_twins(rank, world, group):
    """On CUDA, one NCCL rank a card: smollm-135m at 2 layers (seeded
    f32 masters, bf16 activations), B 4 x S 64, over the model axis at
    (1, ``world``) and under the FSDP layout at (``world``, 1): three
    in-place train steps of the plain step, then three through
    ``DonatedStep`` (eager, capture and replay, replay) from the same
    start; ``launch.serve.generate`` of 8 tokens from a 16-token prompt
    (the rank's rows under the layout) with ``graphs=False``, then
    graphed. -> {program: {``metrics_bitwise``, ``state_bitwise`` (every
    leaf of params, ``mu``, ``nu``, ``step``), ``captures``,
    ``write_back``, ``launches`` (eager, graphed: by kernel),
    ``tokens_bitwise``, ``logits_bitwise`` (the last step's),
    ``generate_captures``}}."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    cfg = dataclasses.replace(get_config("smollm-135m"), num_layers=2)
    g = torch.Generator(device="cuda").manual_seed(5)
    full = T.init_params(cfg, g, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (4, 65), generator=g,
                         device="cuda", dtype=torch.int32)
    out = {}
    for name, (data, fsdp) in {"model_axis": (1, False),
                               "fsdp": (world, True)}.items():
        mesh = make_mesh(data, world // data)
        axis, data_axis, where, layout, params = _program(cfg, full, mesh,
                                                          rank, group, fsdp)
        rows = batch_rows(mesh, 4, where["data"])
        batch = {"tokens": toks[rows, :-1], "labels": toks[rows, 1:]}
        step = tloop.make_train_step(cfg, topt.AdamWConfig(), False, 1,
                                     data_axis, axis, layout, in_place=True)
        runs = []
        for fn in (step, DonatedStep(step)):
            p = tree_map(torch.clone, params)
            s = topt.init_opt_state(p)
            torch.cuda.synchronize()
            before = {k: f.launches for k, f in ops.KERNELS.items()}
            metrics = []
            for _ in range(3):
                p, s, m = fn(p, s, batch)
                metrics.append({k: v.clone() for k, v in m.items()})
            torch.cuda.synchronize()
            runs.append((metrics, [t.clone() for t in tree_leaves((p, s))],
                         {k: f.launches - before[k]
                          for k, f in ops.KERNELS.items()}))
        (me, se, le), (mg, sg, lg) = runs
        rec = {"metrics_bitwise": all(torch.equal(a[k], b[k])
                                      for a, b in zip(me, mg) for k in a),
               "state_bitwise": all(torch.equal(x, y)
                                    for x, y in zip(se, sg, strict=True)),
               "captures": fn.captures, "write_back": fn.write_back,
               "launches": [le, lg]}
        del fn, runs
        prompt = toks[rows, :16]
        stats = [{}, {}]
        got = [generate(params, cfg, prompt, 24, 8, graphs=graphs,
                        stats=st, axis=axis, fsdp=layout)
               for graphs, st in zip((False, None), stats)]
        rec.update(tokens_bitwise=torch.equal(*got),
                   logits_bitwise=torch.equal(stats[0]["last_logits"],
                                              stats[1]["last_logits"]),
                   generate_captures=stats[1]["captures"])
        out[name] = rec
    return out

