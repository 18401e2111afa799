"""Checkpointing: a parameter tree -> a flat ``.npz`` + ``meta.json``, the
reference's ``train/checkpoint.py`` format: keys are the leaves' paths
joined by ``%%`` (``blocks%%0%%attn%%wq``, ``mu%%embed``, ``step``), the
f32 masters and the int32 step stored as they are. A checkpoint the
reference saved loads here, and one saved here loads there, leaf for
leaf the same bits.
"""
from __future__ import annotations

import json
import os
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map

SEP = "%%"


def _paths(tree, prefix=()):
    """(path, leaf) pairs in ``tree_map`` order; list items by index."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _paths(v, prefix + (str(k),))


def _flatten(tree) -> dict:
    return {SEP.join(path): leaf.detach().cpu().numpy()
            for path, leaf in _paths(tree)}


def save_checkpoint(path: str, params, opt_state=None, step: int = 0,
                    metadata: dict | None = None) -> None:
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"), **_flatten(params))
    if opt_state is not None:
        np.savez(os.path.join(path, "opt_state.npz"), **_flatten(opt_state))
    meta = {"step": step, **(metadata or {})}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def _restore_into(template, flat: dict):
    """A tree shaped like ``template`` from the arrays of ``flat``, each
    leaf in its template leaf's dtype and on its device; a missing key or
    a shape that differs raises."""
    leaves = []
    for path, leaf in _paths(template):
        key = SEP.join(path)
        if key not in flat:
            raise KeyError(f"checkpoint has no leaf {key!r}")
        arr = flat[key]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key!r}: shape {arr.shape}, "
                             f"template {tuple(leaf.shape)}")
        leaves.append(torch.from_numpy(np.array(arr)).to(device=leaf.device,
                                                         dtype=leaf.dtype))
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def load_checkpoint(path: str, params_template,
                    opt_state_template=None) -> Tuple[Any, Any, dict]:
    flat = dict(np.load(os.path.join(path, "params.npz")))
    params = _restore_into(params_template, flat)
    opt_state = None
    opt_file = os.path.join(path, "opt_state.npz")
    if opt_state_template is not None and os.path.exists(opt_file):
        opt_state = _restore_into(opt_state_template,
                                  dict(np.load(opt_file)))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return params, opt_state, meta
