"""Sharding rules: parameter / optimizer / cache / batch partition specs
— the port of ``repro/launch/sharding.py``, rule for rule.

A spec is data: one tuple per leaf with an entry per dimension, each an
axis name, a tuple of axis names, or None (replicated). The spec trees
mirror the port's parameter, optimizer, cache and batch trees (nested
dicts and lists, as ``tree.py`` has them), with a tuple where the tree
has a tensor.

Layout: activations are sharded over ``data`` on batch and replicated
over ``model``; weights follow Megatron column -> row pairs:

  embed          (V, D)            -> (model, None)        vocab-sharded
  lm_head        (D, V)            -> (None, model)        logits vocab-sharded
  attn wq/wk/wv  (P, D, H, hd)     -> (None, None, model, None) head-sharded
  attn wo        (P, H, hd, D)     -> (None, model, None, None) row-parallel
  mlp  gate/up   (P, D, F)         -> (None, None, model)
  mlp  down      (P, F, D)         -> (None, model, None)
  moe  experts   (P, E, D, F)      -> (None, model, None, None) expert-parallel
  ssm  w_z/w_x   (P, D, di)        -> (None, None, model)
  ssm  w_out     (P, di, D)        -> (None, model, None)
  ssm  B/C/dt    small, shared across heads -> replicated
  norms / scalars                  -> replicated

``P`` is the stacked period axis, never sharded. Optimizer moments
mirror the parameter specs; ``fsdp`` additionally shards the largest
unsharded dimension over ``data``.

The dry run reads these specs to give the argument bytes per card of
the production meshes (:func:`per_card_bytes`), and the serving steps'
rank program holds what they lay out: :func:`shard_tree` carries a full
tree over to one rank's shards, :func:`local_shape` gives a shard's
shape. On the host mesh
(``mesh.make_host_mesh``, data=n, model=1) the training launcher runs
them: with ``fsdp`` off and a ``model`` axis of 1 every parameter and
moment spec shards nothing, and :func:`batch_rows` gives each data rank
its block of the batch as :func:`batch_pspecs` lays it out. Under
``fsdp`` the rank program (``launch.model_parallel.Fsdp``) reads each
leaf's data-axis split from :func:`fsdp_dims`, and the train step's
gradient norm which axes split each leaf from :func:`split_axes`.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantizer import QUANTIZABLE
from repro_torch.launch.mesh import DATA_AXIS, MODEL_AXIS, POD_AXIS
from repro_torch.tree import tree_map


def _map_with_path(fn, tree, keys=()):
    """``fn(keys, leaf)`` over a nested dict/list tree; ``keys`` holds the
    dict keys on the way down (list positions add none, as JAX's
    sequence keys carry no ``key``)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, keys + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, keys) for v in tree]
    return fn(keys, tree)


def data_axes(mesh) -> tuple:
    """Axes that carry the global batch (pod included when present)."""
    if POD_AXIS in mesh.axis_names:
        return (POD_AXIS, DATA_AXIS)
    return (DATA_AXIS,)


def _data_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in data_axes(mesh))


def batch_axis(mesh, batch: int):
    """The batch dimension's entry: the data axes when the batch splits
    over them, else None (replicated)."""
    daxes = data_axes(mesh)
    dsize = _data_size(mesh)
    if batch % dsize or batch < dsize:
        return None
    return daxes if len(daxes) > 1 else DATA_AXIS


def batch_rows(mesh, batch: int, index: int) -> slice:
    """The rows of a global batch of ``batch`` that data index ``index``
    holds under :func:`batch_axis`: the ``index``-th of equal blocks
    (``NamedSharding``'s block layout) when the batch splits over the
    data axes, else every row (replicated)."""
    if batch_axis(mesh, batch) is None:
        return slice(0, batch)
    per = batch // _data_size(mesh)
    return slice(index * per, (index + 1) * per)


def _leaf_spec(keys, leaf, kv_sharded: bool) -> tuple:
    name = keys[-1]
    ndim = leaf.dim()
    M = MODEL_AXIS
    in_block = "blocks" in keys
    # quantized serving weights: {codes | codes_packed, scale, mu} under
    # the weight's name — codes shard like the weight (packing is on the
    # last dim, never a sharded one); per-period scale/mu replicate
    if name in ("codes", "codes_packed"):
        name = keys[-2]
    elif name in ("scale", "mu") and len(keys) >= 2 and keys[-2] != name \
            and keys[-2] in QUANTIZABLE:
        return (None,) * ndim

    def stacked(*spec):
        """Leaves under blocks/ carry the leading period axis."""
        return (None, *spec) if in_block else spec

    if name == "embed":
        return (M, None)
    if name == "lm_head":
        return (None, M)
    if name in ("scale", "bias"):                 # norms
        return stacked(None)
    # attention (flat padded-head layout) ---------------------------------
    if name == "wq":                              # (D, H_pad, hd)
        return stacked(None, M, None)
    if name == "wo":                              # (H_pad, hd, D)
        return stacked(M, None, None)
    if name == "bq":                              # (H_pad, hd)
        return stacked(M, None)
    if name in ("wk", "wv"):                      # (D, KV_pad, hd)
        return stacked(None, M, None) if kv_sharded else \
            stacked(None, None, None)
    if name in ("bk", "bv"):                      # (KV_pad, hd)
        return stacked(M, None) if kv_sharded else stacked(None, None)
    if name in ("q_norm", "k_norm"):
        return stacked(None)
    # moe / mlp -----------------------------------------------------------
    if name == "w_router":
        return stacked(None, None)
    if name in ("w_gate", "w_up"):
        if ndim == 4:                             # (P, E, D, F)
            return stacked(M, None, None)
        return stacked(None, M)                   # dense mlp (P, D, F)
    if name == "w_down":
        if ndim == 4:                             # (P, E, F, D)
            return stacked(M, None, None)
        return stacked(M, None)                   # dense mlp (P, F, D)
    # ssm -----------------------------------------------------------------
    if name in ("w_z", "w_x"):
        return stacked(None, M)
    if name in ("w_B", "w_C", "w_dt"):
        return stacked(None, None)
    if name == "conv_wx":
        return stacked(None, M)
    if name == "conv_bx":
        return stacked(M)
    if name in ("conv_wB", "conv_wC"):
        return stacked(None, None)
    if name in ("conv_bB", "conv_bC"):
        return stacked(None)
    if name in ("dt_bias", "A_log", "D"):
        return stacked(None)
    if name == "gate_norm":
        return stacked(M)
    if name == "w_out":
        return stacked(M, None)
    raise ValueError(f"no sharding rule for param {'/'.join(map(str, keys))} "
                     f"with ndim={ndim}")


def _with_fsdp(spec: tuple, leaf, mesh) -> tuple:
    """ZeRO-3 flavour: also shard the largest unsharded dim over the data
    axes when it divides evenly."""
    ndim = leaf.dim()
    dsize = _data_size(mesh)
    daxes = data_axes(mesh)
    parts = list(spec) + [None] * (ndim - len(spec))
    cand = [(leaf.shape[i], i) for i in range(ndim) if parts[i] is None]
    for size, i in sorted(cand, reverse=True):
        if size % dsize == 0 and size >= dsize:
            parts[i] = daxes if len(daxes) > 1 else DATA_AXIS
            break
    return tuple(parts)


def param_pspecs(cfg: ModelConfig, params_shape, *, fsdp: bool = False,
                 mesh=None) -> Any:
    """Spec tree matching ``transformer.init_params`` (or its quantized
    serving tree)."""
    msize = mesh.shape[MODEL_AXIS] if mesh is not None else 16
    kv_sharded = bool(cfg.num_heads) and cfg.padded_heads()[0] % msize == 0

    def rule(keys, leaf):
        spec = _leaf_spec(keys, leaf, kv_sharded)
        if fsdp:
            if mesh is None:
                raise ValueError("fsdp specs need a mesh")
            spec = _with_fsdp(spec, leaf, mesh)
        return spec

    return _map_with_path(rule, params_shape)


def model_sharded(cfg: ModelConfig, params_shape, model: int) -> Any:
    """A tree of bools of ``params_shape``'s nesting: True where
    :func:`param_pspecs` splits the leaf over a model axis of ``model``
    cards (the train step's norm sums those over the axis and counts the
    others once)."""
    from repro_torch.launch.mesh import make_mesh
    specs = param_pspecs(cfg, params_shape, mesh=make_mesh(1, model))
    return _map_with_path(lambda _, spec: any(
        MODEL_AXIS in _names(e) for e in spec), specs)


def _names(entry) -> tuple:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def fsdp_dims(cfg: ModelConfig, params_shape, mesh) -> Any:
    """A tree of ``params_shape``'s nesting (the whole tree's shapes):
    the dimension of each leaf that ``param_pspecs(fsdp=True)`` splits
    over the data axes (``pod`` and ``data`` as one) on ``mesh``, or None
    where it leaves the leaf whole over them."""
    daxes = set(data_axes(mesh))

    def dim(_, spec):
        hits = [i for i, e in enumerate(spec) if daxes & set(_names(e))]
        return hits[0] if hits else None

    return _map_with_path(dim, param_pspecs(cfg, params_shape, fsdp=True,
                                            mesh=mesh))


def split_axes(cfg: ModelConfig, params_shape, model: int,
               dims=None) -> Any:
    """A tree of ``params_shape``'s nesting: for each leaf the frozenset
    of the axes that split it, ``model`` where :func:`param_pspecs` splits
    it over a model axis of ``model`` cards (local shapes will do: the
    model rules read names, not sizes) and ``data`` where ``dims`` (a
    :func:`fsdp_dims` tree) gives it a dimension. The train step's
    gradient norm sums each leaf's squares over exactly these axes
    (``optimizer.global_norm``)."""
    model_flags = model_sharded(cfg, params_shape, model)
    if dims is None:
        dims = tree_map(lambda _: None, model_flags)
    return tree_map(lambda f, d: frozenset(
        ((MODEL_AXIS,) if f else ()) + (() if d is None else (DATA_AXIS,))),
        model_flags, dims)


def opt_pspecs(param_specs) -> Any:
    """mu / nu mirror the params; the step counter is replicated."""
    return {"mu": param_specs, "nu": param_specs, "step": ()}


def cache_pspecs(cfg: ModelConfig, cache_shape, mesh, batch: int) -> Any:
    """KV / SSM cache specs. Leaves (stacked over periods):
      attn k/v   (P, B, buf, KV, hd) -> (None, data, None, model?, None)
                 (KV sharded when the padded KV heads divide the model
                  axis; else the ring's sequence dim is, when it divides)
      ssm state  (P, B, H, N, hd)    -> (None, data, model, None, None)
      ssm conv   (P, B, W-1, C)      -> (None, data, None, None)
    Batch replicates when it cannot split over data (long_500k B=1)."""
    b_ax = batch_axis(mesh, batch)
    msize = mesh.shape[MODEL_AXIS]
    kv_ax = MODEL_AXIS if cfg.num_heads and \
        cfg.padded_heads()[0] % msize == 0 else None

    def rule(keys, leaf):
        name = keys[-1]
        if name in ("k", "v"):
            if kv_ax is None and leaf.shape[2] % msize == 0:
                return (None, b_ax, MODEL_AXIS, None, None)
            return (None, b_ax, None, kv_ax, None)
        if name == "state":
            return (None, b_ax, MODEL_AXIS, None, None)
        if name == "conv":
            return (None, b_ax, None, None)
        raise ValueError(f"no cache rule for {keys}")

    return _map_with_path(rule, cache_shape)


def batch_pspecs(mesh, batch: int, has_embeds: bool,
                 has_positions: bool) -> dict:
    b_ax = batch_axis(mesh, batch)
    specs = {"labels": (b_ax, None)}
    if has_embeds:
        specs["embeds"] = (b_ax, None, None)
    else:
        specs["tokens"] = (b_ax, None)
    if has_positions:
        specs["positions"] = (None, b_ax, None)
    return specs


def _shards(entry, mesh) -> int:
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        return math.prod(mesh.shape[a] for a in entry)
    return mesh.shape[entry]


def _pairs(tree, specs):
    """(leaf, spec) pairs of a tree and its spec tree; leaves that are
    not tensors (a host position) are skipped."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, specs[k])
    elif isinstance(tree, (list, tuple)):
        for v, s in zip(tree, specs, strict=True):
            yield from _pairs(v, s)
    elif hasattr(tree, "shape"):
        yield tree, specs


def per_card_bytes(tree, specs, mesh) -> int:
    """Bytes one card holds of ``tree`` laid out by ``specs`` on
    ``mesh``: each leaf's shard, every dimension divided (rounding up)
    by the sizes of the axes its spec names there."""
    total = 0
    for leaf, spec in _pairs(tree, specs):
        dims = list(leaf.shape)
        for i, entry in enumerate(spec):
            dims[i] = -(-dims[i] // _shards(entry, mesh))
        total += math.prod(dims) * leaf.element_size()
    return total


def _shard_of(entry, mesh, where) -> tuple:
    """(shards, this rank's shard index) of a spec entry: the named axes'
    sizes multiplied, the rank's indices on them read in order
    (row-major, as ``NamedSharding`` numbers the blocks)."""
    if entry is None:
        return 1, 0
    axes = entry if isinstance(entry, tuple) else (entry,)
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + where[a]
    return _shards(entry, mesh), idx


def local_shape(leaf, spec, mesh) -> tuple:
    """The shape of one card's shard of ``leaf`` under ``spec``: each
    dimension divided by the sizes of the axes its entry names. A
    dimension that does not divide raises (the rank program holds equal
    shards; :func:`per_card_bytes` rounds such a dimension up)."""
    dims = list(leaf.shape)
    for i, entry in enumerate(spec):
        n = _shards(entry, mesh)
        if dims[i] % n:
            raise ValueError(f"dimension {i} of {tuple(leaf.shape)} does not "
                             f"split over {entry} ({n} shards)")
        dims[i] //= n
    return tuple(dims)


def shard_tree(tree, specs, mesh, where):
    """The weight carry-over: a full tree (NumPy arrays or tensors) in,
    the shards of the rank at ``where`` (``mesh.coords``) out, each a
    contiguous copy (an unsplit leaf may come back as itself).

    An int4 ``codes_packed`` leaf holds code columns 2j and 2j + 1 in
    byte j (``models/transformer.py``'s unpacking), so a contiguous block
    of bytes is a contiguous block of columns: the packed dimension must
    divide, which :func:`local_shape` asserts. A quantized leaf's
    ``scale`` and ``mu`` replicate, as the reference lays them out
    (per-column ones too); the rank slices its columns out of them where
    it uses them (``transformer._dequant_block``)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh, where)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, s, mesh, where)
                          for v, s in zip(tree, specs, strict=True))
    local_shape(tree, specs, mesh)                # every split divides
    index = []
    for dim, entry in zip(tree.shape, specs):
        n, i = _shard_of(entry, mesh, where)
        index.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    part = tree[tuple(index)]
    if isinstance(part, np.ndarray):
        return np.ascontiguousarray(part)
    return part.contiguous()
