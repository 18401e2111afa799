"""The rank's model axis: the collectives of a rank's program over the
``model`` axis of a (data, model) mesh — the port's counterpart of what
GSPMD inserts into the reference's sharded programs
(``repro/launch/dryrun.py`` compiles them under ``param_pspecs`` /
``cache_pspecs`` / ``opt_pspecs``).

A :class:`ModelAxis` holds this rank's index on the axis, the axis's
size, the ``torch.distributed`` subgroup of the ranks that share this
rank's data index (:func:`make_axis`) and the axis's ``name``. The
models take it as ``axis=`` and, where the Megatron layout needs one,
call:

* :func:`to_ranks` — replicated -> rank-specific (Megatron's f): the
  identity, or the rank's slice, forward; backward, the sum over the
  axis of the ranks' cotangents (an all-reduce of the cotangent, zero
  outside the slice), so a replicated tensor's cotangent is the whole
  one on every rank;
* :func:`from_ranks` — rank-specific -> replicated (Megatron's g): the
  sum over the axis forward, the identity backward;
* :func:`sum_partials` — a row-parallel product's partial outputs,
  taken in f32 (:func:`partial_dtype`), summed by :func:`from_ranks`
  and rounded once to the activations' dtype, as the reference's
  compiled program sums f32 partials;
* :func:`all_reduce` — the sum over the axis, outside autograd (the
  sharded gradient norm, the data axis's gradient mean);
* :func:`all_gather` — the axis's shards concatenated in rank order;
* :func:`all_to_all` — block ``j`` of the leading dimension sent to rank
  ``j``, block ``i`` of the result received from rank ``i``;
* :func:`argmax` — the index of the largest logit over a vocab-sharded
  last dimension, ties to the lowest index as ``torch.argmax`` breaks
  them.

The train step's data axis is an axis too (:func:`make_data_axis`,
``name="data"``): the ranks that share this rank's model index, over
which the gradients are averaged.

Under the FSDP layout (``launch.sharding.param_pspecs(fsdp=True)``, the
reference's ZeRO-3 flavour) each leaf may also be split over that data
axis. An :class:`Fsdp` holds the axis and each leaf's split dimension
(``launch.sharding.fsdp_dims``), and the models read a split leaf
through :func:`gather`: one all-gather over the data axis forward; its
backward one reduce-scatter (sum) of the cotangent back to the rank's
shard where the batch is split over the data axis (the train step
divides by the axis's size once, for the mean), or the rank's slice of
it where every replica holds the same batch and so the same cotangent.

With no axis, or an axis of size 1, every one of them returns its input
and launches nothing (nor adds an autograd node): a one-card program is
today's program, bit for bit, forward and backward. ``max_len`` is the
global length of the decode caches a program runs on: a ring whose KV
heads do not divide the axis is laid out by it
(``models.attention.ring_of``), and a step raises where a cache's slots
are not what that layout gives (``models.attention.cache_ring``).

A rank program is captured as a CUDA graph only where every process
group it uses is NCCL's (:func:`require_capturable`): one rank a card.
Its subgroups' communicators are made by its first, eager call, which
runs every collective of the program before the capture.

Every collective, the backward's included, goes through
:func:`_collective`. On fake tensors (the dry run's ``FakeTensorMode``)
it is a stand-in: ``roofline.op_cost.count`` swaps it for one that
records the bytes each call moves, by kind and by axis, as
``repro/roofline/hlo_cost.py`` counts a collective (the larger of its
operand's and its result's bytes, once per call), and returns an empty
result of the right shape. Outside that count a fake tensor raises here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.launch.mesh import (DATA_AXIS, MODEL_AXIS, coords,
                                     mesh_num_chips)
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This rank's place on an axis of the mesh: ``index`` of ``size``,
    the subgroup ``group`` (None for a fake rank, which only the dry
    run's count runs), the global decode-cache length ``max_len`` and
    the axis's ``name`` (``model``, or ``data`` for the train step's
    gradient mean)."""
    index: int = 0
    size: int = 1
    group: Any = None
    max_len: Optional[int] = None
    name: str = MODEL_AXIS

    def __post_init__(self):
        if not 0 <= self.index < self.size:
            raise ValueError(f"model index {self.index} outside an axis of "
                             f"{self.size}")


def active(axis) -> bool:
    """True for an axis that splits anything (size > 1)."""
    return axis is not None and axis.size > 1


def size(axis) -> int:
    return 1 if axis is None else axis.size


def index(axis) -> int:
    return 0 if axis is None else axis.index


def with_len(axis, max_len: int):
    """``axis`` for a program whose decode caches hold ``max_len``
    positions (None stays None)."""
    if axis is None:
        return None
    return dataclasses.replace(axis, max_len=max_len)


def make_axis(mesh, rank: int, group=None) -> ModelAxis:
    """Rank ``rank``'s model axis on ``mesh``, its subgroup made from the
    world's ranks (``torch.distributed.new_group``: every rank of the
    world must call this, in the same order, as the rule is for
    subgroups). With one data index the subgroup is ``group`` itself (the
    world, when None); an axis of size 1 has none."""
    import torch.distributed as dist
    m = mesh.shape[MODEL_AXIS]
    mi = coords(mesh, rank)[MODEL_AXIS]
    if m == 1:
        return ModelAxis(0, 1, None)
    n = mesh_num_chips(mesh)
    if n == m:
        return ModelAxis(mi, m, group if group is not None
                         else dist.group.WORLD)
    mine = None
    for first in range(0, n, m):      # one subgroup per data index
        sub = dist.new_group(list(range(first, first + m)))
        if first <= rank < first + m:
            mine = sub
    return ModelAxis(mi, m, mine)


def require_capturable(graphs, device, axes) -> None:
    """Where ``graphs`` asks for a CUDA graph of a rank program over
    ``axes`` (model axes, data axes, None) on ``device`` (``True``, or
    ``None`` on CUDA: the default of ``serving.decode.graphs.
    use_graphs``), every active axis's process group must be NCCL's,
    whose collectives are kernels on the card's streams; raises naming
    the backend of the first that is not (gloo's collectives run on the
    host, so a capture cannot hold them). The check comes before
    ``use_graphs``'s, so a gloo rank on the CPU hears of its backend.
    There is no fallback to eager: a gloo rank passes ``graphs=False``."""
    import torch.distributed as dist
    if not (graphs or (graphs is None
                       and torch.device(device).type == "cuda")):
        return
    for a in axes:
        if active(a) and dist.get_backend(a.group) != "nccl":
            raise ValueError(
                f"a CUDA graph of the rank program needs NCCL over the "
                f"{a.name} axis, whose group is "
                f"{dist.get_backend(a.group)}'s (its collectives run on "
                f"the host): pass graphs=False")


def data_index(mesh, where) -> tuple:
    """(index, size) of the rank at ``where`` (``mesh.coords``) over the
    mesh's data axes (``pod`` and ``data``, every axis but ``model``)
    taken as one, ``pod`` the outer."""
    index, size = 0, 1
    for a in mesh.axis_names:
        if a != MODEL_AXIS:
            index, size = index * mesh.shape[a] + where[a], \
                size * mesh.shape[a]
    return index, size


def make_data_axis(mesh, rank: int, group=None):
    """Rank ``rank``'s data axis on ``mesh``: the ranks that share its
    model index (:func:`data_index`), over which the train step averages
    its gradients (``name="data"``); None with one data index. Its
    subgroup is ``group`` (the world, when None) where the model axis is
    1, else one of the subgroups made here, one per model index (every
    rank of the world calls this after :func:`make_axis`, in the same
    order)."""
    import torch.distributed as dist
    m = mesh.shape[MODEL_AXIS]
    n = mesh_num_chips(mesh)
    di, d = data_index(mesh, coords(mesh, rank))
    if d == 1:
        return None
    if m == 1:
        return ModelAxis(di, d, group if group is not None
                         else dist.group.WORLD, name=DATA_AXIS)
    mine = None
    for mi in range(m):                  # one subgroup per model index
        sub = dist.new_group(list(range(mi, n, m)))
        if rank % m == mi:
            mine = sub
    return ModelAxis(di, d, mine, name=DATA_AXIS)


def group_axis(group) -> ModelAxis:
    """A process group's ranks as one data axis (the host mesh's, whose
    every rank is a data index)."""
    import torch.distributed as dist
    return ModelAxis(dist.get_rank(group), dist.get_world_size(group),
                     group, name=DATA_AXIS)


def _is_fake(x) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(x, FakeTensor)


def _collective(kind: str, x, axis: ModelAxis, dim: int = 0):
    """One collective over ``axis`` on a real tensor: ``"all-reduce"``
    (sum), ``"all-gather"`` (concatenated along ``dim`` in rank order),
    ``"reduce-scatter"`` (the sum over the axis, of which the rank keeps
    its block of ``dim``, block ``i`` on rank ``i``) or ``"all-to-all"``
    (over the leading dimension, one block a rank)."""
    import torch.distributed as dist
    if _is_fake(x):
        raise TypeError(f"a fake tensor reached the {kind} outside the dry "
                        f"run's count (roofline.op_cost.count)")
    if axis.group is None:
        raise ValueError(f"{kind} over a model axis of {axis.size} with no "
                         f"process group")
    x = x.contiguous()
    if kind == "all-reduce":
        dist.all_reduce(x, group=axis.group)
        return x
    if kind == "all-to-all":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=axis.group)
        return out
    if kind == "reduce-scatter":
        blocks = x.movedim(dim, 0).contiguous()
        out = blocks.new_empty((blocks.shape[0] // axis.size,)
                               + blocks.shape[1:])
        dist.reduce_scatter_tensor(out, blocks, group=axis.group)
        return out.movedim(0, dim)
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts, dim=dim)


def all_reduce(x, axis):
    """The sum of ``x`` over the axis (``x`` itself, summed in place when
    contiguous); ``x`` unchanged without one. Autograd does not see it:
    a differentiated program sums with :func:`from_ranks`."""
    if not active(axis):
        return x
    return _collective("all-reduce", x, axis)


class _FromRanks(torch.autograd.Function):
    """The sum over the axis forward (in place where ``x`` is
    contiguous), the identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        out = _collective("all-reduce", x, axis)
        if out is x:
            ctx.mark_dirty(x)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ToRanks(torch.autograd.Function):
    """The identity, or the slice ``[start, start + length)`` of ``dim``,
    forward; backward the cotangent, zero outside the slice, summed over
    the axis."""

    @staticmethod
    def forward(ctx, x, axis, dim, start, length):
        ctx.axis, ctx.dim, ctx.start, ctx.shape = axis, dim, start, x.shape
        return x if dim is None else x.narrow(dim, start, length)

    @staticmethod
    def backward(ctx, g):
        if ctx.dim is None:
            # a fresh buffer: the engine may hand ``g`` to another node too
            full = g.clone(memory_format=torch.contiguous_format)
        else:
            full = g.new_zeros(ctx.shape)
            full.narrow(ctx.dim, ctx.start, g.shape[ctx.dim]).copy_(g)
        return _collective("all-reduce", full, ctx.axis), None, None, None, \
            None


def _tracked(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def from_ranks(x, axis):
    """Rank-specific -> replicated: the sum of ``x`` over the axis, whose
    backward is the identity (each rank's cotangent is the replicated
    sum's); ``x`` unchanged without an axis. Outside autograd (no
    gradient wanted) it is :func:`all_reduce`."""
    if not active(axis):
        return x
    if not _tracked(x):
        return _collective("all-reduce", x, axis)
    return _FromRanks.apply(x, axis)


def to_ranks(x, axis, dim=None, start: int = 0, length: int = 0):
    """Replicated -> rank-specific: ``x`` itself, or with ``dim`` its
    slice ``[start, start + length)`` there, whose backward sums the
    ranks' cotangents over the axis (zero outside each rank's slice; the
    slices may overlap), so the replicated ``x`` gets its whole cotangent
    on every rank. ``x`` unchanged without an axis."""
    if not active(axis):
        return x
    if not _tracked(x):
        return x if dim is None else x.narrow(dim, start, length)
    return _ToRanks.apply(x, axis, dim, start, length)


def rank_block(x, axis, dim: int, n: int):
    """:func:`to_ranks` of the rank's ``n`` entries of ``dim``, block
    ``axis.index`` (the rank's experts, heads or KV heads of a replicated
    tensor)."""
    return to_ranks(x, axis, dim, index(axis) * n, n)


def partial_dtype(axis, dtype):
    """The dtype a row-parallel product's output is taken in: f32 over
    an axis that splits it (its partial sums are summed in f32 and
    rounded once, by :func:`sum_partials`), else ``dtype``, the one-card
    product's."""
    return torch.float32 if active(axis) else dtype


def sum_partials(y, axis, dtype):
    """A row-parallel product's outputs ``y`` (in :func:`partial_dtype`)
    summed over the axis, then rounded to ``dtype``; ``y`` unchanged
    without one."""
    if not active(axis):
        return y
    return from_ranks(y, axis).to(dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class Fsdp:
    """A rank's FSDP layout: the data ``axis`` its leaves are split over
    (:func:`make_data_axis`), ``dims`` a tree of the params' nesting with
    each leaf's split dimension of the stacked leaf, or None where the
    leaf is whole on every data index (``launch.sharding.fsdp_dims``),
    and ``sums``: True where the batch is split over the data axis, so
    that the ranks' cotangents differ and the gathers' backward sums
    them; False where every replica holds the same batch."""
    axis: Optional[ModelAxis]
    dims: Any
    sums: bool = True


def fsdp_active(fsdp) -> bool:
    """True for a layout whose data axis splits anything."""
    return fsdp is not None and active(fsdp.axis)


class _Gather(torch.autograd.Function):
    """The all-gather over the axis along ``dim`` forward; backward the
    cotangent reduce-scattered (summed, the rank's block kept), or only
    the rank's block of it where ``sums`` is False."""

    @staticmethod
    def forward(ctx, x, axis, dim, sums):
        ctx.axis, ctx.dim, ctx.sums = axis, dim, sums
        return _collective("all-gather", x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        axis, dim = ctx.axis, ctx.dim
        if ctx.sums:
            return _collective("reduce-scatter", g, axis, dim), None, \
                None, None
        n = g.shape[dim] // axis.size
        return g.narrow(dim, axis.index * n, n), None, None, None


def gather(x, fsdp, dim):
    """A leaf split over ``fsdp``'s data axis along ``dim`` (None: not
    split), whole: the axis's shards concatenated in rank order, whose
    backward gives the rank its shard's cotangent (:class:`Fsdp`'s
    ``sums``). ``x`` unchanged without an active layout or a split."""
    if dim is None or not fsdp_active(fsdp):
        return x
    if not _tracked(x):
        return _collective("all-gather", x, fsdp.axis, dim)
    return _Gather.apply(x, fsdp.axis, dim, fsdp.sums)


def gather_tree(tree, dims, fsdp):
    """:func:`gather` over a subtree, each leaf along its dimension in
    the ``dims`` subtree."""
    if not fsdp_active(fsdp):
        return tree
    return tree_map(lambda t, d: gather(t, fsdp, d), tree, dims)


def all_gather(x, axis, dim: int = 0):
    """The axis's ``x`` concatenated along ``dim``, rank 0's first;
    ``x`` unchanged without one."""
    if not active(axis):
        return x
    return _collective("all-gather", x, axis, dim % x.dim())


def all_to_all(x, axis):
    """``x`` (m, ...) whose block ``j`` is bound for rank ``j`` -> (m,
    ...) whose block ``i`` came from rank ``i``; ``x`` unchanged without
    an axis."""
    if not active(axis):
        return x
    if x.shape[0] != axis.size:
        raise ValueError(f"all-to-all of {tuple(x.shape)} over a model axis "
                         f"of {axis.size}")
    return _collective("all-to-all", x, axis)


def argmax(logits, axis):
    """``torch.argmax`` over the last dimension of logits sharded over
    the axis by contiguous blocks in rank order (the unembedding's vocab
    columns): each rank's largest logit and its global index are
    gathered, and the first rank holding the largest wins, so a tie
    goes to the lowest index. Returns int64 indices of ``logits``'s
    leading shape."""
    if not active(axis):
        return torch.argmax(logits, -1)
    local = torch.argmax(logits, -1, keepdim=True)
    value = torch.gather(logits, -1, local)
    local = local + axis.index * logits.shape[-1]
    values = all_gather(value, axis, -1)
    indices = all_gather(local, axis, -1)
    best = torch.argmax(values, -1, keepdim=True)
    return torch.gather(indices, -1, best)[..., 0]
