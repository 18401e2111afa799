"""Donated train steps as CUDA graphs — the port's counterpart of
``jax.jit(step, donate_argnums=...)``: the training launcher's ``jstep``
(``repro/launch/train.py``) and the examples' jitted steps.

:class:`DonatedStep` wraps a step ``fn(*state, *rest) -> (*new_state,
*outputs)`` whose first ``donate`` arguments are state trees (nested
dicts and lists of tensors: the parameters, the optimizer state) that
the step replaces, and whose other arguments (a batch) it only reads.
On CUDA, per key:

  * the first call runs ``fn`` eagerly: the warm-up, which does what a
    capture cannot (kernel builds and module loads, cuBLAS handles, the
    autograd engine's first pass);
  * the second call takes the state trees it is handed as the graph's
    static buffers, releases the warm-up's cached blocks
    (``torch.cuda.empty_cache``, so the eager step's blocks do not stay
    reserved beside the graph's private pool), captures ``fn`` with the
    new state written back into those same buffers at the end of the
    graph (one ``torch._foreach_copy_`` of the leaves whose new tensor
    is not already that buffer: none for a step that updates in place,
    ``make_train_step(in_place=True)``), and replays it once to carry
    out the step;
  * every later call replays the graph and returns the static state
    trees, so a loop that threads the returned state back in copies
    nothing. A state or an input that is not the graph's own tensor is
    copied in first (``StageGraph.replay``); the non-donated inputs'
    static buffers are the graph's own copies, so a caller's batch is
    never written.

This is the reference's donation: from the capture on, the state trees
handed in are the graph's buffers, and a caller that keeps a tree from
before a step sees it move with the step. The outputs (a step's
metrics) are the graph's buffers too, overwritten by the next replay:
read them, or copy them, before the next call.

A wrapper holds one step function (the step's identity), and keys its
graphs by the donated trees' leaf signature and the other inputs' keys,
shapes and dtypes: a new batch shape captures once more, never a new
call.
``captures`` counts the captures, 0 on the CPU. The graph's launch
counters follow ``StageGraph``: a capture launches nothing and puts the
counters back, every replay adds the launches the capture recorded.

``write_back`` lists, capture by capture, how many state leaves each
replay copies back.

On a CPU tensor, ``graphs=None`` runs ``fn`` eagerly every call;
``graphs=False`` does so on CUDA (the eager twin); ``graphs=True`` off
the card raises. There is no fallback: a capture that fails raises.

A rank program's step (``make_train_step`` over a model ``axis``, a data
axis ``group`` or an FSDP layout ``fsdp``, read from the step's
attributes) is captured with its collectives, as the reference's
``jax.jit`` of the sharded step compiles them in: only where every
active axis's process group is NCCL's (``launch.model_parallel.
require_capturable``; over gloo ``graphs=True``, or the default on CUDA,
raises). Every rank must call it alike, so that each captures and
replays the same collectives in the same order. Such a step should be
made with ``in_place=True``: its new state is then its buffers, nothing
is copied back, and the graph's private pool holds no second state.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.launch import model_parallel as mp
from repro_torch.serving.decode.graphs import StageGraph, use_graphs
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def signature(tree):
    """A hashable key of a tree's nesting and of each leaf's shape, dtype
    and device; a leaf that is not a tensor raises."""
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, signature(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(signature(v) for v in tree)
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"a graphed step takes tensor leaves, not "
                        f"{type(tree).__name__}")
    return (tuple(tree.shape), tree.dtype, tree.device)


class DonatedStep:
    """``fn`` with its first ``donate`` arguments donated, run through one
    CUDA graph per key on the card (module docstring). Called as ``fn``
    is; returns ``(*state, *outputs)`` as ``fn`` does (with ``donate`` 0,
    ``fn``'s output as it is)."""

    def __init__(self, fn, donate: int = 2, graphs=None):
        self.fn, self.donate, self.graphs = fn, donate, graphs
        fsdp = getattr(fn, "fsdp", None)
        self.axes = (getattr(fn, "axis", None), getattr(fn, "group", None),
                     fsdp.axis if fsdp is not None else None)
        self.captures = 0
        self.write_back = []
        self._uses = collections.Counter()
        self._graphs = {}

    def __call__(self, *args):
        device = tree_leaves(args)[0].device
        mp.require_capturable(self.graphs, device, self.axes)
        if not use_graphs(self.graphs, device):
            return self.fn(*args)
        key = (signature(args[:self.donate]), signature(args[self.donate:]))
        entry = self._graphs.get(key)
        if entry is None:
            self._uses[key] += 1
            if self._uses[key] == 1:
                return self.fn(*args)
            entry = self._graphs[key] = self._capture(args)
        graph, state, outputs = entry
        out = tree_unflatten(outputs, graph.replay(*tree_leaves(args)))
        return out if not self.donate else (*state, *out)

    def _capture(self, args):
        """(the graph, the static state trees, the outputs' template) of
        ``fn`` on ``args``: the donated trees are the graph's buffers, the
        other inputs cloned."""
        d = self.donate
        state, rest = args[:d], tree_map(lambda t: t.clone(), args[d:])
        static = tree_leaves(state)
        n, template = len(static), []

        def step(*leaves):
            out = self.fn(*tree_unflatten(state, leaves[:n]),
                          *tree_unflatten(rest, leaves[n:]))
            new = tree_leaves(out[:d]) if d else []
            if signature(new) != signature(static):
                raise ValueError("a donated step must return its state "
                                 "trees with the leaves it was given")
            copies = [(s, x) for s, x in zip(leaves[:n], new) if x is not s]
            if copies:
                torch._foreach_copy_([s for s, _ in copies],
                                     [x for _, x in copies])
            outputs = out[d:] if d else out
            if not template:
                self.write_back.append(len(copies))
            template.append(outputs)
            return tuple(tree_leaves(outputs))

        torch.cuda.empty_cache()
        graph = StageGraph(step, static + tree_leaves(rest))
        self.captures += 1
        return graph, state, template[0]
