"""The forward family's graphs — the port's counterpart of the
reference's compile-once forward programs (``tokens_logits``,
``h_logits``, ``acts``, ``cut`` and ``probe_all`` in
``repro/serving/backends/transformer.py``; the classifier's programs,
``serving.backends.classifier``, go through ``graphed_call`` too).

The reference compiles each of those once per shape, with the segment
bounds as dynamic operands, so every start, cut and probe at a shape
shares one program (its segment is a masked scan over all L blocks).
Here a segment is a loop over exactly its blocks, as
``models.transformer.segment_forward`` runs it, and on a backend whose
forward graphs are on (``ModelBackend.forward_graphs``: by default when
its parameters live on CUDA) each block runs through one CUDA graph per
block shape, kept by the backend (``ModelBackend.stage_graphs``) under
the key

    ("block", period position, the block tree's signature (leaf paths,
     shapes, dtypes), B, S, the hidden state's dtype).

The graph's static inputs are the hidden state and one buffer per leaf
of the block's tree. A replay copies in the hidden state and that
layer's leaves in one call (``StageGraph.replay``): a period slice of
the stacked tree, a quantized segment's own tree (``segment_blocks``)
or a perturbed probe's. So one graph serves every layer of its period
position, every start and cut, every plan's quantized blocks, the clean
model and every perturbed probe: captures are O(period positions x
shapes), whatever the depth, as the reference's traces are
(``tests/test_calibration.py`` ``TestCompileOnce``).

As for every stage graph, a key's first use runs the block eagerly, its
second eagerly again (the warm-up) and then captures it, and every
later use, by any layer, program or caller, replays it. A replay
overwrites the graph's output buffer, so what goes back to a caller is
copied out first. The block's router losses are dropped, as the serving
paths drop them. There is no fallback: a capture that fails raises.
"""
from __future__ import annotations

from repro_torch.models import rope as rope_lib
from repro_torch.models import transformer as T
from repro_torch.serving.decode.graphs import StageGraph
from repro_torch.serving.errors import ServingError


def refuse_off_card(backend) -> None:
    """Raise ``ServingError`` when ``forward_graphs=True`` is asked of a
    backend whose parameters are not on CUDA (a backend's
    ``__post_init__``)."""
    if backend.forward_graphs and backend.device.type != "cuda":
        raise ServingError(f"CUDA graphs need a CUDA backend, not "
                           f"{backend.device}")


def graphed(backend) -> bool:
    """Whether ``backend``'s forward family runs through block graphs:
    ``forward_graphs``, or by default whether its parameters live on
    CUDA."""
    on = backend.forward_graphs
    return backend.device.type == "cuda" if on is None else bool(on)


def _flatten(tree, prefix=()):
    """(leaf paths, leaves) of a nested dict, in ``tree_leaves`` order."""
    paths, leaves = [], []
    for k, v in tree.items():
        if isinstance(v, dict):
            sub_paths, sub_leaves = _flatten(v, prefix + (k,))
            paths += sub_paths
            leaves += sub_leaves
        else:
            paths.append(prefix + (k,))
            leaves.append(v)
    return paths, leaves


def _unflatten(paths, leaves) -> dict:
    tree = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def _block_fn(cfg, pos: int, paths):
    """Block ``fn(h, *leaves) -> h_out`` at period position ``pos``, its
    tree rebuilt from ``paths`` and its rotary positions from (B, S)."""
    def fn(h, *leaves):
        b, s = h.shape[:2]
        positions = rope_lib.text_positions(b, s, device=h.device)
        return T.apply_block(_unflatten(paths, leaves), cfg, pos, h,
                             positions)[0]
    return fn


def graphed_call(backend, key: tuple, fn, inputs):
    """``fn(*inputs)`` through the backend's graph of ``key`` (the stage
    name first): the key's first use runs ``fn`` eagerly, its second
    eagerly again and then captures it on clones of ``inputs``, every
    later use replays it with ``inputs`` copied in -> (the outputs,
    whether they are the graph's buffers, which the next replay
    overwrites)."""
    name = key[0]
    entry = backend.stage_graphs(key)
    graph = entry.graphs.get(name)
    if graph is not None:
        return graph.replay(*inputs), True
    entry.uses[name] = uses = entry.uses.get(name, 0) + 1
    out = fn(*inputs)
    if uses >= 2:
        entry.graphs[name] = StageGraph(fn, [t.clone() for t in inputs])
        backend.count_capture()
    return out, False


def _graphed_block(backend, bp, pos: int, h):
    """Block ``bp`` on ``h`` through the backend's graph of its key ->
    (h_out, whether h_out is the graph's output buffer)."""
    paths, leaves = _flatten(bp)
    key = ("block", pos,
           tuple((p, t.shape, t.dtype) for p, t in zip(paths, leaves)),
           h.shape[0], h.shape[1], h.dtype)
    return graphed_call(backend, key, _block_fn(backend.cfg, pos, paths),
                        (h, *leaves))


def run_blocks(backend, params, h, start: int, stop: int, *,
               collect: bool = False, replace=None):
    """Blocks ``[start, stop)`` of ``params`` on hidden state ``h`` (B, S,
    D), bitwise ``models.transformer.segment_forward``: through the
    backend's block graphs when ``graphed(backend)``, else eagerly.
    ``replace`` maps a layer to the block tree it runs in place of its
    own (a calibration probe's perturbed block). ``collect=True`` also
    returns the activation entering every block of the stack, written
    into one (L, B, S, D) buffer (blocks outside the segment pass their
    input through). Returns ``h_out`` or ``(h_out, acts)``, tensors of
    the caller's, never a graph's buffer."""
    cfg, replace = backend.cfg, replace or {}
    on = graphed(backend)
    positions = None if on else rope_lib.text_positions(
        h.shape[0], h.shape[1], device=h.device)
    acts = h.new_empty((cfg.num_layers,) + tuple(h.shape)) \
        if collect else None
    borrowed = False
    for layer in range(0 if collect else start,
                       cfg.num_layers if collect else stop):
        if collect:
            acts[layer].copy_(h)
        if not start <= layer < stop:
            continue
        if layer in replace:
            bp, pos = replace[layer], layer % T.period_len(cfg)
        else:
            bp, pos = T.block_at(params, cfg, layer)
        if on:
            h, borrowed = _graphed_block(backend, bp, pos, h)
        else:
            h = T.apply_block(bp, cfg, pos, h, positions)[0]
    if borrowed:
        h = h.clone()
    return (h, acts) if collect else h
