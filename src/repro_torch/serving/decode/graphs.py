"""CUDA graphs of the decode session's stages — the port's counterpart of
the reference's compile-once programs (``ModelBackend.jitted`` /
``trace_count`` in ``repro/serving/backends/base.py``; the ``embed``,
``prefill_seg``, ``extend_seg``, ``decode_seg``, ``h_logits`` and
``verify_seg`` programs of ``repro/serving/backends/transformer.py``).
The rest of that file's programs, the forward family (``tokens_logits``,
``h_logits``, ``acts``, ``cut``, ``probe_all``), and the classifier's
(``repro/serving/backends/classifier.py``) replay ``StageGraph``s too,
with their weights copied in (``serving.backends.graphs``), kept in the
same backend cache.

The reference traces each program once per shape and every session of
its backend replays it. Here a ``DecodeSession`` on a CUDA backend runs
each stage of its stream through ``ModelBackend.stage_graphs``: a key's
first use runs the stage eagerly; its second runs it eagerly again (the
warm-up, which does what a capture cannot: kernel builds and loads,
library handles) and then captures it as a ``torch.cuda.CUDAGraph``;
every later use of the key, in this stream or any later stream of the
backend, replays it. So a key used once (a prompt length seen once)
never pays for a capture. The stages come in pairs, device then server:

  * the ring prefill of sliding-window and SSM stacks, always one
    chunk: ``prefill_device`` — ``embed`` -> ``prefill_segment([0, p))``
    into the device slot's rings -> the quantized hop; ``prefill_server``
    — ``prefill_segment([p, L))`` -> unembed of the last row -> argmax
    (at p = 0 it embeds first; at p = L the unembed and argmax alone).
    Paged sessions ingest the device ring's pages between the two;
  * a prefill chunk of a full-context attention stack (the monolithic
    prefill is one chunk):
    ``extend_device`` — ``embed`` -> ``extend_segment([0, p))`` -> the
    quantized hop; ``extend_server`` — ``extend_segment([p, L))`` (at
    p = 0 it embeds first; at p = L there is none). The first token's
    unembed and argmax run eagerly after the last chunk;
  * the plain step: ``device`` — ``embed`` -> ``decode_segment([0, p))``
    -> the hop; ``server`` — ``decode_segment([p, L))`` -> unembed ->
    argmax (at p = 0 it embeds first; at p = L the unembed and argmax
    alone);
  * the speculative round at draft length k: ``spec_device`` — for j =
    0..k ``embed`` -> ``decode_segment([0, p))`` at the round start + j
    -> the hop, and for j < k the draft head (argmax of
    ``hidden_logits`` under the device weights) fed back as the next
    token -> (the k+1 hop rows, the k drafts); ``spec_server`` —
    ``verify_segment`` of the k+1 rows over ``[p, L)`` -> argmax.

A pair's key holds what its graphs bake in: the stage pair, the cut
(its segment bounds), rows (the prompt or chunk length, 1, or k + 1),
the stream's two cache slots (which fix batch, ``max_len`` and the cache
dtypes) and the params trees the graphs read. A chunk's offset, a
step's position and a round's start are not in it: they live on the
card, in the slot's 0-d ``pos`` tensor the session fills before each
stage, down into the K/V writes, RoPE and the decode-attention kernel.
Each pair has a memory pool of its own, the server stage in the device
stage's, reading its output where it lies (graphs that share a pool
replay in capture order); a pair is cached and evicted whole. The
backend keeps the keys used last (``_STAGE_GRAPH_KEYS``), so a prefill
graph per prompt length cannot pile up.

Cache slots: a graphed session takes its caches from a pool the backend
owns, keyed by (batch, ``max_len``, dtype), one slot for the device
segment and one for the server's; each holds a whole ``init_cache``
tree (cut-independent) and its ``pos`` tensor. The session holds its
slots from ``prefill`` until its stream ends (``generate`` returns, the
``round_stream`` generator closes, ``sever()``, a new ``prefill``, or
the session is collected); two live sessions of one shape hold two
slots. Acquiring a slot zeroes its trees in place, so every stream
starts from ``init_cache``'s zeros. ``_IDLE_SLOTS`` idle slots are kept
per shape; an evicted slot's graphs are dropped with it. A session
whose stream has ended steps no more (``ServingError``): its slots may
be another stream's.

``ModelBackend.capture_count`` counts captures, as ``trace_count``
counts the reference's traces: at most one per stage of a key, however
many sessions or tokens. The departures: a graph bakes in its segment
bounds and its slots, so a new cut (or a second live session of a
shape) captures once more — captures are O(cuts x shapes), where the
reference's traces are O(shapes) —; a key is captured on its second
use, not its first; and an evicted key captures again if it comes back.

The serving launcher's ``launch.serve.generate`` captures its whole
serve step (embed -> blocks ``[0, L)`` -> unembed) as one
``StageGraph`` per call, from the caches its own prefill built, as the
reference's launcher compiles its ``jstep`` once per call.
The training programs capture through ``StageGraph`` too: the donated
train step (``train.graphs.DonatedStep``) and the token stream's
sampler (``data.pipeline.TokenStream``, its generator registered with
the graph).

A replay calls no kernel wrapper, so no launch counter moves by itself.
A capture records each counter's change (``kernels.ops.COUNTERS``) and
puts the counter back, since a capture launches nothing; every replay
then adds the recorded change. There is no fallback: a capture that
fails raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import transformer as T

_IDLE_SLOTS = 2              # idle cache slots kept per (batch, max_len, dtype)


def use_graphs(graphs, device) -> bool:
    """``graphs`` resolved for ``device``: on by default for CUDA; asked
    for anywhere else, it raises."""
    cuda = torch.device(device).type == "cuda"
    if graphs and not cuda:
        raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
    return cuda if graphs is None else bool(graphs)


class StageGraph:
    """One stage captured as a CUDA graph: ``fn(*inputs)`` recorded once
    on ``inputs``, tensors that stay the graph's static inputs (a replay
    copies its arguments into them unless it is handed them back). The
    stage's outputs stay in ``outputs``, overwritten by every replay; a
    replay copies all its arguments in with one ``torch._foreach_copy_``.
    ``pool`` shares another graph's memory pool; graphs that share one
    replay in the order they were captured. ``generators`` (CUDA
    ``torch.Generator``s ``fn`` draws from) are registered with the
    graph, so a replay draws from each one's seed and offset as they
    stand when it starts, and advances the offset as the eager draws
    would."""

    def __init__(self, fn, inputs, pool=None, generators=()):
        self.inputs = tuple(inputs)
        watched = list(ops.COUNTERS)
        before = [getattr(obj, attr) for obj, attr in watched]
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        self.counts = []
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.outputs = fn(*self.inputs)
        finally:     # a capture launches nothing, even one that raised
            for (obj, attr), was in zip(watched, before):
                if getattr(obj, attr) != was:
                    self.counts.append((obj, attr, getattr(obj, attr) - was))
                    setattr(obj, attr, was)

    def replay(self, *inputs):
        pairs = [(static, x) for static, x in zip(self.inputs, inputs)
                 if x is not static]
        if pairs:                       # one call for all the copies
            torch._foreach_copy_([static for static, _ in pairs],
                                 [x for _, x in pairs])
        self.graph.replay()
        for obj, attr, n in self.counts:
            setattr(obj, attr, getattr(obj, attr) + n)
        return self.outputs


class CacheSlot:
    """One decode cache: an ``init_cache`` tree of ``batch`` x
    ``max_len`` slots in ``dtype`` and the 0-d int64 ``pos`` its stages
    read (the position of the next stage's first row: a chunk's offset,
    a step's token, a round's start). ``held`` while a stream owns it."""

    def __init__(self, cfg, batch: int, max_len: int, dtype, device):
        self.shape = (batch, max_len, dtype)
        self.caches = T.init_cache(cfg, batch, max_len, dtype, device)
        self.pos = torch.zeros((), dtype=torch.int64, device=device)
        self.held = False


def acquire_slot(backend, batch: int, max_len: int, dtype) -> CacheSlot:
    """A cache slot of ``backend``'s pool for one stream: the first idle
    slot of the shape (the one whose graphs most streams replayed), else
    a new one; its trees zeroed in place."""
    slots = backend.__dict__.setdefault("_cache_slots", {}).setdefault(
        (batch, max_len, dtype), [])
    slot = next((s for s in slots if not s.held), None)
    if slot is None:
        slot = CacheSlot(backend.cfg, batch, max_len, dtype, backend.device)
        slots.append(slot)
    else:
        for tree in slot.caches:
            for leaf in tree.values():
                leaf.zero_()
    slot.held = True
    return slot


def release_slots(backend, held: list) -> None:
    """Return the slots in ``held`` to ``backend``'s pool (and empty the
    list); past ``_IDLE_SLOTS`` idle slots of a shape, the last made
    goes, and the stage graphs on it."""
    for slot in held:
        slot.held = False
        slots = backend.__dict__["_cache_slots"][slot.shape]
        while sum(not s.held for s in slots) > _IDLE_SLOTS:
            gone = next(s for s in reversed(slots) if not s.held)
            slots.remove(gone)
            backend.drop_stage_graphs(gone)
    held.clear()
