"""CUDA graphs of the decode step and the speculative round — the port's
counterpart of the reference's compile-once decode programs
(``ModelBackend.jitted`` / ``trace_count`` in
``repro/serving/backends/base.py``; the ``embed``, ``decode_seg``,
``h_logits`` and ``verify_seg`` programs of
``repro/serving/backends/transformer.py``).

The reference traces its programs once and replays the compiled ones
for every token. Here a ``DecodeSession`` on a CUDA backend runs its
first plain decode step eagerly (the warm-up), then captures each stage
of the step once as a ``torch.cuda.CUDAGraph`` and replays the graphs
for every later token:

  * the device stage: ``embed`` -> ``decode_segment([0, p))`` -> the
    quantized channel hop (none at p = 0);
  * the server stage: ``decode_segment([p, L))`` -> unembed -> argmax
    (at p = 0 it embeds the token first; at p = L it is the unembed and
    the argmax alone).

A speculative stream does the same with its rounds at its configured
draft length k: the first runs eagerly, the second captures two stages,
later rounds replay them; a round at a smaller k (the stream's last,
where fewer tokens remain) runs eagerly:

  * ``spec_device``: for j = 0..k, ``embed`` -> ``decode_segment([0,
    p))`` at the round start + j -> the hop, and for j < k the draft
    head (argmax of ``hidden_logits`` under the device weights), fed
    back as the next token inside the graph -> (the k+1 hop rows, the k
    drafts); at p = 0 the embeds and draft heads alone;
  * ``spec_server``: ``verify_segment`` of the k+1 rows over ``[p, L)``
    -> argmax -> the k+1 verified tokens.

Acceptance stays on the host: after each round the drafts and verified
tokens cross to it in one copy. Each pair of stages has a memory pool
of its own (graphs that share a pool replay in capture order, and a
stream may mix speculative rounds with a plain tail step).

The position lives on the card (a 0-d int64 tensor the session fills
before each step or round; a round's row positions are computed from
it there), down into the decode-attention kernel, so one graph serves
every position.

``ModelBackend.capture_count`` counts the graphs captured for a
backend's sessions, as ``trace_count`` counts the reference's traces: at
most 2 for a plain stream and 4 for a speculative one (its two round
stages, and the plain step's two if it takes two plain steps or more),
however many tokens it decodes. The one departure: a graph bakes in
tensor addresses and the segment bounds, so unlike the reference's
programs (dynamic ``start, stop, pos``, shared by every session of a
backend) each new stream — a new session, a new cut, or a new prefill
that allocates new caches — captures anew.

The serving launcher's ``launch.serve.generate`` captures its whole
serve step (embed -> blocks ``[0, L)`` -> unembed) as one
``StageGraph`` per call, from the caches its own prefill built, as the
reference's launcher compiles its ``jstep`` once per call.

A replay calls no kernel wrapper, so no launch counter moves by itself.
A capture records each counter's change (``kernels.ops.COUNTERS``) and
puts the counter back, since a capture launches nothing; every replay
then adds the recorded change. There is no fallback: a capture that
fails raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


class StageGraph:
    """One stage captured as a CUDA graph: ``fn(*inputs)`` recorded once
    on ``inputs``, tensors that stay the graph's static inputs (a replay
    copies its arguments into them unless it is handed them back). The
    stage's outputs stay in ``outputs``, overwritten by every replay.
    ``pool`` shares another graph's memory pool; graphs that share one
    replay in the order they were captured."""

    def __init__(self, fn, inputs, pool=None):
        self.inputs = tuple(inputs)
        watched = list(ops.COUNTERS)
        before = [getattr(obj, attr) for obj, attr in watched]
        self.graph = torch.cuda.CUDAGraph()
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
        for static, x in zip(self.inputs, inputs):
            if x is not static:
                static.copy_(x)
        self.graph.replay()
        for obj, attr, n in self.counts:
            setattr(obj, attr, getattr(obj, attr) + n)
        return self.outputs
