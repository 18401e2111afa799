"""Data pipeline: synthetic token streams (LM training) and a synthetic
MNIST surrogate (the paper's classifier evaluation; nothing is
downloaded).

The image surrogates are NumPy, drawn exactly as the reference draws
them, so both packages see the same arrays from the same seed;
``minibatches`` hands them out as tensors on a device.

The token stream is a seeded low-rank bigram source with learnable
structure. It draws from a ``torch.Generator``: its tokens are not the
reference's (tests that compare the packages feed both the same
tokens). The reference compiles its whole-batch sampler once
(``jax.jit(sample_batch)``); on the card the stream captures its
sampler as one CUDA graph, since batch and length are fixed per stream.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.serving.decode.graphs import StageGraph, use_graphs


# ---------------------------------------------------------------------------
# Token stream

@dataclasses.dataclass
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    rank: int = 16            # low-rank structure of the transition table
    temperature: float = 1.0
    sharpness: float = 8.0    # logit scale: higher -> lower-entropy stream
    seed: int = 0


class TokenStream:
    """Deterministic, restartable synthetic LM data: batch ``step`` is
    drawn from the stream's generator seeded by (``seed``, ``step``), so
    ``batches(start_step)`` resumes the same stream.

    On CUDA (``graphs=None``) the first batch is drawn eagerly (the
    warm-up), the second captures the sampler as one CUDA graph with the
    generator registered to it (``StageGraph``) and every later batch
    replays it: the batch's seed is set on the generator before each
    replay, and reaches the card with the replay's RNG state, so a
    replayed batch is bitwise the eager one. ``captures`` counts the
    captures (at most 1; 0 on the CPU). ``graphs=False`` draws every
    batch eagerly; ``graphs=True`` off the card raises. A batch is the
    caller's own tensor, never the graph's buffer."""

    def __init__(self, cfg: TokenStreamConfig, device="cuda", graphs=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.graphs = use_graphs(graphs, self.device)
        g = torch.Generator(device=self.device).manual_seed(cfg.seed)
        v, r = cfg.vocab_size, cfg.rank
        self._emb_in = torch.randn((v, r), generator=g,
                                   device=self.device) / r ** 0.5
        self._emb_out = torch.randn((r, v), generator=g,
                                    device=self.device) / r ** 0.5
        self._gen = torch.Generator(device=self.device)
        self._graph = None
        self._draws = 0
        self.captures = 0

    def _sample(self, g: torch.Generator) -> torch.Tensor:
        cfg = self.cfg
        tok = torch.randint(0, cfg.vocab_size, (cfg.batch_size,),
                            generator=g, device=self.device)
        toks = []
        for _ in range(cfg.seq_len):
            logits = (self._emb_in[tok] @ self._emb_out) * (
                cfg.sharpness / cfg.temperature)
            tok = draw(torch.softmax(logits, -1), g)
            toks.append(tok)
        return torch.stack(toks, dim=1).to(torch.int32)     # (B, S)

    def _batch(self, seed: int) -> torch.Tensor:
        """The (B, S) tokens of the batch seeded by ``seed``."""
        g = self._gen
        g.manual_seed(seed)
        self._draws += 1
        if not self.graphs or self._draws == 1:
            return self._sample(g)
        if self._graph is None:
            self._graph = StageGraph(lambda: self._sample(g), (),
                                     generators=(g,))
            self.captures += 1
            g.manual_seed(seed)
        return self._graph.replay().clone()

    def batches(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            toks = self._batch((self.cfg.seed + 1) * 1_000_003 + step)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            step += 1


def draw(probs: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """One category per row of ``probs`` (..., V) -> (...) int64:
    argmax(p / q) with q ~ Exp(1) from ``g``, the draw
    ``torch.multinomial(probs, 1, generator=g)`` makes from the same
    generator state, without its check of the probabilities on the host
    (a CUDA graph cannot capture a host read)."""
    q = torch.empty_like(probs).exponential_(1, generator=g)
    return torch.argmax(probs / q, dim=-1)


# ---------------------------------------------------------------------------
# Synthetic MNIST surrogate

def synthetic_mnist(n_train: int = 8192, n_test: int = 2048, seed: int = 0,
                    noise: float = 1.3) -> Tuple[np.ndarray, ...]:
    """Returns (x_train, y_train, x_test, y_test); images (N, 784) in [0,1]."""
    rng = np.random.default_rng(seed)
    protos = rng.uniform(0.0, 1.0, size=(10, 784)).astype(np.float32)
    # sparsify prototypes so images look digit-like (mostly dark background)
    protos *= (rng.uniform(size=protos.shape) < 0.25)

    def make(n, seed2):
        r = np.random.default_rng(seed2)
        y = r.integers(0, 10, size=n)
        x = protos[y] + noise * r.normal(size=(n, 784)).astype(np.float32)
        # per-class elastic jitter: scale each image randomly
        x *= r.uniform(0.8, 1.2, size=(n, 1)).astype(np.float32)
        return np.clip(x, 0.0, 1.5).astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = make(n_train, seed + 1)
    x_te, y_te = make(n_test, seed + 2)
    return x_tr, y_tr, x_te, y_te


def synthetic_images(input_shape, num_classes: int = 10, n_train: int = 4096,
                     n_test: int = 1024, seed: int = 0,
                     noise: float = 0.45) -> Tuple[np.ndarray, ...]:
    """Class-prototype + noise images of arbitrary shape (the CNN
    surrogates: synthetic-SVHN, synthetic-CIFAR)."""
    rng = np.random.default_rng(seed)
    flat = int(np.prod(input_shape))
    protos = rng.uniform(0.0, 1.0, size=(num_classes, flat)).astype(np.float32)
    protos *= (rng.uniform(size=protos.shape) < 0.3)

    def make(n, seed2):
        r = np.random.default_rng(seed2)
        y = r.integers(0, num_classes, size=n)
        x = protos[y] + noise * r.normal(size=(n, flat)).astype(np.float32)
        x = np.clip(x, 0.0, 1.5).astype(np.float32)
        return x.reshape((n,) + tuple(input_shape)), y.astype(np.int32)

    x_tr, y_tr = make(n_train, seed + 1)
    x_te, y_te = make(n_test, seed + 2)
    return x_tr, y_tr, x_te, y_te


def minibatches(x, y, batch: int, seed: int = 0,
                device="cuda") -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Endless shuffled minibatches of NumPy (x, y) as tensors on
    ``device``; the permutations are the reference's (NumPy, ``seed``)."""
    rng = np.random.default_rng(seed)
    n = len(x)
    while True:
        idx = rng.permutation(n)
        for i in range(0, n - batch + 1, batch):
            sl = idx[i:i + batch]
            yield (torch.from_numpy(x[sl]).to(device),
                   torch.from_numpy(y[sl]).to(device))
