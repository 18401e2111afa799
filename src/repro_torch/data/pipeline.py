"""Data pipeline: synthetic token streams (LM training) and a synthetic
MNIST surrogate (the paper's classifier evaluation; nothing is
downloaded).

The image surrogates are NumPy, drawn exactly as the reference draws
them, so both packages see the same arrays from the same seed;
``minibatches`` hands them out as tensors on a device.

The token stream is a seeded low-rank bigram source with learnable
structure. It draws from a ``torch.Generator``: its tokens are not the
reference's (tests that compare the packages feed both the same
tokens).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch


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
    drawn from a generator seeded by (``seed``, ``step``), so
    ``batches(start_step)`` resumes the same stream."""

    def __init__(self, cfg: TokenStreamConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        g = torch.Generator(device=self.device).manual_seed(cfg.seed)
        v, r = cfg.vocab_size, cfg.rank
        self._emb_in = torch.randn((v, r), generator=g,
                                   device=self.device) / r ** 0.5
        self._emb_out = torch.randn((r, v), generator=g,
                                    device=self.device) / r ** 0.5

    def _sample(self, g: torch.Generator) -> torch.Tensor:
        cfg = self.cfg
        tok = torch.randint(0, cfg.vocab_size, (cfg.batch_size,),
                            generator=g, device=self.device)
        toks = []
        for _ in range(cfg.seq_len):
            logits = (self._emb_in[tok] @ self._emb_out) * (
                cfg.sharpness / cfg.temperature)
            tok = torch.multinomial(torch.softmax(logits, -1), 1,
                                    generator=g)[:, 0]
            toks.append(tok)
        return torch.stack(toks, dim=1).to(torch.int32)     # (B, S)

    def batches(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            g = torch.Generator(device=self.device).manual_seed(
                (self.cfg.seed + 1) * 1_000_003 + step)
            toks = self._sample(g)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            step += 1


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
