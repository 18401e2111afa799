"""Step functions the launchers execute (cfg baked in by closure): the
train step (forward, backward and the AdamW update), a full-sequence
prefill that builds the decode caches, and one decode step against
them."""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import make_train_step as _make_train_step


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None,
                    remat: bool = True, accum_steps: int = 1) -> Callable:
    return _make_train_step(cfg, opt_cfg or AdamWConfig(), remat=remat,
                            accum_steps=accum_steps)


def make_prefill_step(cfg: ModelConfig, max_len: int) -> Callable:
    def prefill_step(params, batch):
        logits, caches, _ = T.prefill(
            params, cfg, batch.get("tokens"), embeds=batch.get("embeds"),
            positions=batch.get("positions"), max_len=max_len)
        return logits, caches

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    def serve_step(params, token, caches, pos):
        return T.decode_step(params, cfg, token, caches, pos)

    return serve_step
