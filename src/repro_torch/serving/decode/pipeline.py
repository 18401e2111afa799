"""``DecodeSession`` — streaming greedy decode partitioned at the plan's
cut point.

Prefill: the device embeds the prompt and runs its quantized segment
``[0, p)``, populating its own cache (stored at the deployed bit-width's
dtype, ``cache.kv_cache_dtype``); the cut hidden state crosses the
channel quantized at ``bits_x``; the server tail ``[p, L)`` fills its
full-precision cache and emits the first token (TTFT). Decode: each step
embeds the previous token on the device, advances the device cache,
ships ONE token's quantized hidden state, advances the server cache and
samples greedily. ``p == 0`` runs entirely server-side; ``p == L`` still
unembeds server-side.

On a CUDA backend the device segment runs from quantized wire structs
through the qmatmul/qmatmul4 kernels by default (``qkernels``), and
every decode step's attention through the decode-attention kernel.
Stage boundaries are fenced with ``torch.cuda.synchronize`` so the
wall-clock stage seconds measure finished work.

Chunked prefill (``prefill_chunk_tokens``), speculative decode
(``draft_tokens``), paged KV (``paged``) and sliding-window configs are
not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.quantizer import dequantize, quantize
from repro_torch.models import transformer as T
from repro_torch.serving.backends.base import to_device
from repro_torch.serving.decode.cache import (kv_cache_dtype,
                                              segment_cache_bytes)
from repro_torch.serving.errors import ServingError


def _fence(t):
    """Wait for the device work behind ``t`` (a wall-clock stage fence)."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return t


@dataclasses.dataclass
class GenerationResult:
    """One streamed generation. ``tokens`` (B, new_tokens) greedy ids;
    stage seconds are wall-clock, aggregated over the whole stream. The
    prefill round emits token 0, each decode round one more token, so
    ``per_token_s`` has ``new_tokens - 1`` entries."""
    tokens: np.ndarray
    ttft_s: float                 # prefill → first token
    t_device_s: float             # device-segment seconds (incl. prefill)
    t_server_s: float             # server-tail seconds (incl. prefill)
    t_total_s: float
    per_token_s: List[float]      # per-token seconds (len new_tokens-1)
    device_cache_bytes: int       # resident [0, p) cache footprint
    server_cache_bytes: int       # resident [p, L) cache footprint
    device_cache_dtype: str
    rounds: int = 0               # decode rounds after the prefill

    @property
    def new_tokens(self) -> int:
        return int(self.tokens.shape[1])

    @property
    def tokens_per_s(self) -> float:
        """0.0 for a degenerate zero-duration window."""
        return self.new_tokens / self.t_total_s if self.t_total_s > 0 \
            else 0.0


class DecodeSession:
    """One partitioned prefill→decode stream for a deployed plan.

    ``backend`` must support decode (``TransformerBackend``); ``segment``
    reuses an already-materialized quantized device segment. Prompts are
    token ids (B, S), greedy text decode only. ``qkernels`` (default: on
    when the backend lives on CUDA) runs the device segment from wire
    structs (``qstacked_for``) instead of dense fake-quantized weights
    (``stacked_for``)."""

    def __init__(self, backend, plan, *, max_len: int,
                 segment=None, qkernels: Optional[bool] = None,
                 paged: bool = False,
                 prefill_chunk_tokens: Optional[int] = None,
                 draft_tokens: int = 0):
        if not getattr(backend, "supports_decode", False):
            raise ServingError(
                f"{type(backend).__name__} has no autoregressive decode "
                "path — decode sessions need a transformer backend")
        if paged or prefill_chunk_tokens is not None or draft_tokens:
            raise NotImplementedError(
                "paged KV, chunked prefill and speculative decode are not "
                "ported to repro_torch yet (ROADMAP Queue 1)")
        if backend.cfg.sliding_window is not None:
            raise NotImplementedError(
                "decode sessions on sliding-window configs (ring "
                "wraparound during prefill) are not ported to repro_torch "
                "yet (ROADMAP Queue 1)")
        self.backend = backend
        self.plan = plan
        self.max_len = int(max_len)
        cfg = backend.cfg
        self.cfg = cfg
        self.L = backend.num_layers
        self.p = int(plan.p)
        self.device = backend.device
        self.model_dtype = T.model_dtype(cfg)
        if qkernels is None:
            qkernels = self.device.type == "cuda"
        self.qkernels = bool(qkernels)
        if self.p > 0:
            seg = segment if segment is not None else backend.split(plan)
            self.dev_params = (backend.qstacked_for(seg, plan)
                               if self.qkernels
                               else backend.stacked_for(seg, plan))
            self.bits_x = int(seg.bits_x)
            self.dev_dtype = kv_cache_dtype(self.bits_x, self.model_dtype)
        else:
            self.dev_params = None
            self.bits_x = 0
            self.dev_dtype = self.model_dtype
        self.dev_caches = None
        self.srv_caches = None
        self.pos = 0
        self.t_device_s = 0.0
        self.t_server_s = 0.0
        self.rounds = 0

    # -- pricing views ---------------------------------------------------
    def wire_bits_per_token(self, batch: int) -> float:
        """Uplink bits per decode step: the quantized cut hidden state
        plus the 32-bit sampled-token downlink; 0 for full offload."""
        if self.p == 0:
            return 0.0
        return float(self.bits_x * self.cfg.d_model * batch + 32 * batch)

    def _quant_hop(self, h):
        """Quantize the cut hidden ``h`` (B, S, D) for the channel hop
        with one grid PER TOKEN POSITION (min/max over that position's
        (B, 1, D) slab); a (B, 1, D) decode slab reduces to the plain
        per-tensor ``fake_quant``."""
        mu = torch.amin(h, dim=(0, 2), keepdim=True)
        phi = torch.amax(h, dim=(0, 2), keepdim=True)
        codes, scale, mu = quantize(h, self.bits_x, mu=mu, phi=phi)
        return dequantize(codes, scale, mu, h.dtype)

    def device_cache_bytes(self) -> int:
        if self.dev_caches is None or self.p == 0:
            return 0
        return segment_cache_bytes(self.cfg, self.dev_caches, 0, self.p)

    def server_cache_bytes(self) -> int:
        if self.srv_caches is None:
            return 0
        return segment_cache_bytes(self.cfg, self.srv_caches, self.p,
                                   self.L)

    # -- pipeline stages -------------------------------------------------
    def prefill(self, prompt):
        """Run the partitioned prefill; returns the first greedy token
        (B,) and records stage seconds (TTFT = their sum)."""
        prompt = to_device(prompt, self.device, torch.int32)
        s = prompt.shape[1]
        if s + 1 > self.max_len:
            raise ServingError(
                f"prompt ({s}) leaves no room in max_len={self.max_len}")
        return self._prefill_chunked(prompt)

    def _prefill_chunked(self, prompt):
        """Monolithic prefill as ONE cache-mediated extend chunk: device
        extend → quantized hop → server extend, so the prefill attention
        reads K/V through the same narrowed cache dtype every later
        decode step reads. (Multi-chunk admission is a later slice.)"""
        b, s = prompt.shape
        t0 = time.perf_counter()
        if self.p > 0:
            self.dev_caches = T.init_cache(self.cfg, b, self.max_len,
                                           self.dev_dtype, self.device)
            h0 = self.backend.embed(prompt, params=self.dev_params)
            h_dev, self.dev_caches = self.backend.extend_segment(
                h0, self.dev_caches, 0, 0, self.p, params=self.dev_params)
            h_in = _fence(self._quant_hop(h_dev))
        t1 = time.perf_counter()
        self.srv_caches = T.init_cache(self.cfg, b, self.max_len,
                                       self.model_dtype, self.device)
        if self.p == 0:
            h_in = self.backend.embed(prompt)
        h_srv, self.srv_caches = self.backend.extend_segment(
            h_in, self.srv_caches, 0, self.p, self.L)
        logits = self.backend.hidden_logits(h_srv[:, -1:, :])
        token = _fence(torch.argmax(logits, -1).to(torch.int32))
        t2 = time.perf_counter()
        self.t_device_s += t1 - t0
        self.t_server_s += t2 - t1
        self.pos = s
        return token

    def step(self, token):
        """One decode step feeding ``token`` (B,); returns the next
        greedy token (B,)."""
        if self.pos + 1 > self.max_len:
            raise ServingError(f"decode past max_len={self.max_len}")
        tok = to_device(token, self.device).reshape(-1, 1)
        t0 = time.perf_counter()
        if self.p > 0:
            x = self.backend.embed(tok, params=self.dev_params)
            x_dev, self.dev_caches = self.backend.decode_segment(
                x, self.dev_caches, self.pos, 0, self.p,
                params=self.dev_params)
            x_in = _fence(self._quant_hop(x_dev))
        t1 = time.perf_counter()
        if self.p == 0:
            x_in = self.backend.embed(tok)
        x_srv, self.srv_caches = self.backend.decode_segment(
            x_in, self.srv_caches, self.pos, self.p, self.L)
        logits = self.backend.hidden_logits(x_srv)
        nxt = _fence(torch.argmax(logits, -1).to(torch.int32))
        t2 = time.perf_counter()
        self.t_device_s += t1 - t0
        self.t_server_s += t2 - t1
        self.pos += 1
        return nxt

    # -- drivers ----------------------------------------------------------
    def stream(self, prompt, max_new_tokens: int):
        """Generator of (step_index, token (B,) np.ndarray) — token 0 is
        the prefill's (TTFT)."""
        token = self.prefill(prompt)
        yield 0, token.cpu().numpy()
        for i in range(1, max_new_tokens):
            token = self.step(token)
            self.rounds += 1
            yield i, token.cpu().numpy()

    def generate(self, prompt, max_new_tokens: int,
                 stream_cb=None) -> GenerationResult:
        if max_new_tokens < 1:
            raise ServingError("max_new_tokens must be >= 1")
        toks: List[np.ndarray] = []
        per_token: List[float] = []
        t_start = time.perf_counter()
        ttft = None
        last = t_start
        for i, tok in self.stream(prompt, max_new_tokens):
            now = time.perf_counter()
            if ttft is None:
                ttft = now - t_start
            else:
                per_token.append(now - last)
            last = now
            toks.append(tok)
            if stream_cb is not None:
                stream_cb(i, tok)
        total = time.perf_counter() - t_start
        return GenerationResult(
            tokens=np.stack(toks, axis=1),
            ttft_s=float(ttft),
            t_device_s=self.t_device_s,
            t_server_s=self.t_server_s,
            t_total_s=total,
            per_token_s=per_token,
            device_cache_bytes=self.device_cache_bytes(),
            server_cache_bytes=self.server_cache_bytes(),
            device_cache_dtype=str(self.dev_dtype).removeprefix("torch."),
            rounds=self.rounds)
