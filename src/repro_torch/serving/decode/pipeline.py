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

Serving-shape knobs, all off by default: ``prefill_chunk_tokens`` admits
the prompt in chunks through the cache-mediated extend path,
``draft_tokens`` turns decode rounds speculative (the quantized device
segment drafts, the server verifies every draft in one round trip —
bitwise plain greedy), ``paged`` tracks the device KV page by page.
Sliding-window and SSM stacks prefill through ``prefill_segment`` (a
window's ring wraps; an SSM state is a running reduction), as one ring-
prefill stage pair, and take neither chunking nor speculation.

On a CUDA backend the device segment runs from quantized wire structs
through the qmatmul/qmatmul4 kernels by default (``qkernels``), and
every decode step's attention through the decode-attention kernel.
Ring prefills, prefill chunks, plain decode steps and speculative
rounds keep their offset / position on the device, run on caches from
the backend's slot pool, and replay CUDA graphs of their two stages that
the backend keeps for every later session (``graphs``, the reference's
compile-once programs; see ``serving.decode.graphs``). Stage boundaries are fenced
with ``torch.cuda.synchronize`` so the wall-clock stage seconds measure
finished work.
"""
from __future__ import annotations

import collections
import dataclasses
import time
import weakref
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ATTN
from repro_torch.core.quantizer import dequantize, quantize
from repro_torch.models import transformer as T
from repro_torch.serving.backends.base import to_device
from repro_torch.serving.decode.cache import (DEFAULT_PAGE_TOKENS,
                                              KVPagePool, PagedKVCache,
                                              kv_cache_dtype,
                                              segment_cache_bytes,
                                              segment_nonattn_cache_bytes,
                                              segment_page_pool)
from repro_torch.serving.decode.graphs import (CacheSlot, StageGraph,
                                               acquire_slot, release_slots)
from repro_torch.serving.errors import ServingError


# the second stage of each graphed pair -> the first, whose memory pool
# it shares and whose output it reads
_FIRST_STAGE = {"server": "device", "spec_server": "spec_device",
                "extend_server": "extend_device",
                "prefill_server": "prefill_device"}


def _fence(t):
    """Wait for the device work behind ``t`` (a wall-clock stage fence)."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return t


@dataclasses.dataclass
class GenerationResult:
    """One streamed generation. ``tokens`` (B, new_tokens) greedy ids;
    stage seconds are wall-clock, aggregated over the whole stream.

    Generation advances in server ROUNDS — the prefill round emits token
    0, then each decode round one token (plain greedy) or 1..k+1 tokens
    (a speculative round). ``per_token_s`` has ``new_tokens - 1`` entries
    regardless: a round that emitted ``m`` tokens contributes ``m`` equal
    entries of ``round_seconds / m``. ``rounds`` counts decode rounds
    (the prefill is not one)."""
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
    draft_tokens: int = 0         # configured draft length k (0 = off)
    drafts_proposed: int = 0
    drafts_accepted: int = 0
    prefill_chunks: int = 1       # 1 = monolithic prefill

    @property
    def new_tokens(self) -> int:
        return int(self.tokens.shape[1])

    @property
    def tokens_per_s(self) -> float:
        """0.0 for a degenerate zero-duration window."""
        return self.new_tokens / self.t_total_s if self.t_total_s > 0 \
            else 0.0

    @property
    def accept_rate(self) -> Optional[float]:
        """Measured draft acceptance (accepted / proposed); None when no
        drafts were proposed."""
        if self.drafts_proposed <= 0:
            return None
        return self.drafts_accepted / self.drafts_proposed


class DecodeSession:
    """One partitioned prefill→decode stream for a deployed plan.

    ``backend`` must support decode (``TransformerBackend``); ``segment``
    reuses an already-materialized quantized device segment. Prompts are
    token ids (B, S), greedy text decode only. ``qkernels`` (default: on
    when the backend lives on CUDA) runs the device segment from wire
    structs (``qstacked_for``) instead of dense fake-quantized weights
    (``stacked_for``). ``page_pool`` shares one ``KVPagePool`` between
    paged sessions (default: a pool of this stream's worst case).
    ``graphs`` (default: on when the backend lives on CUDA) takes the
    stream's caches from the backend's slot pool and runs each stage
    (ring prefill, prefill chunk, plain step, speculative round) through
    the backend's stage graphs: eagerly on its key's first use, eagerly
    and captured on its second, replayed on every later use by this or
    any later session; off, a CUDA session allocates its own caches and
    steps eagerly through the same code. CPU sessions step eagerly.

    A graphed session's caches (``dev_caches``, ``srv_caches``) and
    ``last_logits`` (the server graph's output buffer) stay readable
    after its stream ends, until another stream acquires its slots; it
    steps no more (``ServingError``) until a new ``prefill``."""

    def __init__(self, backend, plan, *, max_len: int,
                 segment=None, qkernels: Optional[bool] = None,
                 paged: bool = False,
                 page_tokens: int = DEFAULT_PAGE_TOKENS,
                 page_pool: Optional[KVPagePool] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 draft_tokens: int = 0, graphs: Optional[bool] = None):
        if not getattr(backend, "supports_decode", False):
            raise ServingError(
                f"{type(backend).__name__} has no autoregressive decode "
                "path — decode sessions need a transformer backend")
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
        # block-granular device-KV accounting: the segment functions keep
        # their dense cache operands; the paged structure tracks the
        # page-granular resident footprint, bit for bit the dense ring
        self.paged = bool(paged) and self.p > 0
        self.page_tokens = int(page_tokens)
        self.page_pool = page_pool
        self.paged_kv: Optional[PagedKVCache] = None
        self.draft_tokens = int(draft_tokens)
        if self.draft_tokens < 0:
            raise ServingError("draft_tokens must be >= 0")
        plen = T.period_len(cfg)
        # full-context attention stacks prefill through the cache-
        # mediated extend path (the monolithic prefill is the one-chunk
        # admission), so the prefill attention reads K/V through the
        # narrowed cache dtype every later decode step reads
        self._cache_extendable = (
            cfg.sliding_window is None
            and all(cfg.block_kind(i) == ATTN for i in range(plen)))
        self.prefill_chunk_tokens: Optional[int] = None
        if prefill_chunk_tokens is not None or self.draft_tokens:
            if any(cfg.block_kind(i) != ATTN for i in range(plen)):
                raise ServingError(
                    "chunked prefill / speculative decode need an "
                    "attention-only stack: SSM state is a running "
                    "reduction, not position-addressable")
            if cfg.sliding_window is not None:
                raise ServingError(
                    "chunked prefill / speculative decode need the full-"
                    "context ring (slot == position); sliding-window "
                    "wraparound would overwrite live context")
        if prefill_chunk_tokens is not None:
            c = int(prefill_chunk_tokens) or 2 * self.page_tokens
            if c < 2:
                raise ServingError(
                    "prefill_chunk_tokens must be >= 2 (a 1-row chunk's "
                    "matvec lowering breaks the bitwise prefill lock) or "
                    "0 for the default of 2 * page_tokens")
            if self.paged and c % self.page_tokens:
                raise ServingError(
                    f"prefill_chunk_tokens={c} must be page-aligned "
                    f"(kv page = {self.page_tokens} tokens)")
            self.prefill_chunk_tokens = c
        self.pos = 0
        self.graphs = self.device.type == "cuda" if graphs is None \
            else bool(graphs)
        if self.graphs and self.device.type != "cuda":
            raise ServingError(f"CUDA graphs need a CUDA backend, not "
                               f"{self.device}")
        # the stream's cache slots (from the backend's pool when graphed,
        # else the session's own); each slot's ``pos`` is filled from
        # ``pos`` before each stage, which stays the one source of truth
        self._dev_slot: Optional[CacheSlot] = None
        self._srv_slot: Optional[CacheSlot] = None
        self._held: List[CacheSlot] = []     # pool slots held, if any
        weakref.finalize(self, release_slots, backend, self._held)
        # the stage keys of the backend's graphs this stream ran -> uses
        self.graph_keys = collections.Counter()
        # (B, V) of the last plain step or ring prefill; on a graphed
        # stage the server graph's output buffer, which the next replay
        # overwrites
        self.last_logits = None
        self.t_device_s = 0.0
        self.t_server_s = 0.0
        self.rounds = 0
        self.drafts_proposed = 0
        self.drafts_accepted = 0
        self.prefill_chunks = 1

    # -- pricing views ---------------------------------------------------
    def wire_bits_per_token(self, batch: int) -> float:
        """Uplink bits per decode step: the quantized cut hidden state
        plus the 32-bit sampled-token downlink; 0 for full offload."""
        if self.p == 0:
            return 0.0
        return float(self.bits_x * self.cfg.d_model * batch + 32 * batch)

    def wire_bits_per_round(self, batch: int,
                            k: Optional[int] = None) -> float:
        """Wire bits for ONE speculative round: k drafted ids (32-bit) +
        k+1 quantized cut hiddens uplink, up to k+1 verified ids
        downlink."""
        if self.p == 0:
            return 0.0
        k = self.draft_tokens if k is None else int(k)
        hidden = self.bits_x * self.cfg.d_model * batch
        return float((k + 1) * hidden + 32 * k * batch
                     + 32 * (k + 1) * batch)

    def _quant_hop(self, h):
        """Quantize the cut hidden ``h`` (B, S, D) for the channel hop
        with one grid PER TOKEN POSITION (min/max over that position's
        (B, 1, D) slab): a chunk's rows quantize as the monolithic
        prefill's same rows, and a (B, 1, D) decode slab reduces to the
        plain per-tensor ``fake_quant``."""
        mu = torch.amin(h, dim=(0, 2), keepdim=True)
        phi = torch.amax(h, dim=(0, 2), keepdim=True)
        codes, scale, mu = quantize(h, self.bits_x, mu=mu, phi=phi)
        return dequantize(codes, scale, mu, h.dtype)

    def device_cache_bytes(self) -> int:
        if self.dev_caches is None or self.p == 0:
            return 0
        if self.paged_kv is not None:
            # pages actually held + the dense non-attention remainder
            return self.paged_kv.resident_bytes + \
                segment_nonattn_cache_bytes(self.cfg, self.dev_caches, 0,
                                            self.p)
        return segment_cache_bytes(self.cfg, self.dev_caches, 0, self.p)

    def server_cache_bytes(self) -> int:
        if self.srv_caches is None:
            return 0
        return segment_cache_bytes(self.cfg, self.srv_caches, self.p,
                                   self.L)

    def sever(self) -> int:
        """End the stream: return its cache slots to the backend's pool
        and every held KV page to the page pool. Returns the page count
        released (0 for dense sessions)."""
        release_slots(self.backend, self._held)
        if self.paged_kv is None:
            return 0
        return self.paged_kv.free_all()

    @property
    def _pos_t(self):
        """The stream's position on the device (its server slot's)."""
        return self._srv_slot.pos

    def _open_stream(self, b: int) -> None:
        """The stream's caches: with graphs a device slot (past p = 0)
        and a server slot from the backend's pool, zeroed (the last
        stream's slots go back first); else fresh caches of its own."""
        release_slots(self.backend, self._held)
        self.graph_keys = collections.Counter()
        shapes = [(b, self.max_len, self.dev_dtype)] if self.p > 0 else []
        shapes.append((b, self.max_len, self.model_dtype))
        if self.graphs:
            self._held.extend(acquire_slot(self.backend, *shape)
                              for shape in shapes)
            slots = list(self._held)
        else:
            slots = [CacheSlot(self.cfg, *shape, self.device)
                     for shape in shapes]
        self._dev_slot = slots[0] if self.p > 0 else None
        self._srv_slot = slots[-1]
        self.dev_caches = self._dev_slot.caches if self.p > 0 else None
        self.srv_caches = self._srv_slot.caches

    def _set_pos(self, pos: int) -> None:
        """Fill the slots' device positions for the next stage."""
        for slot in (self._dev_slot, self._srv_slot):
            if slot is not None:
                slot.pos.fill_(pos)

    # -- pipeline stages -------------------------------------------------
    @staticmethod
    def chunk_bounds(s: int, c: int) -> List[tuple]:
        """Chunk boundaries [(lo, hi), ...] covering ``[0, s)`` in
        ``c``-token chunks, folding a remainder of 1 into the final
        chunk (no 1-row chunk)."""
        bounds, lo = [], 0
        while lo < s:
            hi = min(lo + c, s)
            if s - hi == 1:
                hi = s
            bounds.append((lo, hi))
            lo = hi
        return bounds

    def _open_paged(self, b: int) -> None:
        if self.page_pool is None:
            self.page_pool = segment_page_pool(
                self.cfg, 0, self.p, b, self.max_len, self.dev_dtype,
                page_tokens=self.page_tokens, device=self.device)
        self.paged_kv = PagedKVCache(self.page_pool, self.cfg, 0, self.p,
                                     b, self.max_len)

    def prefill(self, prompt):
        """Run the partitioned prefill; returns the first greedy token
        (B,) and records stage seconds (TTFT = their sum)."""
        prompt = to_device(prompt, self.device, torch.int32)
        b, s = prompt.shape
        if s + 1 > self.max_len:
            raise ServingError(
                f"prompt ({s}) leaves no room in max_len={self.max_len}")
        self._open_stream(b)
        if self.prefill_chunk_tokens is not None:
            return self._prefill_chunked(prompt, self.prefill_chunk_tokens)
        if self._cache_extendable:
            return self._prefill_chunked(prompt, None)
        # a wrapping (sliding-window) ring or an SSM stack: the whole
        # prompt at once into the stream's slots, through the ring-
        # prefill stage pair (always one chunk, so the first token's
        # unembed and argmax are the server stage's last ops)
        t0 = time.perf_counter()
        h_in = prompt
        if self.p > 0:
            h_in = _fence(self._stage("prefill_device",
                                      self._prefill_device, prompt, s))
            if self.paged:
                self._open_paged(b)
                self.paged_kv.ingest_prefill(self.dev_caches, s)
        t1 = time.perf_counter()
        self.last_logits, token = self._stage(
            "prefill_server", self._prefill_server, h_in, s)
        token = _fence(token.clone())
        t2 = time.perf_counter()
        self.t_device_s += t1 - t0
        self.t_server_s += t2 - t1
        self.pos = s
        return token

    def _prefill_chunked(self, prompt, chunk_tokens: Optional[int]):
        """Chunk-granular prefill (``chunk_tokens=None``: one chunk, the
        monolithic case): each chunk runs its device stage (embed →
        extend ``[0, p)`` → quantized hop) and its server stage (extend
        ``[p, L)``) at its offset on the device, and (when paged) its
        pages are ingested between the two as it lands. The first
        token's unembed and argmax run after the last chunk."""
        b, s = prompt.shape
        bounds = [(0, s)] if chunk_tokens is None \
            else self.chunk_bounds(s, chunk_tokens)
        self.prefill_chunks = len(bounds)
        if self.paged:
            self._open_paged(b)
        h_srv = None
        for lo, hi in bounds:
            chunk = prompt[:, lo:hi]
            self._set_pos(lo)
            t0 = time.perf_counter()
            h_in = chunk
            if self.p > 0:
                h_in = _fence(self._stage("extend_device",
                                          self._extend_device, chunk,
                                          hi - lo))
                if self.paged_kv is not None:
                    self.paged_kv.ingest_range(self.dev_caches, lo, hi)
            t1 = time.perf_counter()
            h_srv = h_in if self.p == self.L else self._stage(
                "extend_server", self._extend_server, h_in, hi - lo)
            _fence(h_srv)
            t2 = time.perf_counter()
            self.t_device_s += t1 - t0
            self.t_server_s += t2 - t1
        t1 = time.perf_counter()
        logits = self.backend.hidden_logits(h_srv[:, -1:, :])
        token = _fence(torch.argmax(logits, -1).to(torch.int32))
        self.t_server_s += time.perf_counter() - t1
        self.pos = s
        return token

    def _prefill_device(self, prompt):
        """The ring prefill's device stage: embed the prompt's ids (B,
        S), prefill blocks ``[0, p)`` into the device slot's rings, the
        quantized channel hop."""
        h = self.backend.embed(prompt, params=self.dev_params)
        h, self.dev_caches = self.backend.prefill_segment(
            h, self.dev_caches, 0, self.p, params=self.dev_params)
        return self._quant_hop(h)

    def _prefill_server(self, h):
        """The ring prefill's server stage: prefill blocks ``[p, L)``
        over the hop's rows into the server slot's rings (at p == 0,
        embed the prompt's ids ``h`` first), unembed the last row ->
        (logits (B, V), the first greedy token (B,) int32)."""
        if self.p == 0:
            h = self.backend.embed(h)
        h, self.srv_caches = self.backend.prefill_segment(
            h, self.srv_caches, self.p, self.L)
        logits = self.backend.hidden_logits(h[:, -1:, :])
        return logits, torch.argmax(logits, -1).to(torch.int32)

    def _extend_device(self, chunk):
        """A prefill chunk's device stage at the device slot's offset:
        embed the chunk's ids (B, S), extend blocks ``[0, p)``, the
        quantized channel hop."""
        h = self.backend.embed(chunk, params=self.dev_params)
        h, self.dev_caches = self.backend.extend_segment(
            h, self.dev_caches, self._dev_slot.pos, 0, self.p,
            params=self.dev_params)
        return self._quant_hop(h)

    def _extend_server(self, h):
        """A prefill chunk's server stage at the server slot's offset:
        extend blocks ``[p, L)`` over the hop's rows (at p == 0, embed
        the chunk's ids ``h`` first) -> (B, S, D)."""
        if self.p == 0:
            h = self.backend.embed(h)
        h, self.srv_caches = self.backend.extend_segment(
            h, self.srv_caches, self._srv_slot.pos, self.p, self.L)
        return h

    def _device_stage(self, tok):
        """The plain step's device stage at the device position: embed
        ``tok`` (B, 1), blocks ``[0, p)``, the quantized channel hop."""
        x = self.backend.embed(tok, params=self.dev_params)
        x, self.dev_caches = self.backend.decode_segment(
            x, self.dev_caches, self._dev_slot.pos, 0, self.p,
            params=self.dev_params)
        return self._quant_hop(x)

    def _server_stage(self, x):
        """The plain step's server stage: blocks ``[p, L)`` over the hop's
        hidden (at p == 0, the embedded token ``x``) -> (logits (B, V),
        the greedy token (B,) int32)."""
        if self.p == 0:
            x = self.backend.embed(x)
        x, self.srv_caches = self.backend.decode_segment(
            x, self.srv_caches, self._srv_slot.pos, self.p, self.L)
        logits = self.backend.hidden_logits(x)
        return logits, torch.argmax(logits, -1).to(torch.int32)

    def _graph_key(self, name: str, rows: int) -> tuple:
        """What stage ``name``'s graph over ``rows`` rows bakes in: the
        cut, the rows, the stream's slots and the params trees it reads
        (the slots fix batch, ``max_len`` and the cache dtypes)."""
        return (name, self.p, rows, self._dev_slot, self._srv_slot,
                id(self.dev_params), id(self.backend.params))

    def _stage(self, name: str, fn, x, rows: int):
        """Run stage ``fn`` on ``x`` (``rows`` rows per batch row):
        eagerly without graphs; else through the backend's graphs of its
        key: the key's first use runs eagerly, its second eagerly and
        then captures it, every later use (by any session) replays it.
        The second stage of a pair (``prefill_server``,
        ``extend_server``, ``server``, ``spec_server``) is cached under
        its first stage's key, shares its memory pool, so the pair
        replays in capture order, and reads its output where it lies in
        that pool."""
        if not self.graphs:
            return fn(x)
        lead = _FIRST_STAGE.get(name, name)
        key = self._graph_key(lead, rows)
        entry = self.backend.stage_graphs(
            key, reads=(self.dev_params, self.backend.params))
        self.graph_keys[(name,) + key[1:]] += 1
        graph = entry.graphs.get(name)
        if graph is not None:
            return graph.replay(x)
        entry.uses[name] = uses = entry.uses.get(name, 0) + 1
        out = fn(x)
        if uses >= 2:
            first = entry.graphs.get(lead) if lead != name else None
            if first is None:
                static, pool = x.clone(), None
            else:
                outs = first.outputs
                static = outs[0] if isinstance(outs, tuple) else outs
                pool = first.graph.pool()
            entry.graphs[name] = StageGraph(fn, (static,), pool=pool)
            self.backend.count_capture()
        return out

    def _check_stream(self) -> None:
        """A graphed session steps only while its stream holds its slots
        (after ``generate``, a closed ``round_stream`` or ``sever``, they
        may be another stream's)."""
        if self.graphs and not self._held:
            raise ServingError(
                "no live stream: this session's cache slots went back to "
                "the backend's pool (or prefill has not run); prefill "
                "starts a new stream")

    def step(self, token):
        """One decode step feeding ``token`` (B,); returns the next
        greedy token (B,), a tensor no later step overwrites. The logits
        stay in ``last_logits``."""
        if self.pos + 1 > self.max_len:
            raise ServingError(f"decode past max_len={self.max_len}")
        self._check_stream()
        tok = to_device(token, self.device).reshape(-1, 1)
        self._set_pos(self.pos)
        t0 = time.perf_counter()
        x = tok
        if self.p > 0:
            x = _fence(self._stage("device", self._device_stage, tok, 1))
            if self.paged_kv is not None:
                self.paged_kv.append_step(self.dev_caches, self.pos)
        t1 = time.perf_counter()
        self.last_logits, nxt = self._stage("server", self._server_stage, x,
                                            1)
        nxt = _fence(nxt.clone())
        t2 = time.perf_counter()
        self.t_device_s += t1 - t0
        self.t_server_s += t2 - t1
        self.pos += 1
        return nxt

    def _spec_device(self, cur, k: int, pos):
        """The round's device stage from its round start ``pos`` (a host
        int or a 0-d integer tensor on the device, never read on the
        host): for j = 0..k embed ``cur`` (B, 1), blocks ``[0, p)`` at
        ``pos + j``, the quantized hop; for j < k the draft head's argmax
        becomes the next ``cur``. At p == 0 the embeds and draft heads
        alone. Returns (hh (B, k+1, D), drafts (B, k) int32)."""
        qs, drafts = [], []
        for j in range(k + 1):
            if self.p > 0:
                x = self.backend.embed(cur, params=self.dev_params)
                x_dev, self.dev_caches = self.backend.decode_segment(
                    x, self.dev_caches, pos + j, 0, self.p,
                    params=self.dev_params)
                q = self._quant_hop(x_dev)
            else:
                q = self.backend.embed(cur)
            qs.append(q)
            if j < k:
                d = torch.argmax(
                    self.backend.hidden_logits(q, params=self.dev_params),
                    -1).to(torch.int32)
                drafts.append(d)
                cur = d.reshape(-1, 1)
        return torch.cat(qs, dim=1), torch.stack(drafts, dim=1)

    def _spec_server(self, hh, pos):
        """The round's server stage: verify the k+1 rows of ``hh`` from
        the round start ``pos`` through blocks ``[p, L)`` -> the verified
        greedy tokens g (B, k+1) int32."""
        logits, self.srv_caches = self.backend.verify_segment(
            hh, self.srv_caches, pos, self.p, self.L)
        return torch.argmax(logits, -1).to(torch.int32)

    @staticmethod
    def _round_ids(drafts, g):
        """The round's drafts (B, k) and verified tokens (B, k+1) on the
        host, in one copy off the card (before a replay overwrites
        them)."""
        k = drafts.shape[1]
        ids = torch.cat([drafts, g], dim=1).cpu().numpy()
        return ids[:, :k], ids[:, k:]

    def _spec_round(self, token, k: int) -> List[np.ndarray]:
        """One speculative round: draft ``k`` tokens through the device
        segment + draft head, verify all of them in ONE server call, emit
        the longest matching greedy prefix + the server's next token
        (1..k+1 tokens) — bitwise plain greedy decode.

        Draft head: argmax over ``hidden_logits`` of the QUANTIZED cut
        hidden under the device weights — the deployed segment at its
        planned bit-widths is the draft model (at p == L the full model,
        so acceptance is exactly 1). No cache rollback on rejection: every
        slot past the acceptance point is rewritten by a later round
        before any query attends it (slot == position).

        Both stages run from the device position, through the backend's
        graphs of their key (k among it) when graphed."""
        self._check_stream()
        P = self.pos
        t0 = time.perf_counter()
        cur = to_device(token, self.device, torch.int32).reshape(-1, 1)
        self._set_pos(P)
        dev_pos = (self._dev_slot or self._srv_slot).pos
        hh, drafts = self._stage(
            "spec_device", lambda c: self._spec_device(c, k, dev_pos),
            cur, k + 1)
        _fence(hh)
        if self.paged_kv is not None:
            self.paged_kv.ingest_range(self.dev_caches, P, P + k + 1)
        t1 = time.perf_counter()
        srv_pos = self._srv_slot.pos
        g = self._stage("spec_server",
                        lambda h: self._spec_server(h, srv_pos), hh, k + 1)
        d_np, g = self._round_ids(drafts, g)
        t2 = time.perf_counter()
        # acceptance = longest prefix where every batch row's draft
        # matches the verified greedy token (min over rows keeps all rows
        # on their true greedy trajectory)
        a = k
        for i in range(k):
            if not np.array_equal(d_np[:, i], g[:, i]):
                a = i
                break
        if self.p > 0:
            self.t_device_s += t1 - t0
        else:
            self.t_server_s += t1 - t0
        self.t_server_s += t2 - t1
        self.drafts_proposed += k
        self.drafts_accepted += a
        self.pos = P + a + 1
        return [g[:, i] for i in range(a + 1)]

    # -- drivers ----------------------------------------------------------
    def round_stream(self, prompt, max_new_tokens: int):
        """Generator of per-round token lists: the first yield is the
        prefill's ``[token0]``; each later yield is one decode round's
        emissions — ``[token]`` for plain greedy, 1..k+1 tokens for a
        speculative round. ``self.rounds`` counts the decode rounds. The
        stream's cache slots go back to the backend's pool when the
        generator ends or is closed."""
        try:
            token = self.prefill(prompt)
            yield [token.cpu().numpy()]
            emitted = 1
            while emitted < max_new_tokens:
                remaining = max_new_tokens - emitted
                k = min(self.draft_tokens, remaining - 1,
                        self.max_len - 1 - self.pos)
                if k >= 1:
                    out = self._spec_round(token, k)
                    token = out[-1]
                else:
                    token = self.step(token)
                    out = [token.cpu().numpy()]
                self.rounds += 1
                emitted += len(out)
                yield out
        finally:
            release_slots(self.backend, self._held)

    def stream(self, prompt, max_new_tokens: int):
        """Generator of (step_index, token (B,) np.ndarray) — token 0 is
        the prefill's (TTFT). A speculative round's tokens are yielded
        one by one (they become available together)."""
        i = 0
        for out in self.round_stream(prompt, max_new_tokens):
            for tok in out:
                yield i, tok
                i += 1

    def generate(self, prompt, max_new_tokens: int,
                 stream_cb=None) -> GenerationResult:
        if max_new_tokens < 1:
            raise ServingError("max_new_tokens must be >= 1")
        toks: List[np.ndarray] = []
        per_token: List[float] = []
        t_start = time.perf_counter()
        ttft = None
        last = t_start
        i = 0
        for out in self.round_stream(prompt, max_new_tokens):
            now = time.perf_counter()
            if ttft is None:
                ttft = now - t_start
            else:
                # spread the round's wall seconds over its emissions
                per_token.extend([(now - last) / len(out)] * len(out))
            last = now
            for tok in out:
                toks.append(tok)
                if stream_cb is not None:
                    stream_cb(i, tok)
                i += 1
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
            rounds=self.rounds,
            draft_tokens=self.draft_tokens,
            drafts_proposed=self.drafts_proposed,
            drafts_accepted=self.drafts_accepted,
            prefill_chunks=self.prefill_chunks)
