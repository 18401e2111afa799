"""KV-cache dtype plumbing for the partitioned decode pipeline.

The cut splits cache OWNERSHIP: the device holds the caches of its
quantized segment ``[0, p)``, the server the tail's ``[p, L)``. Each side
allocates a full stacked ``transformer.init_cache`` tree but writes only
its own segment's slices; the footprint accounting below counts only
those.

A quantized device segment stores its cache at the deployed bit-width's
storage dtype: ≤8-bit plans get ``float8_e4m3fn`` (1 B/elem — storage
only; attention computes in the query dtype, and every write goes
through ``models.common.to_storage``, the reference's cast), ≤16-bit
plans bf16, full-precision plans the model dtype.

Block-granular (paged) KV: ``KVPagePool`` hands out fixed pages of
``page_tokens`` ring slots, ``PagedKVCache`` maps each (layer, batch
row)'s ring blocks to pages, ``PageLedger`` is the fleet's
pricing-only residency twin. The segment functions keep their DENSE
cache operands; the paged structure is the allocator and residency
ledger the serving layer runs against, and ``to_dense`` rebuilds the
dense ring bit for bit. Unlike the reference, whose pool is a host
array filled by a device-to-host copy of every written slot, the pool
here is a tensor on the cache's device and every write is a device copy
of the same bits (through same-width integer views, so float8 needs no
indexing support of its own).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ATTN
from repro_torch.models.common import as_bits
from repro_torch.models.transformer import num_periods, period_len
from repro_torch.serving.errors import ServingError
from repro_torch.tree import tree_leaves

DEFAULT_PAGE_TOKENS = 16


def kv_cache_dtype(bits, model_dtype=torch.bfloat16):
    """Storage dtype of a decode cache deployed at ``bits`` activation
    bits. ``None``/0 bits means full precision (the server tail)."""
    if not bits:
        return model_dtype
    b = int(math.ceil(float(bits)))
    if b <= 8:
        return torch.float8_e4m3fn
    if b <= 16:
        return torch.bfloat16
    return model_dtype


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def tree_cache_bytes(caches) -> int:
    """Total allocated bytes of an ``init_cache`` tree (all layers)."""
    return int(sum(_nbytes(leaf) for leaf in tree_leaves(caches)))


def segment_cache_bytes(cfg, caches, start: int, stop: int) -> int:
    """Bytes of the cache slices owned by segment ``[start, stop)`` of a
    stacked ``init_cache`` tree (layer l is one of ``nper`` equal slices
    of period position ``l % plen``'s leaves)."""
    plen, nper = period_len(cfg), num_periods(cfg)
    return sum(_nbytes(leaf) // nper for layer in range(start, stop)
               for leaf in tree_leaves(caches[layer % plen]))


def segment_nonattn_cache_bytes(cfg, caches, start: int, stop: int) -> int:
    """``segment_cache_bytes`` restricted to the NON-attention layers of
    the segment (SSM state, O(1) in context)."""
    plen, nper = period_len(cfg), num_periods(cfg)
    return sum(_nbytes(leaf) // nper for layer in range(start, stop)
               if cfg.block_kind(layer % plen) != ATTN
               for leaf in tree_leaves(caches[layer % plen]))


def paged_kv_ctx(tokens: int, page_tokens: int, max_len: int) -> int:
    """Context length a ``tokens``-token stream is PRICED at under paged
    allocation: rounded up to the page boundary, capped by the dense
    worst case."""
    if page_tokens <= 0:
        return max_len
    pages = -(-int(tokens) // int(page_tokens))
    return min(pages * int(page_tokens), int(max_len))


class KVPagePool:
    """Fixed pool of KV pages for one cache geometry. A page holds
    ``page_tokens`` ring slots of ONE (layer, batch-row) pair — both K
    and V — at the segment's storage dtype: (2, page_tokens, kvp, hd),
    on ``device``. Allocation is O(1) (free list); exhaustion raises
    ``ServingError`` (the serving layer sizes pools from the same
    admission math that priced the streams)."""

    def __init__(self, num_pages: int, page_tokens: int, kvp: int, hd: int,
                 dtype=torch.bfloat16, device="cuda"):
        self.page_tokens = int(page_tokens)
        self.kvp, self.hd = int(kvp), int(hd)
        self.dtype = dtype
        self.data = torch.zeros((num_pages, 2, self.page_tokens, kvp, hd),
                                dtype=dtype, device=device)
        self._free = list(range(num_pages - 1, -1, -1))
        self.num_pages = int(num_pages)

    @property
    def page_bytes(self) -> int:
        return self.data[0].numel() * self.data.element_size()

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def used_bytes(self) -> int:
        return self.used_pages * self.page_bytes

    def alloc(self) -> int:
        if not self._free:
            raise ServingError(
                f"KV page pool exhausted ({self.num_pages} pages of "
                f"{self.page_tokens} tokens)")
        page = self._free.pop()
        self.data[page].zero_()
        return page

    def release(self, page: int) -> None:
        self._free.append(int(page))


class PagedKVCache:
    """Per-stream block tables over a ``KVPagePool`` for the ATTENTION
    layers of segment ``[start, stop)``.

    Ring slot ``pos % buf`` lives at offset ``slot % page_tokens`` of the
    page mapped by block ``slot // page_tokens``; a block's page is
    allocated on first write and held until the stream severs (ring
    reuse overwrites in place, so the page set saturates at
    ``ceil(buf / page_tokens)`` per (layer, batch-row)).

    ``ingest_prefill`` / ``ingest_range`` / ``append_step`` copy written
    slots out of the dense cache tree the segment functions run on — one
    indexed device copy per layer for K and one for V; ``to_dense``
    rebuilds the dense ring bit for bit."""

    def __init__(self, pool: KVPagePool, cfg, start: int, stop: int,
                 batch: int, max_len: int):
        self.pool = pool
        self.cfg = cfg
        self.start, self.stop = int(start), int(stop)
        self.batch = int(batch)
        plen = period_len(cfg)
        self.buf = int(min(max_len, cfg.sliding_window)
                       if cfg.sliding_window else max_len)
        # attention layers owned by the segment: layer -> (pos, per)
        self.attn_layers = {
            l: (l % plen, l // plen) for l in range(self.start, self.stop)
            if cfg.block_kind(l % plen) == ATTN}
        # (layer, batch_row) -> {block -> page id}
        self.tables: Dict[Tuple[int, int], Dict[int, int]] = {
            (l, b): {} for l in self.attn_layers for b in range(batch)}
        self.length = 0                     # absolute positions ingested

    # -- allocation ------------------------------------------------------
    def _page_for(self, layer: int, b: int, block: int) -> int:
        table = self.tables[(layer, b)]
        page = table.get(block)
        if page is None:
            page = table[block] = self.pool.alloc()
        return page

    def _write_slots(self, caches, slots) -> None:
        """Copy ring ``slots`` of every owned attention layer from the
        dense tree into their pages (allocating on first touch): one
        gather and one indexed write per period position for K and for
        V, over all of its owned layers at once."""
        t = self.pool.page_tokens
        dev = self.pool.data.device
        raw = as_bits(self.pool.data)
        src = torch.tensor(slots, device=dev)
        offs = torch.tensor([s % t for s in slots], device=dev)
        by_pos: Dict[int, list] = {}
        for layer, (p_pos, per) in self.attn_layers.items():
            by_pos.setdefault(p_pos, []).append((layer, per))
        for p_pos, owned in by_pos.items():
            pers = torch.tensor([per for _, per in owned], device=dev)
            pages = torch.tensor(
                [[[self._page_for(layer, b, s // t) for s in slots]
                  for b in range(self.batch)] for layer, _ in owned],
                device=dev)                         # (layers, B, n)
            for i, name in enumerate(("k", "v")):
                rows = as_bits(caches[p_pos][name])[pers][:, :, src]
                raw[pages, i, offs] = rows

    # -- ingest from the dense cache tree --------------------------------
    def append_step(self, caches, pos: int) -> None:
        """Copy the decode step's written ring slot (``pos % buf``) of
        every owned attention layer out of the dense cache tree."""
        self._write_slots(caches, [int(pos) % self.buf])
        self.length = max(self.length, int(pos) + 1)

    def ingest_range(self, caches, lo: int, hi: int) -> None:
        """Copy positions ``[lo, hi)`` of the dense ring into pages —
        chunked prefill calls this once per admitted chunk, so the paged
        footprint grows with the admitted prefix."""
        lo, hi = int(lo), int(hi)
        if hi <= lo:
            return
        self._write_slots(caches, [p % self.buf for p in range(lo, hi)])
        self.length = max(self.length, hi)

    def ingest_prefill(self, caches, seq_len: int) -> None:
        """Copy every live ring slot after a ``seq_len``-token prefill
        (positions ``max(0, seq_len - buf) .. seq_len - 1``)."""
        self.ingest_range(caches, max(0, int(seq_len) - self.buf), seq_len)

    # -- views -----------------------------------------------------------
    def to_dense(self, template_caches):
        """Rebuild the stacked dense cache tree from the pages: owned
        attention slices are reconstructed (unwritten blocks as zeros —
        the dense init state); every other slice is copied from
        ``template_caches``. The bit-for-bit round-trip target of the
        tests."""
        t = self.pool.page_tokens
        nblk = -(-self.buf // t)
        raw = as_bits(self.pool.data)
        out = [{k: v.clone() for k, v in c.items()} for c in template_caches]
        for layer, (p_pos, per) in self.attn_layers.items():
            table = torch.tensor(
                [[self.tables[(layer, b)].get(blk, -1) for blk in range(nblk)]
                 for b in range(self.batch)], device=raw.device)
            held = (table >= 0)[:, :, None, None, None, None]
            pages = torch.where(held, raw[table.clamp(min=0)],
                                torch.zeros((), dtype=raw.dtype,
                                            device=raw.device))
            for i, name in enumerate(("k", "v")):
                dense = pages[:, :, i].reshape(
                    self.batch, nblk * t, self.pool.kvp,
                    self.pool.hd)[:, :self.buf]
                as_bits(out[p_pos][name])[per] = dense
        return out

    @property
    def held_pages(self) -> int:
        return sum(len(t) for t in self.tables.values())

    @property
    def resident_bytes(self) -> int:
        """Page-granular resident footprint of the owned attention
        caches — monotone in held pages by construction."""
        return self.held_pages * self.pool.page_bytes

    def free_all(self) -> int:
        """Sever: return every page to the pool. Returns the count."""
        n = 0
        for key, table in self.tables.items():
            for page in table.values():
                self.pool.release(page)
                n += 1
            self.tables[key] = {}
        return n


def segment_page_pool(cfg, start: int, stop: int, batch: int, max_len: int,
                      dtype=torch.bfloat16,
                      page_tokens: int = DEFAULT_PAGE_TOKENS,
                      streams: int = 1, device="cuda") -> KVPagePool:
    """A pool sized for ``streams`` concurrent worst-case streams of
    segment ``[start, stop)`` — the dense reservation expressed in
    pages, the upper bound paged allocation stays under."""
    hd = cfg.resolved_head_dim()
    kvp, _ = cfg.padded_heads()
    buf = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    plen = period_len(cfg)
    n_attn = sum(1 for l in range(start, stop)
                 if cfg.block_kind(l % plen) == ATTN)
    pages = -(-buf // page_tokens) * n_attn * batch * streams
    return KVPagePool(max(pages, 1), page_tokens, kvp, hd, dtype, device)


class PageLedger:
    """Pure residency accounting for the fleet engine's decode lane —
    the pricing-only twin of ``KVPagePool`` (no tensors move). Tracks
    per-stream page-granular device-KV bytes, the fleet-wide
    current/peak, and the no-leak invariant: after every stream finishes
    or severs, ``resident_bytes == 0`` and ``open_streams == 0``."""

    def __init__(self):
        self._held: Dict[int, float] = {}       # stream index -> bytes
        self._pages: Dict[int, int] = {}        # stream index -> pages
        self.resident_bytes = 0.0
        self.peak_bytes = 0.0
        self.total_page_allocs = 0
        self.total_page_frees = 0

    @property
    def open_streams(self) -> int:
        return len(self._held)

    @property
    def resident_pages(self) -> int:
        return sum(self._pages.values())

    def open(self, index: int, nbytes: float, pages: int) -> None:
        self.close(index)                       # idempotent re-open
        self._held[index] = float(nbytes)
        self._pages[index] = int(pages)
        self.resident_bytes += float(nbytes)
        self.total_page_allocs += int(pages)
        self.peak_bytes = max(self.peak_bytes, self.resident_bytes)

    def grow(self, index: int, nbytes: float, pages: int) -> None:
        """Raise stream ``index``'s residency to ``nbytes``/``pages``
        (monotone: paged KV never shrinks mid-stream)."""
        if index not in self._held:
            return
        d_bytes = max(0.0, float(nbytes) - self._held[index])
        d_pages = max(0, int(pages) - self._pages[index])
        self._held[index] += d_bytes
        self._pages[index] += d_pages
        self.resident_bytes += d_bytes
        self.total_page_allocs += d_pages
        self.peak_bytes = max(self.peak_bytes, self.resident_bytes)

    def close(self, index: int) -> int:
        """Finish/sever: release the stream's pages. Returns the count."""
        nbytes = self._held.pop(index, 0.0)
        pages = self._pages.pop(index, 0)
        self.resident_bytes -= nbytes
        if not self._held:
            self.resident_bytes = 0.0           # clamp fp residue at empty
        self.total_page_frees += pages
        return pages
