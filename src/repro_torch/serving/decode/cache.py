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

The paged allocator (``KVPagePool``, ``PagedKVCache``, ``PageLedger``)
is not ported yet; ``paged_kv_ctx`` is, because admission pricing uses
it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ATTN
from repro_torch.models.transformer import num_periods, period_len
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
