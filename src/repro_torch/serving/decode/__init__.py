"""Autoregressive decode serving: the prefill→decode pipeline partitioned
at the QPART cut point.

  * ``cache``    — cache dtype ladder, footprint math, paged KV
  * ``pipeline`` — ``DecodeSession`` / ``GenerationResult``
  * ``batching`` — ``DecodeBatcher``: the fleet engine's per-server
                   continuous-batching state for concurrent streams
"""
from repro_torch.serving.decode.batching import DecodeBatcher, DecodeStream
from repro_torch.serving.decode.cache import (kv_cache_dtype,
                                              segment_cache_bytes,
                                              tree_cache_bytes)
from repro_torch.serving.decode.pipeline import (DecodeSession,
                                                 GenerationResult)

__all__ = [
    "DecodeBatcher", "DecodeStream", "DecodeSession", "GenerationResult",
    "kv_cache_dtype", "segment_cache_bytes", "tree_cache_bytes",
]
