"""Autoregressive decode serving: the prefill→decode pipeline partitioned
at the QPART cut point.

  * ``cache``    — cache dtype ladder + device-segment footprint math
  * ``pipeline`` — ``DecodeSession`` / ``GenerationResult``
"""
from repro_torch.serving.decode.cache import (kv_cache_dtype,
                                              segment_cache_bytes,
                                              tree_cache_bytes)
from repro_torch.serving.decode.pipeline import (DecodeSession,
                                                 GenerationResult)

__all__ = ["DecodeSession", "GenerationResult", "kv_cache_dtype",
           "segment_cache_bytes", "tree_cache_bytes"]
