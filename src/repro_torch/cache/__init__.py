"""Serve-layer result caching.

* ``ResultCache`` — (tenant, query, params)-keyed LRU+TTL top-k cache,
  write-invalidated through the engine ``write_epoch``;
* ``result_key`` — the content signature it is keyed by.

The reference's frequency-aware tiering (``FrequencyTracker``, ``HotTier``,
``TieredEngine``) is not ported yet: it waits for ROADMAP queue 1, item 9.
"""
from repro_torch.cache.results import ResultCache, result_key

__all__ = ["ResultCache", "result_key"]
