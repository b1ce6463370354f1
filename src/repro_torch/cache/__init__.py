"""Frequency-aware hot/cold tiering + serve-layer result caching.

Zipfian serving traffic concentrates row accesses and repeats whole
queries; this package exploits both ends:

* ``FrequencyTracker``: decayed EWMA per-row access counters fed from the
  (already host-side) result ids of every search;
* ``HotTier``: the top-frequency rows under a ``hot_rows`` budget kept
  full-precision and contiguous on the device; the rerank gather routes
  hot candidates to a device ``index_select`` and cold candidates to the
  host store, bit-identically;
* ``TieredEngine``: the engine wrapper wiring tracker → epoched
  promotion/demotion (hysteresis) → tiered rerank, with partition-granular
  pinning (``SegmentStore.pin``) on out-of-core engines;
* ``ResultCache``: (tenant, query, params)-keyed LRU+TTL top-k cache,
  write-invalidated through the engine ``write_epoch``.
"""
from repro_torch.cache.engine import TieredEngine
from repro_torch.cache.freq import FrequencyTracker
from repro_torch.cache.results import ResultCache, result_key
from repro_torch.cache.tier import HotTier

__all__ = [
    "FrequencyTracker",
    "HotTier",
    "ResultCache",
    "TieredEngine",
    "result_key",
]
