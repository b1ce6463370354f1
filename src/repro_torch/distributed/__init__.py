"""Sharded hybrid search over a local (data, model) mesh: the public names
of the reference's ``distributed/search.py``."""
from repro_torch.distributed.search import (
    CACHE_SIZE, SHARDED_FORMAT, SHARDED_META, ShardedStableIndex, is_sharded_dir,
    sharded_index_from_numpy,
)

__all__ = [
    "CACHE_SIZE",
    "SHARDED_FORMAT",
    "SHARDED_META",
    "ShardedStableIndex",
    "is_sharded_dir",
    "sharded_index_from_numpy",
]
