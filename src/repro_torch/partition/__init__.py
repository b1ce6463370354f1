"""Out-of-core scale: IVF coarse partitions over HELP subgraphs.

* ``kmeans``: mini-batch k-means coarse quantizer (trained on the device)
* ``index``: ``PartitionedStableIndex``: per-partition subgraphs, codes,
  attribute summaries, save/load (one subdirectory per partition, mmap'd)
* ``store``: ``SegmentStore``: LRU streaming residency under a row cap
* ``search``: ``PartitionedSearcher`` (registered by ``api.Engine`` on
  first use, as the reference does; not imported here, which keeps this
  package import-light)
"""
from repro_torch.partition.kmeans import CoarseQuantizer, assign_partitions, train_coarse
from repro_torch.partition.index import (
    PARTITIONED_FORMAT,
    PartitionSummaries,
    PartitionedStableIndex,
    is_partitioned_dir,
)
from repro_torch.partition.store import (
    PartitionData,
    ResidentPartition,
    SegmentStore,
    row_bucket,
)

__all__ = [
    "PARTITIONED_FORMAT",
    "CoarseQuantizer",
    "PartitionData",
    "PartitionSummaries",
    "PartitionedStableIndex",
    "ResidentPartition",
    "SegmentStore",
    "assign_partitions",
    "is_partitioned_dir",
    "row_bucket",
    "train_coarse",
]
