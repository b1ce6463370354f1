"""Streaming mutability: LSM-style writes without rebuild.

The frozen ``StableIndex`` stays immutable; writes land in an append-only
``DeltaSegment`` (served by an exact ``fused_auto`` scan on the engine's
device), deletes and overwrites mask main rows through a tombstone set, and
a background merge folds the delta into the main index by linking the new
rows into the HELP graph (``help_graph.link_nodes``): no full rebuild,
logical ids stable forever.

  upsert/delete ─▶ oplog ─▶ DeltaSegment + tombstones
                     │           │
                     │     every query: main (graph/brute, tombstone-
                     │     filtered) ⊕ delta (exact scan) → merged top-k
                     ▼
        CompactionPolicy fires ─▶ merge_prepare (off-lock: apply_rows +
        link_nodes + code extension) ─▶ merge_apply (fast swap + replay)

* ``MutableEngine`` — the write-capable engine facade (duck-types
  ``api.Engine`` for the serving stack).
* ``DeltaSegment`` — capacity-doubling mutable rows + latest-row map.
* ``CompactionPolicy`` — size + predicted query-cost-regression trigger.
* ``merge_prepare`` / ``merge_apply`` — the split background merge.
* ``WriteAheadLog`` — on-disk oplog twin in the reference's
  ``stable-wal-v1`` format: log-before-apply durability, replay on restart,
  checkpoint-time reset (``MutableEngine(wal_path=...)``).
"""
from repro_torch.mutable.delta import DeltaSegment
from repro_torch.mutable.engine import CompactionPolicy, MutableEngine, WriteOp
from repro_torch.mutable.merge import PreparedMerge, merge_apply, merge_prepare
from repro_torch.mutable.wal import WriteAheadLog

__all__ = [
    "CompactionPolicy",
    "DeltaSegment",
    "MutableEngine",
    "PreparedMerge",
    "WriteAheadLog",
    "WriteOp",
    "merge_apply",
    "merge_prepare",
]
