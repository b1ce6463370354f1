"""Background merge: fold the delta into the main index, no full rebuild.

The merge is split so the expensive half never blocks serving:

* ``merge_prepare`` — runs WITHOUT the engine lock, while writes and reads
  go on. It snapshots a prefix of the append-only oplog (the source of
  truth; prepare never reads the mutable delta arrays), replays it into a
  last-write-wins view, materializes those rows into a *new*
  ``StableIndex`` via ``StableIndex.apply_rows`` (new tensors: the old
  index keeps serving), and links every alive upserted row into the HELP
  graph with ``help_graph.link_nodes`` (routed candidate search, one-hop
  expansion, new↔new pairs, mutual-neighbour repair). SQ8/PQ codes are
  extended with the frozen codec state inside ``apply_rows``.
* ``merge_apply`` — takes the lock for a fast swap: the engine's index
  reference flips to the prepared one, caches invalidate
  (``Engine.invalidate_caches``), tombstones become the prepared
  post-merge set, a fresh delta replaces the old one, and any ops logged
  *after* the snapshot replay onto the fresh state, so writes that raced
  the prepare are never lost.

Logical ids are stable forever: a deleted id's row survives in the merged
tensors as a *zombie* (materialized with its last-written values so it can
never rank as garbage) behind a persistent tombstone, and ``link_nodes``
never links to it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Optional, Set

import numpy as np

from repro_torch.core import help_graph as help_mod
from repro_torch.mutable.delta import DeltaSegment

if TYPE_CHECKING:
    from repro_torch.mutable.engine import MutableEngine

__all__ = ["PreparedMerge", "merge_apply", "merge_prepare"]


@dataclasses.dataclass
class PreparedMerge:
    """Everything ``merge_apply`` needs for the fast swap."""

    index: object  # the new, fully linked StableIndex
    tombstones: Set[int]  # post-merge persistent tombstones (deleted ids)
    upto: int  # oplog prefix length this merge covers
    linked: int  # delta nodes (re-)linked into the HELP graph
    repaired: int  # existing rows that absorbed reverse edges
    prepare_ms: float


def merge_prepare(m: "MutableEngine") -> Optional[PreparedMerge]:
    """Build the merged index off the serving path. Safe against concurrent
    writes: it reads only the oplog prefix (append-only, ops are immutable)
    and the old index's tensors, which nothing writes."""
    t0 = time.perf_counter()
    upto = len(m.oplog)
    if upto == 0:
        return None
    ops = list(m.oplog[:upto])
    tomb0 = set(m.tombstones)  # ⊇ the state at `upto`; extra entries come
    # only from ops after `upto`, which replay

    data: dict = {}  # id → (vector, attrs) of its last upsert
    alive: dict = {}  # id → visible after the last op in the window
    for op in ops:
        if op.kind == "upsert":
            data[op.id] = (op.vector, op.attrs)
            alive[op.id] = True
        else:
            alive[op.id] = False

    old_index = m.engine.index
    n_main = int(old_index.features.shape[0])
    # every id with known values is materialized, deleted ones included, as
    # zombies: real (stale) values behind a tombstone can never rank
    write_ids = np.asarray(sorted(data), np.int64)
    if write_ids.size:
        feats = np.stack([data[i][0] for i in write_ids])
        attrs = np.stack([data[i][1] for i in write_ids])
        new_index = old_index.apply_rows(write_ids, feats, attrs)
    else:  # a delete-only window: nothing to materialize or link
        new_index = old_index
    n_new = int(new_index.features.shape[0])

    # persistent tombstones: ids deleted in this window, ids already
    # tombstoned that no upsert here revived, and gap rows a sparse id left
    # zero-initialized
    tombstones = {i for i, a in alive.items() if not a}
    tombstones |= {t for t in tomb0 if not alive.get(t, False)}
    tombstones |= set(range(n_main, n_new)) - set(int(i) for i in write_ids)

    link_ids = np.asarray(sorted(i for i, a in alive.items() if a), np.int64)
    linked = repaired = 0
    if link_ids.size and int(new_index.graph.shape[1]) > 0:
        banned = np.asarray(sorted(tombstones), np.int64) if tombstones else None
        graph, repaired = help_mod.link_nodes(
            new_index.features, new_index.attrs, new_index.graph,
            link_ids, new_index.metric_cfg, new_index.help_cfg,
            banned_ids=banned, seed=new_index.help_cfg.seed,
        )
        new_index = dataclasses.replace(new_index, graph=graph)
        linked = int(link_ids.size)
    return PreparedMerge(
        index=new_index, tombstones=tombstones, upto=upto,
        linked=linked, repaired=int(repaired),
        prepare_ms=(time.perf_counter() - t0) * 1e3,
    )


def merge_apply(m: "MutableEngine", prepared: PreparedMerge) -> dict:
    """Swap the prepared index in under the lock (fast: reference flips,
    cache clears and a replay of the oplog tail after the snapshot) and
    reset the delta. Returns merge stats for ``ServerStats.record_merge``."""
    t0 = time.perf_counter()
    with m._lock:
        tail = list(m.oplog[prepared.upto:])
        m.engine.index = prepared.index
        m.engine.invalidate_caches()
        m.tombstones = set(prepared.tombstones)
        m.delta = DeltaSegment(m.feat_dim, m.attr_dim, device=m.device)
        m.oplog = []
        for op in tail:  # writes that raced the prepare re-apply into the
            # fresh delta (log=False: they are already in the WAL; only the
            # in-memory oplog was cleared)
            m._apply_op(op, log=False)
        m.merge_count += 1
        stats = {
            "merged_ops": prepared.upto,
            "replayed_ops": len(tail),
            "linked": prepared.linked,
            "repaired": prepared.repaired,
            "n_main": int(prepared.index.features.shape[0]),
            "tombstones": len(m.tombstones),
            "prepare_ms": round(prepared.prepare_ms, 3),
            "apply_ms": round((time.perf_counter() - t0) * 1e3, 3),
        }
    return stats
