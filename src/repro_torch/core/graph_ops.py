"""Shared graph primitives: fixed-capacity adjacency tables, reverse-edge
construction and the sorted-pool merge/dedup that stands in for the paper's
insertion-sorted candidate lists; and the GNN's message-passing primitives
(``scatter_sum``, ``scatter_max``, ``scatter_mean``,
``degree_normalized_adjacency_apply``, ``take_rows``).

Tie order: ``jax.lax.top_k`` and JAX's sorts keep the lower index first
among equal keys, ``torch.topk`` does not. Every ordering here is a stable
``torch.sort`` (a lexicographic sort is several stable sorts, least
significant key first), so pools fill in exactly the reference's order.
"""
from __future__ import annotations

from typing import Optional

import torch

#: Sentinel padding id for fixed-capacity neighbour tables / pools.
INVALID = -1
#: Padding distance (float32 3e38): anything real beats it in a min-merge.
INF = 3.0e38


def stable_argsort(x: torch.Tensor, dim: int = -1, descending: bool = False) -> torch.Tensor:
    return torch.sort(x, dim=dim, descending=descending, stable=True).indices


def smallest_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k smallest entries per row, ascending, ties
    to the lower index: ``-lax.top_k(-x, k)``."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


#: rows a block that ``largest_k`` sorts in full when its k-th value ties
#: past the cut: (64, 1M) f32 values and int64 indices take 768 MB
TIE_SORT_ROWS = 64


def largest_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row of a 2-D
    ``x``, descending, ties to the lower index: ``lax.top_k(x, k)``.

    Without a full sort of every row: ``torch.topk`` takes k + 1. Where the
    (k+1)-th value is below the k-th, the k chosen are the only candidates
    and only their order is repaired (index, then a stable sort by value).
    Rows where the k-th value ties past the cut are sorted in full
    (stably, ``TIE_SORT_ROWS`` at a time). That takes one synchronisation
    on the card. On meta tensors (the dry run) it returns ``torch.topk``'s
    shapes without the repair."""
    n = x.shape[1]
    if k >= n:
        return torch.sort(x, dim=1, descending=True, stable=True)
    if x.is_meta:  # shapes only: a meta tensor has no ties to read
        return torch.topk(x, k, dim=1)
    vals, idx = torch.topk(x, k + 1, dim=1)
    tied = (vals[:, k] == vals[:, k - 1]).nonzero()[:, 0]
    vals, idx = vals[:, :k], idx[:, :k]
    for r0 in range(0, tied.numel(), TIE_SORT_ROWS):
        rows = tied[r0:r0 + TIE_SORT_ROWS]
        sv, si = torch.sort(x[rows], dim=1, descending=True, stable=True)
        vals[rows], idx[rows] = sv[:, :k], si[:, :k]
    order = idx.argsort(dim=1)  # indices are distinct: any sort is stable
    vals, idx = vals.gather(1, order), idx.gather(1, order)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    return vals.gather(1, order), idx.gather(1, order)


def lexsort(keys: list[torch.Tensor]) -> torch.Tensor:
    """``jnp.lexsort(keys, axis=-1)``: the last key is primary; remaining
    ties keep their original order."""
    order = stable_argsort(keys[0])
    for key in keys[1:]:
        order = order.gather(-1, stable_argsort(key.gather(-1, order)))
    return order


def in_degrees(neighbors: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """In-degree of every node given an (N, Γ) adjacency table (-1 = pad)."""
    flat = neighbors.reshape(-1)
    valid = flat >= 0
    deg = torch.zeros(n_nodes, dtype=torch.int32, device=neighbors.device)
    return deg.scatter_add_(0, flat.clamp_min(0).long(), valid.to(torch.int32))


def reverse_neighbors(neighbors: torch.Tensor, n_nodes: int, capacity: int) -> torch.Tensor:
    """Fixed-capacity reverse adjacency: (N, capacity) table of sources.

    For every directed edge i→j, register i in j's reverse list. Slots are
    assigned by sorting edges (stably) by destination and ranking within
    each segment; overflow beyond ``capacity`` is dropped.
    """
    n, gamma = neighbors.shape
    dev = neighbors.device
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(gamma)
    dst = neighbors.reshape(-1)
    key = torch.where(dst >= 0, dst, torch.full_like(dst, n))
    key_s, order = torch.sort(key, stable=True)
    src_s = src[order]
    pos = torch.arange(key_s.shape[0], device=dev)
    first = torch.ones_like(key_s, dtype=torch.bool)
    first[1:] = key_s[1:] != key_s[:-1]
    seg_start = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)), 0).values
    rank = pos - seg_start
    keep = (rank < capacity) & (key_s < n)
    # dropped edges land in a spare row n that is cut off below
    table = torch.full((n + 1, capacity), INVALID, dtype=torch.int32, device=dev)
    table[
        torch.where(keep, key_s, n).long(),
        torch.where(keep, rank, torch.zeros_like(rank)),
    ] = src_s
    return table[:n]


def mask_duplicate_ids(ids: torch.Tensor, dists: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Within each row, keep the best entry per id; duplicates → (INVALID, INF).
    Rows come back sorted by (id asc, dist asc)."""
    order = lexsort([dists, ids])
    ids_s, dists_s = ids.gather(-1, order), dists.gather(-1, order)
    dup = torch.zeros_like(ids_s, dtype=torch.bool)
    dup[..., 1:] = ids_s[..., 1:] == ids_s[..., :-1]
    dup |= ids_s < 0
    return (
        ids_s.masked_fill(dup, INVALID),
        dists_s.masked_fill(dup, INF),
    )


def merge_pools(
    pool_ids: torch.Tensor,
    pool_dists: torch.Tensor,
    cand_ids: torch.Tensor,
    cand_dists: torch.Tensor,
    capacity: int,
    pool_flags: Optional[torch.Tensor] = None,
    cand_flags: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Merge candidates into a sorted fixed-capacity pool (per row).

    Concatenate, dedup by id keeping the checked copy of a duplicate (flags
    dominate: a checked node must not be re-expanded) and otherwise the
    closest, then take the ``capacity`` smallest. Returns pools sorted
    ascending by distance.
    """
    ids = torch.cat([pool_ids, cand_ids], dim=-1)
    dists = torch.cat([pool_dists, cand_dists], dim=-1)
    flags = None
    if pool_flags is not None:
        if cand_flags is None:
            cand_flags = torch.zeros_like(cand_ids, dtype=pool_flags.dtype)
        flags = torch.cat([pool_flags, cand_flags], dim=-1)
        order = lexsort([dists, -flags.to(torch.int32), ids])
    else:
        order = lexsort([dists, ids])
    ids_s, dists_s = ids.gather(-1, order), dists.gather(-1, order)
    kill = torch.zeros_like(ids_s, dtype=torch.bool)
    kill[..., 1:] = ids_s[..., 1:] == ids_s[..., :-1]
    kill |= ids_s < 0
    ids_s = ids_s.masked_fill(kill, INVALID)
    dists_s = dists_s.masked_fill(kill, INF)
    new_dists, take = smallest_k(dists_s, capacity)
    new_ids = ids_s.gather(-1, take)
    if flags is None:
        return new_ids, new_dists, None
    flags_s = flags.gather(-1, order).masked_fill(kill, 0)
    return new_ids, new_dists, flags_s.gather(-1, take)


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows of ``table`` at ``ids`` (INVALID-safe: pad rows → row 0)."""
    return table[ids.clamp_min(0).long()]


# ---------------------------------------------------------------------------
# Message-passing primitives shared with models/gnn.py
# ---------------------------------------------------------------------------


def take_rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``x[ids]`` with ``jnp`` indexing's rules: a negative id counts from
    the end, and an id still outside [0, n) is clamped into it."""
    n = x.shape[0]
    ids = torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)
    return x[ids.long()]


def _segments(dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Each edge's row among ``n_nodes`` + 1: its destination, or the spare
    row ``n_nodes`` for an id outside [0, n_nodes) (``segment_sum`` drops
    those, −1 included)."""
    valid = (dst >= 0) & (dst < n_nodes)
    return torch.where(valid, dst, n_nodes).long()


def scatter_sum(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Σ of per-edge messages (E, ...) into destination nodes (GNN
    aggregation): (n_nodes, ...) in ``dtype`` (default the messages'). Ids
    outside [0, n_nodes) are dropped. Each node's sum is formed in f32 and
    rounded once to that dtype (the reference on the CPU adds bf16
    messages one at a time in bf16; see ROADMAP.md)."""
    out = messages.new_zeros((n_nodes + 1, *messages.shape[1:]), dtype=torch.float32)
    out = out.index_add(0, _segments(dst, n_nodes), messages.float())
    return out[:n_nodes].to(dtype or messages.dtype)


def scatter_max(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Elementwise max of per-edge messages into destination nodes: a node
    no message reaches is −inf (the lowest integer for integer messages),
    as ``segment_max``; ids outside [0, n_nodes) are dropped. Tied maxima
    share the gradient equally, as in the reference."""
    dt = messages.dtype
    lowest = float("-inf") if dt.is_floating_point else torch.iinfo(dt).min
    out = messages.new_full((n_nodes + 1, *messages.shape[1:]), lowest)
    out = out.index_reduce(0, _segments(dst, n_nodes), messages, "amax", include_self=True)
    return out[:n_nodes]


def segment_count(dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """(n_nodes,) f32 number of edges into each node (ids outside
    [0, n_nodes) dropped)."""
    ones = torch.ones(dst.shape[0], dtype=torch.float32, device=dst.device)
    return scatter_sum(ones, dst, n_nodes)


def scatter_mean(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """``scatter_sum`` over each node's in-degree (at least 1): a bf16 sum
    over the f32 count promotes to f32, as in the reference."""
    return scatter_sum(messages, dst, n_nodes) / segment_count(dst, n_nodes).clamp_min(1.0)[:, None]


def degree_normalized_adjacency_apply(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                                      n_nodes: int) -> torch.Tensor:
    """GCN-style Â·X via gather → scale → scatter (no sparse matrices):
    each edge's ``x[src]`` times rsqrt(deg(src)·deg(dst)), degrees the
    in-degrees clamped to 1, summed into ``dst``."""
    inv_sqrt = torch.rsqrt(segment_count(dst, n_nodes).clamp_min(1.0))
    msgs = take_rows(x, src) * (take_rows(inv_sqrt, src) * take_rows(inv_sqrt, dst))[:, None]
    return scatter_sum(msgs, dst, n_nodes)
