"""HELP index construction (paper §III-C, Alg. 1–2).

Bulk-synchronous NN-descent: every round, each node gathers a fixed-width
candidate set (neighbours of new neighbours ∪ reverse neighbours ∪
neighbours of reverse neighbours), scores it under the AUTO metric with the
``gather_auto`` kernel one node block at a time, and merges with a stable
sort. Convergence is monitored with the sampled graph quality ψ (Eq. 7)
against the brute-force AUTO ground truth (``fused_auto``), stopping at Ψ.

Heterogeneous Semantic Pruning (Alg. 2): per node the Γ×Γ edge-direction
cosine matrix comes from one batched product, and the sequential "Select"
scan is a loop over neighbour slots. The in-degree guard (protect nodes
whose in-degree is 1) and a post-prune orphan repair keep the graph
navigable. Blocks stay on the device; only the orphan repair runs on the
host, vectorised with numpy.

``link_nodes`` links new or rewritten rows into an existing adjacency
without a rebuild: the merge path of ``repro_torch.mutable``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import auto as auto_mod
from repro_torch.core import graph_ops as gops
from repro_torch.core import routing as routing_mod
from repro_torch.core.auto import MetricConfig
from repro_torch.core.graph_ops import INF, INVALID

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class HelpConfig:
    """Index-construction hyper-parameters (paper notation in comments)."""

    gamma: int = 32  # Γ: max neighbours per node
    gamma_new: int = 8  # Γ_new: expansion width per NN-descent round
    reverse_capacity: int = 8  # reverse-neighbour sample slots per node
    sigma: float = 0.44  # σ: cosine prune threshold (HSP)
    psi_target: float = 0.80  # Ψ: graph-quality stop threshold
    max_rounds: int = 15  # Ǐ: NN-descent round cap
    quality_sample: int = 256  # |S| in Eq. 7
    node_block: int = 2048  # rows processed per vectorised block
    prune: bool = True  # heterogeneous semantic prune on/off (ablation)
    reverse_insert: bool = True  # Alg. 2 lines 14-19 reverse densification
    seed: int = 0


@dataclasses.dataclass
class BuildReport:
    psi_history: list[float]
    rounds: int
    pruned_edge_fraction: float
    build_seconds: float = 0.0


def _blocks(n: int, block: int):
    for s in range(0, n, block):
        yield s, min(s + block, n)


def _score_candidates(
    features: Tensor,
    attrs: Tensor,
    node_ids: Tensor,  # (B,) int32
    cand_ids: Tensor,  # (B, C) int32
    cfg: MetricConfig,
) -> Tensor:
    """Fused sq-distances from each node to its candidate list; INVALID and
    self-edges → INF."""
    idx = node_ids.long()
    d = routing_mod._score_candidates(
        features, attrs, cand_ids.contiguous(), features[idx], attrs[idx], cfg, None
    )
    return d.masked_fill(cand_ids == node_ids[:, None], INF)


# ---------------------------------------------------------------------------
# One bulk-synchronous NN-descent round
# ---------------------------------------------------------------------------


def _descent_round(
    features: Tensor,
    attrs: Tensor,
    nbr_ids: Tensor,  # (N, Γ) sorted ascending by dist
    nbr_d: Tensor,  # (N, Γ)
    is_old: Tensor,  # (N, Γ) int8: 1 ⇒ already expanded in a previous round
    cfg: MetricConfig,
    help_cfg: HelpConfig,
) -> tuple[Tensor, Tensor, Tensor]:
    n, gamma = nbr_ids.shape
    g_new = help_cfg.gamma_new
    rev_cap = help_cfg.reverse_capacity
    dev = nbr_ids.device

    # --- expansion set: the Γ_new closest *new* neighbours of each node ----
    newness = (is_old == 0) & (nbr_ids >= 0)
    # prefer new entries, among them closer ones (rows are sorted by dist);
    # the scores are distinct, so the order is that of lax.top_k
    rank_score = newness.to(torch.int32) * (2 * gamma) - torch.arange(
        gamma, dtype=torch.int32, device=dev
    )
    sel_slots = gops.stable_argsort(rank_score, descending=True)[:, :g_new]
    sel_valid = newness.gather(1, sel_slots)
    sel_ids = nbr_ids.gather(1, sel_slots).masked_fill(~sel_valid, INVALID)
    is_old = is_old.scatter(
        1, sel_slots, torch.maximum(is_old.gather(1, sel_slots), sel_valid.to(torch.int8))
    )

    # --- candidate generation ------------------------------------------------
    # (a) neighbours of the selected new neighbours: (N, Γ_new·Γ)
    cand_a = gops.gather_rows(nbr_ids, sel_ids).reshape(n, g_new * gamma)
    cand_a = cand_a.masked_fill(
        (sel_ids < 0)[:, :, None].expand(n, g_new, gamma).reshape(n, -1), INVALID
    )
    # (b) reverse neighbours: (N, R)
    rev = gops.reverse_neighbors(nbr_ids, n, rev_cap)
    # (c) neighbours of reverse neighbours: (N, R·Γ)
    cand_c = gops.gather_rows(nbr_ids, rev).reshape(n, rev_cap * gamma)
    cand_c = cand_c.masked_fill(
        (rev < 0)[:, :, None].expand(n, rev_cap, gamma).reshape(n, -1), INVALID
    )
    cands = torch.cat([cand_a, rev, cand_c], dim=1)  # (N, C)
    del cand_a, cand_c

    # --- blocked scoring + merge ---------------------------------------------
    out_ids = torch.empty_like(nbr_ids)
    out_d = torch.empty_like(nbr_d)
    out_old = torch.empty_like(is_old)
    for s, e in _blocks(n, help_cfg.node_block):
        cand_b = cands[s:e]
        node_b = torch.arange(s, e, dtype=torch.int32, device=dev)
        cd = _score_candidates(features, attrs, node_b, cand_b, cfg)
        out_ids[s:e], out_d[s:e], out_old[s:e] = gops.merge_pools(
            nbr_ids[s:e], nbr_d[s:e], cand_b, cd, gamma,
            pool_flags=is_old[s:e],
            cand_flags=torch.zeros_like(cand_b, dtype=torch.int8),
        )
    return out_ids, out_d, out_old


# ---------------------------------------------------------------------------
# Graph quality ψ (Eq. 7)
# ---------------------------------------------------------------------------


def _graph_quality(
    features: Tensor,
    attrs: Tensor,
    nbr_ids: Tensor,
    sample_ids: Tensor,
    cfg: MetricConfig,
    k: int,
) -> float:
    idx = sample_ids.long()
    d = auto_mod.brute_fused_sqdist(features[idx], attrs[idx], features, attrs, cfg)
    d[torch.arange(idx.shape[0], device=d.device), idx] = INF  # exclude self
    _, gt = gops.smallest_k(d, k)  # (S, k)
    rows = nbr_ids[idx][:, :k].long()  # current best-k in-graph
    hit = (rows[:, :, None] == gt[:, None, :]) & (rows[:, :, None] >= 0)
    # divide on the CPU: CUDA division by a host scalar uses the reciprocal
    return float(hit.any(2).sum(1).to(torch.float32).mean().cpu() / k)


# ---------------------------------------------------------------------------
# Heterogeneous semantic prune (Alg. 2)
# ---------------------------------------------------------------------------


def _prune_block(
    features: Tensor,
    attrs: Tensor,
    node_ids: Tensor,  # (B,)
    nbr_ids: Tensor,  # (B, Γ) sorted ascending
    nbr_d: Tensor,
    in_deg: Tensor,  # (N,)
    sigma: float,
    gamma: int,
) -> tuple[Tensor, Tensor]:
    b = node_ids.shape[0]
    sv = features[node_ids.long()]  # (B, M)
    cv = gops.gather_rows(features, nbr_ids)  # (B, Γ, M)
    ca = gops.gather_rows(attrs, nbr_ids)  # (B, Γ, L)
    edges = cv - sv[:, None, :]
    norm = torch.linalg.vector_norm(edges, dim=-1, keepdim=True)
    unit = edges / torch.clamp_min(norm, 1e-12)
    cos = torch.bmm(unit, unit.transpose(1, 2))  # (B, Γ, Γ)
    same_attr = (ca[:, :, None, :] == ca[:, None, :, :]).all(-1)  # (B, Γ, Γ)
    valid = nbr_ids >= 0
    protected = (in_deg[nbr_ids.clamp_min(0).long()] <= 1) & valid  # island guard
    redundant_with = (cos > sigma) & same_attr

    # prune slot t iff some already-selected same-attr neighbour is too
    # cosine-aligned, unless t is the last in-edge of its target
    selected = torch.zeros((b, gamma), dtype=torch.bool, device=nbr_ids.device)
    for t in range(gamma):
        conflict = (redundant_with[:, t, :] & selected).any(1)
        selected[:, t] = valid[:, t] & (~conflict | protected[:, t])
    out_ids = nbr_ids.masked_fill(~selected, INVALID)
    out_d = nbr_d.masked_fill(~selected, INF)
    order = gops.stable_argsort(out_d, dim=1)  # compact: INVALID pads trail
    return out_ids.gather(1, order), out_d.gather(1, order)


def _prune_all(
    features: Tensor,
    attrs: Tensor,
    nbr_ids: Tensor,
    nbr_d: Tensor,
    sigma: float,
    node_block: int,
) -> tuple[Tensor, Tensor]:
    n, gamma = nbr_ids.shape
    in_deg = gops.in_degrees(nbr_ids, n)
    out_i = torch.empty_like(nbr_ids)
    out_d = torch.empty_like(nbr_d)
    for s, e in _blocks(n, node_block):
        node_b = torch.arange(s, e, dtype=torch.int32, device=nbr_ids.device)
        out_i[s:e], out_d[s:e] = _prune_block(
            features, attrs, node_b, nbr_ids[s:e], nbr_d[s:e], in_deg,
            float(sigma), gamma,
        )
    return out_i, out_d


def _first_in_edges(pre_ids: np.ndarray, pre_d: np.ndarray, is_orphan: np.ndarray):
    """For every orphan with a pre-prune in-edge: its closest in-edge
    (ties → the first in src-major order, as the reference's strict ``<``
    scan keeps), listed in the order the scan first meets each orphan.
    Returns (dst, src, d) arrays."""
    gamma = pre_ids.shape[1]
    flat = pre_ids.reshape(-1)
    pos = np.nonzero((flat >= 0) & is_orphan[np.maximum(flat, 0)])[0]  # src-major
    dst, d = flat[pos], pre_d.reshape(-1)[pos]
    best = np.lexsort((pos, d, dst))  # per dst: smallest d, then first position
    keep = np.ones(best.shape[0], bool)
    keep[1:] = dst[best][1:] != dst[best][:-1]
    best = best[keep]  # one per orphan, sorted by dst
    _, first_seen = np.unique(dst, return_index=True)  # also sorted by dst
    order = np.argsort(pos[first_seen], kind="stable")
    best = best[order]
    return dst[best], pos[best] // gamma, d[best]


def _repair_orphans(
    nbr_ids: Tensor, nbr_d: Tensor, pre_ids: Tensor, pre_d: Tensor
) -> tuple[Tensor, Tensor]:
    """Restore the closest pre-prune in-edge of any in-degree-0 node.

    The reference scans all N·Γ pre-prune edges in Python; here numpy finds
    each orphan's edge, and only the short per-orphan slot overwrite stays a
    loop, in the reference's order, so the result is the same.
    """
    n, gamma = nbr_ids.shape
    dev = nbr_ids.device
    for _ in range(3):
        deg = gops.in_degrees(nbr_ids, n).cpu().numpy()
        orphans = np.nonzero(deg == 0)[0]
        if orphans.size == 0:
            break
        pre_ids_np = pre_ids.cpu().numpy()
        pre_d_np = pre_d.cpu().numpy()
        nbr_ids_np = nbr_ids.cpu().numpy().copy()
        nbr_d_np = nbr_d.cpu().numpy().copy()
        is_orphan = np.zeros(n, bool)
        is_orphan[orphans] = True
        dsts, srcs, ds = _first_in_edges(pre_ids_np, pre_d_np, is_orphan)
        src_of = {
            int(dst): (int(src), float(d)) for dst, src, d in zip(dsts, srcs, ds)
        }
        # fallback: an orphan with no pre-prune in-edge gets the reverse of
        # its own best out-edge (the AUTO metric is symmetric); the set
        # difference iterates in the reference's order
        orphan_set = set(orphans.tolist())
        for dst in orphan_set - set(src_of):
            for t in range(gamma):
                s = int(nbr_ids_np[dst, t])
                if s >= 0 and s != dst:
                    src_of[dst] = (s, float(nbr_d_np[dst, t]))
                    break
        touched = set()
        for dst, (src, d) in src_of.items():
            worst = int(np.argmax(nbr_d_np[src]))  # overwrite the worst slot
            nbr_ids_np[src, worst] = dst
            nbr_d_np[src, worst] = d
            touched.add(src)
        for src in touched:  # restore ascending row order
            order = np.argsort(nbr_d_np[src], kind="stable")
            nbr_ids_np[src] = nbr_ids_np[src][order]
            nbr_d_np[src] = nbr_d_np[src][order]
        nbr_ids = torch.from_numpy(nbr_ids_np).to(dev)
        nbr_d = torch.from_numpy(nbr_d_np).to(dev)
    return nbr_ids, nbr_d


def _reverse_insert(
    features: Tensor,
    attrs: Tensor,
    nbr_ids: Tensor,
    nbr_d: Tensor,
    cfg: MetricConfig,
    help_cfg: HelpConfig,
) -> tuple[Tensor, Tensor]:
    """Alg. 2 lines 14-19 (bulk): offer each edge's reverse to its target."""
    n, gamma = nbr_ids.shape
    rev = gops.reverse_neighbors(nbr_ids, n, gamma)  # (N, Γ) candidate sources
    out_i = torch.empty_like(nbr_ids)
    out_d = torch.empty_like(nbr_d)
    for s, e in _blocks(n, help_cfg.node_block):
        node_b = torch.arange(s, e, dtype=torch.int32, device=nbr_ids.device)
        cd = _score_candidates(features, attrs, node_b, rev[s:e], cfg)
        out_i[s:e], out_d[s:e], _ = gops.merge_pools(
            nbr_ids[s:e], nbr_d[s:e], rev[s:e], cd, gamma
        )
    return out_i, out_d


# ---------------------------------------------------------------------------
# Incremental link and repair (streaming mutability: no full rebuild)
# ---------------------------------------------------------------------------


def _offers(new_rows: np.ndarray, node_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Reverse edges to offer: every existing row ``u`` named in a linked
    node's new row is offered that node. Returns ``u_ids`` in the order a
    row-major scan first meets them and ``off`` (U, width), each row's
    offered nodes in scan order, INVALID-padded: the reference's dict of
    lists, built without a Python loop."""
    gamma = new_rows.shape[1]
    u = new_rows.reshape(-1)
    v = np.repeat(node_ids, gamma)
    keep = (u >= 0) & ~np.isin(u, node_ids)
    u, v = u[keep], v[keep]
    if u.size == 0:
        return np.zeros(0, np.int32), np.zeros((0, 0), np.int32)
    uniq, first, inv, counts = np.unique(u, return_index=True, return_inverse=True,
                                         return_counts=True)
    by_first = np.argsort(first, kind="stable")  # group order: first sighting
    row_of = np.empty_like(by_first)
    row_of[by_first] = np.arange(by_first.size)
    row = row_of[inv]
    order = np.argsort(row, kind="stable")  # pairs grouped by row, scan order kept
    start = np.concatenate([[0], np.cumsum(counts[by_first])[:-1]])
    col = np.empty_like(order)
    col[order] = np.arange(order.size) - start[row[order]]
    off = np.full((by_first.size, int(counts.max())), INVALID, np.int32)
    off[row, col] = v
    return uniq[by_first].astype(np.int32), off


def link_nodes(
    features: Tensor,
    attrs: Tensor,
    graph: Tensor,
    node_ids,  # (D,) rows to (re-)link into the adjacency
    metric_cfg: MetricConfig,
    cfg: HelpConfig,
    banned_ids=None,  # dead rows: never linked to
    seed: int = 0,
) -> tuple[Tensor, int]:
    """Link ``node_ids`` into an existing HELP adjacency without a rebuild
    (the merge path of ``repro_torch.mutable``), on the device of
    ``features``. Returns (new adjacency, number of repaired existing rows);
    ``graph`` itself is not written.

    For each node: (1) a routed search over the current graph under the
    AUTO metric, the node's own attributes as targets; (1b) the one-hop
    expansion of that pool, scored with ``gather_auto``; (2) all pairs of
    the linked set through ``fused_auto``, since the frozen graph has no
    edges into it yet; (3) its row becomes the Γ best candidates; (4)
    mutual-neighbour repair offers each new edge's reverse to its target, so
    that new rows are reachable. Rows in ``banned_ids`` are never linked to.
    """
    node_ids = np.asarray(node_ids, np.int64)
    n, gamma = int(features.shape[0]), int(graph.shape[1])
    d = int(node_ids.shape[0])
    if d == 0 or gamma == 0:
        return graph, 0
    dev = features.device
    banned = np.zeros(0, np.int64) if banned_ids is None else np.unique(
        np.asarray(banned_ids, np.int64))
    node_dev = torch.from_numpy(node_ids.astype(np.int32)).to(dev)
    qv, qa = features[node_dev.long()], attrs[node_dev.long()]

    # (1) routed candidate search, the reference's operating point
    pool = int(min(max(4 * gamma, 64), n))
    rcfg = routing_mod.RoutingConfig(
        k=pool, pool_size=pool, pioneer_size=min(8, pool),
        coarse_max_iters=16, refine_max_iters=64,
    )
    res = routing_mod.search(features, attrs, graph, qv, qa, metric_cfg, rcfg, seed=seed)
    cand_ids, cand_d = res.ids, res.sqdists  # (D, pool)

    # (1b) one-hop expansion: the candidates' own neighbours
    hop_ids = gops.gather_rows(graph, cand_ids).reshape(d, -1)  # (D, pool·Γ)
    hop_ids = hop_ids.masked_fill((cand_ids < 0).repeat_interleave(gamma, dim=1), INVALID)
    hop_d = _score_candidates(features, attrs, node_dev, hop_ids, metric_cfg)
    # (2) new↔new candidates
    d_nn = auto_mod.brute_fused_sqdist(qv, qa, qv, qa, metric_cfg)  # (D, D)
    nn_ids = node_dev[None, :].expand(d, d)
    all_ids = torch.cat([cand_ids, hop_ids, nn_ids], dim=1)
    all_d = torch.cat([cand_d, hop_d, d_nn], dim=1)
    bad = (all_ids == node_dev[:, None]) | (all_ids < 0)
    if banned.size:
        bad |= torch.isin(all_ids, torch.from_numpy(banned.astype(np.int32)).to(dev))
    all_d = all_d.masked_fill(bad, INF)
    all_ids = all_ids.masked_fill(bad, INVALID)
    # (3) each linked node's row: the Γ best candidates, deduped, ascending
    new_rows, _, _ = gops.merge_pools(
        torch.full((d, gamma), INVALID, dtype=torch.int32, device=dev),
        torch.full((d, gamma), INF, dtype=torch.float32, device=dev),
        all_ids, all_d, gamma,
    )
    out = graph.clone()
    out[node_dev.long()] = new_rows
    new_rows_np = new_rows.cpu().numpy()

    # (4) mutual-neighbour repair: existing rows carry no stored distances,
    # so each is rescored once and merged with the reverse edges offered
    u_ids, off = _offers(new_rows_np, node_ids)
    if u_ids.size == 0:
        return out, 0
    u_dev = torch.from_numpy(u_ids).to(dev)
    off_dev = torch.from_numpy(off).to(dev)
    cur = out[u_dev.long()]
    cur_d = _score_candidates(features, attrs, u_dev, cur, metric_cfg)
    off_d = _score_candidates(features, attrs, u_dev, off_dev, metric_cfg)
    out[u_dev.long()] = gops.merge_pools(cur, cur_d, off_dev, off_d, gamma)[0]
    return out, int(u_ids.size)


# ---------------------------------------------------------------------------
# Public build entry point (Alg. 1)
# ---------------------------------------------------------------------------


def build_help_graph(
    features: Tensor,
    attrs: Tensor,
    metric_cfg: MetricConfig,
    cfg: HelpConfig = HelpConfig(),
) -> tuple[Tensor, Tensor, BuildReport]:
    """Build the HELP adjacency table on the device holding ``features``:
    returns (ids (N,Γ) int32, sqdists (N,Γ) f32, report)."""
    t0 = time.perf_counter()
    dev = features.device
    n = features.shape[0]
    gamma = cfg.gamma
    rng = np.random.default_rng(cfg.seed)

    # (1) Initialization: Γ random neighbours per node, scored, deduped, sorted.
    init = torch.from_numpy(rng.integers(0, n, size=(n, gamma), dtype=np.int32)).to(dev)
    nbr_ids = torch.empty_like(init)
    nbr_d = torch.empty((n, gamma), dtype=torch.float32, device=dev)
    for s, e in _blocks(n, cfg.node_block):
        node_b = torch.arange(s, e, dtype=torch.int32, device=dev)
        cd = _score_candidates(features, attrs, node_b, init[s:e], metric_cfg)
        nbr_ids[s:e], nbr_d[s:e], _ = gops.merge_pools(
            torch.full((e - s, gamma), INVALID, dtype=torch.int32, device=dev),
            torch.full((e - s, gamma), INF, dtype=torch.float32, device=dev),
            init[s:e], cd, gamma,
        )
    del init
    is_old = torch.zeros((n, gamma), dtype=torch.int8, device=dev)

    sample_ids = torch.from_numpy(
        rng.choice(n, size=min(cfg.quality_sample, n), replace=False).astype(np.int32)
    ).to(dev)

    # (2)-(3) iterate until ψ ≥ Ψ or the round cap.
    psi_history: list[float] = []
    rounds = 0
    for rounds in range(1, cfg.max_rounds + 1):
        nbr_ids, nbr_d, is_old = _descent_round(
            features, attrs, nbr_ids, nbr_d, is_old, metric_cfg, cfg
        )
        psi = _graph_quality(features, attrs, nbr_ids, sample_ids, metric_cfg, gamma)
        psi_history.append(psi)
        if psi >= cfg.psi_target:
            break

    edges_before = int((nbr_ids >= 0).sum())

    # (4) heterogeneous semantic prune + reverse densification + island repair.
    if cfg.prune:
        pre_ids, pre_d = nbr_ids, nbr_d
        nbr_ids, nbr_d = _prune_all(features, attrs, nbr_ids, nbr_d, cfg.sigma, cfg.node_block)
        if cfg.reverse_insert:
            nbr_ids, nbr_d = _reverse_insert(features, attrs, nbr_ids, nbr_d, metric_cfg, cfg)
            nbr_ids, nbr_d = _prune_all(
                features, attrs, nbr_ids, nbr_d, cfg.sigma, cfg.node_block
            )
        nbr_ids, nbr_d = _repair_orphans(nbr_ids, nbr_d, pre_ids, pre_d)

    edges_after = int((nbr_ids >= 0).sum())
    report = BuildReport(
        psi_history=psi_history,
        rounds=rounds,
        pruned_edge_fraction=1.0 - edges_after / max(edges_before, 1),
        build_seconds=time.perf_counter() - t0,
    )
    return nbr_ids, nbr_d, report
