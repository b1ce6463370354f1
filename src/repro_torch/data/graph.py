"""Graph data: synthetic generators matching the assigned GNN shapes and a
real fanout neighbor sampler for sampled-training (minibatch_lg).

numpy only: every function makes the reference's draws in the reference's
order, so each array equals the reference's bit for bit. Sampled subgraphs
have *static* padded shapes (frontier sizes = batch_nodes · Πfanout; edge
lists padded with an edge mask), the same for every minibatch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class GraphData:
    node_feats: np.ndarray  # (N, F)
    src: np.ndarray  # (E,)
    dst: np.ndarray  # (E,)
    targets: np.ndarray  # (N, d_out)
    # CSR for sampling
    indptr: Optional[np.ndarray] = None
    indices: Optional[np.ndarray] = None

    @property
    def n_nodes(self) -> int:
        return self.node_feats.shape[0]

    @property
    def n_edges(self) -> int:
        return self.src.shape[0]


def make_random_graph(
    n_nodes: int, n_edges: int, d_feat: int, d_out: int, seed: int = 0,
    build_csr: bool = False,
) -> GraphData:
    """Power-law-ish random graph with smooth (learnable) targets."""
    rng = np.random.default_rng(seed)
    # preferential-attachment-flavored degree skew
    p = 1.0 / np.arange(1, n_nodes + 1) ** 0.5
    p /= p.sum()
    src = rng.choice(n_nodes, size=n_edges, p=p).astype(np.int32)
    dst = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    feats = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    w = rng.normal(size=(d_feat, d_out)).astype(np.float32) / np.sqrt(d_feat)
    targets = np.tanh(feats @ w)
    g = GraphData(node_feats=feats, src=src, dst=dst, targets=targets)
    if build_csr:
        order = np.argsort(dst, kind="stable")
        g.indices = src[order]
        g.indptr = np.zeros(n_nodes + 1, np.int64)
        np.add.at(g.indptr, dst + 1, 1)
        g.indptr = np.cumsum(g.indptr)
    return g


def make_molecule_batch(
    batch: int, nodes_per_mol: int, edges_per_mol: int, d_feat: int, d_out: int,
    seed: int = 0,
) -> GraphData:
    """Batched small graphs flattened with block-diagonal edge offsets."""
    rng = np.random.default_rng(seed)
    n = batch * nodes_per_mol
    feats = rng.normal(size=(n, d_feat)).astype(np.float32)
    srcs, dsts = [], []
    for b in range(batch):
        off = b * nodes_per_mol
        s = rng.integers(0, nodes_per_mol, size=edges_per_mol) + off
        d = rng.integers(0, nodes_per_mol, size=edges_per_mol) + off
        srcs.append(s)
        dsts.append(d)
    w = rng.normal(size=(d_feat, d_out)).astype(np.float32) / np.sqrt(d_feat)
    return GraphData(
        node_feats=feats,
        src=np.concatenate(srcs).astype(np.int32),
        dst=np.concatenate(dsts).astype(np.int32),
        targets=np.tanh(feats @ w),
    )


@dataclasses.dataclass(frozen=True)
class SampledSubgraph:
    """Static-shape fanout sample rooted at a seed batch.

    nodes: (n_sub,) global ids (padded with 0)
    node_mask: (n_sub,) — valid rows
    src/dst: (e_sub,) LOCAL indices into ``nodes``; edge_mask marks padding.
    seed_mask: loss restricted to the seed nodes (first ``batch`` rows).
    """

    nodes: np.ndarray
    node_mask: np.ndarray
    src: np.ndarray
    dst: np.ndarray
    edge_mask: np.ndarray
    n_seeds: int


def sample_fanout(
    g: GraphData, seeds: np.ndarray, fanouts: tuple[int, ...], seed: int = 0
) -> SampledSubgraph:
    """GraphSAGE-style uniform fanout sampling over the CSR adjacency.

    Layered frontier expansion; every layer's edges connect a sampled
    neighbor (src) to its anchor (dst). Output shapes depend only on
    (len(seeds), fanouts) — compile once, sample forever.
    """
    assert g.indptr is not None, "build_csr=True required for sampling"
    rng = np.random.default_rng(seed)
    frontier = seeds.astype(np.int64)
    all_nodes = [frontier]
    offsets = [0]
    src_l, dst_l, emask_l = [], [], []
    base = 0
    for fo in fanouts:
        nbr = np.zeros((frontier.size, fo), np.int64)
        valid = np.zeros((frontier.size, fo), bool)
        for i, u in enumerate(frontier):
            lo, hi = g.indptr[u], g.indptr[u + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = rng.integers(0, deg, size=fo)
            nbr[i] = g.indices[lo + take]
            valid[i] = True
        nxt_base = base + frontier.size
        src_local = nxt_base + np.arange(frontier.size * fo)
        dst_local = base + np.repeat(np.arange(frontier.size), fo)
        src_l.append(src_local)
        dst_l.append(dst_local)
        emask_l.append(valid.reshape(-1))
        all_nodes.append(nbr.reshape(-1))
        base = nxt_base
        frontier = nbr.reshape(-1)
    nodes = np.concatenate(all_nodes)
    node_mask = np.ones_like(nodes, bool)
    return SampledSubgraph(
        nodes=nodes.astype(np.int64),
        node_mask=node_mask,
        src=np.concatenate(src_l).astype(np.int32),
        dst=np.concatenate(dst_l).astype(np.int32),
        edge_mask=np.concatenate(emask_l),
        n_seeds=len(seeds),
    )


def subgraph_batch(g: GraphData, sub: SampledSubgraph) -> dict:
    """Materialize a training batch dict for models/gnn.py from a sample."""
    feats = g.node_feats[sub.nodes]
    targets = g.targets[sub.nodes]
    node_mask = np.zeros(len(sub.nodes), np.float32)
    node_mask[: sub.n_seeds] = 1.0  # loss on seed nodes only
    return {
        "node_feats": feats,
        "src": sub.src,
        "dst": sub.dst,
        "edge_mask": sub.edge_mask,
        "targets": targets,
        "node_mask": node_mask,
    }
