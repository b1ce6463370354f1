"""Config substrate: ``ShapeCell`` and ``ArchSpec``, and the shape tables
of the three families: LM (``LM_SHAPES``, ``lm_shapes``), GNN
(``GNN_SHAPES``) and recsys (``RECSYS_SHAPES``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.train.optim import OptimConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture × input-shape) cell."""

    name: str
    kind: str  # train | prefill | decode | serve | retrieval
    # LM
    seq_len: int = 0
    global_batch: int = 0
    # GNN
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    d_out: int = 0
    # RecSys
    n_candidates: int = 0
    skip_reason: str = ""  # non-empty ⇒ cell recorded as skipped

    @property
    def skipped(self) -> bool:
        return bool(self.skip_reason)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # lm | gnn | recsys
    source: str  # public-literature citation tag
    make_config: Callable[..., Any]  # full-size config (kwargs override)
    make_reduced: Callable[[], Any]  # smoke-test config
    shapes: tuple[ShapeCell, ...]
    optim: OptimConfig = OptimConfig(kind="adamw")
    micro_batches: int = 1  # LM train gradient accumulation
    notes: str = ""

    def cell(self, name: str) -> ShapeCell:
        for c in self.shapes:
            if c.name == name:
                return c
        raise KeyError(f"{self.arch_id}: unknown shape {name!r}")


def _pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


LM_SHAPES = (
    ShapeCell(name="train_4k", kind="train", seq_len=4096, global_batch=256),
    ShapeCell(name="prefill_32k", kind="prefill", seq_len=32768, global_batch=32),
    ShapeCell(name="decode_32k", kind="decode", seq_len=32768, global_batch=128),
    ShapeCell(name="long_500k", kind="decode", seq_len=524288, global_batch=1),
)


def lm_shapes(sliding_window: Optional[int]) -> tuple[ShapeCell, ...]:
    """long_500k requires sub-quadratic attention: it runs only for the
    SWA archs (rolling O(window) cache); pure full-attention archs skip it."""
    cells = []
    for c in LM_SHAPES:
        if c.name == "long_500k" and sliding_window is None:
            c = dataclasses.replace(
                c,
                skip_reason=(
                    "pure full-attention arch: 512k-token KV cache/attention "
                    "has no sub-quadratic mechanism in this config"
                ),
            )
        cells.append(c)
    return tuple(cells)


GNN_SHAPES = (
    # cora-like full batch (edges padded 10556 → 10752 = 512·21)
    ShapeCell(name="full_graph_sm", kind="train", n_nodes=2708,
              n_edges=_pad_to(10556, 512), d_feat=1433, d_out=7),
    # reddit-like sampled training: seeds 1024, fanout 15×10 →
    # nodes = 1024 + 15360 + 153600, edges = 15360 + 153600
    ShapeCell(name="minibatch_lg", kind="train", n_nodes=1024 + 15360 + 153600,
              n_edges=15360 + 153600, d_feat=602, d_out=41),
    # ogbn-products-like full batch (nodes and edges padded to multiples of
    # 512, the reference's mesh divisor)
    ShapeCell(name="ogb_products", kind="train", n_nodes=_pad_to(2449029, 512),
              n_edges=_pad_to(61859140, 512), d_feat=100, d_out=47),
    # batched small molecules: 128 graphs × (30 nodes, 64 edges)
    ShapeCell(name="molecule", kind="train", n_nodes=128 * 30,
              n_edges=128 * 64, d_feat=32, d_out=1),
)

RECSYS_SHAPES = (
    ShapeCell(name="train_batch", kind="train", global_batch=65536),
    ShapeCell(name="serve_p99", kind="serve", global_batch=512),
    ShapeCell(name="serve_bulk", kind="serve", global_batch=262144),
    ShapeCell(name="retrieval_cand", kind="retrieval", global_batch=1,
              n_candidates=1_000_000),
)
