"""Config substrate: ``ShapeCell`` and ``ArchSpec``, the LM shape table
(``LM_SHAPES``, ``lm_shapes``) and the recsys shape table. The GNN shape
table comes with its family (ROADMAP.md queue 1, item 16)."""
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


RECSYS_SHAPES = (
    ShapeCell(name="train_batch", kind="train", global_batch=65536),
    ShapeCell(name="serve_p99", kind="serve", global_batch=512),
    ShapeCell(name="serve_bulk", kind="serve", global_batch=262144),
    ShapeCell(name="retrieval_cand", kind="retrieval", global_batch=1,
              n_candidates=1_000_000),
)
