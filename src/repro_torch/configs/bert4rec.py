"""bert4rec: embed 64, 2 blocks, 2 heads, seq 200, bidirectional encoder.
[arXiv:1904.06690] Encoder-only: no decode shapes exist in its shape set.
"""
from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec
from repro_torch.models.recsys import RecsysConfig
from repro_torch.train.optim import OptimConfig


def make_config(**kw) -> RecsysConfig:
    return RecsysConfig(
        name="bert4rec", kind="bert4rec", embed_dim=64, n_blocks=2,
        n_heads=2, seq_len=200, n_items=1_000_000, n_sparse=0, **kw,
    )


def make_reduced() -> RecsysConfig:
    return RecsysConfig(
        name="bert4rec-smoke", kind="bert4rec", embed_dim=16, n_blocks=1,
        n_heads=2, seq_len=16, n_items=200, n_sparse=0,
    )


SPEC = ArchSpec(
    arch_id="bert4rec", family="recsys", source="arXiv:1904.06690",
    make_config=make_config, make_reduced=make_reduced, shapes=RECSYS_SHAPES,
    optim=OptimConfig(kind="adamw", lr=1e-3),
)
