"""dlrm-rm2: 13 dense + 26 sparse, embed 64, bot 13-512-256-64,
top 512-512-256-1, dot interaction. [arXiv:1906.00091]
"""
from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec
from repro_torch.models.recsys import RecsysConfig
from repro_torch.train.optim import OptimConfig


def make_config(**kw) -> RecsysConfig:
    return RecsysConfig(
        name="dlrm-rm2", kind="dlrm", n_dense=13, n_sparse=26,
        vocab_per_field=1_000_000, embed_dim=64,
        bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256, 1), **kw,
    )


def make_reduced() -> RecsysConfig:
    return RecsysConfig(
        name="dlrm-smoke", kind="dlrm", n_dense=13, n_sparse=6,
        vocab_per_field=100, embed_dim=16, bot_mlp=(32, 16), top_mlp=(32, 1),
    )


SPEC = ArchSpec(
    arch_id="dlrm-rm2", family="recsys", source="arXiv:1906.00091",
    make_config=make_config, make_reduced=make_reduced, shapes=RECSYS_SHAPES,
    optim=OptimConfig(kind="adamw", lr=1e-3),
)
