"""fm: 39 sparse fields, embed 10, pairwise ⟨vi,vj⟩xixj via the O(nk)
sum-square trick. [ICDM'10 Rendle] The retrieval_cand cell is the
paper-technique cell: FM factors + attribute filters = STABLE hybrid
retrieval.
"""
from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec
from repro_torch.models.recsys import RecsysConfig
from repro_torch.train.optim import OptimConfig


def make_config(**kw) -> RecsysConfig:
    return RecsysConfig(
        name="fm", kind="fm", n_sparse=39, vocab_per_field=1_000_000,
        embed_dim=10, **kw,
    )


def make_reduced() -> RecsysConfig:
    return RecsysConfig(
        name="fm-smoke", kind="fm", n_sparse=8, vocab_per_field=50, embed_dim=8,
    )


SPEC = ArchSpec(
    arch_id="fm", family="recsys", source="ICDM'10 Rendle",
    make_config=make_config, make_reduced=make_reduced, shapes=RECSYS_SHAPES,
    optim=OptimConfig(kind="adamw", lr=1e-3),
)
