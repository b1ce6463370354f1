"""xdeepfm: 39 sparse, embed 10, CIN 200-200-200, MLP 400-400.
[arXiv:1803.05170]
"""
from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec
from repro_torch.models.recsys import RecsysConfig
from repro_torch.train.optim import OptimConfig


def make_config(**kw) -> RecsysConfig:
    return RecsysConfig(
        name="xdeepfm", kind="xdeepfm", n_sparse=39,
        vocab_per_field=1_000_000, embed_dim=10,
        cin_layers=(200, 200, 200), mlp=(400, 400), **kw,
    )


def make_reduced() -> RecsysConfig:
    return RecsysConfig(
        name="xdeepfm-smoke", kind="xdeepfm", n_sparse=8, vocab_per_field=50,
        embed_dim=8, cin_layers=(16, 16), mlp=(32,),
    )


SPEC = ArchSpec(
    arch_id="xdeepfm", family="recsys", source="arXiv:1803.05170",
    make_config=make_config, make_reduced=make_reduced, shapes=RECSYS_SHAPES,
    optim=OptimConfig(kind="adamw", lr=1e-3),
)
