"""yi-34b: dense 60L d7168 56H (GQA kv=8) ff20480 v64000. [arXiv:2403.04652]

Llama-arch GQA, full attention ⇒ long_500k skipped.
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optim import OptimConfig


def make_config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="yi-34b", n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
        d_head=128, d_ff=20480, vocab=64000, rope_theta=5_000_000.0, **kw,
    )


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        name="yi-34b-smoke", n_layers=2, d_model=112, n_heads=7, n_kv_heads=1,
        d_head=16, d_ff=224, vocab=512, q_chunk=64,
    )


SPEC = ArchSpec(
    arch_id="yi-34b", family="lm", source="arXiv:2403.04652",
    make_config=make_config, make_reduced=make_reduced,
    shapes=lm_shapes(sliding_window=None),
    optim=OptimConfig(kind="adamw", lr=2e-4), micro_batches=4,
)
