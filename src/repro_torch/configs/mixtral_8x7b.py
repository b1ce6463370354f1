"""mixtral-8x7b: MoE 32L d4096 32H (GQA kv=8) ff14336 v32000, 8e top-2, SWA.

[arXiv:2401.04088] sliding-window attention (4096) ⇒ long_500k RUNS with the
rolling-window cache.
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import MoEConfig, TransformerConfig
from repro_torch.train.optim import OptimConfig


def make_config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="mixtral-8x7b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_head=128, d_ff=14336, vocab=32000,
        sliding_window=4096,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336),
        **kw,
    )


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        name="mixtral-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=128, vocab=512, q_chunk=32, sliding_window=32,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128),
    )


SPEC = ArchSpec(
    arch_id="mixtral-8x7b", family="lm", source="arXiv:2401.04088",
    make_config=make_config, make_reduced=make_reduced,
    shapes=lm_shapes(sliding_window=4096),
    optim=OptimConfig(kind="adamw", lr=2e-4), micro_batches=4,
)
