"""phi3-mini-3.8b: dense 32L d3072 32H (MHA kv=32) ff8192 v32064.

[arXiv:2404.14219] RoPE + SwiGLU + GQA(kv=32 ⇒ MHA); full attention ⇒
long_500k skipped.
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optim import OptimConfig


def make_config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="phi3-mini-3.8b", n_layers=32, d_model=3072, n_heads=32,
        n_kv_heads=32, d_head=96, d_ff=8192, vocab=32064, **kw,
    )


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        name="phi3-mini-smoke", n_layers=2, d_model=96, n_heads=4,
        n_kv_heads=4, d_head=24, d_ff=192, vocab=512, q_chunk=64,
    )


SPEC = ArchSpec(
    arch_id="phi3-mini-3.8b", family="lm", source="arXiv:2404.14219",
    make_config=make_config, make_reduced=make_reduced,
    shapes=lm_shapes(sliding_window=None),
    optim=OptimConfig(kind="adamw", lr=3e-4), micro_batches=2,
)
