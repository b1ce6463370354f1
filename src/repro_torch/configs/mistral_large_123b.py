"""mistral-large-123b: dense 88L d12288 96H (GQA kv=8) ff28672 v32768.

[hf:mistralai/Mistral-Large-Instruct-2407; unverified] — pure full attention
(no sliding window in this config) ⇒ long_500k is skipped.
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optim import OptimConfig


def make_config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="mistral-large-123b", n_layers=88, d_model=12288, n_heads=96,
        n_kv_heads=8, d_head=128, d_ff=28672, vocab=32768,
        rope_theta=1_000_000.0, **kw,
    )


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        name="mistral-large-123b-smoke", n_layers=2, d_model=128, n_heads=8,
        n_kv_heads=2, d_head=16, d_ff=256, vocab=512, q_chunk=64,
    )


SPEC = ArchSpec(
    arch_id="mistral-large-123b", family="lm",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    make_config=make_config, make_reduced=make_reduced,
    shapes=lm_shapes(sliding_window=None),
    optim=OptimConfig(kind="adamw", lr=1.5e-4), micro_batches=8,
)
