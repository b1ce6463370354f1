"""kimi-k2-1t-a32b: MoE 61L d7168 64H (GQA kv=8) ffe2048 v163840, 384e top-8.

[arXiv:2501.kimi2; unverified] trillion-param MoE. Full attention ⇒
long_500k skipped. Training state: bf16 params + Adafactor — dense f32
AdamW for 1T params is 16 TB of state.
"""
import torch

from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.common import Precision
from repro_torch.models.transformer import MoEConfig, TransformerConfig
from repro_torch.train.optim import OptimConfig


def make_config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64,
        n_kv_heads=8, d_head=112, d_ff=2048, vocab=163840,
        moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048),
        precision=Precision(param_dtype=torch.bfloat16),
        **kw,
    )


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        name="kimi-k2-smoke", n_layers=2, d_model=112, n_heads=8, n_kv_heads=2,
        d_head=14, d_ff=64, vocab=512, q_chunk=64,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64),
    )


SPEC = ArchSpec(
    arch_id="kimi-k2-1t-a32b", family="lm", source="arXiv:2501.kimi2",
    make_config=make_config, make_reduced=make_reduced,
    shapes=lm_shapes(sliding_window=None),
    optim=OptimConfig(kind="adafactor", lr=2e-4), micro_batches=8,
)
