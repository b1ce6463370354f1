"""Serve-step builders of the recsys family.

Each builder returns ``step(params, batch)``, the reference's signature.
PyTorch runs eagerly, so a step is a plain function; it runs on the device
the parameters lie on. The training builders come with the training slice
(ROADMAP.md queue 1, item 15).
"""
from __future__ import annotations

from repro_torch.models import recsys as recsys_mod


def make_recsys_serve_step(cfg: recsys_mod.RecsysConfig):
    """CTR logits (B,) of ``batch["sparse"]`` (B, F) ids."""

    def step(params, batch):
        return recsys_mod.forward(cfg, params, batch)

    return step


def make_recsys_retrieval_step(
    cfg: recsys_mod.RecsysConfig, k: int = 100, score_chunk: int = 16384,
    topk_shards: int = 1,
):
    """(sq-dists, ids) of the k best of ``batch["item_embs"]`` for each
    user, under the AUTO metric against ``batch["query_attrs"]``."""

    def step(params, batch):
        return recsys_mod.retrieval_step(
            cfg, params, batch, batch["item_embs"], batch["item_attrs"], k=k,
            score_chunk=score_chunk, topk_shards=topk_shards,
        )

    return step
