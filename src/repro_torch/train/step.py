"""The serve steps of the recsys family, for every kind (dlrm, xdeepfm,
bert4rec, fm).

Each builder returns ``step(params, batch)``, the reference's signature.
PyTorch runs eagerly, so a step is a plain function; it runs on the device
the parameters lie on. bert4rec serves its next-item top-k through
``models.recsys.bert4rec_serve_topk``, as the reference's ``build_cell``
does. The training steps come with the training slice (ROADMAP.md queue
1, item 15).
"""
from __future__ import annotations

from repro_torch.models import recsys as recsys_mod


def make_recsys_serve_step(cfg: recsys_mod.RecsysConfig):
    """``forward``'s logits: (B,) CTR logits of ``batch["sparse"]`` (B, F)
    ids (and ``batch["dense"]`` for dlrm), or bert4rec's (B, S, n_items)
    masked-item logits of ``batch["items"]``."""

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
