"""RecSys family: the FM model's CTR forward and the hybrid-retrieval head
that routes the ``retrieval_cand`` shape through the paper's STABLE scorer.

Tables are stacked (F, V, D) and looked up with one gather over the
flattened (F·V, D) table. The FM forward's second-order term runs the
``fm_interaction`` kernel on the card. The retrieval head scores one user
(or a batch) against every candidate with the fused AUTO metric
(``core.auto.brute_fused_sqdist``, the ``fused_auto`` kernel on the card)
and keeps an exact top-k, in one stage or as a two-stage merge over
shards of the candidate axis.

Only ``kind="fm"`` is ported. The dlrm, xdeepfm and bert4rec forwards,
``embedding_bag`` and training come with their ROADMAP.md items (queue 1,
items 13–15); each raises ``NotImplementedError`` naming its item.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import resolve_device, to_tensor
from repro_torch.core.auto import MetricConfig, brute_fused_sqdist
from repro_torch.core.graph_ops import smallest_k
from repro_torch.kernels.fm_interaction.ops import fm_interaction
from repro_torch.models import common
from repro_torch.models.common import MIXED, Precision

Tensor = torch.Tensor

#: the ROADMAP.md item that ports the other recsys kinds
NOT_PORTED_ITEM = "ROADMAP.md queue 1, item 13 (the dlrm, xdeepfm and bert4rec forwards)"


def _not_ported(kind: str, what: str) -> Exception:
    if kind not in ("dlrm", "xdeepfm", "bert4rec"):
        return ValueError(f"unknown recsys kind {kind!r}")
    return NotImplementedError(f"{what} for kind {kind!r} is not ported yet: {NOT_PORTED_ITEM}")


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str  # dlrm | xdeepfm | bert4rec | fm
    n_dense: int = 0
    n_sparse: int = 26
    vocab_per_field: int = 1_000_000
    embed_dim: int = 64
    bot_mlp: tuple = ()
    top_mlp: tuple = ()
    cin_layers: tuple = ()
    mlp: tuple = ()
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    n_items: int = 200_000
    n_attr_dims: int = 4  # filterable attribute dims on retrieval candidates
    precision: Precision = MIXED
    unroll_blocks: bool = False

    @property
    def param_count(self) -> int:
        return common.count_params(abstract_params(self))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def param_shapes(cfg: RecsysConfig) -> dict[str, tuple[int, ...]]:
    """Shape of every parameter, as the reference's ``init_params`` makes it."""
    if cfg.kind != "fm":
        raise _not_ported(cfg.kind, "the parameters")
    f, v, d = cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim
    return {"tables": (f, v, d), "linear": (f, v), "bias": ()}


def abstract_params(cfg: RecsysConfig) -> dict[str, Tensor]:
    """The parameters on ``torch.device("meta")``: shapes and dtypes, no
    memory (the counterpart of ``jax.eval_shape``)."""
    pd = cfg.precision.param_dtype
    return {k: torch.empty(s, dtype=pd, device="meta") for k, s in param_shapes(cfg).items()}


def init_params(cfg: RecsysConfig, seed: int = 0, device=None) -> dict[str, Tensor]:
    """Random parameters drawn on ``device`` (the card by default) from a
    ``torch.Generator`` seeded with ``seed``: ``tables`` and ``linear``
    N(0, 1)·0.01, ``bias`` 0. The draws differ from ``jax.random``'s; tests
    hand the reference's parameters across with ``params_from_numpy``."""
    shapes = param_shapes(cfg)
    dev = resolve_device(device)
    pd = cfg.precision.param_dtype
    g = torch.Generator(device=dev).manual_seed(seed)
    return {
        "tables": torch.randn(shapes["tables"], generator=g, dtype=pd, device=dev).mul_(0.01),
        "linear": torch.randn(shapes["linear"], generator=g, dtype=pd, device=dev).mul_(0.01),
        "bias": torch.zeros((), dtype=pd, device=dev),
    }


def params_from_numpy(cfg: RecsysConfig, tree: dict, device=None) -> dict[str, Tensor]:
    """The reference's parameter dict (numpy or array-likes) as the port's
    tensors on ``device``."""
    shapes = param_shapes(cfg)
    if set(tree) != set(shapes):
        raise ValueError(f"parameters {sorted(tree)} != {sorted(shapes)} for kind {cfg.kind!r}")
    dev = resolve_device(device)
    out = {}
    for k, shape in shapes.items():
        got = tuple(getattr(tree[k], "shape", np.shape(tree[k])))
        if got != shape:
            raise ValueError(f"{k}: shape {got} != {shape}")
        # reshape: to_tensor gives a 0-d numpy array one axis
        out[k] = to_tensor(tree[k], cfg.precision.param_dtype, dev).reshape(shape)
    return out


# ---------------------------------------------------------------------------
# Embedding lookup
# ---------------------------------------------------------------------------


def _flat_ids(ids, n_fields: int, vocab: int, device) -> Tensor:
    """(B, F) ids as int64 rows of the flattened (F·V, ...) table.

    Negative ids wrap (id + V), as ``jnp.take`` does. An id outside
    [−V, V) raises ``IndexError``: the reference's ``jnp.take`` fills such a
    row with NaN, and an unchecked flat gather would read another field's
    row. The check reads the ids' min and max, one synchronisation on the
    card.
    """
    ids = to_tensor(ids, torch.int64, device)
    if ids.ndim != 2 or ids.shape[1] != n_fields:
        raise ValueError(f"ids must be (B, {n_fields}), got {tuple(ids.shape)}")
    if ids.numel():
        lo, hi = torch.aminmax(ids)
        if int(lo) < -vocab or int(hi) >= vocab:
            raise IndexError(
                f"ids must lie in [-{vocab}, {vocab}), got [{int(lo)}, {int(hi)}]"
            )
    ids = torch.where(ids < 0, ids + vocab, ids)
    return ids + torch.arange(n_fields, dtype=torch.int64, device=device) * vocab


def _gather(table: Tensor, flat: Tensor) -> Tensor:
    """Rows ``flat`` (B, F) of ``table`` (F, V, ...) → (B, F, ...)."""
    f, v = table.shape[:2]
    rows = table.reshape(f * v, *table.shape[2:]).index_select(0, flat.reshape(-1))
    return rows.reshape(*flat.shape, *table.shape[2:])


def _sum_fields(x: Tensor) -> Tensor:
    """Sum over axis 1 in ascending order, one add a field: the same bits
    on the CPU and the card, whatever the batch."""
    out = x[:, 0].clone()
    for i in range(1, x.shape[1]):
        out += x[:, i]
    return out


def embedding_lookup(tables: Tensor, ids) -> Tensor:
    """tables (F, V, D), ids (B, F) → (B, F, D).

    Differs from the reference for out-of-range ids: an id outside [−V, V)
    raises ``IndexError`` where ``jnp.take`` returns a NaN row."""
    f, v = tables.shape[:2]
    return _gather(tables, _flat_ids(ids, f, v, tables.device))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _fm_forward(cfg: RecsysConfig, p: dict, batch: dict) -> Tensor:
    tables = p["tables"]
    f, v = tables.shape[:2]
    flat = _flat_ids(batch["sparse"], f, v, tables.device)
    emb = _gather(tables, flat)  # (B, F, D)
    second = fm_interaction(emb.to(torch.float32))  # (B,)
    lin = _sum_fields(_gather(p["linear"], flat))  # (B,)
    return second + lin.to(torch.float32) + p["bias"].to(torch.float32)


def forward(cfg: RecsysConfig, params: dict, batch: dict) -> Tensor:
    """CTR logits (B,) f32."""
    if cfg.kind == "fm":
        return _fm_forward(cfg, params, batch)
    raise _not_ported(cfg.kind, "forward")


# ---------------------------------------------------------------------------
# Hybrid retrieval head (retrieval_cand → STABLE scorer)
# ---------------------------------------------------------------------------


def user_tower(cfg: RecsysConfig, params: dict, batch: dict) -> Tensor:
    """(B, D) user embedding for factorized retrieval: the sum of the
    user's field embeddings (the FM-style user factor)."""
    if cfg.kind in ("dlrm", "bert4rec"):
        raise _not_ported(cfg.kind, "user_tower")
    emb = embedding_lookup(params["tables"], batch["sparse"]).to(torch.float32)
    return _sum_fields(emb)


def hybrid_retrieval_topk(
    user_vec: Tensor,  # (B, D)
    user_attrs,  # (B, L) attribute constraints
    item_embs,  # (N, D)
    item_attrs,  # (N, L)
    k: int,
    alpha: float = 1.0,
    mode: str = "auto",
    score_chunk: int = 16384,
    topk_shards: int = 1,
) -> tuple[Tensor, Tensor]:
    """Exact top-k of every item under the fused AUTO metric: (sq-dists
    (B, k) ascending, ids (B, k) int32), ties to the lower id.

    The scores come from ``brute_fused_sqdist`` in one call; the kernel
    tiles N itself, so ``score_chunk`` is accepted and not used.
    ``topk_shards > 1`` (when it divides N) takes each shard's k best, then
    the k best of the shards·k survivors, as the reference's two-stage
    merge does; on ties both keep the lower shard-major position.
    """
    dev = user_vec.device
    qv = to_tensor(user_vec, torch.float32, dev)
    scores = brute_fused_sqdist(
        qv, to_tensor(user_attrs, torch.int32, dev), to_tensor(item_embs, torch.float32, dev),
        to_tensor(item_attrs, torch.int32, dev), MetricConfig(mode=mode, alpha=alpha),
    )
    b, n = scores.shape
    if topk_shards > 1 and n % topk_shards == 0:
        chunk = n // topk_shards
        vals_l, idx_l = smallest_k(scores.reshape(b, topk_shards, chunk), k)
        offsets = torch.arange(topk_shards, dtype=idx_l.dtype, device=dev) * chunk
        gidx = (idx_l + offsets[None, :, None]).reshape(b, -1)
        vals, take = smallest_k(vals_l.reshape(b, -1), k)
        return vals, gidx.gather(1, take).to(torch.int32)
    vals, idx = smallest_k(scores, k)
    return vals, idx.to(torch.int32)


def retrieval_step(
    cfg: RecsysConfig,
    params: dict,
    batch: dict,
    item_embs,
    item_attrs,
    k: int = 100,
    alpha: float = 1.0,
    score_chunk: int = 16384,
    topk_shards: int = 1,
) -> tuple[Tensor, Tensor]:
    u = user_tower(cfg, params, batch)
    return hybrid_retrieval_topk(
        u, batch["query_attrs"], item_embs, item_attrs, k, alpha,
        score_chunk=score_chunk, topk_shards=topk_shards,
    )
