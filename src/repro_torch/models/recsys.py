"""RecSys family: DLRM, xDeepFM (CIN), BERT4Rec and FM on an EmbeddingBag
substrate, with a hybrid-retrieval head that routes the ``retrieval_cand``
shape through the paper's STABLE scorer.

Tables are stacked (F, V, D) and looked up with one gather over the
flattened (F·V, D) table; multi-hot bags reduce over their hot axis and
ragged bags sum with ``index_add_``. The FM forward's second-order term
runs the ``fm_interaction`` kernel on the card, through an autograd
``Function`` whose backward is plain PyTorch. The dlrm, xdeepfm and
bert4rec forwards compute nothing inside a Pallas kernel in the reference
(MLPs, einsums, a CIN and a two-block encoder), so they are plain PyTorch
here, in the compute dtype of ``cfg.precision`` as the reference computes
them. The retrieval head scores one user (or a batch) against every
candidate with the fused AUTO metric (``core.auto.brute_fused_sqdist``, the
``fused_auto`` kernel on the card) and keeps an exact top-k, in one stage or
as a two-stage merge over shards of the candidate axis.

Training: ``loss_fn`` (BCE on the CTR logits; bert4rec's shared-negative
sampled softmax, ``bert4rec_sampled_loss``) under autograd. The tables'
gradients are dense, as the reference's are: ``index_select``'s backward
adds into a zero (F·V, D) table, and the optimizer decays every row.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core import resolve_device, to_tensor
from repro_torch.core.auto import MetricConfig, brute_fused_sqdist
from repro_torch.core.graph_ops import largest_k, smallest_k
from repro_torch.kernels.fm_interaction.ops import fm_interaction
from repro_torch.models import common
from repro_torch.models.common import MIXED, Precision

Tensor = torch.Tensor

KINDS = ("dlrm", "xdeepfm", "bert4rec", "fm")

#: elements of one row block's CIN outer product (B_blk, H·F, D): 1 GiB in
#: bf16. At the xdeepfm widths (H = 200, F = 39, D = 10) that is 6,882 rows;
#: the reference's unblocked (262,144, 7,800, 10) bf16 product at serve_bulk
#: would take 40.9 GB a layer.
CIN_BLOCK_ELEMS = 1 << 29


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


def _unknown(kind: str) -> ValueError:
    return ValueError(f"unknown recsys kind {kind!r}; have {KINDS}")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def param_shapes(cfg: RecsysConfig) -> dict:
    """Shape of every parameter, nested as the reference's ``init_params``
    (and ``_bert_blocks_init``) nest them, key for key."""
    f, v, d = cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim
    if cfg.kind == "bert4rec":
        nb = cfg.n_blocks
        sq = (nb, d, d)
        return {
            "item_embed": (cfg.n_items, d),
            "pos_embed": (cfg.seq_len, d),
            "blocks": {"wq": sq, "wk": sq, "wv": sq, "wo": sq,
                       "w1": (nb, d, 4 * d), "w2": (nb, 4 * d, d),
                       "b1": (nb, 4 * d), "b2": (nb, d), "ln1": (nb, d), "ln2": (nb, d)},
            "final_ln_w": (d,),
            "final_ln_b": (d,),
        }
    p = {"tables": (f, v, d)}
    if cfg.kind == "dlrm":
        n_int = (f + 1) * f // 2  # pairwise dots incl. the bottom MLP's output
        p["bot"] = common.mlp_param_shapes([cfg.n_dense, *cfg.bot_mlp])
        p["top"] = common.mlp_param_shapes([cfg.bot_mlp[-1] + n_int, *cfg.top_mlp])
    elif cfg.kind == "xdeepfm":
        hs = [f, *cfg.cin_layers]
        p["cin"] = {f"w{i}": (hs[i] * f, hs[i + 1]) for i in range(len(cfg.cin_layers))}
        p["cin_out"] = (sum(cfg.cin_layers), 1)
        p["dnn"] = common.mlp_param_shapes([f * d, *cfg.mlp, 1])
        p["linear"] = (f, v)
    elif cfg.kind == "fm":
        p["linear"] = (f, v)
        p["bias"] = ()
    else:
        raise _unknown(cfg.kind)
    return p


def abstract_params(cfg: RecsysConfig) -> dict:
    """The parameters on ``torch.device("meta")``: shapes and dtypes, no
    memory (the counterpart of ``jax.eval_shape``)."""
    return common.meta_tree(param_shapes(cfg), cfg.precision.param_dtype)


def init_params(cfg: RecsysConfig, seed: int = 0, device=None) -> dict:
    """Random parameters drawn on ``device`` (the card by default) from a
    ``torch.Generator`` seeded with ``seed``, at the reference's scales:
    tables and linear weights N(0, 1)·0.01, dense layers uniform on
    ±1/√fan_in, item and position embeddings N(0, 1)·0.02, biases 0, norm
    weights 1. As in the reference, bert4rec's blocks start equal (one draw
    a weight, stacked). The draws differ from ``jax.random``'s; tests hand
    the reference's parameters across with ``params_from_numpy``."""
    shapes = param_shapes(cfg)
    dev = resolve_device(device)
    pd = cfg.precision.param_dtype
    g = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.embed_dim
    if cfg.kind == "bert4rec":
        nb = cfg.n_blocks

        def stack(i, o):
            return common.dense_init(g, i, o, pd)[None].repeat(nb, 1, 1)

        blocks = {"wq": stack(d, d), "wk": stack(d, d), "wv": stack(d, d), "wo": stack(d, d),
                  "w1": stack(d, 4 * d), "w2": stack(4 * d, d)}
        blocks |= {k: torch.zeros(shapes["blocks"][k], dtype=pd, device=dev)
                   for k in ("b1", "b2")}
        blocks |= {k: torch.ones(shapes["blocks"][k], dtype=pd, device=dev)
                   for k in ("ln1", "ln2")}
        return {
            "item_embed": common.embed_init(g, cfg.n_items, d, pd),
            "pos_embed": common.embed_init(g, cfg.seq_len, d, pd),
            "blocks": blocks,
            "final_ln_w": torch.ones((d,), dtype=pd, device=dev),
            "final_ln_b": torch.zeros((d,), dtype=pd, device=dev),
        }

    def normal(shape):
        return torch.randn(shape, generator=g, dtype=pd, device=dev).mul_(0.01)

    p = {"tables": normal(shapes["tables"])}
    f = cfg.n_sparse
    if cfg.kind == "dlrm":
        n_int = (f + 1) * f // 2
        p["bot"] = common.mlp_params(g, [cfg.n_dense, *cfg.bot_mlp], pd)
        p["top"] = common.mlp_params(g, [cfg.bot_mlp[-1] + n_int, *cfg.top_mlp], pd)
    elif cfg.kind == "xdeepfm":
        p["cin"] = {k: common.dense_init(g, *s, pd) for k, s in shapes["cin"].items()}
        p["cin_out"] = common.dense_init(g, *shapes["cin_out"], pd)
        p["dnn"] = common.mlp_params(g, [f * d, *cfg.mlp, 1], pd)
        p["linear"] = normal(shapes["linear"])
    else:  # fm
        p["linear"] = normal(shapes["linear"])
        p["bias"] = torch.zeros((), dtype=pd, device=dev)
    return p


def params_from_numpy(cfg: RecsysConfig, tree: dict, device=None) -> dict:
    """The reference's nested parameter dict (numpy or array-likes) as the
    port's tensors on ``device``; every key and shape is checked."""
    return common.tree_from_numpy(param_shapes(cfg), tree, cfg.precision.param_dtype,
                                  resolve_device(device), f"kind {cfg.kind!r}")


def model_flops(cfg: RecsysConfig, cell) -> float:
    """The analytic dense FLOPs of the reference's ``build_cell`` for one
    step of ``cell`` (a ``ShapeCell``): a copy of ``launch/build.py``'s
    count. Embedding rows are lookups and count no FLOPs; bert4rec counts
    its encoder, not the scoring of every item; a retrieval step counts
    2·N·(D + L)."""
    if cell.kind == "retrieval":
        return 2.0 * cell.n_candidates * (cfg.embed_dim + cfg.n_attr_dims)
    if cfg.kind == "bert4rec":
        per_ex = 2 * (cfg.seq_len * (12 * cfg.embed_dim**2 * cfg.n_blocks)
                      + cfg.seq_len**2 * cfg.embed_dim * 2 * cfg.n_blocks)
    elif cfg.kind == "dlrm":
        dims = [cfg.n_dense, *cfg.bot_mlp]
        mlps = sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        n_int = (cfg.n_sparse + 1) * cfg.n_sparse // 2
        dims = [cfg.bot_mlp[-1] + n_int, *cfg.top_mlp]
        mlps += sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        per_ex = mlps + 2 * (cfg.n_sparse + 1) ** 2 * cfg.embed_dim
    elif cfg.kind == "xdeepfm":
        f0, d0 = cfg.n_sparse, cfg.embed_dim
        hs = [f0, *cfg.cin_layers]
        cin = sum(2 * hs[i] * f0 * hs[i + 1] * d0 for i in range(len(cfg.cin_layers)))
        dims = [f0 * d0, *cfg.mlp, 1]
        per_ex = cin + sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    elif cfg.kind == "fm":  # the sum-square trick
        per_ex = 4 * cfg.n_sparse * cfg.embed_dim
    else:
        raise _unknown(cfg.kind)
    return (3.0 if cell.kind == "train" else 1.0) * per_ex * cell.global_batch


# ---------------------------------------------------------------------------
# EmbeddingBag substrate
# ---------------------------------------------------------------------------


def _wrap_ids(ids, vocab: int, device) -> Tensor:
    """ids as int64 in [0, V): negative ids wrap (id + V), as ``jnp.take``
    does. An id outside [−V, V) raises ``IndexError``: the reference's
    ``jnp.take`` fills such a row with NaN, and an unchecked flat gather
    would read another field's row. The check reads the ids' min and max,
    one synchronisation on the card; meta ids (the dry run) have none to
    read and skip it."""
    ids = to_tensor(ids, torch.int64, device)
    if ids.numel() and not ids.is_meta:
        lo, hi = torch.aminmax(ids)
        if int(lo) < -vocab or int(hi) >= vocab:
            raise IndexError(
                f"ids must lie in [-{vocab}, {vocab}), got [{int(lo)}, {int(hi)}]"
            )
    return torch.where(ids < 0, ids + vocab, ids)


def _flat_ids(ids, n_fields: int, vocab: int, device) -> Tensor:
    """(B, F, ...) ids as int64 rows of the flattened (F·V, ...) table."""
    ids = to_tensor(ids, torch.int64, device)
    if ids.ndim < 2 or ids.shape[1] != n_fields:
        raise ValueError(f"ids must be (B, {n_fields}, ...), got {tuple(ids.shape)}")
    offsets = torch.arange(n_fields, dtype=torch.int64, device=device) * vocab
    return _wrap_ids(ids, vocab, device) + offsets.reshape(n_fields, *[1] * (ids.ndim - 2))


def _gather(table: Tensor, flat: Tensor) -> Tensor:
    """Rows ``flat`` (B, F, ...) of ``table`` (F, V, ...) → (B, F, ..., ...)."""
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


def embedding_bag(tables: Tensor, ids, mask=None, mode: str = "sum") -> Tensor:
    """Multi-hot bags: tables (F, V, D), ids (B, F, NNZ) → (B, F, D), the
    sum, mean or max over each bag's NNZ rows, weighted by ``mask``
    (B, F, NNZ) where given (max: the rows where it is nonzero; mean
    divides by the mask's sum, at least 1). Ids follow
    ``embedding_lookup``'s rule."""
    if mode not in ("sum", "mean", "max"):
        raise ValueError(mode)
    f, v = tables.shape[:2]
    dev = tables.device
    flat = _flat_ids(ids, f, v, dev)
    if flat.ndim != 3:
        raise ValueError(f"ids must be (B, {f}, NNZ), got {tuple(flat.shape)}")
    g = _gather(tables, flat)  # (B, F, NNZ, D)
    m = None
    if mask is not None:
        m = to_tensor(mask, g.dtype, dev)
        if m.shape != flat.shape:
            raise ValueError(f"mask must be {tuple(flat.shape)}, got {tuple(m.shape)}")
        g = g * m[..., None]
    if mode == "sum":
        return g.sum(2)
    if mode == "mean":
        denom = (m.sum(2)[..., None] if m is not None
                 else torch.tensor(flat.shape[2], dtype=g.dtype, device=dev))
        return g.sum(2) / denom.clamp_min(1.0)
    if m is not None:
        g = torch.where(m[..., None] != 0, g, torch.tensor(-math.inf, dtype=g.dtype, device=dev))
    return g.amax(2)


def embedding_bag_ragged(table: Tensor, flat_ids, bag_ids, n_bags: int) -> Tensor:
    """Ragged bags: table (V, D), flat_ids (T,), bag_ids (T,) → (n_bags, D),
    the sum of each bag's rows (``index_add_``). Ids follow
    ``embedding_lookup``'s rule; a bag id outside [0, n_bags) drops its
    row, as ``segment_sum`` does."""
    dev = table.device
    rows = table.index_select(0, _wrap_ids(flat_ids, table.shape[0], dev).reshape(-1))
    bags = to_tensor(bag_ids, torch.int64, dev).reshape(-1)
    if bags.shape[0] != rows.shape[0]:
        raise ValueError(f"{bags.shape[0]} bag ids for {rows.shape[0]} ids")
    bags = torch.where((bags >= 0) & (bags < n_bags), bags, n_bags)  # the last row drops
    out = torch.zeros((n_bags + 1, *table.shape[1:]), dtype=table.dtype, device=dev)
    return out.index_add_(0, bags, rows)[:n_bags]


# ---------------------------------------------------------------------------
# Forward per kind
# ---------------------------------------------------------------------------


def _dlrm_forward(cfg: RecsysConfig, p: dict, batch: dict) -> Tensor:
    """Logits (B,) in the compute dtype (bf16 under ``MIXED``), as the
    reference returns them: the bottom MLP on ``dense``, the dot
    interaction over [bot; emb] (the F(F+1)/2 pairs above the diagonal, in
    ``jnp.triu_indices``' row-major order), then the top MLP."""
    cdt = cfg.precision.compute_dtype
    tables = p["tables"]
    dev = tables.device
    dense = to_tensor(batch["dense"], torch.float32, dev).to(cdt)  # (B, 13)
    emb = embedding_lookup(tables, batch["sparse"]).to(cdt)  # (B, F, D)
    bot = common.mlp_apply(p["bot"], dense)  # (B, D)
    z = torch.cat([bot[:, None, :], emb], dim=1)  # (B, F+1, D)
    gram = torch.matmul(z, z.transpose(1, 2))  # dot interaction
    f = z.shape[1]
    iu = torch.triu_indices(f, f, offset=1, device=dev)
    x = torch.cat([bot, gram[:, iu[0], iu[1]]], dim=-1)
    return common.mlp_apply(p["top"], x)[:, 0]


def _cin(cfg: RecsysConfig, p: dict, emb: Tensor, row_block: int | None = None) -> Tensor:
    """The CIN's sum-pools (B, Σ H_i) in ``emb``'s dtype. Each layer takes
    the outer product of the previous layer's maps with the field
    embeddings over (H·F) and mixes it down to H' maps (the reference's
    ``bhd,bfd->bhfd`` and ``bzd,zh->bhd``), laid out (B, D, H·F) so the
    mix is one product. Rows are independent, so the batch runs in row
    blocks of ``row_block`` rows (by default the most whose outer product
    holds ``CIN_BLOCK_ELEMS``): the product stays a few GB on the card."""
    b, f0, d = emb.shape
    ws = [p["cin"][f"w{i}"].to(emb.dtype) for i in range(len(cfg.cin_layers))]
    if row_block is None:
        widest = max([f0, *cfg.cin_layers[:-1]]) * f0 * d
        row_block = max(1, CIN_BLOCK_ELEMS // widest)
    x0_all = emb.transpose(1, 2)  # (B, D, F)
    pools = []
    for r0 in range(0, b, row_block):
        x0 = x0_all[r0:r0 + row_block]
        xk, parts = x0, []
        for w in ws:
            rb, _, h = xk.shape
            z = (xk[:, :, :, None] * x0[:, :, None, :]).reshape(rb * d, h * f0)
            xk = (z @ w).reshape(rb, d, w.shape[1])  # 1×1 conv ≡ field-mix matmul
            parts.append(xk.sum(1))  # sum-pool over D
        pools.append(torch.cat(parts, dim=-1))
    return torch.cat(pools, dim=0)


def _xdeepfm_forward(cfg: RecsysConfig, p: dict, batch: dict) -> Tensor:
    """Logits (B,) f32: the CIN's logit and the DNN's in the compute dtype,
    plus the f32 linear term summed over fields."""
    cdt = cfg.precision.compute_dtype
    tables = p["tables"]
    f, v = tables.shape[:2]
    flat = _flat_ids(batch["sparse"], f, v, tables.device)
    emb = _gather(tables, flat).to(cdt)  # (B, F0, D)
    cin_logit = _cin(cfg, p, emb) @ p["cin_out"].to(cdt)
    dnn_logit = common.mlp_apply(p["dnn"], emb.reshape(emb.shape[0], -1))
    lin = _sum_fields(_gather(p["linear"], flat))
    return (cin_logit[:, 0] + dnn_logit[:, 0] + lin.float()).float()


def _fm_forward(cfg: RecsysConfig, p: dict, batch: dict) -> Tensor:
    tables = p["tables"]
    f, v = tables.shape[:2]
    flat = _flat_ids(batch["sparse"], f, v, tables.device)
    emb = _gather(tables, flat)  # (B, F, D)
    second = fm_interaction(emb.to(torch.float32))  # (B,)
    lin = _sum_fields(_gather(p["linear"], flat))  # (B,)
    return second + lin.to(torch.float32) + p["bias"].to(torch.float32)


def _encode(cfg: RecsysConfig, p: dict, ids: Tensor) -> Tensor:
    """Checked ids (B, S) → hidden (B, S, D) in the compute dtype: the
    position embedding added before the cast, then each stacked block
    (pre-norm attention and a tanh-GELU MLP, block norms without bias),
    then the final layer norm."""
    cdt = cfg.precision.compute_dtype
    b, s = ids.shape
    d, nh = cfg.embed_dim, cfg.n_heads
    dh = d // nh
    x = (p["item_embed"].index_select(0, ids.reshape(-1)).reshape(b, s, d)
         + p["pos_embed"][None, :s]).to(cdt)
    blocks = p["blocks"]
    for li in range(blocks["wq"].shape[0]):
        lp = {k: t[li] for k, t in blocks.items()}
        y = common.layer_norm(x, lp["ln1"], torch.zeros_like(lp["ln1"]))
        q, k, v = ((y @ lp[w].to(cdt)).reshape(b, s, nh, dh).transpose(1, 2)
                   for w in ("wq", "wk", "wv"))  # (B, H, S, dh)
        scores = torch.matmul(q, k.transpose(2, 3)).float()
        probs = torch.softmax(scores / math.sqrt(dh), dim=-1).to(cdt)
        o = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, d)
        x = x + o @ lp["wo"].to(cdt)
        y = common.layer_norm(x, lp["ln2"], torch.zeros_like(lp["ln2"]))
        y = F.gelu(y @ lp["w1"].to(cdt) + lp["b1"].to(cdt), approximate="tanh")
        x = x + (y @ lp["w2"].to(cdt) + lp["b2"].to(cdt))
    return common.layer_norm(x, p["final_ln_w"], p["final_ln_b"])


def _item_ids(p: dict, items) -> Tensor:
    emb = p["item_embed"]
    ids = _wrap_ids(items, emb.shape[0], emb.device)
    if ids.ndim != 2:
        raise ValueError(f"items must be (B, S), got {tuple(ids.shape)}")
    if ids.shape[1] > p["pos_embed"].shape[0]:
        raise ValueError(f"sequence of {ids.shape[1]} items is longer than seq_len "
                         f"{p['pos_embed'].shape[0]}")
    return ids


def _bert4rec_encode(cfg: RecsysConfig, p: dict, items) -> Tensor:
    """items (B, S) → hidden (B, S, D); bidirectional encoder. Item ids
    follow ``embedding_lookup``'s rule; S > seq_len raises ``ValueError``."""
    return _encode(cfg, p, _item_ids(p, items))


def _bert4rec_forward(cfg: RecsysConfig, p: dict, batch: dict) -> Tensor:
    """Masked-item logits at every position: (B, S, n_items) f32."""
    h = _bert4rec_encode(cfg, p, batch["items"])
    return h.float() @ p["item_embed"].float().T


def bert4rec_sampled_loss(cfg: RecsysConfig, p: dict, batch: dict) -> Tensor:
    """Masked-item prediction with a sampled softmax over shared negatives:
    the mean over (B, P) masked positions of logsumexp([s_true, s_neg]) −
    s_true, in f32. batch: items (B, S), masked_pos (B, P) (positions in
    [−S, S), negative ones wrap), labels (B, P) and neg_ids (N_neg,) item
    ids (``embedding_lookup``'s rule)."""
    h = _bert4rec_encode(cfg, p, batch["items"]).float()  # (B, S, D)
    dev = h.device
    pos = _wrap_ids(batch["masked_pos"], h.shape[1], dev)
    if pos.ndim != 2 or pos.shape[0] != h.shape[0]:
        raise ValueError(f"masked_pos must be ({h.shape[0]}, P), got {tuple(pos.shape)}")
    hm = h.gather(1, pos[..., None].expand(-1, -1, h.shape[2]))  # (B, P, D)
    emb = p["item_embed"].float()
    labels = _wrap_ids(batch["labels"], emb.shape[0], dev)
    e_true = emb.index_select(0, labels.reshape(-1)).reshape(*labels.shape, emb.shape[1])
    e_neg = emb.index_select(0, _wrap_ids(batch["neg_ids"], emb.shape[0], dev).reshape(-1))
    s_true = (hm * e_true).sum(-1)  # (B, P)
    s_neg = hm @ e_neg.T  # (B, P, N_neg)
    all_s = torch.cat([s_true[..., None], s_neg], dim=-1)
    return (torch.logsumexp(all_s, dim=-1) - s_true).mean()


def bert4rec_serve_topk(cfg: RecsysConfig, p: dict, items, k: int = 100,
                        batch_chunk: int = 4096) -> tuple[Tensor, Tensor]:
    """Next-item top-k for a batch of histories: (scores (B, k) f32
    descending, ids (B, k) int32), ties to the lower id as ``lax.top_k``
    keeps them. The batch runs in chunks of ``batch_chunk`` histories (the
    last zero-padded, as the reference pads it), so the (chunk, n_items)
    score block stays bounded; each chunk's last-position encodings score
    every item in f32 and ``graph_ops.largest_k`` keeps the k best."""
    ids = _item_ids(p, items)
    b = ids.shape[0]
    emb_t = p["item_embed"].float().T  # (D, I)
    chunk = min(batch_chunk, b)
    n_chunks = -(-b // chunk)
    ids = F.pad(ids, (0, 0, 0, n_chunks * chunk - b))
    tops, idxs = [], []
    for c in range(n_chunks):
        h = _encode(cfg, p, ids[c * chunk:(c + 1) * chunk])[:, -1].float()  # (c, D)
        top, idx = largest_k(h @ emb_t, k)
        tops.append(top)
        idxs.append(idx)
    return torch.cat(tops)[:b], torch.cat(idxs)[:b].to(torch.int32)


def forward(cfg: RecsysConfig, params: dict, batch: dict) -> Tensor:
    """Logits of each kind: (B,) CTR logits (f32; dlrm in the compute
    dtype, as the reference), bert4rec (B, S, n_items) f32."""
    if cfg.kind == "dlrm":
        return _dlrm_forward(cfg, params, batch)
    if cfg.kind == "xdeepfm":
        return _xdeepfm_forward(cfg, params, batch)
    if cfg.kind == "fm":
        return _fm_forward(cfg, params, batch)
    if cfg.kind == "bert4rec":
        return _bert4rec_forward(cfg, params, batch)
    raise _unknown(cfg.kind)


def loss_fn(cfg: RecsysConfig, params: dict, batch: dict) -> Tensor:
    """The training loss, a 0-d f32 tensor: bert4rec's sampled softmax, or
    the BCE of the CTR logits against ``batch["labels"]`` (B,)."""
    if cfg.kind == "bert4rec":
        return bert4rec_sampled_loss(cfg, params, batch)
    logits = forward(cfg, params, batch)
    return common.bce_with_logits(logits, to_tensor(batch["labels"], torch.float32,
                                                    logits.device))


# ---------------------------------------------------------------------------
# Hybrid retrieval head (retrieval_cand → STABLE scorer)
# ---------------------------------------------------------------------------


def user_tower(cfg: RecsysConfig, params: dict, batch: dict) -> Tensor:
    """(B, D) f32 user embedding for factorized retrieval: bert4rec's
    last-position encoding; otherwise the sum of the user's field
    embeddings (the FM-style user factor), plus the bottom MLP on
    ``dense`` for dlrm."""
    if cfg.kind == "bert4rec":
        return _bert4rec_encode(cfg, params, batch["items"])[:, -1].float()
    if cfg.kind not in KINDS:
        raise _unknown(cfg.kind)
    tables = params["tables"]
    vec = _sum_fields(embedding_lookup(tables, batch["sparse"]).float())
    if cfg.kind == "dlrm":
        dense = to_tensor(batch["dense"], torch.float32, tables.device)
        vec = vec + common.mlp_apply(params["bot"], dense)
    return vec


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
