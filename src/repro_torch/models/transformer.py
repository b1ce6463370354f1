"""LM transformer family: dense (GQA, RoPE, SwiGLU, sliding window) and MoE
variants from one config class, for serving: the full ``forward`` and
``loss_fn``, prefill (``forward_last``) and one-token ``decode_step``
against a KV cache.

Covers the five LM architectures of the reference (mistral-large-123b,
yi-34b, phi3-mini-3.8b, kimi-k2-1t-a32b, mixtral-8x7b) at its semantics,
rounding for rounding where the two frameworks allow:

  * layers stacked on a leading L axis, run by a Python loop over views;
  * q-chunked attention: each chunk's (chunk, keys) score block is formed
    alone, never the (S, S) one. The score product of bf16 operands is
    rounded to bf16, then cast to f32, divided by √dh, masked with −1e30
    and softmaxed in f32. Sliding-window attention is banded: each chunk
    sees only its (window + chunk) slice of the keys;
  * MoE: token-choice top-k with static capacity and dropping. The
    assignments rank within their expert in token-major order; the
    dispatch is a row copy into (E·C + 1, d) rows (the last one takes the
    dropped), the experts one batched product, the combine a sum over each
    token's k rows;
  * decode with a cache updated in place (the reference donates it), a
    rolling one of ``min(max_len, window)`` rows for the SWA archs. Its
    length and slot stay on the device: a step never waits for the host.

With ``cfg.remat`` set and grad enabled, each layer runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` with
``nothing_saveable``): the backward recomputes one layer's activations at a
time, and no value changes. The stacked layer parameters are unbound once
per forward, so a gradient reaches them as one stack of the L slices.

Nothing here launches a hand-written kernel: the reference computes these
layers in plain ``jnp``, not in Pallas. The sharding fields of the config
(``act_*`` and ``moe_*``) are the reference's ``with_sharding_constraint``
hints, which move data between devices and never change a value; in one
process they change nothing. ``launch.build.build_cell`` sets them as the
reference's does. ``unroll_*`` change no result here either.
Parameters are nested dicts of tensors; the reference's cross with
``params_from_numpy``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import resolve_device
from repro_torch.models import common
from repro_torch.models.common import MIXED, Precision

Tensor = torch.Tensor

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    moe: Optional[MoEConfig] = None
    sliding_window: Optional[int] = None
    rope_theta: float = 10_000.0
    precision: Precision = MIXED
    remat: bool = True
    q_chunk: int = 512
    z_loss: float = 1e-4
    # the reference's sequence-parallel activation sharding (the residual
    # stream's mesh axes): layout only, no value changes
    act_dp_axes: Optional[tuple] = None
    act_seq_axis: Optional[str] = None
    # the reference's dry-run FLOP counting unrolls its scans; a Python loop
    # here, so these change nothing
    unroll_attn: bool = False
    unroll_layers: bool = False
    # the reference's MoE buffer shardings: layout only, no value changes
    moe_expert_axis: Optional[str] = None
    moe_capacity_axes: Optional[tuple] = None
    moe_ff_axis: Optional[str] = None

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def param_count(self) -> int:
        d, ff, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head + (
            self.n_heads * self.d_head * d
        )
        if self.moe:
            ffn = self.moe.n_experts * 3 * d * self.moe.d_ff_expert + d * self.moe.n_experts
        else:
            ffn = 3 * d * ff
        return L * (attn + ffn + 2 * d) + 2 * v * d + d

    @property
    def active_param_count(self) -> int:
        """Activated parameters per token (MoE counts top-k experts only)."""
        if not self.moe:
            return self.param_count
        d, L = self.d_model, self.n_layers
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head + (
            self.n_heads * self.d_head * d
        )
        ffn = self.moe.top_k * 3 * d * self.moe.d_ff_expert + d * self.moe.n_experts
        return L * (attn + ffn + 2 * d) + 2 * self.vocab * d + d


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def param_shapes(cfg: TransformerConfig) -> dict:
    """Shape of every parameter, nested as the reference's ``init_params``
    nests them, key for key; the layers stacked on a leading L axis."""
    d, dh, H, KV, L = cfg.d_model, cfg.d_head, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    attn = {"wq": (L, d, H * dh), "wk": (L, d, KV * dh), "wv": (L, d, KV * dh),
            "wo": (L, H * dh, d)}
    if cfg.moe:
        E, ffe = cfg.moe.n_experts, cfg.moe.d_ff_expert
        ffn = {"router": (L, d, E), "w1": (L, E, d, ffe), "w3": (L, E, d, ffe),
               "w2": (L, E, ffe, d)}
    else:
        ffn = {"w1": (L, d, cfg.d_ff), "w3": (L, d, cfg.d_ff), "w2": (L, cfg.d_ff, d)}
    return {
        "embed": (cfg.vocab, d),
        "layers": {"ln1": (L, d), "ln2": (L, d), "attn": attn, "ffn": ffn},
        "final_ln": (d,),
        "lm_head": (d, cfg.vocab),
    }


def abstract_params(cfg: TransformerConfig) -> dict:
    """The parameters on ``torch.device("meta")``: shapes and dtypes, no
    memory (the counterpart of ``jax.eval_shape``)."""
    return common.meta_tree(param_shapes(cfg), cfg.precision.param_dtype)


def init_params(cfg: TransformerConfig, seed: int = 0, device=None) -> dict:
    """Random parameters drawn on ``device`` (the card by default) from a
    ``torch.Generator`` seeded with ``seed``, at the reference's scales: the
    stacked 2-D weights N(0, 1)·0.02/√fan_in; the MoE ``w1``/``w3``
    N(0, 1)/√d, ``w2`` N(0, 1)/√d_ff_expert, ``router`` N(0, 1)·0.02;
    ``embed`` and ``lm_head`` as ``common.embed_init`` and
    ``common.dense_init``; the norms ones. The draws differ from
    ``jax.random``'s; tests hand the reference's parameters across with
    ``params_from_numpy``."""
    shapes = param_shapes(cfg)
    dev = resolve_device(device)
    pd = cfg.precision.param_dtype
    g = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, scale: float) -> Tensor:
        return torch.randn(shape, generator=g, dtype=pd, device=dev).mul_(scale)

    layers = shapes["layers"]
    attn = {k: normal(s, 0.02 / math.sqrt(s[1])) for k, s in layers["attn"].items()}
    if cfg.moe:
        fs = layers["ffn"]
        ffn = {"router": normal(fs["router"], 0.02),
               "w1": normal(fs["w1"], 1.0 / math.sqrt(cfg.d_model)),
               "w3": normal(fs["w3"], 1.0 / math.sqrt(cfg.d_model)),
               "w2": normal(fs["w2"], 1.0 / math.sqrt(cfg.moe.d_ff_expert))}
    else:
        ffn = {k: normal(s, 0.02 / math.sqrt(s[1])) for k, s in layers["ffn"].items()}
    return {
        "embed": common.embed_init(g, cfg.vocab, cfg.d_model, pd),
        "layers": {
            "ln1": torch.ones(layers["ln1"], dtype=pd, device=dev),
            "ln2": torch.ones(layers["ln2"], dtype=pd, device=dev),
            "attn": attn,
            "ffn": ffn,
        },
        "final_ln": torch.ones(shapes["final_ln"], dtype=pd, device=dev),
        "lm_head": common.dense_init(g, cfg.d_model, cfg.vocab, pd),
    }


def params_from_numpy(cfg: TransformerConfig, tree: dict, device=None) -> dict:
    """The reference's nested parameter dict (numpy or array-likes) as the
    port's tensors on ``device``; every key and shape is checked."""
    return common.tree_from_numpy(param_shapes(cfg), tree, cfg.precision.param_dtype,
                                  resolve_device(device), f"config {cfg.name!r}")


def model_flops(cfg: TransformerConfig, cell) -> float:
    """The reference's ``build_cell`` count for one step of ``cell`` (a
    ``ShapeCell``): 6 (train) or 2 (prefill, decode) · active parameters ·
    tokens, the embedding and head included, attention's quadratic term
    left out by the usual convention. A decode step is one token a
    sequence."""
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    passes = 6.0 if cell.kind == "train" else 2.0
    return passes * cfg.active_param_count * tokens


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., S, H, dh); positions: (..., S). The angles in f32; a bf16
    ``x`` times them promotes to f32, as in the reference, and the result
    is cast back to ``x``'s dtype."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (q-chunked; banded for sliding window)
# ---------------------------------------------------------------------------


def _softmax_scores(s: Tensor, dh: int, mask: Tensor, dtype: torch.dtype) -> Tensor:
    """The reference's order on a score product ``s``: to f32, / √dh,
    −1e30 where ``mask`` is false (padded rows stay finite), softmax in f32,
    cast to ``dtype``."""
    s = s.float().div_(math.sqrt(dh))
    s.masked_fill_(~mask, -1e30)
    return torch.softmax(s, dim=-1).to(dtype)


def _attend(q: Tensor, k: Tensor, v: Tensor, mask: Tensor) -> Tensor:
    """q (B,Sq,KV,G,dh), k/v (B,KV,Sk,dh), mask (Sq,Sk) → (B,Sq,KV,G,dh).
    Each kv head's G query heads are one (G·Sq, dh) operand of one batched
    product over (B, KV)."""
    b, sq, kvh, g, dh = q.shape
    qm = q.permute(0, 2, 3, 1, 4).reshape(b, kvh, g * sq, dh)
    s = torch.matmul(qm, k.transpose(-1, -2)).view(b, kvh, g, sq, -1)
    p = _softmax_scores(s, dh, mask, v.dtype).view(b, kvh, g * sq, -1)
    return torch.matmul(p, v).view(b, kvh, g, sq, dh).permute(0, 3, 1, 2, 4)


def attention(
    cfg: TransformerConfig, q: Tensor, k: Tensor, v: Tensor, causal: bool = True
) -> Tensor:
    """Full-sequence attention over q-chunks: q (B, S, KV, G, dh), k/v (B,
    S, KV, dh) → (B, S, KV, G, dh). S is padded up to a chunk multiple and
    the padded rows dropped. With a sliding window (and S above it) each
    chunk's keys are the (window + chunk) band ``[start − w, end)``,
    clipped into the sequence: sub-quadratic in S."""
    b, s = q.shape[:2]
    qc = min(cfg.q_chunk, s)
    n_chunks = (s + qc - 1) // qc
    s_orig = s
    if s % qc != 0:  # pad to a chunk multiple; padded rows are discarded
        pad = n_chunks * qc - s
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        s = q.shape[1]
    k = k.permute(0, 2, 1, 3).contiguous()  # (B, KV, S, dh)
    v = v.permute(0, 2, 1, 3).contiguous()
    dev = q.device
    w = cfg.sliding_window
    banded = w is not None and s > w
    band = min(w + qc, s) if banded else s
    out = torch.empty_like(q)
    for i in range(n_chunks):
        start = i * qc
        qpos = start + torch.arange(qc, device=dev)
        kv_start = min(max(start - w, 0), s - band) if banded else 0
        kpos = kv_start + torch.arange(band, device=dev)
        mask = (kpos < s_orig)[None, :]
        if banded:
            mask = mask & (qpos[:, None] >= kpos[None, :]) & (qpos[:, None] - kpos[None, :] < w)
        elif causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        out[:, start:start + qc] = _attend(
            q[:, start:start + qc], k[:, :, kv_start:kv_start + band],
            v[:, :, kv_start:kv_start + band], mask)
    return out[:, :s_orig]


# ---------------------------------------------------------------------------
# FFN: dense SwiGLU & token-choice MoE
# ---------------------------------------------------------------------------


def _silu(x: Tensor) -> Tensor:
    """``x · sigmoid(x)``, each op rounded to ``x``'s dtype as the
    reference's ``jax.nn.silu`` is."""
    return x * torch.sigmoid(x)


def swiglu(x: Tensor, w1: Tensor, w3: Tensor, w2: Tensor) -> Tensor:
    h = _silu(x @ w1) * (x @ w3)
    return h @ w2


def _rank_within_expert(expert_ids: Tensor, n_experts: int) -> Tensor:
    """Position of each assignment within its expert: an exclusive prefix
    count of a one-hot over the assignments in their order."""
    onehot = (expert_ids[:, None] == torch.arange(n_experts, device=expert_ids.device)).to(
        torch.int32)
    ranks = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    return ranks.gather(1, expert_ids[:, None].long())[:, 0]


def moe_ffn(cfg: TransformerConfig, x: Tensor, p: dict, stats: Optional[dict] = None) -> Tensor:
    """Token-choice top-k MoE with static capacity and dropping.

    x: (T, d) flattened tokens. Each token's k experts come from its f32
    router logits; their weights are a softmax over the k. An assignment
    ranks within its expert in token-major order and is kept when its rank
    is below the capacity C = max(⌈T·k·cf/E⌉, 1). Kept rows are copied into
    (E, C, d) expert blocks (one batched SwiGLU), gathered back, weighted
    and summed over each token's k rows, all in ``x``'s dtype. With
    ``stats`` (a dict), adds the dropped assignments to
    ``stats["dropped"]`` (a device tensor) and their number to
    ``stats["assignments"]``, and appends the (T, E) f32 router logits to
    ``stats["router_logits"]`` (``unsettled_tokens`` reads them).
    """
    moe = cfg.moe
    t, d = x.shape
    e, k = moe.n_experts, moe.top_k
    cap = max(int(math.ceil(t * k * moe.capacity_factor / e)), 1)

    logits = x.float() @ p["router"].float()  # (T, E)
    # lax.top_k: descending, the lower expert first on a tie (a stable sort
    # of E ≤ a few hundred logits; nothing waits for the host)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_logits, top_e = vals[:, :k], idx[:, :k]  # (T, k)
    weights = torch.softmax(top_logits, dim=-1).to(x.dtype)

    flat_e = top_e.reshape(-1)  # (T·k,) token-major
    rank = _rank_within_expert(flat_e, e)
    keep = rank < cap
    flat_slot = torch.where(keep, flat_e * cap + rank, e * cap)  # row E·C ⇒ dropped
    if stats is not None:
        stats["dropped"] = stats.get("dropped", 0) + (~keep).sum()
        stats["assignments"] = stats.get("assignments", 0) + t * k
        stats.setdefault("router_logits", []).append(logits)

    # kept slots are unique; every dropped assignment lands in the spare row
    dispatch = x.new_zeros((e * cap + 1, d))
    slots = flat_slot.view(t, k)
    for j in range(k):
        dispatch.index_copy_(0, slots[:, j], x)
    dispatch = dispatch[: e * cap].view(e, cap, d)

    h = _silu(torch.bmm(dispatch, p["w1"].to(x.dtype)))
    h = h * torch.bmm(dispatch, p["w3"].to(x.dtype))
    y = torch.bmm(h, p["w2"].to(x.dtype)).view(e * cap, d)  # (E·C, d)
    del h, dispatch

    gathered = y[flat_slot.clamp(max=e * cap - 1)]
    gathered = torch.where(keep[:, None], gathered, 0.0) * weights.reshape(-1, 1)
    return gathered.view(t, k, d).sum(dim=1).to(x.dtype)


def unsettled_tokens(cfg: TransformerConfig, router_logits: list, eps: float) -> Tensor:
    """(T,) bool: the tokens whose MoE output may differ on another device,
    given one forward's router logits, a (T, E) f32 tensor for each MoE call
    in layer order (``moe_ffn``'s ``stats["router_logits"]``), if each
    logit may move there by less than ``eps``/2 (a rounding step of the
    bf16 input).

    A token may pick other experts where its k-th logit lies within
    ``eps`` of the next: an expert may enter its top k if its logit lies
    within ``eps`` of the k-th, and leave if within ``eps`` of the
    (k+1)-th. Every such move takes or frees a slot of its expert for the
    assignments after it (ranks count in token-major order), so a later
    token is unsettled too if that many moves could carry one of its ranks
    across the capacity. An unsettled token carries another input into
    the next layer, where any of its experts may move."""
    moe = cfg.moe
    e, k = moe.n_experts, moe.top_k
    bad = None
    for logits in router_logits:
        t = logits.shape[0]
        cap = max(int(math.ceil(t * k * moe.capacity_factor / e)), 1)
        vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        chose = torch.zeros_like(logits, dtype=torch.bool).scatter_(1, idx[:, :k], True)
        if k < e:
            may_in = ~chose & (logits > (vals[:, k - 1] - eps)[:, None])
            may_out = chose & (logits < (vals[:, k] + eps)[:, None])
        else:
            may_in = may_out = torch.zeros_like(chose)
        moved = may_in.any(dim=1)
        if bad is not None:
            moved = moved | bad
            may_in = may_in | (~chose & bad[:, None])
            may_out = may_out | (chose & bad[:, None])

        def earlier(m: Tensor) -> Tensor:  # moves by tokens before each token
            m = m.to(torch.int32)
            return (torch.cumsum(m, dim=0, dtype=torch.int32) - m).gather(1, idx[:, :k])

        rank = _rank_within_expert(idx[:, :k].reshape(-1), e).view(t, k)
        settled = torch.where(rank < cap, rank + earlier(may_in) < cap,
                              rank - earlier(may_out) >= cap).all(dim=1)
        bad = moved | ~settled
    return bad


# ---------------------------------------------------------------------------
# Blocks & full forward
# ---------------------------------------------------------------------------


def _layer(cfg: TransformerConfig, x: Tensor, lp: dict, positions: Tensor,
           stats: Optional[dict] = None) -> Tensor:
    b, s, d = x.shape
    dh, kv, g = cfg.d_head, cfg.n_kv_heads, cfg.q_per_kv
    cdt = cfg.precision.compute_dtype

    h = common.rms_norm(x, lp["ln1"])
    q = (h @ lp["attn"]["wq"].to(cdt)).view(b, s, kv * g, dh)
    k = (h @ lp["attn"]["wk"].to(cdt)).view(b, s, kv, dh)
    v = (h @ lp["attn"]["wv"].to(cdt)).view(b, s, kv, dh)
    q = rope(q, positions, cfg.rope_theta).view(b, s, kv, g, dh)  # heads kv-major
    k = rope(k, positions, cfg.rope_theta)
    o = attention(cfg, q, k, v, causal=True)
    x = x + o.reshape(b, s, kv * g * dh) @ lp["attn"]["wo"].to(cdt)

    h = common.rms_norm(x, lp["ln2"])
    if cfg.moe:
        y = moe_ffn(cfg, h.reshape(b * s, d), lp["ffn"], stats).view(b, s, d)
    else:
        f = lp["ffn"]
        y = swiglu(h, f["w1"].to(cdt), f["w3"].to(cdt), f["w2"].to(cdt))
    return x + y


def _remat_layer(cfg: TransformerConfig, x: Tensor, lp: dict, positions: Tensor,
                 once: list) -> Tensor:
    """``_layer`` with the MoE ``stats`` that ``once`` holds for its first
    call only: the backward's recompute must not record them again."""
    return _layer(cfg, x, lp, positions, once.pop() if once else None)


def _trunk(cfg: TransformerConfig, params: dict, tokens: Tensor,
           stats: Optional[dict]) -> Tensor:
    """tokens (B, S) → the last layer's output (B, S, d) in the compute
    dtype. With ``cfg.remat`` and grad enabled each layer is checkpointed:
    only its input is kept for the backward."""
    b, s = tokens.shape
    x = params["embed"][tokens.long()].to(cfg.precision.compute_dtype)
    positions = torch.arange(s, device=x.device).expand(b, s)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in common.unstack_layers(params["layers"], cfg.n_layers):
        if remat:
            x = checkpoint(_remat_layer, cfg, x, lp, positions, [stats],
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _layer(cfg, x, lp, positions, stats)
    return x


def forward(cfg: TransformerConfig, params: dict, tokens: Tensor,
            stats: Optional[dict] = None) -> Tensor:
    """tokens (B, S) → logits (B, S, V) in f32."""
    x = common.rms_norm(_trunk(cfg, params, tokens, stats), params["final_ln"])
    return x.float() @ params["lm_head"].float()


def loss_fn(cfg: TransformerConfig, params: dict, batch: dict) -> Tensor:
    logits = forward(cfg, params, batch["tokens"])
    return common.cross_entropy_loss(logits, batch["labels"], cfg.z_loss)


@torch.inference_mode()
def forward_last(cfg: TransformerConfig, params: dict, tokens: Tensor,
                 stats: Optional[dict] = None) -> Tensor:
    """Prefill: logits for the final position only, (B, V) in f32."""
    x = _trunk(cfg, params, tokens, stats)
    x = common.rms_norm(x[:, -1], params["final_ln"])
    return x.float() @ params["lm_head"].float()


# ---------------------------------------------------------------------------
# Decode path (serve_step)
# ---------------------------------------------------------------------------


def _cache_shape(cfg: TransformerConfig, batch: int, max_len: int) -> tuple[int, ...]:
    s = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    return (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.d_head)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """KV cache: ``k``, ``v`` (L, B, S_cache, KV, dh) zeros and ``len`` a 0-d
    int32 tensor, all on ``device`` (the card by default). SWA archs use a
    rolling window cache, S_cache = min(max_len, window)."""
    dev = resolve_device(device)
    shape = _cache_shape(cfg, batch, max_len)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "len": torch.zeros((), dtype=torch.int32, device=dev),
    }


def abstract_cache(cfg: TransformerConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    """``init_cache``'s tensors on ``torch.device("meta")``."""
    shape = _cache_shape(cfg, batch, max_len)
    return {"k": torch.empty(shape, dtype=dtype, device="meta"),
            "v": torch.empty(shape, dtype=dtype, device="meta"),
            "len": torch.empty((), dtype=torch.int32, device="meta")}


def _decode_attend(q: Tensor, k: Tensor, v: Tensor, valid: Tensor) -> Tensor:
    """q (B, KV, G, dh) against one layer's cache k/v (B, S, KV, dh), keys
    where ``valid`` (S,) → (B, KV, G, dh). The cache is read in place: the
    products run over the smaller of B and KV, each a batched product over
    the other whose operands are strided views of the cache (a
    (B, KV, S, dh) copy would move the cache's bytes twice more)."""
    b, kvh, g, dh = q.shape
    if b <= kvh:  # a sequence's kv heads, at a stride of dh
        s = torch.stack([q[i] @ k[i].permute(1, 2, 0) for i in range(b)])
    else:  # a kv head's sequences
        s = torch.stack([q[:, j] @ k[:, :, j].transpose(1, 2) for j in range(kvh)], dim=1)
    p = _softmax_scores(s, dh, valid, v.dtype)  # (B, KV, G, S)
    if b <= kvh:
        return torch.stack([p[i] @ v[i].transpose(0, 1) for i in range(b)])
    return torch.stack([p[:, j] @ v[:, :, j] for j in range(kvh)], dim=1)


@torch.inference_mode()
def decode_step(cfg: TransformerConfig, params: dict, cache: dict, tokens: Tensor,
                stats: Optional[dict] = None) -> tuple[dict, Tensor]:
    """One token step: tokens (B, 1) + cache → (cache, logits (B, V) in
    f32). The cache is updated in place and returned: this token's keys
    (roped at its absolute position) and values go to slot ``pos mod
    S_cache`` (SWA) or ``min(pos, S_cache − 1)`` (past the end the last slot
    is overwritten, as in the reference), and ``len`` grows by one."""
    b = tokens.shape[0]
    dh, kv, g = cfg.d_head, cfg.n_kv_heads, cfg.q_per_kv
    cdt = cfg.precision.compute_dtype
    cache_len = cache["k"].shape[2]
    pos = cache["len"]  # global position of this token
    ar = torch.arange(cache_len, device=pos.device)
    if cfg.sliding_window:
        slot = pos % cache_len
        valid = ar < torch.clamp(pos + 1, max=cache_len)
    else:
        slot = torch.clamp(pos, max=cache_len - 1)
        valid = ar <= slot
    slot = slot.view(1).long()

    x = params["embed"][tokens[:, 0].long()].to(cdt)  # (B, d)
    positions = pos.expand(b, 1)
    for i, lp in enumerate(common.unstack_layers(params["layers"], cfg.n_layers)):
        h = common.rms_norm(x, lp["ln1"])
        q = (h @ lp["attn"]["wq"].to(cdt)).view(b, 1, kv * g, dh)
        knew = (h @ lp["attn"]["wk"].to(cdt)).view(b, 1, kv, dh)
        vnew = (h @ lp["attn"]["wv"].to(cdt)).view(b, 1, kv, dh)
        q = rope(q, positions, cfg.rope_theta).view(b, kv, g, dh)
        knew = rope(knew, positions, cfg.rope_theta)
        k_cache, v_cache = cache["k"][i], cache["v"][i]  # (B, S_cache, KV, dh) views
        k_cache.index_copy_(1, slot, knew.to(k_cache.dtype))
        v_cache.index_copy_(1, slot, vnew.to(v_cache.dtype))
        o = _decode_attend(q, k_cache.to(cdt), v_cache.to(cdt), valid)
        x = x + o.reshape(b, kv * g * dh) @ lp["attn"]["wo"].to(cdt)

        h = common.rms_norm(x, lp["ln2"])
        if cfg.moe:
            y = moe_ffn(cfg, h, lp["ffn"], stats)
        else:
            f = lp["ffn"]
            y = swiglu(h, f["w1"].to(cdt), f["w3"].to(cdt), f["w2"].to(cdt))
        x = x + y
    x = common.rms_norm(x, params["final_ln"])
    logits = x.float() @ params["lm_head"].float()
    cache["len"] += 1
    return cache, logits
