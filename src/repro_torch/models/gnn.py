"""GraphCast-style GNN: encoder → message-passing processor → decoder.

[arXiv:2212.12794] encode-process-decode on a mesh graph. The processor is a
stack of interaction-network layers (edge MLP on [h_src, h_dst] → aggregation
into the destination nodes → node MLP, both residual), shared between the
four graph shapes of ``configs.base.GNN_SHAPES`` (full-batch small and large,
sampled training from the fanout sampler, batched small molecules).

Message passing is a gather of node states at the edges' ends, the edge MLP,
and a scatter into the destinations (``core.graph_ops``): no sparse matrix,
as in the reference. Its casts follow the reference's order: the encoder and
the layers in the compute dtype, the aggregate cast back to it,
``rms_norm(h + relu(upd))``, the decoder in f32.

Nothing here launches a hand-written kernel: the reference computes these
layers with plain ``jnp`` and ``jax.ops.segment_*``, not in Pallas. The
sharding fields of the config (``edge_shard_axes``, ``node_shard_axes``)
are the reference's ``with_sharding_constraint`` hints on the edge messages
and node states: layout only, so in one process they change nothing.
``launch.build.build_cell`` sets them as the reference's does.
``unroll_layers`` changes nothing either (the layers run in a Python loop).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import graph_ops, resolve_device
from repro_torch.models import common
from repro_torch.models.common import MIXED, Precision

Tensor = torch.Tensor

@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int = 16
    d_hidden: int = 512
    d_in: int = 227  # n_vars for graphcast; dataset feature dim otherwise
    d_out: int = 227
    mesh_refinement: int = 6  # recorded from the paper config (the weather
    # multimesh's edge count; generic graphs supply their own edges)
    aggregator: str = "sum"
    precision: Precision = MIXED
    unroll_layers: bool = False  # the reference's dry-run FLOP passes
    # the reference's activation shardings (edge messages, node states):
    # layout only, no value changes
    edge_shard_axes: object = None
    node_shard_axes: object = None

    @property
    def param_count(self) -> int:
        """The reference's count: it leaves out the L·d norm weights."""
        d = self.d_hidden
        enc = self.d_in * d + d
        dec = d * self.d_out + self.d_out
        per_layer = (2 * d) * d + d + d * d + d + (2 * d) * d + d  # edge+node MLPs
        return enc + dec + self.n_layers * per_layer


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def param_shapes(cfg: GNNConfig) -> dict:
    """Shape of every parameter, nested and ordered as the reference's
    ``init_params``; the layers stacked on a leading L axis."""
    d, L = cfg.d_hidden, cfg.n_layers
    return {
        "encoder": {"w": (cfg.d_in, d), "b": (d,)},
        "layers": {
            # edge MLP: [h_src ; h_dst] → d → d
            "we1": (L, 2 * d, d), "be1": (L, d), "we2": (L, d, d), "be2": (L, d),
            # node MLP: [h ; agg] → d
            "wn1": (L, 2 * d, d), "bn1": (L, d), "ln": (L, d),
        },
        "decoder": {"w": (d, cfg.d_out), "b": (cfg.d_out,)},
    }


def abstract_params(cfg: GNNConfig) -> dict:
    """The parameters on ``torch.device("meta")``: shapes and dtypes, no
    memory (the counterpart of ``jax.eval_shape``)."""
    return common.meta_tree(param_shapes(cfg), cfg.precision.param_dtype)


def init_params(cfg: GNNConfig, seed: int = 0, device=None) -> dict:
    """Random parameters drawn on ``device`` (the card by default) from a
    ``torch.Generator`` seeded with ``seed``: the weights as
    ``common.dense_init`` (encoder, we1, we2, wn1, decoder, in that order),
    each layer weight one draw repeated over the L layers as the
    reference's ``[None].repeat(L, 0)`` does (every layer starts equal);
    biases zeros, norm weights ones. The draws differ from ``jax.random``'s;
    tests hand the reference's parameters across with
    ``params_from_numpy``."""
    dev = resolve_device(device)
    d, L, pd = cfg.d_hidden, cfg.n_layers, cfg.precision.param_dtype
    g = torch.Generator(device=dev).manual_seed(seed)

    def zeros(*shape) -> Tensor:
        return torch.zeros(shape, dtype=pd, device=dev)

    def stack(i: int, o: int) -> Tensor:
        return common.dense_init(g, i, o, pd)[None].repeat(L, 1, 1)

    encoder = {"w": common.dense_init(g, cfg.d_in, d, pd), "b": zeros(d)}
    layers = {"we1": stack(2 * d, d), "be1": zeros(L, d), "we2": stack(d, d),
              "be2": zeros(L, d), "wn1": stack(2 * d, d), "bn1": zeros(L, d),
              "ln": torch.ones((L, d), dtype=pd, device=dev)}
    decoder = {"w": common.dense_init(g, d, cfg.d_out, pd), "b": zeros(cfg.d_out)}
    return {"encoder": encoder, "layers": layers, "decoder": decoder}


def params_from_numpy(cfg: GNNConfig, tree: dict, device=None) -> dict:
    """The reference's nested parameter dict (numpy or array-likes) as the
    port's tensors on ``device``; every key and shape is checked."""
    return common.tree_from_numpy(param_shapes(cfg), tree, cfg.precision.param_dtype,
                                  resolve_device(device), f"config {cfg.name!r}")


# ---------------------------------------------------------------------------
# Forward and loss
# ---------------------------------------------------------------------------


def _aggregate(cfg: GNNConfig, messages: Tensor, dst: Tensor, n_nodes: int) -> Tensor:
    if cfg.aggregator == "sum":
        return graph_ops.scatter_sum(messages, dst, n_nodes)
    if cfg.aggregator == "mean":
        return graph_ops.scatter_mean(messages, dst, n_nodes)
    if cfg.aggregator == "max":
        return graph_ops.scatter_max(messages, dst, n_nodes)
    raise ValueError(cfg.aggregator)


def forward(cfg: GNNConfig, params: dict, node_feats: Tensor, src: Tensor, dst: Tensor,
            edge_mask: Optional[Tensor] = None) -> Tensor:
    """node_feats (N, d_in), src/dst (E,) ids, edge_mask (E,) bool for padded
    edge lists → per-node outputs (N, d_out) in f32. Node states are
    gathered with ``jnp`` indexing's rules (``graph_ops.take_rows``);
    messages to ids outside [0, N) are dropped. Under the ``max``
    aggregator a node with no in-edge gets −inf, and its state turns
    non-finite, as in the reference."""
    cdt = cfg.precision.compute_dtype
    n = node_feats.shape[0]
    enc = params["encoder"]
    h = F.relu(node_feats.to(cdt) @ enc["w"].to(cdt) + enc["b"].to(cdt))
    for lp in common.unstack_layers(params["layers"], cfg.n_layers):
        m = torch.cat([graph_ops.take_rows(h, src), graph_ops.take_rows(h, dst)], dim=-1)
        m = F.relu(m @ lp["we1"].to(cdt) + lp["be1"].to(cdt))
        m = m @ lp["we2"].to(cdt) + lp["be2"].to(cdt)
        if edge_mask is not None:
            m = torch.where(edge_mask[:, None].bool(), m, 0.0)
        agg = _aggregate(cfg, m, dst, n)  # (N, d)
        upd = torch.cat([h, agg.to(cdt)], dim=-1)
        upd = upd @ lp["wn1"].to(cdt) + lp["bn1"].to(cdt)
        h = common.rms_norm(h + F.relu(upd), lp["ln"])
    dec = params["decoder"]
    return h.float() @ dec["w"].float() + dec["b"].float()


def loss_fn(cfg: GNNConfig, params: dict, batch: dict) -> Tensor:
    """MSE regression on the (masked) target nodes, the GraphCast
    objective's shape: with ``node_mask`` the squared errors of the masked
    nodes over their count times d_out (at least 1), else the mean."""
    out = forward(cfg, params, batch["node_feats"], batch["src"], batch["dst"],
                  batch.get("edge_mask"))
    err = (out - batch["targets"].float()) ** 2
    if "node_mask" in batch:
        w = batch["node_mask"].float()[:, None]
        return (err * w).sum() / (w.sum() * out.shape[-1]).clamp_min(1.0)
    return err.mean()
