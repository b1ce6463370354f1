"""The train and serve steps of the three families: recsys (every kind:
dlrm, xdeepfm, bert4rec, fm), LM (train with micro-batched gradient
accumulation, prefill, decode) and GNN (train, infer).

A train step is ``step(params, opt_state, batch) → (params, opt_state,
{"loss", "grad_norm"})`` and a serve step ``step(params, batch)``, the
reference's signatures. PyTorch runs eagerly, so a step is a plain
function; it runs on the device the parameters lie on. A train step
updates ``params`` and ``opt_state`` in place and returns them, as the
reference's step donates them (``train.optim``'s docstring says what a
caller copies). bert4rec serves its next-item top-k through
``models.recsys.bert4rec_serve_topk``, as the reference's ``build_cell``
does. The LM serving steps and the GNN infer step run under
``torch.inference_mode()``; the decode step updates its cache in place, as
the reference's donates it. LM training runs ``models.transformer.loss_fn``
over ``micro_batches`` slices of the batch (the checkpointed layers bound
the activations it keeps, ``TransformerConfig.remat``).
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable

import torch

from repro_torch.core import tree as tree_mod
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as recsys_mod
from repro_torch.models import transformer as tfm
from repro_torch.train import optim as optim_mod
from repro_torch.train.optim import OptimConfig

PyTree = Any


def loss_and_grads(loss_fn: Callable[[PyTree, dict], torch.Tensor], params: PyTree,
                   batch: dict) -> tuple[torch.Tensor, PyTree]:
    """(loss, gradients) of ``loss_fn(params, batch)``
    (``jax.value_and_grad``): the loss detached, the gradients in
    ``params``' structure, zeros for a parameter the loss does not reach.
    ``params`` are left as they are: the loss runs on detached aliases of
    them that require grad."""
    flat = [p.detach().requires_grad_(True) for p in tree_mod.leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_mod.unflatten(params, flat), batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return loss.detach(), tree_mod.unflatten(params, grads)


def accumulated_grads(loss_fn: Callable[[PyTree, dict], torch.Tensor], params: PyTree,
                      batch: dict, micro_batches: int,
                      split_batch: Callable[[dict, int], dict]) -> tuple[torch.Tensor, PyTree]:
    """(loss, gradients) over ``micro_batches`` slices of ``batch``: with
    one, ``loss_and_grads``; else each slice's gradients summed in f32 in
    slice order (the reference's ``lax.scan``) and divided by their count,
    the loss the slices' mean."""
    if micro_batches == 1:
        return loss_and_grads(loss_fn, params, batch)
    sliced = split_batch(batch, micro_batches)
    grads = tree_mod.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    losses = []
    for i in range(micro_batches):
        micro = tree_mod.tree_map(lambda x: x[i], sliced)
        loss_i, g = loss_and_grads(loss_fn, params, micro)
        for a, b in zip(tree_mod.leaves(grads), tree_mod.leaves(g)):
            a.add_(b.float())
        losses.append(loss_i)
        del g
    for a in tree_mod.leaves(grads):
        a.div_(micro_batches)
    return torch.stack(losses).mean(), grads


def _accumulating_step(
    loss_fn: Callable[[PyTree, dict], torch.Tensor],
    opt_cfg: OptimConfig,
    micro_batches: int,
    split_batch: Callable[[dict, int], dict],
):
    """Generic microbatched train step: ``accumulated_grads``, then one
    ``opt_cfg`` update."""

    def step(params, opt_state, batch):
        loss, grads = accumulated_grads(loss_fn, params, batch, micro_batches, split_batch)
        new_p, new_s, metrics = optim_mod.apply_updates(opt_cfg, params, grads, opt_state)
        return new_p, new_s, {"loss": loss, **metrics}

    return step


def _split_leading(batch: dict, n: int) -> dict:
    """Each leaf (B, ...) as (n, B/n, ...)."""
    return tree_mod.tree_map(lambda x: x.reshape(n, x.shape[0] // n, *x.shape[1:]), batch)


def make_lm_train_step(cfg: tfm.TransformerConfig, opt_cfg: OptimConfig,
                       micro_batches: int = 1, unroll_micro: bool = False):
    """``loss_fn``'s gradients over ``micro_batches`` slices of the batch's
    leading axis, then one ``opt_cfg`` update. ``unroll_micro`` (the
    reference's scan unrolling) changes nothing: the slices run in a Python
    loop."""
    return _accumulating_step(partial(tfm.loss_fn, cfg), opt_cfg, micro_batches, _split_leading)


def make_lm_prefill_step(cfg: tfm.TransformerConfig):
    """Inference prefill: ``step(params, batch) → (B, V)`` f32 logits of
    the last position of ``batch["tokens"]`` (B, S) (full logits for a 32k
    prompt would be far larger; serving emits the next-token
    distribution)."""

    def step(params, batch):
        return tfm.forward_last(cfg, params, batch["tokens"])

    return step


def make_lm_decode_step(cfg: tfm.TransformerConfig):
    """``step(params, cache, batch) → (cache, (B, V) logits)`` for one
    token a sequence, ``batch["tokens"]`` (B, 1); ``cache`` is updated in
    place (``models.transformer.decode_step``)."""

    def step(params, cache, batch):
        return tfm.decode_step(cfg, params, cache, batch["tokens"])

    return step


def make_gnn_train_step(cfg: gnn_mod.GNNConfig, opt_cfg: OptimConfig):
    """``models.gnn.loss_fn``'s gradients and one ``opt_cfg`` update."""
    return _accumulating_step(partial(gnn_mod.loss_fn, cfg), opt_cfg, 1, _split_leading)


def make_gnn_infer_step(cfg: gnn_mod.GNNConfig):
    """``step(params, batch) → (N, d_out)`` f32 node outputs of ``forward``
    on ``batch``'s graph (``edge_mask`` optional)."""

    @torch.inference_mode()
    def step(params, batch):
        return gnn_mod.forward(cfg, params, batch["node_feats"], batch["src"], batch["dst"],
                               batch.get("edge_mask"))

    return step


def make_recsys_train_step(cfg: recsys_mod.RecsysConfig, opt_cfg: OptimConfig):
    """``loss_fn``'s gradients and one ``opt_cfg`` update."""
    return _accumulating_step(partial(recsys_mod.loss_fn, cfg), opt_cfg, 1, _split_leading)


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
