"""Sharding rules: parameter, optimizer-state, batch and cache partition
specs for each family, and ``NamedSharding`` to read and apply them.

Axis conventions (the reference's):
  * ``model``: tensor parallel (attention heads, d_ff, vocab, experts,
    embedding-table rows, candidate shards, the decode cache's sequence);
  * ``data`` (with a leading ``pod`` on the multi-pod mesh): data parallel
    over the batch, and FSDP over the parameters' second dimension and the
    optimizer state;
  * GNN edge lists are sharded over every axis (edge parallel).

A spec is the port's ``P``: one entry a dimension, each ``None``, an axis
name or a tuple of axis names (the major axis first); dimensions past its
end are whole. The spec functions read only a mesh's ``shape`` and
``axis_names``, so they serve the production mesh
(``launch.mesh.make_production_mesh``, no devices) and a ``LocalMesh``
alike. ``NamedSharding.shard_shape`` gives each shard's shape on either;
on a ``LocalMesh``, ``split`` cuts a tensor into its shards on their
devices and ``join`` puts them back.

The reference's ``shard_map`` and ``named_axis_size`` are JAX's own and
have no counterpart: the ring functions (``collective_matmul``,
``gnn_aggregate``) take the mesh and lists of per-shard tensors instead.
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Optional

import torch

from repro_torch.core import tree as tree_mod
from repro_torch.models.gnn import GNNConfig
from repro_torch.models import recsys as recsys_mod
from repro_torch.models.recsys import RecsysConfig
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optim import (
    AdafactorState, AdamWState, OptimConfig, SGDState, _factored,
)

PyTree = Any


def _normalize(entry):
    """An entry as JAX's ``PartitionSpec`` keeps it: a sequence of axis
    names as a tuple, one name alone as the name, none as ``None``."""
    if entry is None or isinstance(entry, str):
        return entry
    entry = tuple(entry)
    return None if not entry else entry[0] if len(entry) == 1 else entry


class P:
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"), None)``.
    Entries are normalized as JAX's are (``("data",)`` is ``"data"``).
    Indexing and slicing read them; it compares equal to another ``P`` or a
    tuple with the same entries. Not a tuple, so that a tree walk
    (``core.tree``) takes it as a leaf."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        self._parts = tuple(_normalize(e) for e in parts)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, P):
            return self._parts == other._parts
        if isinstance(other, tuple):
            return self._parts == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return f"P{self._parts!r}" if len(self._parts) != 1 else f"P({self._parts[0]!r})"


def _entry_axes(entry) -> tuple:
    """The axis names of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return math.prod(mesh.shape[a] for a in axes)


def batch_axes(mesh) -> tuple:
    """("pod", "data") on the multi-pod mesh, ("data",) on the others."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def maybe(mesh, dim_size: int, axes):
    """``axes`` if the dimension divides evenly over them, else ``None``
    (replicated)."""
    if axes is None:
        return None
    if dim_size % _axis_size(mesh, axes) != 0:
        return None
    return axes


# ---------------------------------------------------------------------------
# LM transformer
# ---------------------------------------------------------------------------


def lm_param_specs(cfg: TransformerConfig, mesh, fsdp: bool = True) -> dict:
    bx = batch_axes(mesh)
    dp = bx if fsdp else None
    dp_d = maybe(mesh, cfg.d_model, dp)

    attn = {
        "wq": P(None, dp_d, maybe(mesh, cfg.n_heads * cfg.d_head, "model")),
        "wk": P(None, dp_d, maybe(mesh, cfg.n_kv_heads * cfg.d_head, "model")),
        "wv": P(None, dp_d, maybe(mesh, cfg.n_kv_heads * cfg.d_head, "model")),
        "wo": P(None, maybe(mesh, cfg.n_heads * cfg.d_head, "model"), dp_d),
    }
    if cfg.moe:
        e, ffe = cfg.moe.n_experts, cfg.moe.d_ff_expert
        if e % mesh.shape["model"] == 0:  # expert parallel
            ffn = {
                "router": P(None, dp_d, None),
                "w1": P(None, "model", dp_d, None),
                "w3": P(None, "model", dp_d, None),
                "w2": P(None, "model", None, dp_d),
            }
        else:  # tensor parallel inside each expert (e.g. 8 experts on 16)
            ffn = {
                "router": P(None, dp_d, None),
                "w1": P(None, None, dp_d, maybe(mesh, ffe, "model")),
                "w3": P(None, None, dp_d, maybe(mesh, ffe, "model")),
                "w2": P(None, None, maybe(mesh, ffe, "model"), dp_d),
            }
    else:
        ffn = {
            "w1": P(None, dp_d, maybe(mesh, cfg.d_ff, "model")),
            "w3": P(None, dp_d, maybe(mesh, cfg.d_ff, "model")),
            "w2": P(None, maybe(mesh, cfg.d_ff, "model"), dp_d),
        }
    return {
        "embed": P(maybe(mesh, cfg.vocab, "model"), dp_d),
        "layers": {"ln1": P(None, None), "ln2": P(None, None), "attn": attn, "ffn": ffn},
        "final_ln": P(None),
        "lm_head": P(dp_d, maybe(mesh, cfg.vocab, "model")),
    }


def lm_batch_specs(mesh, global_batch: int) -> dict:
    bx = maybe(mesh, global_batch, batch_axes(mesh))
    return {"tokens": P(bx, None), "labels": P(bx, None)}


def lm_cache_specs(cfg: TransformerConfig, mesh, batch: int, seq_shard: bool = True) -> dict:
    """KV cache (L, B, S, KV, dh): the batch over the data axes, the
    sequence over ``model`` (the flash-decoding layout)."""
    bx = maybe(mesh, batch, batch_axes(mesh))
    sx = "model" if seq_shard else None
    return {"k": P(None, bx, sx, None, None), "v": P(None, bx, sx, None, None), "len": P()}


# ---------------------------------------------------------------------------
# GNN
# ---------------------------------------------------------------------------


def gnn_param_specs(cfg: GNNConfig, mesh, fsdp: bool = True) -> dict:
    bx = batch_axes(mesh) if fsdp else None
    d = cfg.d_hidden
    dd = maybe(mesh, d, bx)
    d2 = maybe(mesh, 2 * d, bx)
    return {
        "encoder": {"w": P(None, maybe(mesh, d, "model")), "b": P(None)},
        "layers": {
            "we1": P(None, d2, maybe(mesh, d, "model")),
            "be1": P(None, None),
            "we2": P(None, dd, maybe(mesh, d, "model")),
            "be2": P(None, None),
            "wn1": P(None, d2, maybe(mesh, d, "model")),
            "bn1": P(None, None),
            "ln": P(None, None),
        },
        "decoder": {"w": P(dd, None), "b": P(None)},
    }


def gnn_batch_specs(mesh, n_edges: int) -> dict:
    ex = maybe(mesh, n_edges, tuple(mesh.axis_names))
    return {
        "node_feats": P(None, None),  # node states replicated (edge parallel)
        "src": P(ex),
        "dst": P(ex),
        "edge_mask": P(ex),
        "targets": P(None, None),
        "node_mask": P(None),
    }


# ---------------------------------------------------------------------------
# RecSys
# ---------------------------------------------------------------------------


def recsys_param_specs(cfg: RecsysConfig, mesh, abstract_params: Optional[PyTree] = None
                       ) -> PyTree:
    """Small dense weights replicated; the embedding tables (and the
    per-field linear weights) row-sharded over ``model``, by the names on
    each parameter's path."""
    if abstract_params is None:
        abstract_params = recsys_mod.abstract_params(cfg)

    def spec(path: str, leaf) -> P:
        names = path.split("/")
        if "tables" in names:
            return P(None, maybe(mesh, cfg.vocab_per_field, "model"), None)
        if "linear" in names:
            return P(None, maybe(mesh, cfg.vocab_per_field, "model"))
        if "item_embed" in names:
            return P(maybe(mesh, cfg.n_items, "model"), None)
        return P(*([None] * leaf.ndim))

    return tree_mod.unflatten(
        abstract_params, [spec(path, leaf) for path, leaf in
                          tree_mod.flatten_with_paths(abstract_params)])


def recsys_batch_specs(cfg: RecsysConfig, mesh, batch: int, train: bool = True) -> dict:
    bx = maybe(mesh, batch, batch_axes(mesh))
    if cfg.kind == "bert4rec":
        if not train:
            return {"items": P(bx, None)}
        return {"items": P(bx, None), "masked_pos": P(bx, None), "labels": P(bx, None),
                "neg_ids": P(None)}
    out = {"sparse": P(bx, None)}
    if train:
        out["labels"] = P(bx)
    if cfg.n_dense:
        out["dense"] = P(bx, None)
    return out


def retrieval_batch_specs(cfg: RecsysConfig, mesh, n_candidates: int) -> dict:
    cx = maybe(mesh, n_candidates, "model")
    if cfg.kind == "bert4rec":
        base = {"items": P(None, None)}
    else:
        base = {"sparse": P(None, None)} | ({"dense": P(None, None)} if cfg.n_dense else {})
    return base | {"query_attrs": P(None, None), "item_embs": P(cx, None),
                   "item_attrs": P(cx, None)}


# ---------------------------------------------------------------------------
# Optimizer-state specs follow the parameter specs
# ---------------------------------------------------------------------------


def opt_state_specs(opt_cfg: OptimConfig, param_specs: PyTree, abstract_params: PyTree):
    """The state's specs in the shape of ``train.optim``'s state types:
    AdamW's moments as the parameters; Adafactor's factored row moment
    without the last axis and column moment without the second last."""
    if opt_cfg.kind == "adamw":
        return AdamWState(step=P(), mu=param_specs, nu=param_specs)
    if opt_cfg.kind == "sgd":
        return SGDState(step=P())
    if opt_cfg.kind == "adafactor":
        def vr_spec(spec: P, p) -> P:
            return P(*spec[:-1]) if _factored(p.shape) else spec

        def vc_spec(spec: P, p) -> P:
            return P(*(tuple(spec[:-2]) + (spec[-1],))) if _factored(p.shape) else P(None)

        return AdafactorState(step=P(),
                              vr=tree_mod.tree_map(vr_spec, param_specs, abstract_params),
                              vc=tree_mod.tree_map(vc_spec, param_specs, abstract_params))
    raise ValueError(opt_cfg.kind)


# ---------------------------------------------------------------------------
# NamedSharding
# ---------------------------------------------------------------------------


class NamedSharding:
    """``spec`` laid over ``mesh``: one shard at each point of the mesh, in
    row-major order over ``mesh.axis_names``."""

    def __init__(self, mesh, spec: P):
        for entry in spec:
            for axis in _entry_axes(entry):
                if axis not in mesh.axis_names:
                    raise ValueError(f"{spec}: no axis {axis!r} in mesh {mesh.axis_names}")
        self.mesh, self.spec = mesh, spec

    def _counts(self, ndim: int) -> list[int]:
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec} has more entries than the {ndim} dimensions")
        return [_axis_size(self.mesh, _entry_axes(e)) for e in self.spec] + [1] * (
            ndim - len(self.spec))

    def shard_shape(self, global_shape) -> tuple:
        """Each shard's shape; a dimension that does not divide raises."""
        out = []
        for n, k in zip(global_shape, self._counts(len(global_shape))):
            if n % k:
                raise ValueError(f"dimension {n} does not divide over {k} shards ({self.spec})")
            out.append(n // k)
        return tuple(out)

    def _points(self):
        names = self.mesh.axis_names
        for coords in itertools.product(*(range(self.mesh.shape[a]) for a in names)):
            yield dict(zip(names, coords))

    def _slices(self, point: dict, shape) -> tuple:
        sizes = self.shard_shape(shape)
        out = []
        for dim, size in enumerate(sizes):
            axes = _entry_axes(self.spec[dim]) if dim < len(self.spec) else ()
            index = 0
            for a in axes:  # the major axis first
                index = index * self.mesh.shape[a] + point[a]
            out.append(slice(index * size, (index + 1) * size))
        return tuple(out)

    def split(self, t: torch.Tensor) -> list:
        """``t``'s shards, one for each point of the mesh, each on the
        device of its ``model`` shard (a view where that is ``t``'s own
        device). Needs a mesh with devices (``LocalMesh``)."""
        return [t[self._slices(pt, t.shape)].to(self.mesh.device(pt.get("model", 0)))
                for pt in self._points()]

    def join(self, pieces) -> torch.Tensor:
        """The tensor that ``split`` cut into ``pieces``, on the first
        piece's device (a replicated dimension is read from each shard in
        turn: their copies are equal)."""
        pieces = list(pieces)
        points = list(self._points())
        if len(pieces) != len(points):
            raise ValueError(f"{len(pieces)} pieces for a mesh of {len(points)} shards")
        first = pieces[0]
        shape = [n * k for n, k in zip(first.shape, self._counts(first.ndim))]
        out = first.new_empty(shape)
        for pt, piece in zip(points, pieces):
            out[self._slices(pt, shape)] = piece.to(out.device)
        return out


def to_shardings(mesh, specs: PyTree) -> PyTree:
    """A ``NamedSharding`` at every spec of the tree ``specs``."""
    return tree_mod.tree_map(lambda s: NamedSharding(mesh, s), specs)


def sharded_bytes(mesh, tree: PyTree, specs: PyTree) -> int:
    """Bytes of one shard of each leaf of ``tree`` under its spec in
    ``specs`` (the same structure), summed: what one device holds."""
    return int(sum(math.prod(NamedSharding(mesh, s).shard_shape(t.shape)) * t.element_size()
                   for t, s in zip(tree_mod.leaves(tree), tree_mod.leaves(specs))))
