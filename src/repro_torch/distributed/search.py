"""Sharded hybrid search: the database split over ``model`` shards, the
query batch over ``data`` blocks, an exact per-shard top-k merge.

Each model shard owns an independent HELP sub-index over its slice of the
rows, with local ids. A query block is searched on every shard with the
same routing stages as the single-host path (``routing.traverse_pool``);
local ids are offset to global ids, the per-shard heads are concatenated
shard-major (the reference's ``all_gather`` over ``model`` and
``moveaxis``) and reduced by one stable top-k: an exact merge, since the
top-k of a union equals the top-k of the per-shard top-k's.

Quantized serving (sq8, pq, pq4, opq-pq, opq-pq4): codes are sharded
row-aligned with the features, the codec state is replicated, and the
rerank is pooled across shards. Every shard traverses over codes only, the
per-shard code heads merge into one global code top-r, and each shard
scores exactly only the candidates it owns (INF elsewhere); an elementwise
minimum across shards assembles the exact distances (the reference's
``pmin``). Full-precision work per query is one global ``rerank_size``
pool, not one per shard.

The reference runs the shards as one ``shard_map`` program over the
devices of its process. The port keeps that one-process design without
collectives: a ``LocalMesh`` (``repro_torch.launch.mesh``) names the
device of each model shard, and this module loops over data blocks and
shards, moving each shard's head to the first shard's device for the
merge. On one card every shard sits on it.

Persistence matches the reference's ``stable-sharded-v1`` layout byte for
byte: one ``shard_*`` subdirectory per model shard (its feature, attribute
and code rows and its local HELP graph), the replicated codec arrays and
``sharded_meta.json``. Loading puts the shards on the current mesh: its
model axis must equal the saved shard count (graphs hold ids local to the
saved boundaries); its data axis is free.
"""
from __future__ import annotations

import dataclasses
import json
import os
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import lru_get, routing as routing_mod, to_tensor
from repro_torch.core.auto import MetricConfig
from repro_torch.core.graph_ops import INF, INVALID, smallest_k
from repro_torch.core.help_graph import HelpConfig, build_help_graph
from repro_torch.core.routing import RoutingConfig, SearchResult
from repro_torch.launch.mesh import LocalMesh, make_local_mesh
from repro_torch.quant import (
    PQCodebook, QuantConfig, QuantizedVectors, adc_lut, has_rotation, rotate,
)

Tensor = torch.Tensor

SHARDED_META = "sharded_meta.json"
SHARDED_FORMAT = "stable-sharded-v1"

#: the per-index entry-pool cache is LRU-bounded, so a long-running server
#: cycling seeds or pool sizes cannot grow it without limit
CACHE_SIZE = 64

_CODEC_FILES = {"sq_scale": "sq_scale.npy", "sq_zero": "sq_zero.npy",
                "pq_centroids": "pq_centroids.npy", "pq_rotation": "pq_rotation.npy"}


def is_sharded_dir(path: str) -> bool:
    """True when ``path`` holds the sharded on-disk layout."""
    return os.path.exists(os.path.join(path, SHARDED_META))


@dataclasses.dataclass
class ShardedStableIndex:
    """Database + per-shard HELP graphs laid out for a (data, model) mesh.

    ``shard_features[s]`` (and attrs, graphs, codes) hold model shard s's
    rows ``[s·shard_rows, (s+1)·shard_rows)`` on ``mesh.device(s)``; the
    replicated codec state sits on model shard 0's device."""

    mesh: LocalMesh
    shard_features: tuple  # S × (rows, M) f32
    shard_attrs: tuple  # S × (rows, L) int32
    shard_graphs: tuple  # S × (rows, Γ) int32, LOCAL ids
    metric_cfg: MetricConfig
    shard_rows: int
    quant_mode: str = "none"
    shard_codes: Optional[tuple] = None  # S × (rows, ·) int8 / uint8
    sq_scale: Optional[Tensor] = None  # (M,)
    sq_zero: Optional[Tensor] = None  # (M,)
    pq_centroids: Optional[Tensor] = None  # (S_pq, K, D_sub)
    pq_dim: int = 0  # codebook-native feature dim
    pq_rotation: Optional[Tensor] = None  # (Mp, Mp) OPQ rotation
    build_reports: Optional[tuple] = dataclasses.field(default=None, repr=False, compare=False)
    _entry_cache: OrderedDict = dataclasses.field(
        default_factory=OrderedDict, repr=False, compare=False
    )

    # -- shape and global views ----------------------------------------------

    @property
    def n_shards(self) -> int:
        return self.mesh.model

    @property
    def device(self) -> torch.device:
        """Where merged results land: model shard 0's device."""
        return self.mesh.device(0)

    @property
    def n_items(self) -> int:
        return self.shard_rows * self.n_shards

    @property
    def attr_dim(self) -> int:
        return int(self.shard_attrs[0].shape[1])

    @property
    def has_graph(self) -> bool:
        return int(self.shard_graphs[0].shape[1]) > 0

    def _cat(self, parts) -> Optional[Tensor]:
        return None if parts is None else torch.cat([p.to(self.device) for p in parts])

    @property
    def features(self) -> Tensor:
        """(N, M) copy of every shard's rows, on ``device``."""
        return self._cat(self.shard_features)

    @property
    def attrs(self) -> Tensor:
        return self._cat(self.shard_attrs)

    @property
    def graphs(self) -> Tensor:
        """(N, Γ) per-shard LOCAL adjacency, stacked."""
        return self._cat(self.shard_graphs)

    @property
    def codes(self) -> Optional[Tensor]:
        return self._cat(self.shard_codes)

    # -- construction --------------------------------------------------------

    @classmethod
    def build(
        cls,
        mesh: LocalMesh,
        features,
        attrs,
        metric_cfg: MetricConfig,
        help_cfg: HelpConfig = HelpConfig(),
        quant_cfg: QuantConfig = QuantConfig(),
    ) -> "ShardedStableIndex":
        """Build one HELP sub-index per model shard over its row slice, on
        that shard's device (one after another here; a fleet builds them on
        their hosts in parallel). The codec trains once on the whole
        database (codebooks are global); codes shard row-aligned with the
        features."""
        n = int(np.shape(features)[0])
        n_shards = mesh.model
        if n % n_shards:
            raise ValueError(f"{n} rows do not divide into {n_shards} model shards")
        rows = n // n_shards
        dev0 = mesh.device(0)
        feats = to_tensor(features, torch.float32, dev0)
        attrs_t = to_tensor(attrs, torch.int32, dev0)
        shard_f, shard_a, graphs, reports = [], [], [], []
        for s in range(n_shards):
            dev = mesh.device(s)
            f_s = feats[s * rows:(s + 1) * rows].to(dev)
            a_s = attrs_t[s * rows:(s + 1) * rows].to(dev)
            g, _, report = build_help_graph(f_s, a_s, metric_cfg, help_cfg)
            shard_f.append(f_s)
            shard_a.append(a_s)
            graphs.append(g)
            reports.append(report)
        kw: dict = {}
        store = QuantizedVectors.build(feats, quant_cfg)
        if store is not None:
            kw["quant_mode"] = quant_cfg.mode
            kw["shard_codes"] = tuple(
                store.codes[s * rows:(s + 1) * rows].to(mesh.device(s)) for s in range(n_shards)
            )
            if store.sq_params is not None:
                kw["sq_scale"], kw["sq_zero"] = store.sq_params.scale, store.sq_params.zero
            if store.codebook is not None:
                kw["pq_centroids"] = store.codebook.centroids
                kw["pq_dim"] = store.codebook.dim
            kw["pq_rotation"] = store.rotation
        return cls(
            mesh=mesh, shard_features=tuple(shard_f), shard_attrs=tuple(shard_a),
            shard_graphs=tuple(graphs), metric_cfg=metric_cfg, shard_rows=rows,
            build_reports=tuple(reports), **kw,
        )

    # -- search ---------------------------------------------------------------

    def _entry_ids(self, b: int, pool: int, seed: int, device: torch.device) -> Tensor:
        entry, _ = lru_get(
            self._entry_cache, (b, pool, seed, device),
            lambda: routing_mod.make_entry_ids(self.shard_rows, b, pool, seed, device=device),
            CACHE_SIZE,
        )
        return entry

    def _operand(self, s: int, qv: Tensor, mode: str, luts: dict) -> tuple:
        """Shard s's traversal codec operand: (codes, scale, zero) for sq8,
        (codes, ADC tables) for the PQ family, the tables built once per
        device from the replicated codebook (the OPQ rotation folds into
        the query here, so codes and tables stay rotation-oblivious)."""
        if mode == "none":
            return ()
        dev = self.mesh.device(s)
        codes = self.shard_codes[s]
        if mode == "sq8":
            return (codes, self.sq_scale.to(dev), self.sq_zero.to(dev))
        if dev not in luts:
            qv_lut = qv
            if has_rotation(mode):
                qv_lut = rotate(qv, self.pq_rotation.to(dev))
            luts[dev] = adc_lut(qv_lut, PQCodebook(self.pq_centroids.to(dev), self.pq_dim))
        return (codes, luts[dev])

    def _search_block(
        self, qv: Tensor, qa: Tensor, mask: Optional[Tensor], cfg: RoutingConfig, k: int, seed: int,
    ) -> tuple:
        """One data block against every model shard: (ids, sqdists, evals,
        code_evals, hops) on ``device``."""
        dev0 = self.device
        rows = self.shard_rows
        b = qv.shape[0]
        exact = cfg.quant_mode == "none"
        r = min(cfg.effective_rerank, cfg.pool_size)
        local: list = []
        heads_ids, heads_d = [], []
        code_evals = torch.zeros((b,), dtype=torch.int32, device=dev0)
        evals = torch.zeros((b,), dtype=torch.int32, device=dev0)
        hops = 0
        luts: dict = {}
        for s in range(self.n_shards):
            dev = self.mesh.device(s)
            q_s = (qv.to(dev), qa.to(dev), None if mask is None else mask.to(dev))
            feats, attrs, graph = self.shard_features[s], self.shard_attrs[s], self.shard_graphs[s]
            state = routing_mod.traverse_pool(
                feats, attrs, graph, q_s[0], q_s[1], self._entry_ids(b, cfg.pool_size, seed, dev),
                self.metric_cfg, cfg, rows, q_s[2], self._operand(s, q_s[0], cfg.quant_mode, luts),
            )
            hops += state.hops
            lo = s * rows
            if exact:
                # exact traversal: per-shard top-k heads merge exactly
                out = routing_mod.emit_topk(
                    state, feats, attrs, q_s[0], q_s[1], self.metric_cfg, cfg, q_s[2]
                )
                loc_ids, loc_d = out.ids, out.sqdists
                evals += out.n_dist_evals.to(dev0)
                code_evals += out.n_code_evals.to(dev0)
            else:
                loc_ids = state.r_ids[:, :r]
                loc_d = state.r_d[:, :r].masked_fill(loc_ids < 0, INF)
                code_evals += state.evals.to(dev0)
                local.append(q_s)
            heads_ids.append(torch.where(loc_ids >= 0, loc_ids + lo, INVALID).to(dev0))
            heads_d.append(loc_d.to(dev0))
        # shard-major (b, S·width): the reference's all_gather + moveaxis
        all_ids, all_d = torch.cat(heads_ids, dim=1), torch.cat(heads_d, dim=1)
        if exact:
            out_sq, take = smallest_k(all_d, k)
            return all_ids.gather(1, take), out_sq, evals, code_evals, hops

        # pooled quantized rerank: one global code top-r, scored exactly by
        # the shard that owns each candidate
        code_d, take = smallest_k(all_d, r)
        cand = torch.where(code_d < INF / 2, all_ids.gather(1, take), INVALID)
        exact_d = torch.full(cand.shape, INF, dtype=torch.float32, device=dev0)
        viol = torch.zeros(cand.shape, dtype=torch.bool, device=dev0)
        for s, (qv_s, qa_s, m_s) in enumerate(local):
            dev = self.mesh.device(s)
            lo = s * rows
            cand_s = cand.to(dev)
            mine = (cand_s >= lo) & (cand_s < lo + rows)
            loc = torch.where(mine, cand_s - lo, INVALID)  # INVALID scores INF
            rd = routing_mod.score_exact(
                self.shard_features[s], self.shard_attrs[s], loc, qv_s, qa_s, self.metric_cfg, m_s
            )
            if cfg.enforce_equality:
                # the owner flags violating candidates; the verdict applies
                # after the final top-k (INVALID holes in place), as
                # emit_topk orders a single-host search
                ids_f, _ = routing_mod.enforce_filter(loc, rd, self.shard_attrs[s], qa_s, m_s)
                viol |= (mine & (ids_f < 0)).to(dev0)
            exact_d = torch.minimum(exact_d, rd.to(dev0))
            evals += mine.sum(1, dtype=torch.int32).to(dev0)
        out_sq, take2 = smallest_k(exact_d, k)
        out_ids = torch.where(out_sq < INF / 2, cand.gather(1, take2), INVALID)
        if cfg.enforce_equality:
            bad = viol.gather(1, take2)
            out_ids = out_ids.masked_fill(bad, INVALID)
            out_sq = out_sq.masked_fill(bad, INF)
        return out_ids, out_sq, evals, code_evals, hops

    def search(
        self,
        qv,
        qa,
        k: int = 10,
        routing_cfg: Optional[RoutingConfig] = None,
        mask=None,
        seed: int = 0,
    ) -> SearchResult:
        """Sharded hybrid search; the same ``SearchResult`` as the
        single-host path. ``n_dist_evals`` / ``n_code_evals`` are per-query
        totals summed over model shards; ``n_hops`` sums the iterations of
        every (data block, model shard) pair.

        ``qa`` is (B, L) point targets or (B, L, 2) [lo, hi] intervals; B
        must divide by the mesh's data axis. Prefer
        ``repro_torch.api.Engine``: this is the backend behind its
        ``Searcher`` protocol."""
        cfg = routing_cfg or RoutingConfig(k=k, pool_size=max(4 * k, 32))
        if cfg.k != k:
            cfg = dataclasses.replace(cfg, k=k)
        if self.quant_mode != "none" and cfg.quant_mode == "none":
            cfg = dataclasses.replace(cfg, quant_mode=self.quant_mode)
        if cfg.quant_mode != self.quant_mode:
            raise ValueError(
                f"routing_cfg.quant_mode={cfg.quant_mode!r} but this index "
                f"was built with quant mode {self.quant_mode!r}"
            )
        dev0 = self.device
        qv = to_tensor(qv, torch.float32, dev0)
        qa = to_tensor(qa, torch.int32, dev0)
        mask = None if mask is None else to_tensor(mask, torch.int32, dev0)
        n_data = self.mesh.data
        if qv.shape[0] % n_data:
            raise ValueError(
                f"batch of {qv.shape[0]} queries does not divide over the mesh's "
                f"{n_data} data blocks"
            )
        b = qv.shape[0] // n_data
        blocks = [
            self._search_block(
                qv[d * b:(d + 1) * b], qa[d * b:(d + 1) * b],
                None if mask is None else mask[d * b:(d + 1) * b], cfg, k, seed,
            )
            for d in range(n_data)
        ]
        ids, sqd, evals, code_evals = (torch.cat([blk[i] for blk in blocks]) for i in range(4))
        return SearchResult(
            ids=ids,
            dists=torch.sqrt(torch.clamp_min(sqd, 0.0)),
            sqdists=sqd,
            n_dist_evals=evals,
            n_hops=torch.tensor(sum(blk[4] for blk in blocks), dtype=torch.int32, device=dev0),
            n_code_evals=code_evals,
        )

    # -- persistence ----------------------------------------------------------

    def save(self, path: str, extra_meta: Optional[dict] = None) -> None:
        """Write one ``shard_*`` subdirectory per model shard (its feature,
        attribute and code rows and its local HELP graph), the replicated
        codec arrays and ``sharded_meta.json``. ``extra_meta`` keys (e.g.
        an injected planner cost model) ride along in the meta."""
        os.makedirs(path, exist_ok=True)
        for s in range(self.n_shards):
            d = os.path.join(path, f"shard_{s:05d}")
            os.makedirs(d, exist_ok=True)
            np.save(os.path.join(d, "features.npy"), self.shard_features[s].cpu().numpy())
            np.save(os.path.join(d, "attrs.npy"), self.shard_attrs[s].cpu().numpy())
            np.save(os.path.join(d, "graph.npy"), self.shard_graphs[s].cpu().numpy())
            if self.shard_codes is not None:
                np.save(os.path.join(d, "codes.npy"), self.shard_codes[s].cpu().numpy())
        for name, fname in _CODEC_FILES.items():
            t = getattr(self, name)
            if t is not None:
                np.save(os.path.join(path, fname), t.cpu().numpy())
        meta = {
            "format": SHARDED_FORMAT,
            "n_shards": self.n_shards,
            "shard_rows": self.shard_rows,
            "metric_cfg": dataclasses.asdict(self.metric_cfg),
            "quant_mode": self.quant_mode,
            "pq_dim": self.pq_dim,
            "mesh_shape": self.mesh.shape,
            **(extra_meta or {}),
        }
        tmp = os.path.join(path, SHARDED_META + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)
        os.replace(tmp, os.path.join(path, SHARDED_META))

    @classmethod
    def load(cls, path: str, mesh: Optional[LocalMesh] = None, device=None) -> "ShardedStableIndex":
        """Read a saved sharded index (either package's) onto ``mesh``
        (default: ``data=1`` and the saved shard count, on ``device``, None
        → the CUDA cards). The model axis must equal the saved shard count;
        the data axis may differ from save time."""
        with open(os.path.join(path, SHARDED_META)) as f:
            meta = json.load(f)
        if meta.get("format") != SHARDED_FORMAT:
            raise ValueError(
                f"{path} is not a {SHARDED_FORMAT} layout (found {meta.get('format')!r})"
            )
        n_shards = int(meta["n_shards"])
        mesh = _resolve_mesh(mesh, n_shards, device, path)

        def shard(s: int, name: str) -> np.ndarray:
            return np.load(os.path.join(path, f"shard_{s:05d}", name))

        codec = {}
        for name, fname in _CODEC_FILES.items():
            p = os.path.join(path, fname)
            if os.path.exists(p):
                codec[name] = np.load(p)
        quantized = meta["quant_mode"] != "none"
        return _from_shards(
            mesh,
            [shard(s, "features.npy") for s in range(n_shards)],
            [shard(s, "attrs.npy") for s in range(n_shards)],
            [shard(s, "graph.npy") for s in range(n_shards)],
            meta["metric_cfg"], meta["quant_mode"],
            [shard(s, "codes.npy") for s in range(n_shards)] if quantized else None,
            pq_dim=int(meta.get("pq_dim", 0)) if "pq_centroids" in codec else 0,
            **codec,
        )


def _resolve_mesh(mesh: Optional[LocalMesh], n_shards: int, device, path: str) -> LocalMesh:
    if mesh is None:
        return make_local_mesh(data=1, model=n_shards,
                               devices=None if device is None else [device])
    if device is not None:
        raise ValueError("pass either mesh= or device=, not both (the mesh names its devices)")
    if mesh.model != n_shards:
        raise ValueError(
            f"mesh has {mesh.model} model shards but {path} was saved with "
            f"{n_shards}: per-shard HELP graphs are local to the saved shard "
            "boundaries (rebuild to change the model-axis size; the data axis "
            "may differ freely)"
        )
    return mesh


def _from_shards(
    mesh: LocalMesh,
    features: Sequence,
    attrs: Sequence,
    graphs: Sequence,
    metric_cfg,
    quant_mode: str = "none",
    codes: Optional[Sequence] = None,
    sq_scale=None,
    sq_zero=None,
    pq_centroids=None,
    pq_dim: int = 0,
    pq_rotation=None,
) -> ShardedStableIndex:
    """An index from per-shard host arrays, each placed on its shard's
    device; codec arrays go to model shard 0's device."""
    n_shards = mesh.model
    if len(features) != n_shards:
        raise ValueError(f"{len(features)} shards of rows for a mesh of {n_shards} model shards")
    rows = int(np.shape(features[0])[0])
    dev0 = mesh.device(0)

    def placed(parts, dtype):
        return tuple(to_tensor(parts[s], dtype, mesh.device(s)) for s in range(n_shards))

    def f32(x):
        return None if x is None else to_tensor(x, torch.float32, dev0)

    shard_codes = None
    if codes is not None:
        # codes keep their stored dtype: int8 for sq8, uint8 for the PQ family
        shard_codes = tuple(torch.from_numpy(np.ascontiguousarray(codes[s])).to(mesh.device(s))
                            for s in range(n_shards))
    if not isinstance(metric_cfg, MetricConfig):
        metric_cfg = MetricConfig(**metric_cfg)
    return ShardedStableIndex(
        mesh=mesh,
        shard_features=placed(features, torch.float32),
        shard_attrs=placed(attrs, torch.int32),
        shard_graphs=placed(graphs, torch.int32),
        metric_cfg=metric_cfg,
        shard_rows=rows,
        quant_mode=quant_mode,
        shard_codes=shard_codes,
        sq_scale=f32(sq_scale),
        sq_zero=f32(sq_zero),
        pq_centroids=f32(pq_centroids),
        pq_dim=int(pq_dim),
        pq_rotation=f32(pq_rotation),
    )


def sharded_index_from_numpy(
    mesh: LocalMesh,
    features: np.ndarray,
    attrs: np.ndarray,
    graphs: np.ndarray,
    metric_cfg,
    quant_mode: str = "none",
    codes: Optional[np.ndarray] = None,
    sq_scale=None,
    sq_zero=None,
    pq_centroids=None,
    pq_dim: int = 0,
    pq_rotation=None,
) -> ShardedStableIndex:
    """A port ``ShardedStableIndex`` from a reference sharded index's
    global arrays (as numpy: (N, ·) rows and the (N, Γ) stack of local
    graphs) and its metric config (a ``MetricConfig`` or its dict), split
    over ``mesh``'s model shards. Both packages then traverse the same
    per-shard graphs."""
    n_shards = mesh.model
    n = int(np.shape(features)[0])
    if n % n_shards:
        raise ValueError(f"{n} rows do not divide into {n_shards} model shards")
    rows = n // n_shards

    def split(a):
        return None if a is None else [np.asarray(a)[s * rows:(s + 1) * rows] for s in range(n_shards)]

    return _from_shards(
        mesh, split(features), split(attrs), split(graphs), metric_cfg, quant_mode, split(codes),
        sq_scale=sq_scale, sq_zero=sq_zero, pq_centroids=pq_centroids, pq_dim=pq_dim,
        pq_rotation=pq_rotation,
    )
