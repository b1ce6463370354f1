"""Public STABLE index API of the port.

``StableIndex`` bundles the AUTO-calibrated metric, the HELP graph, an
optional codec store and the dynamic router behind build/search/save/load.
``save``/``load`` use the reference's ``stable-single-v1`` layout
(``features.npy``, ``attrs.npy``, ``graph.npy``, ``meta.json`` and, for a
quantized index, the ``quant_*.npy`` files and the meta's ``quant`` block),
so each package loads the other's directory.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.core import auto as auto_mod
from repro_torch.core import help_graph as help_mod
from repro_torch.core import resolve_device, routing as routing_mod, to_tensor
from repro_torch.core.auto import DatasetStats, MetricConfig
from repro_torch.core.help_graph import BuildReport, HelpConfig
from repro_torch.core.routing import RoutingConfig, SearchResult
from repro_torch.quant import QuantConfig, QuantizedVectors

Tensor = torch.Tensor

FORMAT = "stable-single-v1"


@dataclasses.dataclass
class StableIndex:
    features: Tensor  # (N, M) f32
    attrs: Tensor  # (N, L) int32 (numerically mapped)
    graph: Tensor  # (N, Γ) int32 HELP adjacency
    metric_cfg: MetricConfig
    help_cfg: HelpConfig
    stats: DatasetStats
    report: Optional[BuildReport] = None
    quant: Optional[QuantizedVectors] = None  # codes + codec state (or None)

    @property
    def device(self) -> torch.device:
        return self.features.device

    # -- construction --------------------------------------------------------

    @classmethod
    def build(
        cls,
        features,
        attrs,
        help_cfg: HelpConfig = HelpConfig(),
        metric_mode: str = "auto",
        alpha: Optional[float] = None,
        nhq_weight: float = 1.0,
        stats_seed: int = 0,
        quant_cfg: Optional[QuantConfig] = None,
        build_graph: bool = True,
        device=None,
    ) -> "StableIndex":
        """Calibrate α on the host (numpy, bit-equal to the reference), then
        build the HELP graph on ``device`` (None → the CUDA card), then
        train ``quant_cfg``'s codec there (None or mode 'none': no codec).
        ``build_graph=False`` stores an empty (N, 0) adjacency for corpora
        that will only ever be scanned."""
        if quant_cfg is not None and not isinstance(quant_cfg, QuantConfig):
            raise TypeError(f"quant_cfg must be a QuantConfig or None, got {quant_cfg!r}")
        dev = resolve_device(device)
        feats_np = np.asarray(features, np.float32)
        attrs_np = np.asarray(attrs, np.int32)
        stats = auto_mod.sample_stats(feats_np, attrs_np, seed=stats_seed)
        metric_cfg = MetricConfig(
            mode=metric_mode,
            alpha=float(alpha) if alpha is not None else stats.alpha,
            nhq_weight=nhq_weight,
        )
        feats = to_tensor(feats_np, torch.float32, dev)
        attrs_t = to_tensor(attrs_np, torch.int32, dev)
        if build_graph:
            graph, _, report = help_mod.build_help_graph(feats, attrs_t, metric_cfg, help_cfg)
        else:
            graph = torch.zeros((feats.shape[0], 0), dtype=torch.int32, device=dev)
            report = None
        return cls(
            features=feats, attrs=attrs_t, graph=graph, metric_cfg=metric_cfg,
            help_cfg=help_cfg, stats=stats, report=report,
            quant=QuantizedVectors.build(feats, quant_cfg or QuantConfig()),
        )

    # -- search ---------------------------------------------------------------

    def search(
        self,
        qv,
        qa,
        k: int = 10,
        routing_cfg: Optional[RoutingConfig] = None,
        mask=None,
        seed: int = 0,
    ) -> SearchResult:
        """Legacy keyword entry point (prefer ``repro_torch.api.Engine``);
        runs on the index's device. A quantized index routes over its codes
        and reranks exactly (``quant_mode`` defaults from ``self.quant``)."""
        cfg = routing_cfg or RoutingConfig(k=k, pool_size=max(4 * k, 32))
        if cfg.k != k:
            cfg = dataclasses.replace(cfg, k=k)
        if self.quant is not None and cfg.quant_mode == "none":
            cfg = dataclasses.replace(cfg, quant_mode=self.quant.cfg.mode)
        return routing_mod.search(
            self.features, self.attrs, self.graph, qv, qa, self.metric_cfg, cfg,
            mask=mask, seed=seed, quant=self.quant,
        )

    # -- streaming mutability (repro_torch.mutable) ---------------------------

    def apply_rows(self, ids, features, attrs) -> "StableIndex":
        """Scatter and append logical rows into a new index whose tensors
        are all new: the old index keeps serving readers that may be
        mid-search on it, so none of its tensors is written.

        Rows with ``id < N`` are overwritten; ids beyond N grow the corpus
        to ``max(id) + 1`` (gap rows get zero vectors; the caller tombstones
        them). Graph rows are not linked here: appended rows are all
        INVALID until ``help_graph.link_nodes`` links them, and overwritten
        rows keep their old out-edges. Codes are extended with the frozen
        codec state (``QuantizedVectors.encode_rows``)."""
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return self
        dev = self.device
        n_old = int(self.features.shape[0])
        n_new = max(n_old, int(ids.max()) + 1)
        idx = torch.from_numpy(ids).to(dev)

        def grown(a: Tensor, rows: Tensor) -> Tensor:
            pad = a.new_zeros((n_new - n_old,) + tuple(a.shape[1:]))
            return torch.cat([a, pad]).index_copy_(0, idx, rows.to(a.dtype))

        feats_new = to_tensor(features, torch.float32, dev)
        quant = self.quant
        if quant is not None:
            codes = grown(quant.codes, quant.encode_rows(feats_new))
            quant = dataclasses.replace(quant, codes=codes)
        graph = torch.cat([self.graph, self.graph.new_full((n_new - n_old, self.graph.shape[1]),
                                                           help_mod.INVALID)])
        return dataclasses.replace(
            self, features=grown(self.features, feats_new),
            attrs=grown(self.attrs, to_tensor(attrs, torch.int32, dev)), graph=graph, quant=quant,
        )

    # -- persistence ----------------------------------------------------------

    def save(self, path: str, extra_meta: Optional[dict] = None) -> None:
        """Write the ``stable-single-v1`` layout; ``extra_meta`` keys (e.g.
        the planner cost model) ride along in meta.json."""
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "features.npy"), self.features.cpu().numpy())
        np.save(os.path.join(path, "attrs.npy"), self.attrs.cpu().numpy())
        np.save(os.path.join(path, "graph.npy"), self.graph.cpu().numpy())
        meta = {
            "format": FORMAT,
            "metric_cfg": dataclasses.asdict(self.metric_cfg),
            "help_cfg": dataclasses.asdict(self.help_cfg),
            "stats": dataclasses.asdict(self.stats),
            "quant": self.quant.save(path) if self.quant is not None else None,
            **(extra_meta or {}),
        }
        tmp = os.path.join(path, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)
        os.replace(tmp, os.path.join(path, "meta.json"))

    @classmethod
    def load(cls, path: str, device=None, mmap: bool = False) -> "StableIndex":
        """Read a ``stable-single-v1`` directory (either package's) onto
        ``device`` (None → the CUDA card). ``mmap`` streams the arrays from
        the page cache instead of reading them into host RAM first."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("format", FORMAT) != FORMAT:
            raise ValueError(f"{path}: format {meta['format']!r} is not {FORMAT!r}")
        mode = "r" if mmap else None

        def arr(name):
            return np.load(os.path.join(path, name), mmap_mode=mode)

        quant_meta = meta.get("quant")
        quant = None
        if quant_meta is not None:
            quant = QuantizedVectors.load(path, quant_meta, mmap=mmap, device=device)
        return index_from_numpy(
            arr("features.npy"), arr("attrs.npy"), arr("graph.npy"),
            meta["metric_cfg"], meta["help_cfg"], meta["stats"], device, quant=quant,
        )


def index_from_numpy(
    features: np.ndarray,
    attrs: np.ndarray,
    graph: np.ndarray,
    metric_cfg: dict,
    help_cfg: dict,
    stats: dict,
    device=None,
    quant: Optional[QuantizedVectors] = None,
) -> StableIndex:
    """A port ``StableIndex`` from a reference index's arrays (as numpy)
    and its dataclasses (as dicts, e.g. ``dataclasses.asdict``), placed on
    ``device`` (None → the CUDA card). Both packages then score and
    traverse the same graph. ``quant`` is a codec store on the same device
    (``repro_torch.quant.quant_from_numpy`` builds one from a reference
    store's arrays)."""
    dev = resolve_device(device)
    if quant is not None and quant.device.type != dev.type:
        raise ValueError(f"quant store is on {quant.device}, the index on {dev}")
    return StableIndex(
        features=to_tensor(features, torch.float32, dev),
        attrs=to_tensor(attrs, torch.int32, dev),
        graph=to_tensor(graph, torch.int32, dev),
        metric_cfg=MetricConfig(**metric_cfg),
        help_cfg=HelpConfig(**help_cfg),
        stats=DatasetStats(**stats),
        quant=quant,
    )
