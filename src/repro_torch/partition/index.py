"""PartitionedStableIndex: IVF coarse partitions over HELP subgraphs.

The out-of-core container: a mini-batch k-means coarse quantizer
(``partition.kmeans``) assigns every row to one of P partitions; each
partition holds its own feature/attr slice, an optional HELP subgraph, a
slice of the *globally trained* quantized codes, and a per-attribute
min/max summary. Queries score the P centroids, prune partitions whose
attribute summaries cannot contain a predicate survivor, and probe the
top-``nprobe`` remainder through a ``SegmentStore`` (LRU residency, cap in
rows), so the corpus scales past device memory while full-probe results
stay bit-identical to the port's unpartitioned brute engine.

Two invariants keep that parity exact:

* the codec (SQ8 params / PQ codebook) and the AUTO metric calibration are
  trained once, globally, exactly as ``StableIndex.build`` trains them;
  partitions only *slice* the resulting code rows, so a code scores
  identically whichever partition serves it;
* rows are assigned to partitions in ascending global-id order, so
  per-partition top-k tie-breaking by (score, global id) composes into the
  order the flat engine's stable sort gives, where position == global id.

The global codec state and the centroids live on the index's ``device``
(None → the CUDA card); the (N, L) global attribute matrix stays a host
array (a memmap once loaded), and partitions reach the device only through
the store.

Persistence layout (``format: stable-partitioned-v1``), byte for byte the
reference's, so each package loads the other's directory:

    path/
      meta.json             format, calibration, codec meta, summaries
      coarse_centroids.npy  the trained coarse quantizer
      attrs.npy             (N, L) global attrs (engine-side filtering)
      quant_*.npy           global codec state (no global code array)
      part_00000/
        features.npy  attrs.npy  graph.npy  quant_codes.npy  row_ids.npy
      part_00001/ ...

``load`` opens every per-partition array with ``np.load(mmap_mode="r")``:
cold partitions cost ~0 host RAM.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.core import auto as auto_mod
from repro_torch.core import help_graph as help_mod
from repro_torch.core import resolve_device, to_tensor
from repro_torch.core.auto import DatasetStats, MetricConfig
from repro_torch.core.help_graph import HelpConfig
from repro_torch.partition.kmeans import CoarseQuantizer, train_coarse
from repro_torch.partition.store import PartitionData, SegmentStore, row_bucket
from repro_torch.quant import QuantConfig, QuantizedVectors
from repro_torch.quant.opq import rotate as opq_rotate
from repro_torch.quant.pq import PQCodebook, adc_lut
from repro_torch.quant.sq import SQParams
from repro_torch.quant.store import check_codec_spec, codec_spec, is_pq_mode

Tensor = torch.Tensor

PARTITIONED_FORMAT = "stable-partitioned-v1"

__all__ = ["PartitionSummaries", "PartitionedStableIndex", "PARTITIONED_FORMAT",
           "is_partitioned_dir"]


@dataclasses.dataclass
class PartitionSummaries:
    """Per-partition predicate statistics: row counts + attribute hulls.

    ``attr_min``/``attr_max`` bound every attribute value present in the
    partition, so interval-hull intersection (and, for ONE_OF, value-in-hull
    membership) is a *conservative* pruning test: it may keep a partition
    with no true survivor, it can never drop one that has any.
    """

    n_rows: np.ndarray  # (P,) i64
    attr_min: np.ndarray  # (P, L) i32
    attr_max: np.ndarray  # (P, L) i32

    def to_json(self) -> dict:
        return {
            "n_rows": self.n_rows.tolist(),
            "attr_min": self.attr_min.tolist(),
            "attr_max": self.attr_max.tolist(),
        }

    @classmethod
    def from_json(cls, d: dict) -> "PartitionSummaries":
        return cls(
            n_rows=np.asarray(d["n_rows"], np.int64),
            attr_min=np.asarray(d["attr_min"], np.int32),
            attr_max=np.asarray(d["attr_max"], np.int32),
        )


#: the .npy header versions ``np.save`` writes, by their public readers
_NPY_HEADER_READERS = {
    (1, 0): np.lib.format.read_array_header_1_0,
    (2, 0): np.lib.format.read_array_header_2_0,
}


def _part_dir(path: str, pid: int) -> str:
    return os.path.join(path, f"part_{pid:05d}")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class PartitionedStableIndex:
    quantizer: CoarseQuantizer
    summaries: PartitionSummaries
    metric_cfg: MetricConfig
    help_cfg: HelpConfig
    stats: DatasetStats
    quant_cfg: QuantConfig
    attrs: np.ndarray  # (N, L) global host attrs (memmap when disk-backed)
    sq_params: Optional[SQParams] = None
    codebook: Optional[PQCodebook] = None
    rotation: Optional[Tensor] = None  # (Mp, Mp) OPQ rotation (opq-*)
    path: Optional[str] = None  # disk-backed partitions (mmap loaders)
    graph_built: bool = True  # subgraph traversal requested at build
    #: in-memory partition payloads (build mode; ``path`` is None)
    _parts: Optional[dict] = dataclasses.field(default=None, repr=False)
    store: SegmentStore = dataclasses.field(default=None, repr=False)
    residency_rows: Optional[int] = None
    device: Optional[torch.device] = None  # None → the CUDA card
    #: seconds of each build stage (``build`` only): codec, kmeans, partitions
    build_seconds: Optional[dict] = dataclasses.field(default=None, repr=False, compare=False)
    #: per-partition entry-pool LRU (see ``partition.search``)
    _entry_cache: "OrderedDict" = dataclasses.field(
        default_factory=OrderedDict, repr=False, compare=False
    )
    #: parsed .npy headers of the partition files, by path (see ``_map``)
    _headers: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.store is None:
            self.set_residency(self.residency_rows)

    # -- geometry --------------------------------------------------------

    @property
    def n_partitions(self) -> int:
        return self.quantizer.n_partitions

    @property
    def n_items(self) -> int:
        return int(self.summaries.n_rows.sum())

    @property
    def attr_dim(self) -> int:
        return int(self.attrs.shape[1])

    @property
    def feat_dim(self) -> int:
        return int(self.quantizer.centroids.shape[1])

    @property
    def has_graph(self) -> bool:
        """True when subgraph traversal was built (``help_cfg.gamma`` wide);
        tiny partitions may individually fall back to (n, 0) scan-only
        adjacency; the searcher checks per partition."""
        return self.graph_built

    @property
    def quant_mode(self) -> str:
        return self.quant_cfg.mode

    def quant_for(self, codes) -> Optional[QuantizedVectors]:
        """Wrap one partition's code slice with the global codec state."""
        if self.quant_cfg.mode == "none" or codes is None:
            return None
        return QuantizedVectors(
            cfg=self.quant_cfg, codes=codes,
            sq_params=self.sq_params, codebook=self.codebook,
            rotation=self.rotation,
        )

    def query_lut(self, qv: Tensor) -> Tensor:
        """Per-query ADC tables against the global codebook, with the OPQ
        rotation (if any) folded into the query: shared by every partition
        probe (codes are slices of one globally encoded array)."""
        if self.rotation is not None:
            qv = opq_rotate(qv, self.rotation)
        return adc_lut(qv, self.codebook)

    # -- residency -------------------------------------------------------

    def set_residency(self, cap_rows: Optional[int]) -> None:
        """(Re)create the segment store with a new resident-row cap.
        ``None`` → everything may stay resident (sum of row buckets)."""
        if cap_rows is None:
            cap_rows = int(sum(row_bucket(int(n)) for n in self.summaries.n_rows)) or 1
        self.residency_rows = int(cap_rows)
        self.store = SegmentStore(self._load_partition, self.residency_rows, device=self.device)

    def _map(self, path: str) -> Optional[np.ndarray]:
        """``np.load(path, mmap_mode="r")`` with the header parsed once per
        file (a partition is mapped again on every load); None when the
        file does not exist."""
        head = self._headers.get(path)
        if head is None:
            if not os.path.exists(path):
                return None
            with open(path, "rb") as f:
                read = _NPY_HEADER_READERS.get(np.lib.format.read_magic(f))
                if read is None:  # a newer header version: np.load parses it
                    return np.load(path, mmap_mode="r")
                shape, fortran, dtype = read(f)
                head = self._headers[path] = (shape, "F" if fortran else "C", dtype, f.tell())
        shape, order, dtype, offset = head
        return np.memmap(path, dtype=dtype, mode="r", offset=offset, shape=shape, order=order)

    def _load_partition(self, pid: int) -> PartitionData:
        if self._parts is not None:
            return self._parts[pid]
        d = _part_dir(self.path, pid)
        mm = {name: self._map(os.path.join(d, f"{name}.npy"))
              for name in ("features", "attrs", "graph", "row_ids", "quant_codes")}
        return PartitionData(
            features=mm["features"], attrs=mm["attrs"], graph=mm["graph"],
            codes=mm["quant_codes"], row_ids=mm["row_ids"],
        )

    # -- coarse routing ---------------------------------------------------

    def survivor_mask(self, queries, hard_all: bool) -> np.ndarray:
        """(B, P) bool: partitions whose attribute summary may contain a
        predicate survivor. Conservative by construction (hull tests only).

        ``hard_all=False`` prunes on ONE_OF dimensions alone: membership is
        exact on every backend, while MATCH/BETWEEN stay a *soft* penalty
        under traversal, so pruning on them would change soft semantics.
        ``hard_all=True`` (oracle sub-backend, or ``enforce_equality``)
        prunes on every active dimension.
        """
        return self._survivors(self._probe_operands(queries), hard_all).cpu().numpy().copy()

    def _probe_operands(self, queries) -> dict:
        """The query operands ``probe`` reads, on the index's device."""
        lo, hi = queries._bounds()
        dev = self.device
        return {
            "vectors": to_tensor(queries.vectors, torch.float32, dev),
            "lo": to_tensor(lo, torch.int32, dev), "hi": to_tensor(hi, torch.int32, dev),
            "allowed": (None if queries.allowed is None
                        else to_tensor(queries.allowed, torch.int32, dev)),
            "hard": None if queries.hard is None else to_tensor(queries.hard, torch.bool, dev),
            "mask": None if queries.mask is None else to_tensor(queries.mask, torch.int32, dev),
        }

    def _summary_tensors(self) -> tuple:
        """(n_rows, attr_min, attr_max) of the summaries on the device, once."""
        got = getattr(self, "_summaries_dev", None)
        if got is None:
            s, dev = self.summaries, self.device
            got = (to_tensor(s.n_rows, torch.int64, dev), to_tensor(s.attr_min, torch.int32, dev),
                   to_tensor(s.attr_max, torch.int32, dev))
            self._summaries_dev = got
        return got

    def _survivors(self, q: dict, hard_all: bool) -> torch.Tensor:
        """``survivor_mask`` over device operands (``_probe_operands``)."""
        n_rows, amin, amax = self._summary_tensors()
        lo, hi = q["lo"], q["hi"]
        b, p = lo.shape[0], self.n_partitions
        ok = (n_rows > 0)[None, :].expand(b, p)  # (B, P)
        active = torch.ones_like(lo, dtype=torch.bool) if q["mask"] is None else q["mask"] != 0
        if hard_all:
            hard = active
        elif q["hard"] is not None:
            hard = q["hard"] & active
        else:
            return ok
        # interval-hull intersection per hard dim: [lo, hi] ∩ [min, max] ≠ ∅
        hit = (amax[None, :, :] >= lo[:, None, :]) & (amin[None, :, :] <= hi[:, None, :])
        if q["allowed"] is not None:
            # ONE_OF dims: some *member value* must lie inside the hull,
            # strictly stronger than the covering-interval test and still
            # conservative (values outside [min, max] cannot occur)
            av = q["allowed"][:, None, :, :]  # (B, 1, L, V), -1 padded
            member_hit = (
                (av >= 0) & (av >= amin[None, :, :, None]) & (av <= amax[None, :, :, None])
            ).any(-1)  # (B, P, L)
            hit = torch.where(q["hard"][:, None, :], member_hit, hit)
        return ok & torch.where(hard[:, None, :], hit, True).all(-1)

    def probe(self, queries, nprobe: int, hard_all: bool, operands: Optional[dict] = None
              ) -> np.ndarray:
        """(B, nprobe) partition ids by ascending centroid distance over the
        survivor set; -1 slots mark pruned/empty probes. Computed on the
        index's device from ``operands`` (``_probe_operands``'s keys; made
        from ``queries`` when None); only the ids come back to the host."""
        q = self._probe_operands(queries) if operands is None else operands
        return self.probe_ids(q, nprobe, hard_all).cpu().numpy()

    def probe_ids(self, q: dict, nprobe: int, hard_all: bool) -> torch.Tensor:
        """``probe`` on the device, over device operands: (B, nprobe) int32."""
        scores = self.quantizer.scores(q["vectors"])  # (B, P)
        scores = torch.where(self._survivors(q, hard_all), scores, torch.inf)
        order = torch.sort(scores, dim=1, stable=True).indices[:, :nprobe]
        chosen = scores.gather(1, order)
        return torch.where(torch.isfinite(chosen), order, -1).to(torch.int32)

    # -- construction ------------------------------------------------------

    @classmethod
    def build(
        cls,
        features,
        attrs,
        n_partitions: int,
        help_cfg: HelpConfig = HelpConfig(),
        quant_cfg: Optional[QuantConfig] = None,
        metric_mode: str = "auto",
        alpha: Optional[float] = None,
        nhq_weight: float = 1.0,
        stats_seed: int = 0,
        build_graph: bool = True,
        residency_rows: Optional[int] = None,
        kmeans_iters: int = 50,
        seed: int = 0,
        device=None,
    ) -> "PartitionedStableIndex":
        """Train the coarse quantizer, slice the corpus into partitions and
        build each partition's subgraph/codes on ``device`` (None → the
        CUDA card).

        Calibration (AUTO stats → metric) and codec training run *globally*,
        as ``StableIndex.build`` runs them on the same arrays, then code rows
        are sliced per partition (see the module docstring). A partition
        smaller than ``gamma + 2`` rows gets (n, 0) scan-only adjacency (the
        searcher scans it exactly instead of traversing).
        """
        dev = resolve_device(device)
        quant_cfg = quant_cfg or QuantConfig()
        features = np.asarray(features, np.float32)
        attrs_np = np.asarray(attrs, np.int32)
        stats = auto_mod.sample_stats(features, attrs_np, seed=stats_seed)
        metric_cfg = MetricConfig(
            mode=metric_mode,
            alpha=float(alpha) if alpha is not None else stats.alpha,
            nhq_weight=nhq_weight,
        )
        seconds = {}
        t0 = time.perf_counter()
        quant = QuantizedVectors.build(to_tensor(features, torch.float32, dev), quant_cfg)
        codes_np = None if quant is None else quant.codes.cpu().numpy()
        _sync(dev)
        seconds["codec"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        quantizer = train_coarse(features, n_partitions, n_iters=kmeans_iters, seed=seed,
                                 device=dev)
        assign = quantizer.assign(features)
        seconds["kmeans"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        parts: dict[int, PartitionData] = {}
        n_rows = np.zeros(n_partitions, np.int64)
        attr_min = np.zeros((n_partitions, attrs_np.shape[1]), np.int32)
        attr_max = np.zeros((n_partitions, attrs_np.shape[1]), np.int32)
        for pid in range(n_partitions):
            rows = np.where(assign == pid)[0]  # ascending global ids
            n_rows[pid] = rows.size
            f_p = features[rows]
            a_p = attrs_np[rows]
            if rows.size:
                attr_min[pid], attr_max[pid] = a_p.min(0), a_p.max(0)
            if build_graph and rows.size >= help_cfg.gamma + 2:
                graph, _, _ = help_mod.build_help_graph(
                    to_tensor(f_p, torch.float32, dev), to_tensor(a_p, torch.int32, dev),
                    metric_cfg, help_cfg,
                )
                g_p = graph.cpu().numpy()
            else:
                g_p = np.zeros((rows.size, 0), np.int32)
            parts[pid] = PartitionData(
                features=f_p, attrs=a_p, graph=g_p,
                codes=None if codes_np is None else codes_np[rows],
                row_ids=rows.astype(np.int64),
            )
        seconds["partitions"] = time.perf_counter() - t0
        return cls(
            quantizer=quantizer,
            summaries=PartitionSummaries(n_rows, attr_min, attr_max),
            metric_cfg=metric_cfg, help_cfg=help_cfg, stats=stats,
            quant_cfg=quant_cfg,
            attrs=attrs_np,
            sq_params=None if quant is None else quant.sq_params,
            codebook=None if quant is None else quant.codebook,
            rotation=None if quant is None else quant.rotation,
            _parts=parts,
            graph_built=build_graph,
            residency_rows=residency_rows,
            device=dev,
            build_seconds=seconds,
        )

    # -- persistence -------------------------------------------------------

    def save(self, path: str, extra_meta: Optional[dict] = None) -> None:
        os.makedirs(path, exist_ok=True)
        self.quantizer.save(path)
        np.save(os.path.join(path, "attrs.npy"), np.asarray(self.attrs))
        if self.sq_params is not None:
            np.save(os.path.join(path, "quant_sq_scale.npy"), self.sq_params.scale.cpu().numpy())
            np.save(os.path.join(path, "quant_sq_zero.npy"), self.sq_params.zero.cpu().numpy())
        if self.codebook is not None:
            np.save(os.path.join(path, "quant_centroids.npy"),
                    self.codebook.centroids.cpu().numpy())
        if self.rotation is not None:
            np.save(os.path.join(path, "quant_rotation.npy"), self.rotation.cpu().numpy())
        for pid in range(self.n_partitions):
            d = _part_dir(path, pid)
            os.makedirs(d, exist_ok=True)
            part = self._load_partition(pid)
            np.save(os.path.join(d, "features.npy"), np.asarray(part.features, np.float32))
            np.save(os.path.join(d, "attrs.npy"), np.asarray(part.attrs, np.int32))
            np.save(os.path.join(d, "graph.npy"), np.asarray(part.graph, np.int32))
            np.save(os.path.join(d, "row_ids.npy"), np.asarray(part.row_ids, np.int64))
            if part.codes is not None:
                np.save(os.path.join(d, "quant_codes.npy"), np.asarray(part.codes))
        meta = {
            "format": PARTITIONED_FORMAT,
            "n_partitions": self.n_partitions,
            "has_graph": self.has_graph,
            "metric_cfg": dataclasses.asdict(self.metric_cfg),
            "help_cfg": dataclasses.asdict(self.help_cfg),
            "stats": dataclasses.asdict(self.stats),
            "quant_cfg": dataclasses.asdict(self.quant_cfg),
            "quant_dim": self.codebook.dim if self.codebook else None,
            "quant_codec": (codec_spec(self.quant_cfg)
                            if self.quant_cfg.mode != "none" else None),
            "summaries": self.summaries.to_json(),
            **(extra_meta or {}),
        }
        tmp = os.path.join(path, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)
        os.replace(tmp, os.path.join(path, "meta.json"))

    @classmethod
    def load(
        cls, path: str, residency_rows: Optional[int] = None, device=None
    ) -> "PartitionedStableIndex":
        """Open a ``stable-partitioned-v1`` directory (either package's):
        codec state and centroids onto ``device`` (None → the CUDA card),
        every other array memory-mapped."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("format") != PARTITIONED_FORMAT:
            raise ValueError(f"{path} is not a {PARTITIONED_FORMAT} layout")
        dev = resolve_device(device)
        quant_cfg = QuantConfig(**meta["quant_cfg"])
        if quant_cfg.mode != "none":
            check_codec_spec(meta.get("quant_codec"), quant_cfg)

        def arr(name):
            return to_tensor(np.load(os.path.join(path, name)), torch.float32, dev)

        sq_params = codebook = rotation = None
        if quant_cfg.mode == "sq8":
            sq_params = SQParams(scale=arr("quant_sq_scale.npy"), zero=arr("quant_sq_zero.npy"))
        elif is_pq_mode(quant_cfg.mode):
            codebook = PQCodebook(centroids=arr("quant_centroids.npy"),
                                  dim=int(meta["quant_dim"]))
            if os.path.exists(os.path.join(path, "quant_rotation.npy")):
                rotation = arr("quant_rotation.npy")
        return cls(
            quantizer=CoarseQuantizer.load(path, device=dev),
            summaries=PartitionSummaries.from_json(meta["summaries"]),
            metric_cfg=MetricConfig(**meta["metric_cfg"]),
            help_cfg=HelpConfig(**meta["help_cfg"]),
            stats=DatasetStats(**meta["stats"]),
            quant_cfg=quant_cfg,
            attrs=np.load(os.path.join(path, "attrs.npy"), mmap_mode="r"),
            sq_params=sq_params, codebook=codebook, rotation=rotation,
            path=path,
            graph_built=bool(meta.get("has_graph", True)),
            residency_rows=residency_rows,
            device=dev,
        )


def is_partitioned_dir(path: str) -> bool:
    """Format sniff for ``Engine.load``."""
    meta = os.path.join(path, "meta.json")
    if not os.path.exists(meta):
        return False
    with open(meta) as f:
        return json.load(f).get("format") == PARTITIONED_FORMAT
