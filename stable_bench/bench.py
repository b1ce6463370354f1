"""Run one cell of ``BENCHMARK.json``: set-up, a measured window, the check.

Everything a cell needs is found by name: the workload in
``BENCHMARK.json``, its configuration's file, its traffic mix under
``traffic/``, the mix's driver under ``drivers/``, its correctness limits
under ``limits/`` and each per-layer metric's reader under
``layer_metrics/``. A key the harness does not read, in a configuration or
a mix, stops the run.

A run:

1. set-up (``setup_s``, from the start of the process): the data is drawn
   on the card from the seed (``datagen``), the program's ``Engine.build``
   (or ``Engine.build_partitioned``, where the configuration's ``index``
   names a ``partition``) indexes it as that ``index`` states (``build_s``), the
   program compiles each group of queries once (``loadgen``), and the
   driver warms up every shape the window uses (the first run in a
   checkout also builds the kernels there);
2. the window: the driver's calls of ``Engine.search`` for ``seconds``.
   With ``--trace 1`` the first calls (``TRACE_CALLS`` and
   ``TRACE_SECONDS``) run under ``torch.profiler`` and each call's hop and
   evaluation counters are read;
3. after the window: the peak device memory is read, the program's index is
   freed, and the reference (``reference.py``) judges every answer
   (``check.py``) and gives the exact top-k that recall is taken against.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from stable_bench import check, datagen, devtrace, loadgen, reference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: a ``--trace 1`` run profiles the window's first calls: at least this many
#: and seconds
TRACE_CALLS, TRACE_SECONDS = 8, 1.0
#: top-level modules that may not be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the keys of a configuration's file; ``index`` holds ``help`` (the
#: program's ``HelpConfig`` fields), ``quant`` (``QuantConfig``'s, or null)
#: and ``partition`` (null, or ``PartitionedStableIndex.build`` keywords: the
#: flat index where it is missing or null)
CONFIG_KEYS = {"name", "source", "reduced", "n_rows", "dim", "n_queries", "attr_dim",
               "labels_per_dim", "cardinality", "profile", "n_clusters", "data_seed",
               "latent_dim", "index", "assumed"}
INDEX_KEYS = {"help", "quant", "partition"}
#: ``n_partitions`` is required; ``residency_rows`` null lets every
#: partition stay resident
PARTITION_KEYS = {"n_partitions", "residency_rows", "kmeans_iters"}
#: the sub-backends a partitioned mix may pin (the planner's "auto" would
#: leave the choice to its cost model)
SUB_BACKENDS = ("brute", "graph")
#: the end-to-end quantities a run measures; a metric ``<quantity>.<part>``
#: is that quantity, reported in the cells its ``workloads`` names
END_TO_END = ("qps", "p95_ms", "recall_at_10", "setup_s")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def foreign_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _module(folder: str, name: str):
    """``<folder>/<name>.py`` of the benchmark, loaded from its file."""
    path = HERE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"stable_bench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quantity(name: str, known) -> str:
    """The quantity a metric name reports: the name itself where a reader or
    an end-to-end quantity has it, else the name without its last part."""
    return name if name in known or "." not in name else name.rsplit(".", 1)[0]


class Cell:
    """One workload of the manifest with everything it is found by."""

    def __init__(self, manifest: dict, name: str):
        work = {w["name"]: w for w in manifest["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(work)})")
        self.workload = work[name]
        self.name = name
        conf = {c["name"]: c for c in manifest["configs"]}[self.workload["config"]]
        self.config = load_json(ROOT / conf["file"])
        index = self.config.get("index", {})
        unread = ((set(self.config) - CONFIG_KEYS) | (set(index) - INDEX_KEYS)
                  | (set(index.get("partition") or {}) - PARTITION_KEYS))
        if unread:
            raise ValueError(f"{conf['file']}: keys the harness does not read: {sorted(unread)}")
        self.mix = loadgen.load_mix(self.workload["traffic"])
        check_backend(conf["file"], index, self.workload["traffic"], self.mix["params"])
        self.driver = _module("drivers", self.mix["driver"])
        self.limits = load_json(HERE / "limits" / f"{name}.json")
        self.end_to_end = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in manifest["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)
        ]


def check_backend(config_file: str, index: dict, traffic: str, params: dict) -> None:
    """Stop the run before set-up where the mix's backend cannot search the
    configuration's index: a partitioned index takes the partitioned backend
    and a flat one any other, and a partitioned mix pins ``nprobe`` and its
    sub-backend."""
    part = index.get("partition")
    backend = params.get("backend")
    if part is not None and "n_partitions" not in part:
        raise ValueError(f"{config_file}: index.partition needs n_partitions")
    if (part is not None) != (backend == "partitioned"):
        kind = "a partitioned" if part is not None else "a flat"
        raise ValueError(f"traffic {traffic!r} searches with backend {backend!r}, which "
                         f"{kind} index ({config_file}) does not take")
    if backend == "partitioned" and not (params.get("nprobe", 0) > 0
                                         and params.get("sub_backend") in SUB_BACKENDS):
        raise ValueError(f"traffic {traffic!r}: a partitioned mix names nprobe (> 0) and "
                         f"sub_backend (one of {SUB_BACKENDS})")


def reader(metric: str):
    """The ``read(ctx)`` function of one per-layer metric (``layer_metrics/``,
    by the metric's name, or by its quantity's where the metric is split)."""
    known = {p.stem for p in (HERE / "layer_metrics").glob("*.py")}
    return _module("layer_metrics", quantity(metric, known)).read


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_engine(api, cfg: dict, features, attrs, device):
    """``Engine.build`` with the configuration's index: its ``HelpConfig`` and
    codec; ``Engine.build_partitioned`` where the index names a
    ``partition``, with its keywords as well."""
    from repro_torch.core.help_graph import HelpConfig
    from repro_torch.quant import QuantConfig

    idx = cfg["index"]
    help_cfg = HelpConfig(**idx.get("help", {}))
    quant = QuantConfig(**idx["quant"]) if idx.get("quant") else None
    part = idx.get("partition")
    if part is not None:
        rest = {k: v for k, v in part.items() if k != "n_partitions"}
        return api.Engine.build_partitioned(features, attrs, part["n_partitions"],
                                            help_cfg=help_cfg, quant_cfg=quant, device=device,
                                            **rest)
    return api.Engine.build(features, attrs, help_cfg=help_cfg, quant_cfg=quant, device=device)


class Program:
    """The system under test, set up for one cell: data, index, batches."""

    def __init__(self, cell: Cell, seed: int, device, api):
        cfg, mix = cell.config, cell.mix
        self.mix, self.device = mix, device
        self.phases = {}
        t = time.perf_counter()
        torch.empty(1, device=device)
        sync(device)
        t = self._phase("device init", t)
        self.data = datagen.make_data(cfg, seed, device)
        sync(device)
        t = self._phase("data", t)
        host = [x.cpu().numpy() for x in self.data]
        t = self._phase("host copy", t)
        self.groups = cell.driver.groups(mix, cfg["n_queries"])
        self.rows = [rows for _, rows in self.groups]
        self.batches = loadgen.group_batches(api, mix["classes"], host[2], host[3],
                                             cfg["labels_per_dim"], self.rows)
        t = self._phase("queries compiled", t)
        self.engine = build_engine(api, cfg, host[0], host[1], device)
        sync(device)
        t = self._phase("build", t)
        self.build_s = self.phases["build"]
        self.params = api.SearchParams(**mix["params"])
        cell.driver.warm_up(self)
        sync(device)
        self._phase("warm-up", t)

    def _phase(self, name: str, t: float) -> float:
        now = time.perf_counter()
        self.phases[name] = now - t
        return now

    def call(self, c: int, pos: np.ndarray, counters: bool = False) -> dict:
        """One search of the rows ``pos`` of group ``c``: its answers on the
        host and its latency, with the hop and evaluation counters."""
        qb = self.batches[c].take(pos)
        t = time.perf_counter()
        res = self.engine.search(qb, self.params)
        ids, sq = res.ids.cpu().numpy(), res.sqdists.cpu().numpy()
        out = {"group": self.groups[c][0], "batch": len(pos), "latency_s": time.perf_counter() - t,
               "query": self.rows[c][pos], "ids": ids, "sq": sq}
        if counters:
            out["hops"] = int(res.n_hops)
            out["evals"] = int(res.n_dist_evals.sum())
        return out

    def free(self) -> None:
        """Drop the program's index and compiled plans; the compiled query
        batches stay for the check."""
        del self.engine
        gc.collect()
        if self.data.features.is_cuda:
            torch.cuda.empty_cache()


def measure(prog: Program, driver, seconds: float, trace: bool, min_calls: int = 1) -> dict:
    """The driver's window; returns the calls, the answers and, traced, the trace."""
    ex0 = dict(prog.engine.executor.stats())
    rec = devtrace.Recorder(TRACE_CALLS, TRACE_SECONDS) if trace else None
    span = rec.call if rec else (lambda name: contextlib.nullcontext())
    t0 = time.perf_counter()
    calls = driver.window(prog, seconds, span, trace, min_calls)
    window_s = time.perf_counter() - t0
    ex1 = prog.engine.executor.stats()
    answers = check.Answers(*(np.concatenate([c.pop(k) for c in calls]) for k in ("query", "ids", "sq")))
    return {
        "calls": calls, "window_s": window_s, "answers": answers,
        "executor": {k: ex1[k] - ex0[k] for k in ("hits", "misses")},
        "trace": rec.finish() if rec else None,
        "traced_calls": calls[:rec.n] if trace else [],
    }


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, api,
             t_start: float) -> dict:
    """Set up, measure and judge one run; returns the result line's object."""
    t = time.perf_counter()
    prog = Program(cell, seed, device, api)
    sync(device)
    setup_s = time.perf_counter() - t_start
    # what set-up left behind is never collected in the window
    gc.collect()
    gc.freeze()
    w = measure(prog, cell.driver, seconds, trace)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    prog.free()
    t_check = time.perf_counter()
    out = finish(cell, w, prog, setup_s, peak, device)
    phases = ", ".join(f"{k} {v:.3f}" for k, v in prog.phases.items())
    print(f"set-up {setup_s:.3f} s (start {t - t_start:.3f}, {phases}), "
          f"window {w['window_s']:.3f} s ({len(w['calls'])} calls), "
          f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    return out


def finish(cell, w, prog, setup_s, peak, device) -> dict:
    """Judge the window's answers against the reference and assemble the
    result line. ``prog`` gives the data, the compiled batches, their groups
    and the build time; its index may be freed."""
    cfg, mix = cell.config, cell.mix
    data = prog.data
    preds = reference.compile_predicates(mix["classes"], data.query_attrs, cfg["labels_per_dim"])
    numbers = {"predicates": check.predicate_mismatches(prog.batches, prog.rows, preds)}
    alpha = reference.alpha(data.features, data.attrs)
    exact = reference.exact_topk(data.features, data.attrs, data.query_features, preds,
                                 mix["params"]["k"])
    promises = check.promises(mix["params"], cfg["index"])
    judged = check.judge(data.features, data.attrs, data.query_features, preds, alpha, exact,
                         w["answers"], promises)
    recall = judged.pop("recall")
    malformed_by = judged.pop("malformed_by")
    numbers.update(judged)
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    lat = [c["latency_s"] for c in w["calls"]]
    queries = sum(c["batch"] for c in w["calls"])
    e2e = {
        "qps": queries / w["window_s"],
        "p95_ms": (statistics.quantiles(lat, n=20)[-1] if len(lat) > 1 else lat[0]) * 1e3,
        "recall_at_10": recall,
        "setup_s": setup_s,
    }
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.workload["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": queries, "failed": numbers["malformed"],
           "malformed_by": malformed_by}
    if w["trace"] is None:
        out["metrics"] = {m["name"]: {"value": e2e[quantity(m["name"], END_TO_END)],
                                      "unit": m["unit"]} for m in cell.end_to_end}
    else:
        ctx = {"calls": w["calls"], "traced_calls": w["traced_calls"], "executor": w["executor"],
               "build_s": prog.build_s, "trace": w["trace"], "config": cfg, "mix": mix}
        out["metrics"] = {}
        for m in cell.per_layer:
            v = reader(m["name"])(ctx)
            if v is not None:
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = w["trace"]["busy_s"]
        dev["window_s"] = w["trace"]["window_s"]
        out["breakdown"] = w["trace"]["breakdown"]
    out["device"] = dev
    out["checks"] = checks
    return out
