"""Dry run: every (arch × shape × mesh) cell's step, on meta tensors, on
the production meshes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b \\
        --shape train_4k --mesh single

The reference lowers and compiles each cell with XLA on 512 placeholder
host devices and reads the compiler's memory and cost analyses. The port
has no compiler to ask: PyTorch runs eagerly, and nothing inserts
collectives. So its dry run runs each cell's step once on
``torch.device("meta")`` tensors, which carry shapes and dtypes and no
memory, and counts what the step does as it dispatches. Nothing is
allocated on any device, and no ``XLA_FLAGS`` are needed. For each cell it
builds the cell with ``launch.build.build_cell`` on
``launch.mesh.make_production_mesh`` and writes one JSON under
``DRYRUN_ARTIFACTS`` (default ``build/dryrun/``) with:

  * ``memory``: ``argument_bytes``, each argument's shard under its spec
    (``NamedSharding.shard_shape``) summed: exact, what one device holds;
    ``output_bytes`` the same over the outputs under ``out_specs`` (an
    output whose spec is ``None`` is counted whole, and the file says so);
    ``alias_bytes`` the donated arguments'; ``temp_bytes`` an estimate of
    the peak of live bytes the step allocates, tracked by a dispatch mode
    while it runs at one data-parallel replica's batch (``temp_method``
    says how and what it leaves out); ``per_device_total`` the reference's
    sum, arguments + temporaries + outputs − aliased.
  * ``cost``: ``flops`` of the whole step (the global batch) counted by
    ``torch.utils.flop_counter.FlopCounterMode``, and ``bytes_accessed``,
    every dispatched op's operand and result bytes summed (views left
    out): an upper bound with nothing fused. ``method`` says how.
  * ``corrected``: the reference's ``corrected_costs``, with its methods:
    LM and GNN cells counted at 1 and 2 layers (and 1 and 2 micro-batches
    where the cell has more) and extrapolated, bert4rec's blocks likewise,
    bert4rec serve and every retrieval cell counted over one chunk. The
    reference corrects XLA's count of a loop body once; a Python loop here
    counts every iteration, so the extrapolation only keeps runs short (a
    full-depth run of a large cell takes minutes), and the tests hold it
    to a full-depth count. Where it gives numbers, ``cost`` takes them;
    else (and with ``--no-correct``) the step is counted at full depth.
    The temporaries of an LM or GNN cell are extrapolated from 1 and 2
    layers the same way.
  * ``collectives`` and ``hlo_ops``: ``null``, with the reason. The
    reference parses them out of XLA's compiled HLO; there is no such
    program here.

The hand-written kernels on these paths (``fused_auto`` in retrieval,
``fm_interaction`` in fm) give their results' shapes on meta tensors and
count nothing, as their launches count nothing on the card, so a count
here equals the count of the same step on the card. Two host reads have
nothing to read on meta and are skipped there: the id range check of
``models.recsys._wrap_ids`` and ``graph_ops.largest_k``'s repair of rows
whose k-th value ties (its ties are not counted).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import tree as tree_mod
from repro_torch.distributed.sharding import NamedSharding, batch_axes, maybe, sharded_bytes

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))

TEMP_METHOD = (
    "peak of the live bytes of the storages the step allocates, tracked by a dispatch mode "
    "while it runs on meta tensors at one data-parallel replica's batch (each batch and "
    "cache dimension split over the data axes divided by their size), less the outputs it "
    "returns; a temporary of a parameter's shape or of one layer's slice of a stacked "
    "parameter (a gradient, an optimizer temporary) is divided by that parameter's shard "
    "count. Left out: the model axis's split of activations and caches, and what a "
    "compiler would fuse, reuse or overlap"
)
BYTES_METHOD = ("every dispatched op's operand and result bytes summed, views left out: "
                "an unfused upper bound")
NO_HLO = ("no compiled program: PyTorch runs eagerly and no compiler inserts collectives, "
          "so there is no HLO to parse")


def artifact_dir() -> str:
    return os.environ.get("DRYRUN_ARTIFACTS", os.path.join(ROOT, "build", "dryrun"))


def artifact_path(arch: str, shape: str, mesh_kind: str, tag: str = "") -> str:
    return os.path.join(artifact_dir(), f"{arch}__{shape}__{mesh_kind}{tag}.json")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


class StepCounter(TorchDispatchMode):
    """Counts, over the ops dispatched while it is active, the operand and
    result bytes (``bytes_accessed``) and the peak of the live bytes of
    the storages they allocate (``peak``; ``live`` at the end). Storages
    that exist before (``known``) are not counted. ``factor(t)`` divides a
    new storage's bytes (the shard count of a parameter-shaped tensor)."""

    def __init__(self, known=(), factor=None):
        super().__init__()
        self.bytes_accessed = 0
        self.live = self.peak = 0.0
        self._known = {t.untyped_storage()._cdata for t in known}
        self._refs: dict = {}
        self._factor = factor

    def _release(self, key: int, nb: float, _ref) -> None:
        self._refs.pop(key, None)
        self.live -= nb

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known or key in self._refs:
            return
        nb = st.nbytes() / (self._factor(t) if self._factor else 1)
        self._refs[key] = weakref.ref(st, lambda r, k=key, n=nb: self._release(k, n, r))
        self.live += nb
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not func.is_view:
            self.bytes_accessed += sum(_nbytes(t) for t in _tensors(args) + _tensors(kwargs))
            self.bytes_accessed += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out


def count_step(build) -> dict:
    """Run ``build.step`` once on its meta arguments and count it: FLOPs
    (``FlopCounterMode``), bytes accessed, and the outputs."""
    args = build.abstract_args
    with FlopCounterMode(display=False) as fc, StepCounter(tree_mod.leaves(args)) as sc:
        out = build.step(*args)
    return {"flops": float(fc.get_total_flops()), "bytes_accessed": float(sc.bytes_accessed),
            "out": out}


def _spec_bytes(mesh, out, specs) -> tuple[int, bool]:
    """Bytes of one shard of ``out`` under ``specs`` (same structure); a
    ``None`` spec counts its subtree whole. Returns (bytes, any whole)."""
    if specs is None:
        return sum(_nbytes(t) for t in tree_mod.leaves(out)), bool(tree_mod.leaves(out))
    if isinstance(out, torch.Tensor):
        return sharded_bytes(mesh, out, specs), False
    if isinstance(out, dict):
        pairs = [(out[k], specs[k]) for k in out]
    else:
        pairs = list(zip(out, specs))
    total, whole = 0, False
    for o, s in pairs:
        b, w = _spec_bytes(mesh, o, s)
        total, whole = total + b, whole or w
    return total, whole


def _state_args(kind: str) -> int:
    """How many leading arguments are parameters and optimizer state."""
    return 2 if kind == "train" else 1


def replica_args(build, mesh, kind: str, micro_cut: int = 1) -> tuple:
    """The arguments at one data-parallel replica's batch: each dimension
    of a batch or cache argument that its spec splits over the data axes
    divided by their size (and the leading one by ``micro_cut`` more);
    parameters and optimizer state as they are."""
    data_axes = set(batch_axes(mesh))
    n_state = _state_args(kind)

    def shrink(t, spec):
        shape = list(t.shape)
        for dim, entry in enumerate(spec):
            axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
            shape[dim] //= math.prod(mesh.shape[a] for a in axes if a in data_axes)
        if shape:
            shape[0] //= micro_cut
        return torch.empty(shape, dtype=t.dtype, device="meta")

    return build.abstract_args[:n_state] + tuple(
        tree_mod.tree_map(shrink, arg, specs)
        for arg, specs in zip(build.abstract_args[n_state:], build.in_specs[n_state:]))


def _temp(build, mesh, kind: str, micro_cut: int = 1) -> int:
    """One run's peak of live bytes above the arguments (``TEMP_METHOD``)."""
    n_state = _state_args(kind)
    factors: dict = {}
    for args, specs in zip(build.abstract_args[:n_state], build.in_specs[:n_state]):
        for t, s in zip(tree_mod.leaves(args), tree_mod.leaves(specs)):
            k = math.prod(t.shape) // max(math.prod(NamedSharding(mesh, s).shard_shape(t.shape)), 1)
            shapes = [tuple(t.shape)]
            if t.ndim > 1 and (not len(s) or s[0] is None):
                shapes.append(tuple(t.shape[1:]))  # one layer's slice of a stack
            for shape in shapes:
                factors[shape] = min(factors.get(shape, k), k)
    args = replica_args(build, mesh, kind, micro_cut)
    counter = StepCounter(tree_mod.leaves(args),
                          factor=lambda t: factors.get(tuple(t.shape), 1))
    with counter:
        out = build.step(*args)
    # what the step allocated and still returns is output, not temporary
    returned = {t.untyped_storage()._cdata: _nbytes(t) / factors.get(tuple(t.shape), 1)
                for t in tree_mod.leaves(out)}
    return int(max(counter.peak - sum(nb for key, nb in returned.items()
                                      if key in counter._refs), 0))


def _depth(spec, cell) -> Optional[int]:
    """The layer count of an LM or GNN cell (the loop the estimates
    extrapolate over), else None."""
    if spec.family == "lm":
        return spec.make_config().n_layers
    if spec.family == "gnn":
        return spec.make_config(cell).n_layers
    return None


def _solve2(c1: float, c2: float, L: int) -> float:
    per = c2 - c1
    return c1 - per + L * per


def temp_estimate(spec, cell, mesh, overrides: Optional[dict] = None) -> tuple[int, str]:
    """(temp bytes, how): ``TEMP_METHOD`` at full depth where the step has
    no layer loop; else at two depths a and a + 1, extrapolated linearly to
    the cell's depth (never below the deeper run's), with at most 2 of an
    LM cell's micro-batches (of the same size: each one's peak is the
    same). The depths are 1 and 2 unless a micro-batch has that many rows:
    then a stacked parameter's shape (L, …) could equal an activation's
    (rows, …) and be divided as the parameter's, so they start above it."""
    from repro_torch.launch.build import build_cell

    overrides = dict(overrides or {})
    L = _depth(spec, cell)
    if L is None:
        return _temp(build_cell(spec, cell, mesh, overrides), mesh, cell.kind), "full depth"
    L = overrides.get("n_layers", L)
    m = overrides.get("micro_batches", spec.micro_batches) if cell.kind == "train" else 1
    m2 = min(m, 2)
    a = 1
    if spec.family == "lm" and cell.kind == "train":
        overrides["micro_batches"] = m2
        axes = maybe(mesh, cell.global_batch, batch_axes(mesh)) or ()
        rows = cell.global_batch // math.prod(mesh.shape[x] for x in axes) // m
        a = 1 if rows > 2 else rows + 1  # rows: a micro-batch's
    t = [_temp(build_cell(spec, cell, mesh, overrides | {"n_layers": n}), mesh, cell.kind,
               micro_cut=m // m2) for n in (a, a + 1)]
    how = f"extrapolated L∈{{{a},{a + 1}}}→L={L}"
    if m > m2:
        how += f", {m2} of the {m} micro-batches"
    return int(max(t[0] + (L - a) * (t[1] - t[0]), t[1])), how


def _outputs(spec, cell, mesh, build, overrides: Optional[dict]) -> Any:
    """The full-depth step's outputs, from a run at one layer (and one
    micro-batch): an output that is an argument (updated in place, the
    donated parameters, state and cache) is the full build's argument."""
    from repro_torch.launch.build import build_cell

    if _depth(spec, cell) is None:
        return count_step(build)["out"]
    shallow = dict(overrides or {}, n_layers=1)
    if cell.kind == "train" and spec.family == "lm":
        shallow["micro_batches"] = 1
    small = build_cell(spec, cell, mesh, shallow)
    full = {id(a): b for a, b in zip(tree_mod.leaves(small.abstract_args),
                                     tree_mod.leaves(build.abstract_args))}
    return tree_mod.tree_map(lambda t: full.get(id(t), t), count_step(small)["out"])


def memory_analysis(spec, cell, mesh, build, overrides: Optional[dict] = None) -> dict:
    """The ``memory`` section of a cell's artifact."""
    arg = sharded_bytes(mesh, build.abstract_args, build.in_specs)
    alias = sum(sharded_bytes(mesh, build.abstract_args[i], build.in_specs[i])
                for i in build.donate)
    out, whole = _spec_bytes(mesh, _outputs(spec, cell, mesh, build, overrides),
                             build.out_specs)
    temp, how = temp_estimate(spec, cell, mesh, overrides)
    mem = {"argument_bytes": arg, "output_bytes": out, "temp_bytes": temp,
           "alias_bytes": alias, "per_device_total": arg + temp + out - alias,
           "temp_method": f"{TEMP_METHOD}; {how}"}
    if whole:
        mem["output_note"] = "outputs with no spec (layout left open) counted whole"
    return mem


def _count_cost(spec, cell, mesh, overrides) -> dict:
    from repro_torch.launch.build import build_cell

    cost = count_step(build_cell(spec, cell, mesh, overrides))
    return {"flops": cost["flops"], "bytes_accessed": cost["bytes_accessed"]}


def corrected_costs(spec, cell, mesh) -> dict:
    """The reference's corrected totals: c(L, m) = K0 + L·K1 + m·K2 +
    m·L·K3 solved from L, m ∈ {1, 2} and evaluated at the cell's (L, m);
    one-loop families extrapolate linearly from L ∈ {1, 2}; bert4rec serve
    and retrieval count one chunk; the other recsys cells are loop-free."""
    family, kind = spec.family, cell.kind

    def solve4(c11, c21, c12, c22, L, m):
        k3 = c22 - c21 - c12 + c11
        k1 = c21 - c11 - k3
        k2 = c12 - c11 - k3
        k0 = c11 - k1 - k2 - k3
        return k0 + L * k1 + m * k2 + m * L * k3

    solve2 = _solve2
    keys = ("flops", "bytes_accessed")

    if family == "lm":
        L = spec.make_config().n_layers
        base = {"unroll_attn": True, "unroll_layers": True, "n_layers": 1, "unroll_micro": True}
        if kind == "train":
            m = spec.micro_batches
            c11 = _count_cost(spec, cell, mesh, base | {"micro_batches": 1})
            c21 = _count_cost(spec, cell, mesh, base | {"n_layers": 2, "micro_batches": 1})
            if m > 1:
                c12 = _count_cost(spec, cell, mesh, base | {"micro_batches": 2})
                c22 = _count_cost(spec, cell, mesh, base | {"n_layers": 2, "micro_batches": 2})
                out = {k: solve4(c11[k], c21[k], c12[k], c22[k], L, m) for k in keys}
                method = f"extrapolated L∈{{1,2}}×m∈{{1,2}}→(L={L},m={m})"
                # MoE capacity rounds with the micro-batch count: where the
                # bilinear solve degenerates, extrapolate in L at m = 1
                if any(out[k] < 0.5 * c11[k] for k in keys):
                    out = {k: solve2(c11[k], c21[k], L) for k in keys}
                    method = f"extrapolated L∈{{1,2}}@m=1→L={L} (bilinear fallback)"
            else:
                out = {k: solve2(c11[k], c21[k], L) for k in keys}
                method = f"extrapolated L∈{{1,2}}→L={L}"
            return out | {"method": method}
        c1 = _count_cost(spec, cell, mesh, base)
        c2 = _count_cost(spec, cell, mesh, base | {"n_layers": 2})
        return {k: solve2(c1[k], c2[k], L) for k in keys} | {
            "method": f"extrapolated L∈{{1,2}}→L={L}"}

    if family == "gnn":
        L = spec.make_config(cell).n_layers
        c1 = _count_cost(spec, cell, mesh, {"n_layers": 1, "unroll_layers": True})
        c2 = _count_cost(spec, cell, mesh, {"n_layers": 2, "unroll_layers": True})
        return {k: solve2(c1[k], c2[k], L) for k in keys} | {
            "method": f"extrapolated L∈{{1,2}}→L={L}"}

    cfg_full = spec.make_config()
    if cfg_full.kind == "bert4rec":
        if kind == "serve":
            c = _count_cost(spec, cell, mesh, {"serve_chunk": cell.global_batch,
                                               "unroll_blocks": True})
            return c | {"method": "single-chunk count (one chunk of the whole batch)"}
        if kind != "retrieval":
            L = cfg_full.n_blocks
            c1 = _count_cost(spec, cell, mesh, {"n_blocks": 1, "unroll_blocks": True})
            c2 = _count_cost(spec, cell, mesh, {"n_blocks": 2, "unroll_blocks": True})
            return {k: solve2(c1[k], c2[k], L) for k in keys} | {
                "method": f"extrapolated blocks∈{{1,2}}→{L}"}
    if kind == "retrieval":
        c = _count_cost(spec, cell, mesh, {"score_chunk": cell.n_candidates})
        return c | {"method": "single-chunk count (one chunk of every candidate)"}
    return {"method": "raw (loop-free)"}


def run_cell(arch_id: str, shape: str, mesh_kind: str, overrides=None, tag: str = "",
             correct: bool = True) -> dict:
    """One cell's artifact (a dict): see the module's docstring."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.build import build_cell
    from repro_torch.launch.mesh import make_production_mesh

    spec = get_arch(arch_id)
    cell = spec.cell(shape)
    result = {"arch": arch_id, "shape": shape, "mesh": mesh_kind, "tag": tag,
              "family": spec.family, "kind": cell.kind, "ok": False}
    if cell.skipped:
        return result | {"skipped": True, "skip_reason": cell.skip_reason, "ok": True}

    mesh = make_production_mesh(multi_pod=(mesh_kind == "pod"))
    t0 = time.perf_counter()
    build = build_cell(spec, cell, mesh, overrides)
    t_build = time.perf_counter() - t0
    memory = memory_analysis(spec, cell, mesh, build, overrides)
    corrected = corrected_costs(spec, cell, mesh) if correct else {}
    if "flops" in corrected:
        cost = {k: corrected[k] for k in ("flops", "bytes_accessed")}
        cost["method"] = corrected["method"]
    else:
        counted = count_step(build)
        cost = {"flops": counted["flops"], "bytes_accessed": counted["bytes_accessed"],
                "method": "counted at full depth"}
    cost["flops_counter"] = "torch.utils.flop_counter.FlopCounterMode on meta tensors"
    cost["bytes_method"] = BYTES_METHOD
    result |= {
        "ok": True,
        "n_chips": math.prod(mesh.shape.values()),
        "build_s": round(t_build, 2),
        "count_s": round(time.perf_counter() - t0 - t_build, 2),
        "meta": build.meta,
        "memory": memory,
        "cost": cost,
        "collectives": None,
        "hlo_ops": None,
        "no_hlo": NO_HLO,
    }
    if correct:
        result["corrected"] = corrected
    return result


def summary(res: dict) -> str:
    """One line of a cell's artifact: argument and temp GB a device, the
    model FLOPs and the counted TFLOP with their method."""
    if res.get("skipped"):
        return f"SKIP {res['skip_reason'][:60]}"
    mem, cost = res["memory"], res["cost"]
    return (f"args/dev={mem['argument_bytes'] / 1e9:.4f}GB temp~{mem['temp_bytes'] / 1e9:.4f}GB "
            f"model_flops={res['meta']['model_flops']:.4e} "
            f"counted={cost['flops'] / 1e12:.4f}TFLOP ({cost['method']}) {res['count_s']}s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="dry run of the (arch × shape × mesh) cells "
                                             "on meta tensors")
    ap.add_argument("--arch")
    ap.add_argument("--arch-all-shapes", help="run every shape of one arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("single", "pod", "both"), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-correct", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import all_cells

    if args.all:
        cells = all_cells()
    elif args.arch_all_shapes:
        cells = [c for c in all_cells() if c[0] == args.arch_all_shapes]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --all, --arch-all-shapes ARCH, or --arch and --shape")
    os.makedirs(artifact_dir(), exist_ok=True)
    meshes = ("single", "pod") if args.mesh == "both" else (args.mesh,)
    failures = 0
    for arch, shape in cells:
        for mk in meshes:
            path = artifact_path(arch, shape, mk, args.tag)
            if args.skip_existing and os.path.exists(path):
                print(f"[skip] {arch} × {shape} × {mk} (exists)")
                continue
            try:
                res = run_cell(arch, shape, mk, tag=args.tag, correct=not args.no_correct)
            except Exception as e:  # recorded: a failure to fix, not to hide
                res = {"arch": arch, "shape": shape, "mesh": mk, "tag": args.tag, "ok": False,
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
                failures += 1
            with open(path, "w") as f:
                json.dump(res, f, indent=2)
            status = "FAIL" if not res["ok"] else "SKIP" if res.get("skipped") else "OK"
            extra = res["error"] if not res["ok"] else summary(res)
            print(f"[{status}] {arch} × {shape} × {mk} {extra}", flush=True)
    if failures:
        print(f"{failures} cells failed")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
