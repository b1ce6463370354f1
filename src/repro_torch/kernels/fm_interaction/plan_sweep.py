"""Time fm_interaction's launch-plan variants against each other, on one card.

``launch_plan`` picks the path (a persistent ring of shared-memory stages,
or reads straight from device memory), the resident blocks an SM and the
stages a block. This script backs those choices: at the fm widths (F = 39,
D = 10) and serve_p99, train_batch and serve_bulk (B = 512, 65,536,
262,144) it runs the forward and the backward kernel under each variant,
checks that every variant's results equal the plain versions bit for bit,
and times each. A time is device ms, the lesser of two readings of 20
calls replayed from one CUDA graph, taken in the variant order and then
in reverse. ``--baseline FILE`` builds another source that exports
``int fm_interaction_launch(emb, out, B, F, D, stream)`` (an earlier
kernel, say the parent commit's, from ``git show``) and times its forward
in the same turns, held to the same bits. Run from the root of a
checkout:

    PYTHONPATH=src python -m repro_torch.kernels.fm_interaction.plan_sweep [--baseline FILE] [--json PATH]

It prints the card's name and power limit and one line per shape and
variant, and writes the table as JSON to PATH when asked.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fm_interaction.ops import (
    direct_plan, fm_interaction_bwd_ref, fm_interaction_ref, plan_for, stage_examples,
    staged_plan,
)
from repro_torch.kernels.fused_auto.tile_sweep import device_ms

F_FIELDS, D_DIM = 39, 10
BATCHES = {"serve_p99": 512, "train_batch": 65_536, "serve_bulk": 262_144}
#: staged variants: (resident blocks an SM, stages a block)
STAGED = ((1, 3), (1, 4), (1, 6), (2, 2), (2, 3), (2, 4), (3, 2), (3, 3))
#: staged runs at serve_p99: examples a block (grid 256, 128, 86, 64)
SMALL_RUNS = (2, 4, 6, 8)
HBM_BYTES_PER_S = 3.35e12


def baseline_launcher(src: Path):
    out = build.BUILD_DIR / f"fm_baseline-{src.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out), str(src)], check=True)
    fn = ctypes.CDLL(str(out)).fm_interaction_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def variants(b: int, sms: int) -> dict:
    """The plans timed at batch ``b``: None for the shipped ones (each
    direction its own ``launch_plan``), then forced plans that run both
    kernels (a staged one therefore has at least 2 stages)."""
    out = {"shipped": None, "direct": direct_plan(b, D_DIM, sms)}
    for bps, stages in STAGED:
        run = stage_examples(F_FIELDS, D_DIM, bps, stages)
        out[f"staged {bps}x{stages}"] = staged_plan(b, F_FIELDS, D_DIM, sms, bps, stages, run)
    if b <= 4096:  # one short run a block, enough blocks to cover the SMs
        for e in SMALL_RUNS:
            out[f"staged E={e}"] = staged_plan(b, F_FIELDS, D_DIM, sms, 4, 2, e)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, help="a source exporting the earlier launcher")
    ap.add_argument("--json", type=Path, help="write the table here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("plan_sweep: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fwd, bwd = build.launcher("fm_interaction"), build.launcher("fm_interaction_bwd")
    base = baseline_launcher(args.baseline) if args.baseline else None
    table = {"card": card, "shapes": {}}

    def call(name, fn, *args):  # on the current stream: a graph capture's too
        return lambda: build.check(name, fn(*args, torch.cuda.current_stream().cuda_stream))

    for cell, b in BATCHES.items():
        g = torch.Generator(device=dev).manual_seed(b)
        emb = torch.randn(b, F_FIELDS, D_DIM, generator=g, device=dev) * 0.3
        up = torch.randn(b, generator=g, device=dev)
        want_out, want_grad = fm_interaction_ref(emb), fm_interaction_bwd_ref(emb, up)
        out, grad = torch.empty(b, device=dev), torch.empty_like(emb)
        dims = (b, F_FIELDS, D_DIM)
        calls = {}
        for name, plan in variants(b, sms).items():
            fplan, bplan = (plan, plan) if plan else (plan_for(emb), plan_for(emb, True))
            calls[name] = (call(name, fwd, emb.data_ptr(), out.data_ptr(), *dims, *fplan.args),
                           call(name, bwd, emb.data_ptr(), up.data_ptr(), grad.data_ptr(), *dims,
                                *bplan.args),
                           (fplan, bplan))
        if base is not None:
            calls["baseline"] = (call("baseline", base, emb.data_ptr(), out.data_ptr(), *dims),
                                 None, None)
        for name, (f_call, b_call, _) in calls.items():  # every variant's bits first
            out.zero_(), grad.zero_()
            f_call()
            if b_call is not None:
                b_call()
            torch.cuda.synchronize()
            if not torch.equal(out, want_out) or (b_call and not torch.equal(grad, want_grad)):
                raise SystemExit(f"{cell} {name}: not bitwise equal to the plain version")
        # yardsticks, not kernels of the port: one read of emb (a sum) and
        # one read and write of its bytes (a copy), as PyTorch's own kernels
        # reach them
        calls["torch sum | copy"] = (lambda: emb.sum(), lambda: grad.copy_(emb), None)
        times = {name: [float("inf"), float("inf")] for name in calls}
        order = list(calls)
        for names in (order, order[::-1]):
            for name in names:
                f_call, b_call, _ = calls[name]
                times[name][0] = min(times[name][0], device_ms(f_call))
                if b_call is not None:
                    times[name][1] = min(times[name][1], device_ms(b_call))
        fwd_bound = (b * F_FIELDS * D_DIM * 4 + b * 4) / HBM_BYTES_PER_S * 1e3
        bwd_bound = (2 * b * F_FIELDS * D_DIM * 4 + b * 4) / HBM_BYTES_PER_S * 1e3
        rows = {}
        for name, (fm, bm) in times.items():
            plan = calls[name][2]
            rows[name] = {"forward_device_ms": fm,
                          "backward_device_ms": bm if bm < float("inf") else None,
                          "plans": None if plan is None else [p.__dict__ for p in plan]}
            print(f"{cell} B={b} {name:>12}: forward {fm:.4f} ms ({100 * fwd_bound / fm:.1f}% of "
                  f"{fwd_bound:.4f})"
                  + (f", backward {bm:.4f} ms ({100 * bwd_bound / bm:.1f}% of {bwd_bound:.4f})"
                     if bm < float("inf") else "")
                  + "".join(f"  [{p.path}, E={p.examples}, grid={p.grid}, stages={p.stages}, "
                            f"threads={p.threads}]" for p in dict.fromkeys(plan or ())),
                  flush=True)
        table["shapes"][cell] = {"B": b, "forward_bound_ms": fwd_bound,
                                 "backward_bound_ms": bwd_bound, "variants": rows}
        del emb, up, want_out, want_grad, out, grad
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(table, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
