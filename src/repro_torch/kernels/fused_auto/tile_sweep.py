"""Time every tile of the fused_auto kernel against the others, on one card.

``fused_auto_launch`` picks its tile from B alone. This script backs that
choice with measurements: it builds a probe library that includes
``csrc/fused_auto.cu`` and exposes the tile template at each candidate
shape, then for every B of a sweep, at the retrieval width (M = 10, L = 4)
and the oracle width (M = 128, L = 5), N = 1M rows, l2 and auto (point
targets), it times each tile and checks that every tile's scores equal
the shipped launcher's bit for bit. A time is device ms, the lesser of two
readings of 20 calls replayed from one CUDA graph, taken in the tile order
A, B, C and then C, B, A. Run from the root of a checkout:

    PYTHONPATH=src python -m repro_torch.kernels.fused_auto.tile_sweep [--json PATH]

It prints the card's name and power limit and one line per shape, and
writes the table as JSON to PATH when asked.
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
from repro_torch.kernels.common import inv_alpha, mode_code
from repro_torch.kernels.fused_auto.ops import fused_auto

#: candidate tiles: (name, BM, BN, TM, TN) of the kernel template.
TILES = (("16x256", 16, 256, 4, 4), ("64x64", 64, 64, 4, 4), ("128x128", 128, 128, 8, 8))
BATCHES = (1, 8, 16, 17, 24, 32, 48, 64, 65, 80, 96, 128)
#: (M, L): the recsys retrieval head and the SIFT1M-shaped brute oracle.
WIDTHS = ((10, 4), (128, 5))
N_ROWS = 1_000_000
ALPHA = 0.8


def probe_source() -> str:
    cases = "\n".join(
        f"    case {i}: return launch_tile<{bm}, {bn}, {tm}, {tn}>(ARGS);"
        for i, (_, bm, bn, tm, tn) in enumerate(TILES)
    )
    return f"""#include "{build.CSRC / 'fused_auto.cu'}"
#define ARGS (const float*)qv, (const float*)xv, (const int*)qlo, (const int*)qhi, \\
    (const int*)mask, (const int*)xa, (float*)out, B, N, M, L, inv_alpha, mode, vec_out, \\
    (cudaStream_t)stream
extern "C" int fused_auto_tile_launch(int tile, const void* qv, const void* xv,
                                      const void* qlo, const void* qhi, const void* mask,
                                      const void* xa, void* out, int B, int N, int M, int L,
                                      float inv_alpha, int mode, void* stream) {{
  const int vec_out = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  switch (tile) {{
{cases}
  }}
  return (int)cudaErrorInvalidValue;
}}
"""


def build_probe():
    out_dir = build.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "fused_auto_tiles.cu"
    src.write_text(probe_source())
    lib = out_dir / "fused_auto_tiles.so"
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"probe build failed:\n{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    fn = ctypes.CDLL(str(lib)).fused_auto_tile_launch
    fn.argtypes = [ctypes.c_int, *build.SIGNATURES["fused_auto"]]
    fn.restype = ctypes.c_int
    return fn, res.stdout + res.stderr


def device_ms(fn, reps: int = 20) -> float:
    """``reps`` calls captured in one CUDA graph, replayed between two
    events after a warm-up replay; ms a call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=Path, help="write the table here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tile_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(gpu, flush=True)
    launch, ptxas = build_probe()
    print("\n".join(ln for ln in ptxas.splitlines() if "registers" in ln or "spill" in ln))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for m, l in WIDTHS:
        xv = torch.randn((N_ROWS, m), generator=g, device=dev)
        xa = torch.randint(0, 8, (N_ROWS, l), generator=g, device=dev, dtype=torch.int32)
        for b in BATCHES:
            qv = torch.randn((b, m), generator=g, device=dev)
            qa = torch.randint(0, 8, (b, l), generator=g, device=dev, dtype=torch.int32)
            out = torch.empty((b, N_ROWS), device=dev)
            for mode in ("l2", "auto"):
                shipped = fused_auto(qv, qa, xv, xa, ALPHA, mode)

                def run(tile, mode=mode, qv=qv, qa=qa, out=out, b=b):
                    rc = launch(tile, qv.data_ptr(), xv.data_ptr(), qa.data_ptr(), qa.data_ptr(),
                                None, xa.data_ptr(), out.data_ptr(), b, N_ROWS, m, l,
                                inv_alpha(ALPHA), mode_code(mode),
                                torch.cuda.current_stream().cuda_stream)
                    build.check("fused_auto_tile", rc)

                for t, (name, *_) in enumerate(TILES):
                    run(t)
                    if not torch.equal(out, shipped):
                        raise SystemExit(f"tile {name} B={b} M={m} {mode}: scores differ "
                                         "from the shipped launcher's")
                order = list(range(len(TILES)))
                times = {name: [] for name, *_ in TILES}
                for t in order + order[::-1]:
                    times[TILES[t][0]].append(device_ms(lambda t=t: run(t)))
                row = {"B": b, "M": m, "L": l, "mode": mode,
                       "ms": {k: min(v) for k, v in times.items()}, "ms_both_passes": times}
                rows.append(row)
                best = min(row["ms"], key=row["ms"].get)
                print(f"B={b:4d} M={m:3d} {mode:4s} "
                      + " ".join(f"{k}={v:.4f}" for k, v in row["ms"].items())
                      + f"  fastest {best}", flush=True)
            del qv, qa, out, shipped
        del xv, xa
        torch.cuda.empty_cache()
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"gpu": gpu, "n_rows": N_ROWS, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
