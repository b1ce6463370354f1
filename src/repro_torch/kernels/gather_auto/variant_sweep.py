"""Time the gather_auto kernel's variants against each other, on one card.

``gather_auto_launch`` picks the rows a warp keeps in flight (R) and the
candidates a warp scores (its span) from the number of work units; neither
enters a result. This script backs that choice with measurements: it builds
a probe library that includes ``csrc/gather_auto.cu`` and exposes the
kernel template at each (R, span) of ``VARIANTS``, then at the main path's
three shapes (a refine hop, B = 128, C = 1280; an NN-descent block,
B = 2048, C = 520; the build's narrow block, B = 2048, C = 32) over
N = 1M rows of M = 128 floats and L = 5 attributes, in l2 and auto modes
(point targets), it checks that every variant's scores equal the shipped
launcher's bit for bit and times each. With ``--baseline FILE`` it also
builds another gather_auto source (one that exports ``gather_auto_launch``,
such as an earlier version of the kernel), checks its scores against the
shipped launcher's bit for bit and times it beside the variants. A time is
device ms, the lesser of two readings of 20 calls replayed from one CUDA
graph, taken in the variant order and then in reverse. Run from the root
of a checkout:

    PYTHONPATH=src python -m repro_torch.kernels.gather_auto.variant_sweep \\
        [--baseline FILE] [--json PATH]

It prints the card's name and power limit and one line per shape and mode,
and writes the table as JSON to PATH when asked.
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
from repro_torch.kernels.fused_auto.tile_sweep import device_ms
from repro_torch.kernels.gather_auto.ops import gather_auto

#: (rows in flight a warp, candidates a warp)
VARIANTS = ((4, 32), (8, 8), (8, 16), (8, 32), (16, 16), (16, 32))
SHAPES = {"hop": (128, 1280), "descent": (2048, 520), "narrow": (2048, 32)}
N_ROWS, WIDTH, ATTRS = 1_000_000, 128, 5
ALPHA = 0.8


def probe_source() -> str:
    cases = "\n".join(
        f"  if (rows == {r} && span == {s}) return launch_rows<{r}>(ARGS, {s}, "
        "(cudaStream_t)stream);"
        for r, s in VARIANTS
    )
    return f"""#include "{build.CSRC / 'gather_auto.cu'}"
#define ARGS (const float*)qv, (const int*)qlo, (const int*)qhi, (const int*)mask, \\
    (const float*)db_v, (const int*)db_a, (const int*)cand, (float*)out, B, C, M, L, N, \\
    inv_alpha, mode, vec
extern "C" int gather_auto_variant_launch(int rows, int span, const void* qv, const void* qlo,
                                          const void* qhi, const void* mask, const void* db_v,
                                          const void* db_a, const void* cand, void* out, int B,
                                          int C, int M, int L, int N, float inv_alpha, int mode,
                                          void* stream) {{
  const int vec = (M % 4 == 0) && ((reinterpret_cast<uintptr_t>(db_v) & 15) == 0);
{cases}
  return (int)cudaErrorInvalidValue;
}}
"""


def _compile(src: Path, lib: Path) -> str:
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"build failed:\n{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    return res.stdout + res.stderr


def build_probe(baseline: Path | None):
    """(variant launcher, baseline launcher or None, ptxas report)."""
    out_dir = build.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "gather_auto_variants.cu"
    src.write_text(probe_source())
    log = _compile(src, out_dir / "gather_auto_variants.so")
    fn = ctypes.CDLL(str(out_dir / "gather_auto_variants.so")).gather_auto_variant_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, *build.SIGNATURES["gather_auto"]]
    fn.restype = ctypes.c_int
    base = None
    if baseline is not None:
        log += _compile(baseline, out_dir / "gather_auto_baseline.so")
        base = ctypes.CDLL(str(out_dir / "gather_auto_baseline.so")).gather_auto_launch
        base.argtypes = list(build.SIGNATURES["gather_auto"])
        base.restype = ctypes.c_int
    return fn, base, log


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, help="another gather_auto source to time beside")
    ap.add_argument("--json", type=Path, help="write the table here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("variant_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(gpu, flush=True)
    variants, base, ptxas = build_probe(args.baseline)
    print("\n".join(ln for ln in ptxas.splitlines() if "registers" in ln or "spill" in ln))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    db_v = torch.randn((N_ROWS, WIDTH), generator=g, device=dev)
    db_a = torch.randint(0, 3, (N_ROWS, ATTRS), generator=g, device=dev, dtype=torch.int32)
    names = [f"R{r}/span{s}" for r, s in VARIANTS] + (["baseline"] if base else [])
    rows = []
    for tag, (b, c) in SHAPES.items():
        qv = db_v[torch.randint(0, N_ROWS, (b,), generator=g, device=dev)].contiguous()
        qa = torch.randint(0, 3, (b, ATTRS), generator=g, device=dev, dtype=torch.int32)
        cand = torch.randint(-1, N_ROWS, (b, c), generator=g, device=dev, dtype=torch.int32)
        cand[torch.rand((b, c), generator=g, device=dev) < 0.1] = -1
        out = torch.empty((b, c), device=dev)
        for mode in ("l2", "auto"):
            shipped = gather_auto(qv, qa, db_v, db_a, cand, ALPHA, mode)

            def run(i, mode=mode, qv=qv, qa=qa, cand=cand, out=out, b=b, c=c):
                a = (qv.data_ptr(), qa.data_ptr(), qa.data_ptr(), None, db_v.data_ptr(),
                     db_a.data_ptr(), cand.data_ptr(), out.data_ptr(), b, c, WIDTH, ATTRS,
                     N_ROWS, inv_alpha(ALPHA), mode_code(mode),
                     torch.cuda.current_stream().cuda_stream)
                rc = base(*a) if i == len(VARIANTS) else variants(*VARIANTS[i], *a)
                build.check("gather_auto_variant", rc)

            for i, name in enumerate(names):
                out.zero_()
                run(i)
                if not torch.equal(out, shipped):
                    raise SystemExit(f"{name} {tag} {mode}: scores differ from the shipped "
                                     f"launcher's ({int((out != shipped).sum())} of {b * c})")
            order = list(range(len(names)))
            times = {name: [] for name in names}
            for i in order + order[::-1]:
                times[names[i]].append(device_ms(lambda i=i: run(i)))
            row = {"shape": tag, "B": b, "C": c, "mode": mode,
                   "ms": {k: min(v) for k, v in times.items()}, "ms_both_passes": times}
            rows.append(row)
            best = min(row["ms"], key=row["ms"].get)
            print(f"{tag:8s} B={b:5d} C={c:5d} {mode:4s} "
                  + " ".join(f"{k}={v:.4f}" for k, v in row["ms"].items())
                  + f"  fastest {best}", flush=True)
        del qv, qa, cand, out, shipped
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"gpu": gpu, "n_rows": N_ROWS, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
