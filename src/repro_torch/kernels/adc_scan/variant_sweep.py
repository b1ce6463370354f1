"""Time the ADC scanners' variants against each other, on one card.

``adc_scan_launch`` and ``adc_scan4_launch`` pick the tables a block stages
(bq), its threads, the queries a lane scores in one pass over its row and
the blocks aimed for per SM; none of them enters a result. This script backs
that choice with measurements: it builds a probe library that includes
``csrc/adc_scan.cu`` and exposes the kernel template at each variant of
``VARIANTS``, then at B = 128, N = 1M, S = 64 (K = 256 8-bit codes for
``adc_scan``, K = 16 packed codes for ``adc_scan4``), in l2 and auto modes
(point targets, L = 5), it checks that every variant's scores equal the
shipped launcher's bit for bit and times each. With ``--baseline FILE`` it
also builds another ADC source (one that exports ``adc_scan_launch`` and
``adc_scan4_launch``, such as an earlier version of the kernel, which may
sum in another order), holds its scores to the shipped launcher's within
rtol 1e-5 and times it beside the variants. A time is device ms, the lesser
of two readings of 20 calls replayed from one CUDA graph, taken in the
variant order and then in reverse. Run from the root of a checkout:

    PYTHONPATH=src python -m repro_torch.kernels.adc_scan.variant_sweep \\
        [--baseline FILE] [--json PATH]

It prints the card's name and power limit, its maximum SM clock and the
lookup ceiling, then one line per kernel and mode, and writes the table as
JSON to PATH when asked.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.adc_scan.ops import adc_scan4_scores, adc_scan_scores
from repro_torch.kernels.common import inv_alpha, mode_code
from repro_torch.kernels.fused_auto.tile_sweep import device_ms
from repro_torch.quant import pack_nibbles

#: (tables a block, threads a block, queries a pass, blocks aimed for per SM),
#: each at S = 64: two chunks, the rows' codes in registers
VARIANTS = {
    "adc_scan": ((3, 512, 3, 8), (3, 512, 3, 16), (3, 512, 3, 4), (3, 384, 3, 8),
                 (3, 640, 3, 8), (2, 512, 2, 8), (2, 768, 2, 8)),
    "adc_scan4": ((16, 512, 4, 8), (16, 512, 4, 16), (16, 512, 4, 4), (12, 512, 3, 8),
                  (8, 512, 4, 8), (24, 512, 4, 8), (16, 384, 4, 8), (16, 768, 4, 8)),
}
B, N_ROWS, S, ATTRS = 128, 1_000_000, 64, 5
ALPHA = 0.8
BASELINE_RTOL = 1e-5
LOOKUPS_PER_CLOCK = 32


def probe_source() -> str:
    combos = sorted({(t, p) for vs in VARIANTS.values() for _, t, p, _ in vs})
    cases = "\n".join(
        f"  if (threads == {t} && pass == {p}) return (int)(packed ? start<true, {t}, {p}, 2>"
        f"(a, bq, per_sm, n_sm) : start<false, {t}, {p}, 2>(a, bq, per_sm, n_sm));"
        for t, p in combos
    )
    return f"""#include "{build.CSRC / 'adc_scan.cu'}"
extern "C" int adc_scan_variant_launch(int packed, int bq, int threads, int pass, int per_sm,
                                       const void* lut, const void* codes, const void* qlo,
                                       const void* qhi, const void* mask, const void* xa,
                                       void* out, int B, int N, int S, int K, int L,
                                       float inv_alpha, int mode, void* stream) {{
  const Args a = make_args(lut, codes, qlo, qhi, mask, xa, out, B, N, S, K, L, inv_alpha, mode,
                           stream, packed != 0);
  int smem_max = 0, n_sm = 0;
  cudaError_t err = device_limits(&smem_max, &n_sm);
  if (err != cudaSuccess) return (int)err;
  if (!valid(packed != 0, a) || bq < 1 || smem_bytes(S, K, L, bq, pass) > (size_t)smem_max) {{
    return (int)cudaErrorInvalidValue;
  }}
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
    """(variant launcher, {name: baseline launcher} or None, ptxas report)."""
    out_dir = build.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "adc_scan_variants.cu"
    src.write_text(probe_source())
    log = _compile(src, out_dir / "adc_scan_variants.so")
    fn = ctypes.CDLL(str(out_dir / "adc_scan_variants.so")).adc_scan_variant_launch
    I = ctypes.c_int
    fn.argtypes = [I, I, I, I, I, *build.SIGNATURES["adc_scan"]]
    fn.restype = I
    base = None
    if baseline is not None:
        log += _compile(baseline, out_dir / "adc_scan_baseline.so")
        lib = ctypes.CDLL(str(out_dir / "adc_scan_baseline.so"))
        base = {}
        for name in VARIANTS:
            f = getattr(lib, f"{name}_launch")
            f.argtypes = list(build.SIGNATURES[name])
            f.restype = I
            base[name] = f
    return fn, base, log


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel instantiation: its template arguments, registers
    and spills, from ``-Xptxas -v``."""
    lines, name = [], "?"
    for ln in log.splitlines():
        m = re.search(r"adc_scan_kernelILb(\d)ELi(\d+)ELi(\d+)ELi(\d+)E", ln)
        if "Compiling entry" in ln:
            name = ("packed={} threads={} pass={} chunks={}".format(*m.groups()) if m
                    else ln.split("'")[1][:60])
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln:
            lines.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
    return lines


def gpu_query(field: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, help="another adc_scan source to time beside")
    ap.add_argument("--json", type=Path, help="write the table here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("variant_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    gpu = gpu_query("name,power.limit")
    clock_mhz = float(gpu_query("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    ceiling_ms = B * N_ROWS * S / (n_sm * LOOKUPS_PER_CLOCK * clock_mhz * 1e6) * 1e3
    print(gpu, flush=True)
    print(f"max SM clock {clock_mhz:.0f} MHz, {n_sm} SMs: lookup ceiling {ceiling_ms:.4f} ms "
          f"at B={B} N={N_ROWS} S={S}", flush=True)
    variants, base, ptxas = build_probe(args.baseline)
    print("\n".join(ptxas_summary(ptxas)))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    lut = torch.rand((B, S, 256), generator=g, device=dev) * 40
    codes = torch.randint(0, 256, (N_ROWS, S), generator=g, device=dev, dtype=torch.uint8)
    xa = torch.randint(0, 3, (N_ROWS, ATTRS), generator=g, device=dev, dtype=torch.int32)
    qa = torch.randint(0, 3, (B, ATTRS), generator=g, device=dev, dtype=torch.int32)
    operands = {
        "adc_scan": (adc_scan_scores, lut, codes, 256),
        "adc_scan4": (adc_scan4_scores, lut[:, :, :16].contiguous(), pack_nibbles(codes & 0xF),
                      16),
    }
    rows = []
    for name, (shipped_fn, lt, cd, k) in operands.items():
        vs = VARIANTS[name]
        names = ["bq{}/t{}/p{}/b{}".format(*v) for v in vs] + (["baseline"] if base else [])
        out = torch.empty((B, N_ROWS), device=dev)
        for mode in ("l2", "auto"):
            shipped = shipped_fn(lt, cd, qa, xa, ALPHA, mode)

            def run(i, mode=mode, lt=lt, cd=cd, k=k, name=name, vs=vs):
                a = (lt.data_ptr(), cd.data_ptr(), qa.data_ptr(), qa.data_ptr(), None,
                     xa.data_ptr(), out.data_ptr(), B, N_ROWS, S, k, ATTRS, inv_alpha(ALPHA),
                     mode_code(mode), torch.cuda.current_stream().cuda_stream)
                if i == len(vs):
                    rc = base[name](*a)
                else:
                    rc = variants(int(name == "adc_scan4"), *vs[i], *a)
                build.check(f"{name}_variant", rc)

            for i, vname in enumerate(names):
                out.zero_()
                run(i)
                if vname == "baseline":
                    if not torch.allclose(out, shipped, rtol=BASELINE_RTOL, atol=0.0):
                        err = float(((out - shipped).abs() / shipped.abs()).max())
                        raise SystemExit(f"baseline {name} {mode}: relative error {err:.3e} "
                                         f"above {BASELINE_RTOL}")
                elif not torch.equal(out, shipped):
                    raise SystemExit(f"{vname} {name} {mode}: scores differ from the shipped "
                                     f"launcher's ({int((out != shipped).sum())} of {B * N_ROWS})")
            order = list(range(len(names)))
            times = {vname: [] for vname in names}
            for i in order + order[::-1]:
                times[names[i]].append(device_ms(lambda i=i: run(i)))
            row = {"kernel": name, "K": k, "mode": mode, "ms": {n: min(v) for n, v in times.items()},
                   "ms_both_passes": times}
            rows.append(row)
            best = min(row["ms"], key=row["ms"].get)
            print(f"{name:9s} K={k:3d} {mode:4s} "
                  + " ".join(f"{n}={v:.4f}" for n, v in row["ms"].items())
                  + f"  fastest {best}", flush=True)
            del shipped
        del out
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"gpu": gpu, "max_sm_clock_mhz": clock_mhz,
                                         "lookup_ceiling_ms": ceiling_ms, "B": B, "n_rows": N_ROWS,
                                         "S": S, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
