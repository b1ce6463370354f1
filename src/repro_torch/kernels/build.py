"""Build the CUDA kernels from ``csrc/*.cu`` at first use and bind them.

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``. The library lands
in ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source and the flags, so an
unchanged kernel is never rebuilt and a changed one never loads stale.
``build_all`` starts one ``nvcc`` per source at once. A failed build
raises: nothing falls back to the plain versions. A launcher lives in
``<name>.cu`` unless ``SOURCES`` names another file (``adc_scan4`` shares
``adc_scan.cu`` with ``adc_scan``: one kernel template, two launchers;
``fm_interaction_bwd`` shares ``fm_interaction.cu``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C signature of every kernel's launcher: ``int <name>_launch(...)``
#: returning ``cudaGetLastError()``. Pointers and the stream are c_void_p.
SIGNATURES = {
    # qv, qlo, qhi, mask, db_v, db_a, cand, out, B, C, M, L, N, inv_alpha, mode, stream
    "gather_auto": (P, P, P, P, P, P, P, P, I, I, I, I, I, F, I, P),
    # qv, xv, qlo, qhi, mask, xa, out, B, N, M, L, inv_alpha, mode, stream
    "fused_auto": (P, P, P, P, P, P, P, I, I, I, I, F, I, P),
    # lut, codes, qlo, qhi, mask, xa, out, B, N, S, K, L, inv_alpha, mode, stream
    "adc_scan": (P, P, P, P, P, P, P, I, I, I, I, I, F, I, P),
    "adc_scan4": (P, P, P, P, P, P, P, I, I, I, I, I, F, I, P),
    # emb, out, B, F, D, staged, E, grid, stages, threads, lanes, smem, stream
    "fm_interaction": (P, P, I, I, I, I, I, I, I, I, I, I, P),
    # emb, g, grad, B, F, D, staged, E, grid, stages, threads, lanes, smem, stream
    "fm_interaction_bwd": (P, P, P, I, I, I, I, I, I, I, I, I, I, P),
}
#: the source file stem of each launcher that does not live in <name>.cu.
SOURCES = {"adc_scan4": "adc_scan", "fm_interaction_bwd": "fm_interaction"}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: ptxas register/shared-memory report of each build (``-Xptxas -v``).
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels cannot be built"
        )
    return found


def source(name: str) -> str:
    """Stem of the ``csrc/`` file that holds ``<name>_launch``."""
    return SOURCES.get(name, name)


def _target(src_name: str, nvcc: str) -> Path:
    src = CSRC / f"{src_name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join((nvcc,) + NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src_name}-{h.hexdigest()[:16]}.so"


def _start(src_name: str, nvcc: str):
    """Start ``nvcc`` for one source unless its library is built already;
    returns (target, process or None)."""
    out = _target(src_name, nvcc)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{src_name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return out, (proc, tmp, cmd)


def _finish(name: str, out: Path, job) -> str:
    """Wait for one build; returns its error text ('' on success)."""
    if job is None:
        return ""
    proc, tmp, cmd = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        return (
            f"nvcc failed for {name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{log}"
        )
    build_logs[name] = log
    os.replace(tmp, out)  # atomic: a concurrent builder never sees half a file
    return ""


def _bind(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = list(SIGNATURES[name])
    fn.restype = ctypes.c_int
    return lib


def build_all(names=tuple(SIGNATURES)) -> None:
    """Build (in parallel) and load every named kernel library."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return
        nvcc = nvcc_path()
        jobs = {src: _start(src, nvcc) for src in dict.fromkeys(map(source, todo))}
        errors = [_finish(src, out, job) for src, (out, job) in jobs.items()]
        if any(errors):
            raise RuntimeError("\n".join(e for e in errors if e))
        for n in todo:
            _libs[n] = _bind(n, jobs[source(n)][0])


def launcher(name: str):
    """The bound ``<name>_launch`` C function, building it on first use."""
    if name not in _libs:
        build_all((name,))
    return getattr(_libs[name], f"{name}_launch")


def check(name: str, rc: int) -> None:
    """Raise if a launcher reported a CUDA error (a refused launch never
    runs and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
