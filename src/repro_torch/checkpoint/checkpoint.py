"""Fault-tolerant checkpointing: atomic per-leaf .npy + manifest, in the
reference's format.

  * every leaf of the tree (say ``(params, opt_state)``) is one ``.npy`` of
    the full array, ``leaf_<i>.npy`` numbered in JAX's leaf order
    (``core.tree``), its path name, shape and dtype in ``manifest.json``;
    so each package restores the other's checkpoints;
  * writes go to ``step_<n>.tmp/``, then one atomic ``os.replace`` to
    ``step_<n>/``: a preemption mid-write never corrupts the latest valid
    checkpoint, and ``.tmp`` directories are never listed;
  * ``latest_step`` reads directory names and manifests only;
  * retention keeps the newest ``keep`` checkpoints (default 3).
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import resolve_device
from repro_torch.core import tree as tree_mod

PyTree = Any

_MANIFEST = "manifest.json"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: PyTree, keep: int = 3,
         extra: Optional[dict] = None) -> str:
    """Write ``tree`` as checkpoint ``step`` under ``ckpt_dir``; returns
    its directory. Older checkpoints past the newest ``keep`` are removed."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    index = []
    for i, (name, leaf) in enumerate(tree_mod.flatten_with_paths(tree)):
        arr = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        index.append({"name": name, "file": fname,
                      "shape": list(arr.shape), "dtype": str(arr.dtype)})
    manifest = {"step": step, "time": time.time(), "leaves": index, "extra": extra or {}}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish

    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, _MANIFEST)):
                out.append(int(d[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like: PyTree, device=None) -> tuple[PyTree, dict]:
    """Checkpoint ``step`` in the structure of ``like``: (tree, extra).
    Each leaf keeps its stored dtype and goes to ``device`` when given,
    else to the device of its ``like`` leaf (the CUDA card where that leaf
    is no tensor or lies on ``meta``). A leaf count or shape that differs
    from ``like``'s raises ``ValueError``."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    leaves_like = tree_mod.leaves(like)
    stored = manifest["leaves"]
    if len(stored) != len(leaves_like):
        raise ValueError(f"checkpoint has {len(stored)} leaves, expected {len(leaves_like)}")
    dev = None if device is None else resolve_device(device)
    out = []
    for rec, ref in zip(stored, leaves_like):
        arr = np.load(os.path.join(path, rec["file"]))
        if tuple(arr.shape) != tuple(np.shape(ref)):
            raise ValueError(f"leaf {rec['name']}: stored {arr.shape} != expected "
                             f"{tuple(np.shape(ref))}")
        target = dev
        if target is None:
            on = getattr(ref, "device", None)
            target = on if isinstance(on, torch.device) and on.type != "meta" else resolve_device()
        out.append(torch.from_numpy(arr).to(target))
    return tree_mod.unflatten(like, out), manifest["extra"]
