"""Fault-tolerant training loop: checkpoint/resume, preemption safety,
straggler watchdog.

The loop is bulk-synchronous: fault tolerance comes from (a) atomic
checkpoints every ``ckpt_every`` steps with resume from the latest, and
(b) a step-time watchdog that flags stragglers (on a fleet it would
trigger an eviction or a hot-spare swap; here it records them). Int8
gradient compression with error feedback is ``train/compress.py``.

One process holds the whole model, so the reference's ``shardings``
argument (elastic resharding on restore) has no counterpart: a restore
puts each leaf where the tree it restores into lies.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np

from repro_torch.checkpoint import checkpoint as ckpt_mod

PyTree = Any


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None
    keep_checkpoints: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0  # step > factor × median ⇒ flagged
    crash_at_step: Optional[int] = None  # fault injection for tests


@dataclasses.dataclass
class LoopResult:
    final_step: int
    losses: list
    resumed_from: Optional[int]
    straggler_events: list
    checkpoints_written: int


class SimulatedPreemption(RuntimeError):
    pass


def run(
    step_fn: Callable,  # (params, opt_state, batch) -> (params, opt_state, metrics)
    params: PyTree,
    opt_state: PyTree,
    batches: Callable[[int], dict] | Iterator[dict],
    cfg: LoopConfig,
) -> tuple[PyTree, PyTree, LoopResult]:
    """Steps ``step_fn`` from the latest checkpoint in ``cfg.ckpt_dir``
    (or from ``params`` and ``opt_state``) to ``cfg.total_steps``. A step
    time is host time around the step up to its loss read back, which
    waits for the device."""
    start_step = 0
    resumed_from = None
    if cfg.ckpt_dir:
        latest = ckpt_mod.latest_step(cfg.ckpt_dir)
        if latest is not None:
            (params, opt_state), _ = ckpt_mod.restore(cfg.ckpt_dir, latest, (params, opt_state))
            start_step = latest
            resumed_from = latest

    losses: list[float] = []
    step_times: list[float] = []
    stragglers: list[dict] = []
    ckpts = 0

    # Step-keyed data (callable) gives exact resume equivalence: after a
    # restart the stream realigns to the global step. A plain iterator works
    # too but won't replay skipped batches.
    get_batch = batches if callable(batches) else (lambda s, it=batches: next(it))

    for step in range(start_step, cfg.total_steps):
        batch = get_batch(step)
        t0 = time.perf_counter()
        if cfg.crash_at_step is not None and step == cfg.crash_at_step:
            raise SimulatedPreemption(f"injected preemption at step {step}")
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        losses.append(loss)
        step_times.append(dt)

        # straggler watchdog (bulk-synchronous: one slow step stalls every
        # worker, so surfacing it is the mitigation hook)
        if len(step_times) >= 5:
            med = float(np.median(step_times[-50:]))
            if dt > cfg.straggler_factor * med:
                stragglers.append({"step": step, "dt": dt, "median": med})

        if cfg.ckpt_dir and (step + 1) % cfg.ckpt_every == 0:
            ckpt_mod.save(cfg.ckpt_dir, step + 1, (params, opt_state),
                          keep=cfg.keep_checkpoints, extra={"loss": loss})
            ckpts += 1

        if cfg.log_every and (step + 1) % cfg.log_every == 0:
            print(f"[train] step {step + 1} loss {loss:.4f} ({dt*1e3:.0f} ms)", flush=True)

    if cfg.ckpt_dir and cfg.total_steps % cfg.ckpt_every != 0:
        ckpt_mod.save(cfg.ckpt_dir, cfg.total_steps, (params, opt_state),
                      keep=cfg.keep_checkpoints)
        ckpts += 1

    return params, opt_state, LoopResult(
        final_step=cfg.total_steps, losses=losses, resumed_from=resumed_from,
        straggler_events=stragglers, checkpoints_written=ckpts,
    )
