"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs the fault-tolerant loop (checkpoint/resume, straggler watchdog) for a
registered recsys architecture (fm, dlrm-rm2, xdeepfm, bert4rec) on the
CUDA card, or on the CPU with ``--device cpu``. ``--full-config`` takes the
full-size config; by default the smoke-scale one runs. The LM ids resolve
in the registry (their serving is ported) but raise ``KeyError`` here,
naming ROADMAP.md queue 1, item 16 (LM training); the GNN id raises the
registry's ``KeyError``.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch fm --steps 50 --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import resolve_device, to_tensor


#: the ROADMAP.md item that ports each family's training
_NOT_PORTED = {"lm": "ROADMAP.md queue 1, item 16 (LM training)",
               "gnn": "ROADMAP.md queue 1, item 16 (the GNN model)"}


def _require_recsys(spec) -> None:
    if spec.family != "recsys":
        raise KeyError(f"{spec.arch_id}: {spec.family} training is not ported yet: "
                       f"{_NOT_PORTED[spec.family]}")


def make_batch_fn(spec, cfg, batch_size: int, seq_len: int, device=None):
    """``batch_for_step(step)``: the reference's numpy stream for ``step``
    (``default_rng(10_000 + step)``, the same draws in the same order), as
    tensors on ``device`` (the card by default). bert4rec: 4 masked
    positions a sequence and 64 shared negatives; the others: ids, labels
    in {0, 1} and, for dlrm, N(0, 1) dense features. ``seq_len`` is the
    LM families' and not read here."""
    _require_recsys(spec)
    dev = resolve_device(device)

    def batch_for_step(step: int) -> dict:
        rng = np.random.default_rng(10_000 + step)
        if cfg.kind == "bert4rec":
            out = {
                "items": rng.integers(0, cfg.n_items, (batch_size, cfg.seq_len)),
                "masked_pos": rng.integers(0, cfg.seq_len, (batch_size, 4)),
                "labels": rng.integers(0, cfg.n_items, (batch_size, 4)),
                "neg_ids": rng.integers(0, cfg.n_items, (64,)),
            }
            return {k: to_tensor(v, torch.int32, dev) for k, v in out.items()}
        out = {
            "sparse": to_tensor(rng.integers(0, cfg.vocab_per_field,
                                             (batch_size, cfg.n_sparse)), torch.int32, dev),
            "labels": to_tensor(rng.integers(0, 2, (batch_size,)), torch.float32, dev),
        }
        if cfg.n_dense:
            out["dense"] = to_tensor(rng.normal(size=(batch_size, cfg.n_dense)),
                                     torch.float32, dev)
        return out

    return batch_for_step


def main(argv=None):
    """Parse ``argv``, train, print the ``[done]`` line; returns the
    ``LoopResult``."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import recsys as recsys_mod
    from repro_torch.train import loop as loop_mod, optim as optim_mod, step as step_mod

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--full-config", action="store_true",
                    help="full-size config (default: reduced)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    _require_recsys(spec)
    dev = resolve_device(args.device)
    cfg = spec.make_config() if args.full_config else spec.make_reduced()
    params = recsys_mod.init_params(cfg, seed=0, device=dev)
    step = step_mod.make_recsys_train_step(cfg, spec.optim)
    opt_state = optim_mod.init_state(spec.optim, params)

    lcfg = loop_mod.LoopConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, log_every=max(args.steps // 10, 1),
    )
    batches = make_batch_fn(spec, cfg, args.batch_size, args.seq_len, dev)
    params, opt_state, res = loop_mod.run(step, params, opt_state, batches, lcfg)
    print(f"[done] {args.arch}: loss {res.losses[0]:.4f} → {res.losses[-1]:.4f} "
          f"({res.checkpoints_written} ckpts, resumed_from={res.resumed_from}, "
          f"stragglers={len(res.straggler_events)})")
    return res


if __name__ == "__main__":
    main()
