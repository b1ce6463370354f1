"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs the fault-tolerant loop (checkpoint/resume, straggler watchdog) for any
registered architecture (the five LM ids, graphcast, and the recsys ids fm,
dlrm-rm2, xdeepfm, bert4rec) on the CUDA card, or on the CPU with
``--device cpu``. ``--full-config`` takes the full-size config (graphcast at
its 227 weather variables); by default the smoke-scale one runs.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch fm --steps 50 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b --steps 6 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch graphcast --steps 6 --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import resolve_device, to_tensor


def make_batch_fn(spec, cfg, batch_size: int, seq_len: int, device=None):
    """``batch_for_step(step)``: the reference's numpy stream for ``step``
    (``default_rng(10_000 + step)``, the same draws in the same order), as
    tensors on ``device`` (the card by default). LM: (batch_size, seq_len)
    tokens, labels the tokens rolled by −1. GNN: a fixed graph of 256 nodes
    and 1,024 edges, N(0, 1) features, targets tanh(features @ N(0, 1)
    weights), every edge and node kept (``batch_size`` and ``seq_len`` not
    read). bert4rec: 4 masked positions a sequence and 64 shared
    negatives; the other recsys kinds: ids, labels in {0, 1} and, for dlrm,
    N(0, 1) dense features."""
    family = spec.family
    dev = resolve_device(device)

    def batch_for_step(step: int) -> dict:
        rng = np.random.default_rng(10_000 + step)
        if family == "lm":
            toks = rng.integers(0, cfg.vocab, (batch_size, seq_len))
            return {"tokens": to_tensor(toks, torch.int32, dev),
                    "labels": to_tensor(np.roll(toks, -1, axis=1), torch.int32, dev)}
        if family == "gnn":
            n, e = 256, 1024
            feats = rng.normal(size=(n, cfg.d_in)).astype(np.float32)
            w = rng.normal(size=(cfg.d_in, cfg.d_out)).astype(np.float32)
            return {"node_feats": to_tensor(feats, torch.float32, dev),
                    "src": to_tensor(rng.integers(0, n, (e,)), torch.int32, dev),
                    "dst": to_tensor(rng.integers(0, n, (e,)), torch.int32, dev),
                    "edge_mask": torch.ones((e,), dtype=torch.bool, device=dev),
                    "targets": to_tensor(np.tanh(feats @ w), torch.float32, dev),
                    "node_mask": torch.ones((n,), dtype=torch.float32, device=dev)}
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
    from repro_torch.models import gnn as gnn_mod
    from repro_torch.models import recsys as recsys_mod
    from repro_torch.models import transformer as tfm
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
    dev = resolve_device(args.device)
    if args.full_config:
        cfg = spec.make_config() if spec.family != "gnn" else spec.make_config(None)
    else:
        cfg = spec.make_reduced()
    if spec.family == "lm":
        params = tfm.init_params(cfg, seed=0, device=dev)
        step = step_mod.make_lm_train_step(cfg, spec.optim)
    elif spec.family == "gnn":
        params = gnn_mod.init_params(cfg, seed=0, device=dev)
        step = step_mod.make_gnn_train_step(cfg, spec.optim)
    else:
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
