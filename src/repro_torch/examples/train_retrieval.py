"""Train a two-tower FM retrieval model for a few hundred steps (with
checkpoints), embed an item corpus, then serve hybrid retrieval through
the unified ``Engine`` API: the full train → index → serve pipeline. The
item corpus is small and scan-friendly, so the engine is built without a
HELP graph and the planner routes every request to the exact brute-force
backend.

    PYTHONPATH=src python -m repro_torch.examples.train_retrieval [--device cpu]

The checkpoints go to a fresh temporary directory, removed at the end, so
every run trains from step 0.
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.api import Engine, QueryBatch, SearchParams
from repro_torch.configs.registry import get_arch
from repro_torch.core import resolve_device, to_tensor
from repro_torch.models import recsys as recsys_mod
from repro_torch.train import loop as loop_mod, optim as optim_mod, step as step_mod

STEPS, CKPT_EVERY, LOG_EVERY = 300, 100, 50


def main(argv=None) -> dict:
    """Returns the losses, user 0's top-10 ids and how many of them match
    its attributes."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    spec = get_arch("fm")
    cfg = spec.make_reduced()
    params = recsys_mod.init_params(cfg, seed=0, device=dev)
    opt = optim_mod.init_state(spec.optim, params)
    step = step_mod.make_recsys_train_step(cfg, spec.optim)

    def batch_for_step(s):
        rng = np.random.default_rng(s)
        sparse = rng.integers(0, cfg.vocab_per_field, (256, cfg.n_sparse))
        # planted preference: label depends on a linear score of the ids
        w = np.linspace(-1, 1, cfg.n_sparse)
        logits = ((sparse / cfg.vocab_per_field - 0.5) * w).sum(1) * 4
        y = (rng.random(256) < 1 / (1 + np.exp(-logits))).astype(np.float32)
        return {"sparse": to_tensor(sparse, torch.int32, dev),
                "labels": to_tensor(y, torch.float32, dev)}

    with tempfile.TemporaryDirectory(prefix="stable_fm_ckpt_") as ckpt_dir:
        lcfg = loop_mod.LoopConfig(total_steps=STEPS, ckpt_every=CKPT_EVERY,
                                   ckpt_dir=ckpt_dir, log_every=LOG_EVERY)
        params, opt, res = loop_mod.run(step, params, opt, batch_for_step, lcfg)
    print(f"loss: {res.losses[0]:.4f} → {res.losses[-1]:.4f} "
          f"({res.checkpoints_written} checkpoints, resumed_from={res.resumed_from})")
    if not res.losses[-1] < res.losses[0]:
        raise RuntimeError("training must reduce the loss")

    # embed an item corpus from the trained factors and serve hybrid retrieval
    rng = np.random.default_rng(7)
    n_items = 5000
    item_fields = rng.integers(0, cfg.vocab_per_field, (n_items, cfg.n_sparse))
    with torch.no_grad():
        item_embs = recsys_mod.embedding_lookup(params["tables"], item_fields).sum(1)
        item_attrs = rng.integers(0, 3, (n_items, 4)).astype(np.int32)
        user_batch = batch_for_step(999)
        query_attrs = rng.integers(0, 3, (256, 4)).astype(np.int32)
        user_embs = recsys_mod.user_tower(cfg, params, user_batch)

    # scan-only corpus: no HELP graph; the planner picks the exact
    # brute-force backend (hard attribute filter + L2 rank) automatically.
    eng = Engine.build(item_embs.cpu().numpy(), item_attrs, build_graph=False, device=dev)
    req = QueryBatch.match(user_embs.cpu().numpy(), query_attrs)
    plan = eng.plan(req, SearchParams(k=10))
    found = eng.search(req, SearchParams(k=10))
    ids = found.ids.cpu().numpy()
    match = (item_attrs[np.maximum(ids[0], 0)] == query_attrs[0]).all(1)
    match &= ids[0] >= 0
    print(f"retrieval via Engine ({plan.backend}: {plan.reason}):")
    print(f"  top-10 items for user 0 = {ids[0].tolist()}")
    print(f"  attribute-matched: {int(match.sum())}/10 "
          f"(exact predicate oracle; per-request evals "
          f"{found.mean_dist_evals:.0f})")
    return {"losses": res.losses, "ids": ids, "matched": int(match.sum()),
            "backend": plan.backend}


if __name__ == "__main__":
    main()
