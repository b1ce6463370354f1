"""The control of the correctness check: the reference in the program's place.

The configurations state float32 search. The control answers every query
of a window with the reference's exact filtered top-k computed in the
next precision below, bfloat16 (features and queries rounded to it,
sums in float32), and reports its own scores as a program would. The
check has to find it not correct; ``tools/readings.py`` reads it on the
card and ``tests/test_stable_bench_faults.py`` at a small size.
"""
from __future__ import annotations

import numpy as np
import torch

from stable_bench import check, reference


def answers(data, preds: reference.Predicates, window_answers: check.Answers, k: int,
            dtype=torch.bfloat16) -> check.Answers:
    """The control's answers to the same queries, in the same order."""
    ids, d2, _ = reference.exact_topk(data.features, data.attrs, data.query_features, preds, k,
                                      dtype=dtype)
    q = torch.as_tensor(window_answers.query, device=ids.device)
    return check.Answers(window_answers.query, ids[q].to(torch.int32).cpu().numpy(),
                         d2[q].to(torch.float32).cpu().numpy().astype(np.float32))
