"""Dispatch for the gathered-candidate AUTO scorer.

CPU tensors run the plain version (``ref.py``); CUDA tensors launch the
hand-written kernel (``kernels/csrc/gather_auto.cu``) or raise.
``gather_auto.launches`` counts kernel launches only.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operands, inv_alpha, mode_code, split_targets
from repro_torch.kernels.gather_auto.ref import gather_auto_ref


def gather_auto(
    qv: torch.Tensor,
    qa: torch.Tensor,
    db_v: torch.Tensor,
    db_a: torch.Tensor,
    cand_ids: torch.Tensor,
    alpha: float = 1.0,
    mode: str = "auto",
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, C) squared fused distances of query b to rows ``cand_ids[b]``
    of (``db_v``, ``db_a``); INF where ``cand_ids < 0``. ``qa`` is (B, L)
    point targets or (B, L, 2) [lo, hi] intervals."""
    device = check_operands(
        "gather_auto", qv=qv, qa=qa, db_v=db_v, db_a=db_a, cand_ids=cand_ids,
        mask=mask,
    )
    code = mode_code(mode)
    b, m = qv.shape
    n, l = db_a.shape
    c = cand_ids.shape[1]
    if cand_ids.shape[0] != b or qa.shape[:2] != (b, l) or db_v.shape != (n, m):
        raise ValueError(
            f"gather_auto: shapes qv {tuple(qv.shape)}, qa {tuple(qa.shape)}, "
            f"db_v {tuple(db_v.shape)}, db_a {tuple(db_a.shape)}, "
            f"cand_ids {tuple(cand_ids.shape)} do not agree"
        )
    if mask is not None and mask.shape != (b, l):
        raise ValueError(f"gather_auto: mask must be {(b, l)}, got {tuple(mask.shape)}")
    if device.type == "cpu":
        return gather_auto_ref(qv, qa, db_v, db_a, cand_ids, alpha, mode, mask)
    if device.type != "cuda":
        raise ValueError(f"gather_auto: unsupported device {device}")
    qlo, qhi = (t.contiguous() for t in split_targets(qa))
    out = torch.empty((b, c), dtype=torch.float32, device=device)
    launch = build.launcher("gather_auto")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(
            qv.data_ptr(), qlo.data_ptr(), qhi.data_ptr(),
            None if mask is None else mask.data_ptr(),
            db_v.data_ptr(), db_a.data_ptr(), cand_ids.data_ptr(),
            out.data_ptr(), b, c, m, l, n, inv_alpha(alpha), code, stream,
        )
    build.check("gather_auto", rc)
    gather_auto.launches += 1
    return out


gather_auto.launches = 0

__all__ = ["gather_auto", "gather_auto_ref"]
