"""Optimizers on plain trees of tensors (no ``torch.optim``): AdamW,
Adafactor and SGD.

AdamW is the default. Adafactor (factored second moment, no first moment)
is the memory-lean choice; its factored branch takes leaves whose last two
axes are both at least 128 (``_factored``, which does not read
``min_dim_size_to_factor``, as in the reference).

Each update is the reference's arithmetic op for op, in f32, in its order:
AdamW steps ``p − lr·(m̂/(√v̂ + eps) + wd·p)`` with ``m̂ = m/(1 − b1^t)``
and ``v̂ = v/(1 − b2^t)``, the bias corrections computed in f32 from an
f32 ``t`` on the parameters' device. ``torch.optim.AdamW`` decays first and
divides by ``√v/√bc2 + eps``, which rounds otherwise, so it is not used.

Leaves are walked in JAX's order (``core.tree``): the global norm sums
them in it. The reference donates parameters and state to its jitted step,
so ``apply_updates`` updates both in place and returns them (at dlrm-rm2's
widths an out-of-place AdamW would hold 6.66 GB more for each elementwise
op on the tables) and scales the gradients it is given in place when it
clips. A caller that still needs any of them passes copies: on the CPU
``params_from_numpy`` shares the numpy arrays' memory, so tests clone.
``state_from_numpy`` always copies.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import to_tensor
from repro_torch.core import tree as tree_mod

Tensor = torch.Tensor
PyTree = Any


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    kind: str = "adamw"  # adamw | adafactor | sgd
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999  # adafactor: decay exponent handled separately
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    # adafactor
    min_dim_size_to_factor: int = 128
    decay_offset: float = 0.8  # \hat{β}2_t = 1 - t^{-0.8}


class AdamWState(NamedTuple):
    step: Tensor  # 0-d int32
    mu: PyTree
    nu: PyTree


class AdafactorState(NamedTuple):
    step: Tensor
    vr: PyTree  # row second-moment (or full v for unfactored leaves)
    vc: PyTree  # col second-moment ((1,) zeros when unfactored)


class SGDState(NamedTuple):
    step: Tensor


def _global_norm(tree: PyTree) -> Tensor:
    """√(Σ over leaves of Σ x²), the leaves in JAX's order, in f32."""
    total = None
    for x in tree_mod.leaves(tree):
        s = x.float().square().sum()
        total = s if total is None else total + s
    return torch.zeros(()) if total is None else total.sqrt()


def clip_by_global_norm(grads: PyTree, max_norm: float) -> tuple[PyTree, Tensor]:
    """Scales ``grads`` in place by min(1, max_norm / max(norm, 1e-12));
    returns them and the norm before scaling."""
    norm = _global_norm(grads)
    scale = (max_norm / norm.clamp_min(1e-12)).clamp_max(1.0)
    for g in tree_mod.leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 128 and shape[-2] >= 128


def _device(params: PyTree) -> torch.device:
    flat = tree_mod.leaves(params)
    return flat[0].device if flat else torch.device("cpu")


def init_state(cfg: OptimConfig, params: PyTree):
    """Zero state beside ``params`` (on their device; ``step`` a 0-d int32)."""
    step = torch.zeros((), dtype=torch.int32, device=_device(params))

    def zeros(shape, p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    if cfg.kind == "adamw":
        return AdamWState(step=step, mu=tree_mod.tree_map(lambda p: zeros(p.shape, p), params),
                          nu=tree_mod.tree_map(lambda p: zeros(p.shape, p), params))
    if cfg.kind == "adafactor":
        def vr(p):
            return zeros(p.shape[:-1] if _factored(p.shape) else p.shape, p)

        def vc(p):
            return zeros(p.shape[:-2] + p.shape[-1:] if _factored(p.shape) else (1,), p)

        return AdafactorState(step=step, vr=tree_mod.tree_map(vr, params),
                              vc=tree_mod.tree_map(vc, params))
    if cfg.kind == "sgd":
        return SGDState(step=step)
    raise ValueError(cfg.kind)


def _write(p: Tensor, new32: Tensor) -> None:
    """p ← new32 cast to p's dtype (nothing to do where ``new32`` is ``p``,
    an f32 leaf updated in place)."""
    if new32 is not p:
        p.copy_(new32)


@torch.no_grad()
def apply_updates(cfg: OptimConfig, params: PyTree, grads: PyTree, state):
    """One update of ``params`` by ``grads``. Returns (params, state,
    {"grad_norm"}), the first two the ones given, updated in place (see
    the module's docstring); ``grad_norm`` is the norm before clipping."""
    grads = tree_mod.tree_map(lambda g: g.float(), grads)
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = _global_norm(grads)
    flat_p, flat_g = tree_mod.leaves(params), tree_mod.leaves(grads)
    if len(flat_p) != len(flat_g):
        raise ValueError(f"{len(flat_g)} gradients for {len(flat_p)} parameters")
    step = state.step + 1
    t = step.float()

    if cfg.kind == "adamw":
        bc1 = 1.0 - cfg.b1**t
        bc2 = 1.0 - cfg.b2**t
        for p, g, m, v in zip(flat_p, flat_g, tree_mod.leaves(state.mu),
                              tree_mod.leaves(state.nu)):
            m.mul_(cfg.b1).add_(g * (1 - cfg.b1))  # b1·m + (1 − b1)·g
            v.mul_(cfg.b2).add_((g * (1 - cfg.b2)).mul_(g))  # b2·v + ((1 − b2)·g)·g
            denom = (v / bc2).sqrt_().add_(cfg.eps)
            delta = (m / bc1).div_(denom)
            del denom
            p32 = p.float()
            delta.add_(p32 * cfg.weight_decay)
            _write(p, p32.sub_(delta.mul_(cfg.lr)))
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu), {"grad_norm": gnorm}

    if cfg.kind == "adafactor":
        beta2t = 1.0 - torch.pow(t, -cfg.decay_offset)
        for p, g32, vr, vc in zip(flat_p, flat_g, tree_mod.leaves(state.vr),
                                  tree_mod.leaves(state.vc)):
            if _factored(p.shape):
                gg = g32 * g32
                r = beta2t * vr + (1 - beta2t) * gg.mean(-1)
                c = beta2t * vc + (1 - beta2t) * gg.mean(-2)
                del gg
                rc = r.mean(-1, keepdim=True)
                vhat = (r / rc.clamp_min(1e-30))[..., None] * c[..., None, :]
                precond = g32 / (vhat + cfg.eps).sqrt()
                del vhat
                vc.copy_(c)
            else:
                r = beta2t * vr + (1 - beta2t) * g32 * g32
                precond = g32 / (r + cfg.eps).sqrt()
            vr.copy_(r)
            # update clipping (Shazeer & Stern): RMS(update) ≤ 1
            rms = ((precond * precond).mean() + 1e-30).sqrt()
            precond = precond / rms.clamp_min(1.0)
            p32 = p.float()
            delta = precond + cfg.weight_decay * p32
            _write(p, p32.sub_(delta.mul_(cfg.lr)))
        return params, AdafactorState(step=step, vr=state.vr, vc=state.vc), {"grad_norm": gnorm}

    if cfg.kind == "sgd":
        for p, g in zip(flat_p, flat_g):
            _write(p, p.float().sub_(g * cfg.lr))
        return params, SGDState(step=step), {"grad_norm": gnorm}

    raise ValueError(cfg.kind)


def abstract_state(cfg: OptimConfig, abstract_params: PyTree):
    """The state's shapes and dtypes on ``meta`` (``jax.eval_shape``)."""
    meta = tree_mod.tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"),
                             abstract_params)
    return init_state(cfg, meta)


def state_from_numpy(cfg: OptimConfig, params: PyTree, tree: PyTree):
    """The reference's optimizer state for ``params`` (its ``NamedTuple``
    with numpy or array-like leaves) as the port's, copied onto the
    parameters' device. Leaf names, order and shapes are checked against
    ``init_state``'s."""
    like = abstract_state(cfg, params)
    want = tree_mod.flatten_with_paths(like)
    got = tree_mod.flatten_with_paths(tree)
    names = [n for n, _ in want]
    if [n for n, _ in got] != names:
        raise ValueError(f"optimizer state leaves {[n for n, _ in got]} != {names}")
    dev = _device(params)
    out = []
    for (name, ref), (_, x) in zip(want, got):
        a = np.array(x, copy=True)
        if a.shape != tuple(ref.shape):
            raise ValueError(f"{name}: shape {a.shape} != {tuple(ref.shape)}")
        out.append(to_tensor(a, ref.dtype, dev).reshape(ref.shape))
    return tree_mod.unflatten(like, out)
