"""Shared model-building blocks: the precision policy, init helpers, norms,
the MLP stack, losses, and parameter counting over nested dicts of tensors.

Parameters are nested dicts of tensors. The inits draw from an explicit
``torch.Generator`` on the generator's device; their draws differ from
``jax.random``'s, so tests hand the reference's parameters across as numpy
arrays. The norms compute in f32 and cast back to the input's dtype, with
the reference's eps of 1e-6 (PyTorch's own default is 1e-5).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils._device import _device_constructors

from repro_torch.core import to_tensor

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Precision:
    """Mixed-precision policy: f32 master params, bf16 compute."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32


FP32 = Precision(param_dtype=torch.float32, compute_dtype=torch.float32)
MIXED = Precision()


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype = torch.float32) -> Tensor:
    """(in, out) uniform on [−1/√in, 1/√in)."""
    scale = 1.0 / math.sqrt(in_dim)
    w = torch.rand((in_dim, out_dim), generator=gen, dtype=dtype, device=gen.device)
    return w.mul_(2 * scale).sub_(scale)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype = torch.float32) -> Tensor:
    """(vocab, dim) N(0, 1)·0.02."""
    return torch.randn((vocab, dim), generator=gen, dtype=dtype, device=gen.device).mul_(0.02)


def rms_norm(x: Tensor, weight: Tensor, eps: float = 1e-6) -> Tensor:
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def layer_norm(x: Tensor, weight: Tensor, bias: Tensor, eps: float = 1e-6) -> Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dtype)


def mlp_params(gen: torch.Generator, dims: list[int],
               dtype: torch.dtype = torch.float32) -> dict[str, Tensor]:
    """Plain MLP parameter stack for dims = [in, h1, ..., out]: ``w{i}``
    (dense_init) then ``b{i}`` (zeros), the reference's key order."""
    n = len(dims) - 1
    ws = {f"w{i}": dense_init(gen, dims[i], dims[i + 1], dtype) for i in range(n)}
    return ws | {f"b{i}": torch.zeros((dims[i + 1],), dtype=dtype, device=gen.device)
                 for i in range(n)}


def mlp_param_shapes(dims: list[int]) -> dict[str, tuple[int, ...]]:
    """The shapes ``mlp_params`` gives, without drawing anything."""
    n = len(dims) - 1
    return ({f"w{i}": (dims[i], dims[i + 1]) for i in range(n)}
            | {f"b{i}": (dims[i + 1],) for i in range(n)})


def mlp_apply(params: dict, x: Tensor, act: Callable[[Tensor], Tensor] = F.relu,
              final_act: Optional[Callable[[Tensor], Tensor]] = None) -> Tensor:
    """``x @ w{i} + b{i}`` in ``x``'s dtype, ``act`` between layers."""
    n = len([k for k in params if k.startswith("w")])
    for i in range(n):
        x = x @ params[f"w{i}"].to(x.dtype) + params[f"b{i}"].to(x.dtype)
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def leaves(tree) -> Iterator[Tensor]:
    """The tensors of a nested dict, depth first in key order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def count_params(tree) -> int:
    """Number of parameters in a nested dict of tensors (meta tensors count
    without memory)."""
    return int(sum(math.prod(t.shape) for t in leaves(tree)))


def map_shapes(shapes: dict, fn: Callable, path: str = "") -> dict:
    """``fn(path, shape)`` at every leaf of a nested dict of shapes."""
    return {k: map_shapes(s, fn, f"{path}{k}/") if isinstance(s, dict) else fn(f"{path}{k}", s)
            for k, s in shapes.items()}


def meta_tree(shapes: dict, dtype: torch.dtype) -> dict:
    """Tensors of ``shapes`` on ``torch.device("meta")``: shapes and dtypes,
    no memory (the counterpart of ``jax.eval_shape``)."""
    return map_shapes(shapes, lambda _, s: torch.empty(s, dtype=dtype, device="meta"))


def tree_from_numpy(shapes: dict, tree: dict, dtype: torch.dtype, device, what: str) -> dict:
    """The reference's nested dict ``tree`` (numpy or array-likes) as
    tensors of ``dtype`` on ``device``; every key and shape is checked
    against ``shapes`` (``what`` names the model in the error)."""
    def convert(shapes: dict, sub: dict, path: str) -> dict:
        if not isinstance(sub, dict) or set(sub) != set(shapes):
            got = sorted(sub) if isinstance(sub, dict) else type(sub).__name__
            raise ValueError(f"parameters {path or '/'}: {got} != {sorted(shapes)} for {what}")
        out = {}
        for k, shape in shapes.items():
            if isinstance(shape, dict):
                out[k] = convert(shape, sub[k], f"{path}{k}/")
                continue
            got = tuple(getattr(sub[k], "shape", np.shape(sub[k])))
            if got != shape:
                raise ValueError(f"{path}{k}: shape {got} != {shape}")
            # reshape: to_tensor gives a 0-d numpy array one axis
            out[k] = to_tensor(sub[k], dtype, device).reshape(shape)
        return out

    return convert(shapes, tree, "")


def unstack_layers(layers: dict, n: int) -> list[dict]:
    """Stacked (L, ...) layer parameters, nested dicts, as ``n`` per-layer
    dicts of views, each leaf unbound once: its gradient is one stack of
    the L slices' gradients (an index per layer would add L zero-filled
    gradients of the whole stack)."""
    parts = {k: unstack_layers(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in layers.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


class _OnMeta(TorchFunctionMode):
    """Every tensor factory call makes a meta tensor, whatever device it
    names (``torch.device("meta")`` as a context only fills in a device
    that is not named, and the initialisers name theirs)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func in _device_constructors():
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


def abstract_like(init_fn: Callable[[], object]):
    """``init_fn()``'s tree with every tensor on ``torch.device("meta")``:
    shapes and dtypes, nothing allocated (``jax.eval_shape``). The
    initialisers draw from a ``torch.Generator`` on the device they are
    given; pass ``device="cpu"`` where no card is needed."""
    with _OnMeta():
        return init_fn()


def tree_bytes(tree) -> int:
    return int(sum(math.prod(t.shape) * t.element_size() for t in leaves(tree)))


def cross_entropy_loss(logits: Tensor, labels: Tensor, z_loss: float = 0.0) -> Tensor:
    """Token-mean CE in f32 with an optional z-loss."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    loss = (lse - ll).mean()
    if z_loss > 0.0:
        loss = loss + z_loss * (lse**2).mean()
    return loss


def bce_with_logits(logits: Tensor, labels: Tensor) -> Tensor:
    logits = logits.float()
    labels = labels.float()
    return (logits.clamp_min(0.0).mean() - (logits * labels).mean()
            + torch.log1p(torch.exp(-logits.abs())).mean())
