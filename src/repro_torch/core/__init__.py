"""Core of the port: AUTO metric, HELP graph, routing, index."""
from collections import OrderedDict
from typing import Callable, Tuple, TypeVar

import numpy as np
import torch

_V = TypeVar("_V")


def lru_get(
    cache: "OrderedDict", key, build: Callable[[], _V], max_size: int
) -> Tuple[_V, bool]:
    """Bounded-LRU lookup shared by the executable caches (api.executor):
    returns ``(value, hit)``, building + inserting on miss and evicting
    least-recently-used beyond ``max_size``."""
    hit = cache.get(key)
    if hit is not None:
        cache.move_to_end(key)
        return hit, True
    out = cache[key] = build()
    if len(cache) > max_size:
        cache.popitem(last=False)
    return out, False


def to_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A contiguous tensor of ``dtype`` on ``device`` from a tensor or any
    array-like (numpy arrays are shared, not copied, where possible)."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        if not a.flags.writeable:  # torch.from_numpy needs a writable buffer
            a = a.copy()
        x = torch.from_numpy(np.ascontiguousarray(a))
    return x.to(device=device, dtype=dtype).contiguous()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on. ``None`` means the CUDA card; a
    missing card raises instead of carrying on quietly on the CPU, so a
    caller that wants the plain CPU versions asks for ``"cpu"``."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
