"""Local device mesh for the sharded backend (``repro_torch.distributed``).

The reference's mesh is the devices of one process (``jax.make_mesh`` over
``("data", "model")``). The port keeps that design without collectives:
a ``LocalMesh`` names how many query blocks (``data``) and database shards
(``model``) a search splits into, and the device each model shard lives
on. One process drives every shard; on one card all of them sit on it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core import resolve_device


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """A (data, model) mesh over the devices of this process."""

    data: int
    model: int
    devices: tuple  # (model,) torch.device of each model shard

    def __post_init__(self):
        if self.data < 1 or self.model < 1:
            raise ValueError(f"mesh axes must be positive, got data={self.data} model={self.model}")
        if len(self.devices) != self.model:
            raise ValueError(f"{len(self.devices)} devices for {self.model} model shards")

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    def device(self, shard: int) -> torch.device:
        return self.devices[shard]


def make_local_mesh(
    data: int = 1, model: int = 1, devices: Optional[Sequence] = None
) -> LocalMesh:
    """A (data, model) mesh. Model shards go round-robin over ``devices``
    (default: every visible CUDA card; without a card this raises, so a
    caller that wants the CPU passes ``devices=["cpu"]``)."""
    if devices is None:
        resolve_device(None)
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("make_local_mesh needs at least one device")
    return LocalMesh(data=int(data), model=int(model),
                     devices=tuple(devs[s % len(devs)] for s in range(int(model))))
