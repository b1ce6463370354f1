"""Meshes: the local device mesh of the sharded backend
(``repro_torch.distributed``) and the production mesh of the dry run.

The reference's mesh is the devices of one process (``jax.make_mesh`` over
``("data", "model")``). The port keeps that design without collectives:
a ``LocalMesh`` names how many query blocks (``data``) and database shards
(``model``) a search splits into, and the device each model shard lives
on. One process drives every shard; on one card all of them sit on it.

``make_production_mesh`` returns a ``DeviceFreeMesh``: the production
mesh's named axes and sizes, with no devices behind them (the reference
lays it over 512 placeholder host devices). The sharding specs
(``distributed.sharding``) read only a mesh's ``shape`` and
``axis_names``, so one spec function serves both kinds.
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

    axis_names = ("data", "model")

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


@dataclasses.dataclass(frozen=True)
class DeviceFreeMesh:
    """Named mesh axes and their sizes, in order, with no devices."""

    axes: tuple  # ((name, size), ...)

    @property
    def shape(self) -> dict:
        return dict(self.axes)

    @property
    def axis_names(self) -> tuple:
        return tuple(name for name, _ in self.axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceFreeMesh:
    """The reference's production mesh: (data 16, model 16), or (pod 2,
    data 16, model 16) with ``multi_pod``."""
    if multi_pod:
        return DeviceFreeMesh((("pod", 2), ("data", 16), ("model", 16)))
    return DeviceFreeMesh((("data", 16), ("model", 16)))
