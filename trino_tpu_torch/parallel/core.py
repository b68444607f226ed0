"""Device mesh construction — the port of ``trino_tpu/parallel/core.py``.

The JAX package's mesh is a ``jax.sharding.Mesh`` over devices, and its
tests run an 8-shard mesh over eight virtual CPU devices of one process.
Here a mesh is a list of torch devices, one per shard, driven by one
process: the list may repeat a device, so an 8-shard mesh runs on one
GPU (or the CPU) exactly as the JAX tests' mesh runs on one CPU, every
shard's work done by that device and every exchange a real copy between
shard buffers. With distinct devices the same code copies peer to peer.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["Mesh", "WORKER_AXIS", "make_mesh"]

#: the canonical 1-D data-partitioning axis
WORKER_AXIS = "workers"


class DeviceList(tuple):
    """The mesh's devices in shard order (``size`` as on the JAX mesh's
    device array)."""

    @property
    def size(self) -> int:
        return len(self)


@dataclass(frozen=True)
class Mesh:
    """One torch device per shard along one axis."""

    devices: DeviceList
    axis: str = WORKER_AXIS

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: len(self.devices)}

    @property
    def n_shards(self) -> int:
        return len(self.devices)


def make_mesh(n_shards: int | None = None, device=None, devices=None,
              axis: str = WORKER_AXIS) -> Mesh:
    """A mesh of ``n_shards`` shards on ``device`` (default ``cuda``; with
    CUDA absent and no device given this raises), or over the explicit
    ``devices`` list, one shard per entry."""
    if devices is None:
        if n_shards is None or n_shards < 1:
            raise ValueError("make_mesh needs n_shards >= 1 or a devices list")
        from trino_tpu_torch.engine import resolve_device

        devices = [resolve_device(device)] * int(n_shards)
    elif n_shards is not None and n_shards != len(devices):
        raise ValueError(f"{n_shards} shards over {len(devices)} devices")
    return Mesh(DeviceList(torch.device(d) for d in devices), axis)
