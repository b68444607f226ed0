"""Collectives over the device-list mesh — the port of
``trino_tpu/parallel/exchange.py``.

The JAX package swaps buckets between shards with one ``lax.all_to_all``
inside ``shard_map``. Here one process holds every shard's tensors:
``partition_exchange`` packs each shard's rows into per-destination
buckets with M1 (``kernels.partition_pack``) and ``all_to_all`` hands
destination ``d`` the concatenation, in shard order, of every shard's
bucket ``d``, copied to ``d``'s device (a device-local copy when the mesh
repeats one device, a peer copy otherwise). Buckets are fixed-size;
overflow is reported, not hidden, and the caller retries with larger
buckets.
"""

from __future__ import annotations

import torch

from trino_tpu_torch.exec import kernels as K

__all__ = [
    "all_to_all", "all_gather", "pack_shards",
    "partition_exchange",
]


def all_to_all(buckets, devices, bucket: int):
    """``buckets[s][j]`` is shard ``s``'s ``[n * bucket, ...]`` packed
    tensor ``j``; returns ``recv[d][j]``, the concatenation over ``s`` of
    bucket ``d`` of ``buckets[s][j]``, on ``devices[d]``."""
    n = len(devices)
    recv = []
    for d, dev in enumerate(devices):
        lo, hi = d * bucket, (d + 1) * bucket
        recv.append([
            torch.cat([
                buckets[s][j][lo:hi].to(dev, non_blocking=True)
                for s in range(n)
            ])
            for j in range(len(buckets[0]))
        ])
    return recv


def all_gather(tensors, device) -> torch.Tensor:
    """Every shard's tensor, concatenated in shard order on ``device``."""
    return torch.cat([t.to(device, non_blocking=True) for t in tensors])


def pack_shards(dests, lives, payloads, n_parts: int, bucket: int):
    """M1 on every shard: ``dests[s]``, ``lives[s]`` and ``payloads[s]``
    (a list of tensors) are shard ``s``'s. Returns (packed, counts):
    ``packed[s]`` is shard ``s``'s buckets with its sent-live mask last,
    ``counts`` the host [n_shards, n_parts] table of live rows per
    destination (one host sync for all shards)."""
    packed, counts = [], []
    for dest, live, payload in zip(dests, lives, payloads):
        buckets, sent, cnt = K.partition_pack(dest, live, payload, n_parts,
                                              bucket)
        packed.append(buckets + [sent])
        counts.append(cnt)
    table = torch.stack([c.to(counts[0].device) for c in counts]).cpu()
    return packed, table.numpy()


def partition_exchange(dests, lives, payloads, n_parts: int, bucket: int,
                       devices):
    """Route every shard's live rows to the shard named by its ``dest``:
    ``pack_shards`` then ``all_to_all``. Returns (received payloads per
    shard, received live mask per shard, overflowed, counts) where each
    shard receives ``n_parts * bucket`` rows and ``overflowed`` is True
    when a bucket was too small and rows were dropped."""
    packed, counts = pack_shards(dests, lives, payloads, n_parts, bucket)
    recv = all_to_all(packed, devices, bucket)
    return (
        [r[:-1] for r in recv], [r[-1] for r in recv],
        bool((counts > bucket).any()), counts,
    )
