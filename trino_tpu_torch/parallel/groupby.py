"""Distributed hash aggregation over the mesh — the port of
``trino_tpu/parallel/groupby.py``.

1. each shard partial-aggregates its rows into a local slot table
   (``assign_groups`` over K1 + M2 sums) — the PARTIAL step;
2. surviving (key, partial-state) rows route to the shard that owns
   their hash — ``partition_exchange`` (M1 + ``all_to_all``);
3. the owner runs the same slot assignment over the rows it received
   and combines the partial states — the FINAL step.

The JAX package runs the three as one jitted SPMD program; here they run
shard by shard, and the overflow flags of every shard meet in one host
OR, as ``pmax`` reduces them there.
"""

from __future__ import annotations

import torch

from trino_tpu_torch.exec import kernels as K
from trino_tpu_torch.parallel.core import Mesh
from trino_tpu_torch.parallel.exchange import partition_exchange

__all__ = ["distributed_group_sums", "make_group_sums_step", "q1_step"]

I64 = torch.int64


def _local_partial(key_bits, key_null, vals, live, capacity):
    """Shard-local partial aggregation: slot table + per-slot sums (M2).

    Returns an ``overflow`` flag: live rows that ``assign_groups`` could
    not place (group == capacity) would otherwise drop silently."""
    group, owner = K.assign_groups((key_bits,), (key_null,), live, capacity)
    overflow = (live & (group == capacity)).any()
    g = torch.where(live, group, capacity)
    zero = torch.zeros((), dtype=I64, device=live.device)
    sums = [
        K.segment_reduce(torch.where(live, v, zero), g, capacity, "sum")
        for v in vals
    ]
    counts = K.segment_reduce(live.to(I64), g, capacity, "sum")
    n = live.shape[0]
    own = owner.clamp(0, n - 1)
    return key_bits[own], key_null[own], sums, counts, owner < n, overflow


def make_group_sums_step(mesh: Mesh, n_values: int, local_capacity: int,
                         final_capacity: int, bucket_capacity: int):
    """The distributed step. It takes per-shard lists (``key_bits[s]``,
    ``key_null[s]``, ``live[s]``, ``vals[j][s]``) and returns per-shard
    final slot tables (key_bits, key_null, sums..., counts, slot_live),
    each ``[final_capacity]`` on its shard's device, and the OR of every
    shard's exchange and slot-table overflow."""
    n_part = mesh.n_shards
    devices = list(mesh.devices)

    def step(key_bits, key_null, live, *vals):
        parts = [
            _local_partial(key_bits[s], key_null[s], [v[s] for v in vals],
                           live[s], local_capacity)
            for s in range(n_part)
        ]
        dests, lives, payloads = [], [], []
        for sk, sn, sums, counts, slive, _ in parts:
            # route each surviving group to its owner by key hash
            h = K.hash_keys([(sk, None), (sn.to(I64), None)])
            dests.append(K.umod(h, n_part))
            lives.append(slive)
            payloads.append([sk, sn.to(torch.int8), counts, *sums])
        recv, rlives, overflow, _ = partition_exchange(
            dests, lives, payloads, n_part, bucket_capacity, devices)
        flags = [p[5] for p in parts]
        outs = []
        for (rk, rn, rc, *rv), rlive in zip(recv, rlives):
            rn = rn.to(torch.bool)
            group, owner = K.assign_groups((rk,), (rn,), rlive, final_capacity)
            flags.append((rlive & (group == final_capacity)).any())
            g = torch.where(rlive, group, final_capacity)
            zero = torch.zeros((), dtype=I64, device=rlive.device)
            fsums = [
                K.segment_reduce(torch.where(rlive, v, zero), g,
                                 final_capacity, "sum")
                for v in rv
            ]
            fcount = K.segment_reduce(torch.where(rlive, rc, zero), g,
                                      final_capacity, "sum")
            nr = rlive.shape[0]
            own = owner.clamp(0, nr - 1)
            outs.append((rk[own], rn[own], *fsums, fcount, owner < nr))
        # one host sync: every slot-table flag (the exchange's overflow
        # came with its counts)
        dev = flags[0].device
        overflow = overflow or bool(torch.stack([f.to(dev) for f in flags]).any())
        return outs, overflow

    return step


def distributed_group_sums(mesh: Mesh, key_bits, key_null, live, vals,
                           local_capacity: int, final_capacity: int,
                           bucket_capacity: int | None = None):
    """Group-by-key sums + counts across the mesh (convenience wrapper).

    Inputs are global [N] tensors split contiguously over the shards (N
    must divide by the mesh size). Returns (key_bits, key_null, sums,
    counts, slot_live, overflowed) with the slot tensors
    ``[n_shards * final_capacity]``, shard-major, on the first device."""
    n_part = mesh.n_shards
    if bucket_capacity is None:
        bucket_capacity = local_capacity  # safe: <= local groups total
    n = key_bits.shape[0]
    if n % n_part:
        raise ValueError(f"{n} rows do not split over {n_part} shards")
    per = n // n_part

    def split(t):
        return [t[s * per:(s + 1) * per].to(dev)
                for s, dev in enumerate(mesh.devices)]

    step = make_group_sums_step(mesh, len(vals), local_capacity,
                                final_capacity, bucket_capacity)
    outs, overflow = step(split(key_bits), split(key_null), split(live),
                          *[split(v) for v in vals])
    home = mesh.devices[0]
    cols = [torch.cat([o[j].to(home) for o in outs])
            for j in range(len(outs[0]))]
    key, null, *rest = cols
    sums = rest[:len(vals)]
    counts, slot_live = rest[len(vals)], rest[len(vals) + 1]
    return key, null, sums, counts, slot_live, overflow


def q1_step(shipdate, returnflag, linestatus, qty, price, disc, tax,
            capacity: int = 16):
    """The single-chip Q1-shaped step of ``__graft_entry__.entry()``:
    filter -> ``assign_groups`` over (returnflag, linestatus) -> M2 sums
    of the fixed-point decimal columns. Returns (returnflag, linestatus,
    slot_live, sum_qty, sum_price, sum_disc_price, sum_charge, count),
    each ``[capacity]``."""
    live = shipdate <= 10471  # the Q1 shipdate predicate
    kb1, kn1 = K.normalize_key(returnflag, None)
    kb2, kn2 = K.normalize_key(linestatus, None)
    group, owner = K.assign_groups((kb1, kb2), (None, None), live, capacity)
    g = torch.where(live, group, capacity)
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    zero = torch.zeros((), dtype=I64, device=live.device)

    def total(v):
        return K.segment_reduce(torch.where(live, v, zero), g, capacity, "sum")

    n = live.shape[0]
    own = owner.clamp(0, n - 1)
    return (
        returnflag[own], linestatus[own], owner < n,
        total(qty), total(price), total(disc_price), total(charge),
        K.segment_reduce(live.to(I64), g, capacity, "sum"),
    )
