"""Canonical capacity buckets — the port of ``bucket``, ``table_bucket``
and ``exchange_bucket`` from ``trino_tpu/exec/shapes.py``.

Every operator capacity (scan pages, aggregate slot tables, join
outputs, TopN caps) quantizes onto the power-of-two / 1.5x-power-of-two
ladder of ``page.pad_capacity``, exactly as in the JAX package, so the
two packages pick the same shapes and make the same overflow-retry
decisions. Chain canonicalization, pre-warm and the padding-waste gauge
serve XLA's compile cache and have no counterpart here.
"""

from __future__ import annotations

from trino_tpu_torch.page import pad_capacity

__all__ = ["bucket", "table_bucket", "exchange_bucket", "TABLE_FLOOR"]

#: the minimum aggregate-table bucket
TABLE_FLOOR = 1024


def bucket(n: int, minimum: int = 8) -> int:
    """Canonical row-capacity bucket (the pad_capacity family)."""
    return pad_capacity(n, minimum)


def table_bucket(est: float, max_cap: int) -> int:
    """Canonical aggregate slot-table capacity for an estimated group
    count: 1.25x margin + floor, quantized onto the bucket family."""
    want = max(int(est * 1.25) + TABLE_FLOOR, TABLE_FLOOR)
    return min(bucket(want), max_cap) if max_cap else bucket(want)


def exchange_bucket(shard_cap: int, n_shards: int) -> int:
    """Canonical per-destination bucket capacity of the mesh exchange (2x
    mean occupancy margin, >= 128, capped at the shard capacity so
    escalation always terminates)."""
    want = max(2 * shard_cap // max(n_shards, 1), 128)
    return min(bucket(want), shard_cap)
