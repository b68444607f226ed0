"""Device kernels for relational operators — the torch port of
``trino_tpu/exec/kernels.py``.

Everything is a whole-column computation on tensors of the executor's
device. Twenty-two functions have hand-written CUDA kernels (``csrc/``),
each beside its plain torch version:

- ``group_ids`` (K1): dense group ids, the inverse permutation and the
  group ranges after the key sort of ``group_by`` (and, for a
  DISTINCT's dedupe, each group's representative row);
- ``seg_sum`` (K2): per-group sums over group-sorted values, the core of
  ``seg_sum_ranges``;
- ``join_probe`` (K3): per-probe match ranges of ``join_ranges``;
- ``expand_matches`` (K4): match expansion into output pairs;
- ``range_any`` (K5): per-probe "any live expanded match" (semi joins,
  the probe-unmatched rows of outer joins);
- ``scatter_any`` (K6): per-build-row "any live match" (the
  build-unmatched rows of full outer joins);
- ``hash_keys`` (K7): the combined 64-bit hash of multi-key join keys
  (``hash_columns`` with ``normalize_key`` folded in);
- ``pack_keys`` (K8, ``csrc/pack_words.cu``): GROUP BY and DISTINCT
  keys, null flags and the live bit packed into sort words
  (``_pack_words`` with ``normalize_key`` folded in);
- ``seg_minmax`` (K9): per-group min/max over group-sorted values
  (``seg_minmax_scan``);
- ``order_words`` (K10): the ORDER BY words, null-flag and dead-row
  bytes of ``sort_perm``, whose sorts stay ``torch.sort``;
- ``window_peers`` (W1): a window's peer-group starts and ends and the
  dense_rank counter (``window.py:94-122``);
- ``range_sum`` (W2): per-row sums over window frames (``_range_sum``);
- ``range_minmax`` (W3): running min/max over prefix window frames
  (``_range_minmax``, ``_range_minmax_limbs``);
- ``seg_searchsorted`` (W4): the bisection that turns RANGE offset
  frames into positions (``_seg_searchsorted``);
- ``hll_registers`` (A1, ``csrc/hll.cu``): approx_distinct's HLL
  registers, max rho per (group, bucket) (``aggregates.py:_hll_registers``
  with ``dev_hash64`` and ``_clz64`` fused);
- ``hll_estimate`` (A2, ``csrc/hll.cu``): registers to estimates
  (``aggregates.py:_hll_estimate``);
- ``seg_arg_extreme`` (A3): max_by/min_by's segmented arg-extreme
  (``seg_arg_extreme`` with ``order_bits`` fused);
- ``hll_merge`` (A4, ``csrc/hll_merge.cu``): the FINAL register max of
  approx_distinct's partial states (``aggregates.py:_hll_merge``);
- ``quant_summary`` (A5, ``csrc/quant_summary.cu``): approx_percentile's
  PARTIAL k-point summary (``aggregates.py:_quant_summary``);
- ``quant_merge`` (A6, ``csrc/quant_merge.cu``): the FINAL weighted rank
  pick over merged summaries (``aggregates.py:_quant_merge``), a radix
  select per group with no sort of the points;
- ``partition_pack`` (M1): a shard's rows packed stably into
  per-destination buckets, the send side of the mesh's exchanges
  (``parallel/exchange.py:partition_exchange``);
- ``segment_reduce`` (M2): scatter sums, minima and maxima by group id
  (``kernels.py:seg_sum``/``seg_min``/``seg_max``).

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel (and adds one to its ``launches`` count)
or raises. There is no fallback between the two.

Conventions of the port:

- **uint64 as int64.** The JAX package's key words, hashes and sort
  words are uint64. torch cannot shift, compare or searchsorted uint64,
  so the same bits ride in int64 tensors: ``_shr`` is a logical right
  shift, and unsigned order is taken by flipping bit 63 (``^ _SIGN``)
  before a signed sort, compare or searchsorted. When liveness is folded
  into a 63-bit pack, the liveness bit is bit 63 itself.
- **Index dtype.** Row indices, permutations, group ids, counts and
  ranges are int64 throughout (torch's index dtype; ``torch.sort``
  returns it). The JAX package uses int32 for them; tests compare
  values, not dtypes.
- Stable multi-operand sorts (``lax.sort(..., is_stable=True)``) become
  ``torch.sort(stable=True)`` plus gathers.
"""

from __future__ import annotations

import math
import struct
from typing import NamedTuple

import torch

from trino_tpu_torch.exec import native

__all__ = [
    "hash_keys",
    "hash_keys_plain",
    "normalize_key",
    "limb_parts",
    "GroupInfo",
    "group_by",
    "assign_groups",
    "pack_keys",
    "pack_keys_plain",
    "group_ids",
    "group_ids_plain",
    "seg_sum",
    "seg_sum_plain",
    "seg_sum_ranges",
    "seg_minmax",
    "seg_minmax_plain",
    "order_words",
    "order_words_plain",
    "sort_perm",
    "join_ranges",
    "join_probe",
    "join_probe_plain",
    "expand_matches",
    "expand_matches_plain",
    "range_any",
    "range_any_plain",
    "scatter_any",
    "scatter_any_plain",
    "count_true",
    "blocked_sum",
    "window_peers",
    "window_peers_plain",
    "range_sum",
    "range_sum_plain",
    "range_minmax",
    "range_minmax_plain",
    "seg_searchsorted",
    "seg_searchsorted_plain",
    "order_bits",
    "seg_arg_extreme",
    "seg_arg_extreme_plain",
    "seg_first_index",
    "dev_hash64",
    "clz64",
    "hll_registers",
    "hll_registers_plain",
    "hll_estimate",
    "hll_estimate_plain",
    "hll_merge",
    "hll_merge_plain",
    "quant_summary",
    "quant_summary_plain",
    "quant_merge",
    "quant_merge_plain",
    "umod",
    "segment_reduce",
    "segment_reduce_plain",
    "partition_pack",
    "partition_pack_plain",
]

I64 = torch.int64
#: bit 63 as a signed int64 value: x ^ _SIGN maps unsigned order to signed
_SIGN = -(1 << 63)


def _u64(x: int) -> int:
    """The int64 value carrying the unsigned 64-bit constant ``x``."""
    return x - (1 << 64) if x >= (1 << 63) else x


_MIX_1 = _u64(0xFF51AFD7ED558CCD)
_MIX_2 = _u64(0xC4CEB9FE1A85EC53)
_NULL_SALT = _u64(0x9E3779B97F4A7C15)


def _shr(h: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of the u64 bits carried in an int64 tensor."""
    if k == 0:
        return h
    return (h >> k) & ((1 << (64 - k)) - 1)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when the plain version must run (every tensor on the CPU),
    False for CUDA tensors (the kernel runs); raises otherwise."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise RuntimeError(f"kernel inputs must all be on cpu or all on cuda: {kinds}")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, length: int | None = None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if length is not None and t.shape != (length,):
        raise ValueError(f"{name}: expected shape ({length},), got {tuple(t.shape)}")


#: column element type codes of the kernels (``ColType`` in csrc/common.cuh)
_TYPE_CODES = {
    torch.int64: 0, torch.int32: 1, torch.int16: 2, torch.int8: 3,
    torch.bool: 4, torch.float64: 5, torch.float32: 6,
}
#: most key columns one launch of K7 or K10 takes (their MAX_PARTS and
#: MAX_KEYS); K8 packs one word, at most 64 keys, per launch
MAX_KEY_PARTS = 32


def _col_desc(name: str, data: torch.Tensor, valid, n: int) -> list[int]:
    """[data pointer, validity pointer (0 = none), stride, type code] of
    one 1-D key column for a kernel's descriptor table. The data may be
    strided (a limb of a two-limb decimal, a hash lane) or broadcast
    (stride 0); the validity must be a contiguous bool row mask (see
    ``_dense_valid``)."""
    code = _TYPE_CODES.get(data.dtype)
    if code is None:
        raise TypeError(f"{name}: unsupported key dtype {data.dtype}")
    if data.dim() != 1 or data.shape[0] != n:
        raise ValueError(f"{name}: expected shape ({n},), got {tuple(data.shape)}")
    if valid is not None:
        _check(f"{name}.valid", valid, torch.bool, n)
    return [
        data.data_ptr(), 0 if valid is None else valid.data_ptr(),
        data.stride(0), code,
    ]


def _dense_valid(cols):
    """Key columns with each validity mask made contiguous (a broadcast
    NULL literal's is a stride-0 view); the returned list keeps the
    copies alive while a kernel reads them."""
    return [
        (d, None if v is None else v.contiguous(), *rest)
        for d, v, *rest in cols
    ]


def _host_table(rows: list[list[int]]) -> torch.Tensor:
    """A descriptor table as a host int64 tensor (the launcher copies it
    into a by-value kernel parameter before it returns)."""
    return torch.tensor(rows, dtype=I64).reshape(len(rows), -1).contiguous()


# ---- hashing / key normalization ------------------------------------------


def _mix64(h: torch.Tensor) -> torch.Tensor:
    """splitmix64-style finalizer (wraparound 64-bit math)."""
    h = h ^ _shr(h, 33)
    h = h * _MIX_1
    h = h ^ _shr(h, 33)
    h = h * _MIX_2
    h = h ^ _shr(h, 33)
    return h


def _canonical_float(data: torch.Tensor) -> torch.Tensor:
    """-0.0 -> +0.0 and every NaN payload -> the canonical quiet NaN."""
    data = torch.where(data == 0.0, torch.zeros_like(data), data)
    return torch.where(
        torch.isnan(data), torch.full_like(data, float("nan")), data
    )


def _to_bits(data: torch.Tensor) -> torch.Tensor:
    """A key column's bits as u64 carried in int64 (floats canonicalized)."""
    if data.dtype == torch.float64:
        return _canonical_float(data).contiguous().view(I64)
    if data.dtype == torch.float32:
        b = _canonical_float(data).contiguous().view(torch.int32)
        return b.to(I64) & 0xFFFFFFFF
    return data.to(I64)


def limb_parts(data: torch.Tensor) -> list[torch.Tensor]:
    """A key column as 1D pieces: two-limb decimal columns ([n, 2])
    contribute their hi and lo limbs as separate key parts."""
    if data.dim() == 2:
        return [data[:, 0], data[:, 1]]
    return [data]


def normalize_key(data: torch.Tensor, valid: torch.Tensor | None):
    """(bits, null_flag) with NULL data zeroed so equal keys have equal
    bits (GROUP BY / join keys treat NULLs as one group)."""
    bits = _to_bits(data)
    if valid is None:
        return bits, torch.zeros(bits.shape, dtype=torch.bool, device=bits.device)
    return torch.where(valid, bits, torch.zeros_like(bits)), ~valid


def hash_keys_plain(cols) -> torch.Tensor:
    """Plain torch version of K7 (port of ``kernels.py:hash_columns``):
    the combined 64-bit hash of key columns, NULLs hashing to a salt."""
    h = torch.zeros(cols[0][0].shape[0], dtype=I64, device=cols[0][0].device)
    for data, valid in cols:
        bits, isnull = normalize_key(data, valid)
        bits = torch.where(isnull, torch.full_like(bits, _NULL_SALT), bits)
        h = _mix64(h ^ _mix64(bits))
    return h


def hash_keys(cols) -> torch.Tensor:
    """K7 wrapper: the combined 64-bit hash (u64 bits in int64) of the
    1-D key columns ``[(data, valid|None), ...]``; plain version on the
    CPU, CUDA kernel (``csrc/hash_keys.cu``) on the card, one launch per
    batch of up to ``MAX_KEY_PARTS`` columns (a batch continues the
    previous batch's hash)."""
    if _on_cpu(*(t for col in cols for t in col)):
        return hash_keys_plain(cols)
    cols = _dense_valid(cols)
    n = cols[0][0].shape[0]
    dev = cols[0][0].device
    h = None
    for lo in range(0, len(cols), MAX_KEY_PARTS):
        batch = cols[lo: lo + MAX_KEY_PARTS]
        desc = _host_table([
            _col_desc(f"hash_keys[{lo + i}]", d, v, n)
            for i, (d, v) in enumerate(batch)
        ])
        out = torch.empty(n, dtype=I64, device=dev)
        native.call("hash_keys", "hash_keys_launch", desc, len(batch), h, n, out)
        hash_keys.launches += 1
        h = out
    return h


hash_keys.launches = 0


def _argsort_u64(x: torch.Tensor) -> torch.Tensor:
    """Stable argsort in unsigned 64-bit order of int64-carried bits."""
    return torch.sort(x ^ _SIGN, stable=True).indices


def _argsort_flag(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x.to(torch.int8), stable=True).indices


# ---- group-by via sort ------------------------------------------------------


class GroupInfo(NamedTuple):
    """Sorted-group context shared by every aggregate over one GROUP BY
    (the first seven fields as in the JAX package; all int64). ``rep``
    (bool, per row; None unless asked for with ``with_rep``) marks each
    group's representative: the row at the group's first sorted
    position, ``owner[group[i]] == i`` for a live row ``i`` (what
    ``stage.py:_dedupe`` keeps)."""

    perm: torch.Tensor
    gid_sorted: torch.Tensor
    group: torch.Tensor
    starts: torch.Tensor
    ends: torch.Tensor
    owner: torch.Tensor
    num_groups: torch.Tensor
    rep: torch.Tensor


def group_by(
    cols,
    live: torch.Tensor,
    capacity: int,
    widths=None,
    pre_perm: torch.Tensor | None = None,
    with_rep: bool = False,
) -> GroupInfo:
    """Exact multi-key grouping by lexsort + boundary cumsum (port of
    ``kernels.py:sort_group``) over raw key columns
    ``[(data, valid|None), ...]``. With widths, ``pack_keys`` (K8)
    normalizes and packs the keys into sort words; the sorts are
    ``torch.sort``; everything after the sort is ``group_ids`` (K1),
    which also marks each group's representative row when
    ``with_rep``."""
    n = live.shape[0]
    dev = live.device
    words = pack_keys(cols, live, widths)
    if words is not None:
        packed_words, live_folded, total_bits = words
        if pre_perm is None and len(packed_words) == 1 and live_folded:
            # one sort yields the sorted words and the permutation
            # together; liveness reads off the folded MSB
            flipped, perm = torch.sort(packed_words[0] ^ _SIGN, stable=True)
            ps = (flipped ^ _SIGN).contiguous()
            live_s = _shr(ps, total_bits) == 0
            return group_ids(ps, None, live_s, perm, capacity, with_rep)
        perm = (
            torch.arange(n, dtype=I64, device=dev)
            if pre_perm is None else pre_perm.to(I64)
        )
        for w in reversed(packed_words):
            perm = perm[_argsort_u64(w[perm])]
        if not live_folded:
            perm = perm[_argsort_flag((~live)[perm])]
        live_s = live[perm]
        same = torch.ones(n, dtype=torch.bool, device=dev)
        for w in packed_words:
            ws = w[perm]
            same = same & (ws == torch.roll(ws, 1))
        return group_ids(None, same, live_s, perm, capacity, with_rep)
    norm = [
        (b, None if v is None else f)
        for (b, f), (_, v) in zip((normalize_key(d, v) for d, v in cols), cols)
    ]
    perm = (
        torch.arange(n, dtype=I64, device=dev)
        if pre_perm is None else pre_perm.to(I64)
    )
    for bits, flag in reversed(norm):
        perm = perm[_argsort_u64(bits[perm])]
        if flag is not None:
            perm = perm[_argsort_flag(flag[perm])]
    # dead rows last (live is a prefix after this stable pass)
    perm = perm[_argsort_flag((~live)[perm])]
    live_s = live[perm]
    same = torch.ones(n, dtype=torch.bool, device=dev)
    for bits, flag in norm:
        bs = bits[perm]
        same = same & (bs == torch.roll(bs, 1))
        if flag is not None:
            fs = flag[perm]
            same = same & (fs == torch.roll(fs, 1))
    return group_ids(None, same, live_s, perm, capacity, with_rep)


def assign_groups(norm_bits, null_flags, live: torch.Tensor, capacity: int,
                  widths=None):
    """(group, owner), the JAX package's ``assign_groups`` over
    ``group_by``: ``group[i]`` is row i's dense id in key order
    (``capacity`` for dead rows and rows beyond ``capacity`` groups),
    ``owner[s]`` group s's representative row (n when unused). Keys come
    normalized with their null flags (None: no NULLs)."""
    cols = [
        (b, None if f is None else ~f) for b, f in zip(norm_bits, null_flags)
    ]
    info = group_by(cols, live, capacity, widths)
    return info.group, info.owner


def _word_layout(needs):
    """The greedy chunking of keys into <= 64-bit words, significance
    order kept (as ``kernels.py:_pack_words``): ``needs`` holds each key's
    (width, flagged). Returns (word index per key, number of words,
    live_folded, total_bits) or None when a single key needs more than
    64 bits. ``total_bits`` counts the last word's key and flag bits;
    liveness folds in above them when the pack is one word with a bit to
    spare."""
    word_of: list[int] = []
    cur_bits = 0
    n_words = 0
    for w, flagged in needs:
        need = w + (1 if flagged else 0)
        if need > 64:
            return None  # a single over-wide key defeats packing
        if n_words == 0 or cur_bits + need > 64:
            n_words += 1
            cur_bits = 0
        word_of.append(n_words - 1)
        cur_bits += need
    live_folded = n_words == 1 and cur_bits + 1 <= 64
    return word_of, n_words, live_folded, cur_bits


def _pack_words(norm_bits, null_flags, live, widths):
    """(packed_words, live_folded, total_bits), or None when no widths
    are known — the keys packed into as few u64 sort words as possible
    (port of ``kernels.py:_pack_words``, words carried in int64)."""
    if not widths:
        return None
    layout = _word_layout(
        [(w, f is not None) for w, f in zip(widths, null_flags)]
    )
    if layout is None:
        return None
    word_of, n_words, live_folded, total_bits = layout
    words: list = [None] * n_words
    if live_folded:
        # start from the liveness bit (or the first key): a shift by the
        # full 64-bit width never happens
        words[0] = (~live).to(I64)
    for bits, flag, w, wi in zip(norm_bits, null_flags, widths, word_of):
        piece = bits & ((1 << w) - 1) if w < 64 else bits
        words[wi] = piece if words[wi] is None else (words[wi] << w) | piece
        if flag is not None:
            words[wi] = (words[wi] << 1) | flag.to(I64)
    return words, live_folded, total_bits


def pack_keys_plain(cols, live, widths):
    """Plain torch version of K8: ``normalize_key`` on each key column,
    NULL flags only for nullable keys, then ``_pack_words``."""
    norm = [normalize_key(d, v) for d, v in cols]
    return _pack_words(
        tuple(b for b, _ in norm),
        tuple(None if v is None else f for (_, f), (_, v) in zip(norm, cols)),
        live, widths,
    )


def pack_keys(cols, live: torch.Tensor, widths):
    """K8 wrapper: the key columns ``[(data, valid|None), ...]``
    normalized and packed with their null flags (and the live bit, when
    it fits) into u64 sort words carried in int64, as
    ``(words, live_folded, total_bits)``; None when no widths are known
    or a key is too wide to pack. Plain version on the CPU, CUDA kernel
    (``csrc/pack_words.cu``) on the card: one launch per word."""
    if not widths:
        return None
    layout = _word_layout(
        [(w, v is not None) for w, (_, v) in zip(widths, cols)]
    )
    if layout is None:
        return None
    if _on_cpu(live, *(t for col in cols for t in col)):
        return pack_keys_plain(cols, live, widths)
    word_of, n_words, live_folded, total_bits = layout
    cols = _dense_valid(cols)
    n = live.shape[0]
    _check("pack_keys.live", live, torch.bool, n)
    words = []
    for wi in range(n_words):
        keys = [i for i, x in enumerate(word_of) if x == wi]
        desc = _host_table([
            _col_desc(f"pack_keys[{i}]", *cols[i], n)
            + [int(widths[i]), int(cols[i][1] is not None)]
            for i in keys
        ])
        out = torch.empty(n, dtype=I64, device=live.device)
        native.call(
            "pack_words", "pack_words_launch", desc, len(keys), live,
            int(live_folded), n, out,
        )
        pack_keys.launches += 1
        words.append(out)
    return words, live_folded, total_bits


pack_keys.launches = 0


def group_ids_plain(words, same, live_s, perm, capacity: int,
                    with_rep: bool = False) -> GroupInfo:
    """Plain torch version of K1: the tail of ``kernels.py:sort_group``
    after the sort. ``words`` are the sorted packed words (adjacent
    compare gives the run flags) or None, then ``same`` holds them."""
    n = live_s.shape[0]
    dev = live_s.device
    pos = torch.arange(n, dtype=I64, device=dev)
    if words is not None:
        same = words == torch.roll(words, 1)
    boundary = live_s & ((pos == 0) | ~same)
    gid1 = torch.cumsum(boundary.to(I64), 0)
    num_groups = gid1[-1] if n else torch.zeros((), dtype=I64, device=dev)
    gid_sorted = torch.where(live_s, gid1 - 1, capacity).clamp(max=capacity)
    group = torch.empty_like(gid_sorted)
    group[perm] = gid_sorted  # inverse permutation as a scatter
    # gid_sorted is non-decreasing: each used id's start is the position
    # where it first appears; unused slots start (and end) at n_live,
    # the first position at capacity
    n_live = (gid_sorted < capacity).sum().reshape(1)
    starts = torch.full((capacity + 1,), 0, dtype=I64, device=dev)
    starts[:] = n_live
    first = (gid_sorted != torch.roll(gid_sorted, 1)) | (pos == 0)
    rep = None
    if with_rep:
        rep = torch.empty(n, dtype=torch.bool, device=dev)
        rep[perm] = first & (gid_sorted < capacity)
    at = torch.nonzero(first & (gid_sorted < capacity)).reshape(-1)
    starts[gid_sorted[at]] = at
    starts = starts[:capacity]
    ends = torch.cat([starts[1:], n_live])
    sids = torch.arange(capacity, dtype=I64, device=dev)
    if n:
        owner = torch.where(
            sids < num_groups, perm[starts.clamp(0, n - 1)], n
        )
    else:
        owner = torch.zeros(capacity, dtype=I64, device=dev)
    return GroupInfo(
        perm, gid_sorted, group, starts, ends, owner, num_groups, rep
    )


def group_ids(words, same, live_s, perm, capacity: int,
              with_rep: bool = False) -> GroupInfo:
    """K1 wrapper: plain version for CPU tensors, CUDA kernel
    (``csrc/group_ids.cu``) for CUDA tensors."""
    if _on_cpu(live_s, perm):
        return group_ids_plain(words, same, live_s, perm, capacity, with_rep)
    n = live_s.shape[0]
    _check("group_ids.live_s", live_s, torch.bool, n)
    _check("group_ids.perm", perm, I64, n)
    if words is not None:
        _check("group_ids.words", words, I64, n)
    else:
        _check("group_ids.same", same, torch.bool, n)
    dev = live_s.device

    def empty(k):
        return torch.empty(k, dtype=I64, device=dev)

    # the look-back scan's tile words and tile counter (2048-row tiles),
    # the fill counts (int32) of the row windows (512 rows or more), the
    # staged ids
    tiles, windows = (n + 2047) // 2048, (n + 511) // 512
    state = empty(tiles + 1 + (windows + 1) // 2)
    staged, gid_sorted, group = empty(n), empty(n), empty(n)
    rep = torch.empty(n, dtype=torch.bool, device=dev) if with_rep else None
    starts, ends, owner = empty(capacity), empty(capacity), empty(capacity)
    num_groups = torch.empty((), dtype=I64, device=dev)
    n_live = torch.full((1,), n, dtype=I64, device=dev)
    native.call(
        "group_ids", "group_ids_launch",
        words, None if words is not None else same, live_s, perm, n,
        capacity, state, staged, gid_sorted, group, rep, starts, ends,
        owner, num_groups, n_live,
    )
    group_ids.launches += 1
    return GroupInfo(
        perm, gid_sorted, group, starts, ends, owner, num_groups, rep
    )


group_ids.launches = 0


# ---- segment reductions over sorted groups ---------------------------------


def seg_sum_plain(vals: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor):
    """Plain torch version of K2. Integers: cumsum + boundary
    differences (exact mod 2^64, as in the JAX package). float64: each
    group summed on its own (order differs from the JAX segmented scan;
    relative tolerance 1e-12). Groups are dense and contiguous:
    ``ends[g] == starts[g + 1]``."""
    n = vals.shape[0]
    cap = starts.shape[0]
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    if n == 0:
        return torch.zeros(cap, dtype=vals.dtype, device=vals.device)
    if vals.dtype.is_floating_point:
        # group of position p = number of groups ending at or before p
        n_end = int(ends[-1])
        marks = torch.zeros(n_end + 1, dtype=I64, device=vals.device)
        marks.index_add_(0, ends.clamp(max=n_end), torch.ones_like(ends))
        seg = torch.cumsum(marks[:n_end], 0)
        out = torch.zeros(cap, dtype=vals.dtype, device=vals.device)
        out.index_add_(0, seg, vals[:n_end])
        return torch.where(ends > starts, out, zero)
    cs = torch.cumsum(vals, 0)

    def at(idx):
        return torch.where(idx > 0, cs[(idx - 1).clamp(0, n - 1)], zero)

    lo = at(starts)
    hi = torch.cat([lo[1:], at(ends[-1:])])
    return torch.where(ends > starts, hi - lo, zero)


def seg_sum(vals: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor):
    """K2 wrapper: per-group sums of group-sorted int64 or float64 values
    over dense contiguous ranges; plain version on the CPU, CUDA kernel
    (``csrc/seg_sum.cu``) on the card."""
    if _on_cpu(vals, starts, ends):
        return seg_sum_plain(vals, starts, ends)
    if vals.dtype not in (I64, torch.float64):
        raise TypeError(f"seg_sum: int64 or float64 values, got {vals.dtype}")
    cap = starts.shape[0]
    _check("seg_sum.vals", vals, vals.dtype, vals.shape[0])
    _check("seg_sum.ends", ends, I64, cap)
    out = torch.zeros(cap, dtype=vals.dtype, device=vals.device)
    fn = "seg_sum_i64_launch" if vals.dtype == I64 else "seg_sum_f64_launch"
    native.call("seg_sum", fn, vals, ends, vals.shape[0], cap, out)
    seg_sum.launches += 1
    return out


seg_sum.launches = 0


def seg_sum_ranges(vals_sorted: torch.Tensor, info: GroupInfo, zero=None):
    """Per-group sums of an already group-sorted, contribution-masked
    value column (port of ``kernels.py:seg_sum_ranges``)."""
    dtype = vals_sorted.dtype
    if dtype.is_floating_point:
        return seg_sum(vals_sorted.to(torch.float64), info.starts, info.ends).to(dtype)
    # integers sum exactly mod 2^64; narrower inputs wrap back to their
    # width, as their cumsum does in the JAX package
    return seg_sum(vals_sorted.to(I64), info.starts, info.ends).to(dtype)


def _minmax_pair(a: torch.Tensor, b: torch.Tensor, is_min: bool) -> torch.Tensor:
    """``jnp.minimum``/``jnp.maximum`` elementwise: NaN propagates and
    -0.0 is below +0.0 (so the result does not depend on the order of a
    reduction)."""
    if not a.dtype.is_floating_point:
        return torch.minimum(a, b) if is_min else torch.maximum(a, b)
    if is_min:
        pick_b = (b < a) | ((b == a) & torch.signbit(b))
    else:
        pick_b = (b > a) | ((b == a) & ~torch.signbit(b))
    out = torch.where(pick_b, b, a)
    nan = torch.isnan(a) | torch.isnan(b)
    return torch.where(nan, torch.full_like(out, float("nan")), out)


def seg_minmax_plain(vals: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
                     fill, is_min: bool) -> torch.Tensor:
    """Plain torch version of K9 (port of ``kernels.py:seg_minmax_scan``):
    a segmented inclusive scan (log-step, each position combining with
    the one ``d`` back while both lie in one group) read at each group's
    last position; empty groups give ``fill``. Groups are dense and
    contiguous: ``ends[g] == starts[g + 1]``."""
    cap = starts.shape[0]
    fill_t = torch.tensor(fill, dtype=vals.dtype, device=vals.device)
    n_end = int(ends[-1]) if cap else 0
    if n_end == 0:
        return fill_t.expand(cap).clone()
    # group of position p = number of groups ending at or before p
    marks = torch.zeros(n_end + 1, dtype=I64, device=vals.device)
    marks.index_add_(0, ends.clamp(max=n_end), torch.ones_like(ends))
    seg = torch.cumsum(marks[:n_end], 0)
    m = vals[:n_end]
    d = 1
    while d < n_end:
        joined = _minmax_pair(m[:-d], m[d:], is_min)
        m = torch.cat([m[:d], torch.where(seg[d:] == seg[:-d], joined, m[d:])])
        d <<= 1
    out = m[(ends - 1).clamp(0, n_end - 1)]
    return torch.where(ends > starts, out, fill_t)


#: value dtype -> the accumulator dtype K9 writes (narrow integers widen)
_MINMAX_ACC = {
    torch.int64: torch.int64, torch.int32: torch.int32,
    torch.int16: torch.int32, torch.int8: torch.int32,
    torch.float64: torch.float64, torch.float32: torch.float32,
}


def seg_minmax(vals: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
               fill, is_min: bool) -> torch.Tensor:
    """K9 wrapper: per-group min (``is_min``) or max of group-sorted
    values whose non-contributing rows hold ``fill``, over dense
    contiguous ranges; empty groups give ``fill``. Plain version on the
    CPU, CUDA kernel (``csrc/seg_minmax.cu``) on the card."""
    if _on_cpu(vals, starts, ends):
        return seg_minmax_plain(vals, starts, ends, fill, is_min)
    acc = _MINMAX_ACC.get(vals.dtype)
    if acc is None:
        raise TypeError(f"seg_minmax: unsupported values {vals.dtype}")
    cap = starts.shape[0]
    _check("seg_minmax.vals", vals, vals.dtype, vals.shape[0])
    _check("seg_minmax.ends", ends, I64, cap)
    out = torch.full((cap,), fill, dtype=acc, device=vals.device)
    if acc == torch.float64:
        fill_bits = struct.unpack("<q", struct.pack("<d", float(fill)))[0]
    elif acc == torch.float32:
        fill_bits = struct.unpack("<I", struct.pack("<f", float(fill)))[0]
    else:
        fill_bits = int(fill)
    native.call(
        "seg_minmax", "seg_minmax_launch", vals, ends,
        _TYPE_CODES[vals.dtype], vals.shape[0], cap, fill_bits, int(is_min),
        out,
    )
    seg_minmax.launches += 1
    return out if acc == vals.dtype else out.to(vals.dtype)


seg_minmax.launches = 0


def blocked_sum(x: torch.Tensor) -> torch.Tensor:
    """Scalar int64 sum (the JAX blocked form only works around an XLA
    compiler bug); ``calls`` counts its uses."""
    blocked_sum.calls += 1
    return x.to(I64).sum()


blocked_sum.calls = 0


def count_true(mask: torch.Tensor) -> torch.Tensor:
    """Scalar count of True values; ``calls`` counts its uses."""
    count_true.calls += 1
    return mask.to(I64).sum()


count_true.calls = 0


# ---- sorting ---------------------------------------------------------------


#: key dtypes whose ORDER BY word is int64 (every other key: int32)
_WIDE_KEYS = (torch.int64, torch.float64)


def order_words_plain(keys, live: torch.Tensor):
    """Plain torch version of K10: (words, flags, dead) for ``sort_perm``.

    Per key (data, valid, ascending, nulls_first): its order word, whose
    signed order is the key's order — integers as they are or negated in
    their own width for DESC (wrapping, as the JAX package's ``-x``),
    bools 0/1 or complemented, floats as ``_float_sort_bits``
    (complemented for DESC) with the top bit flipped to signed order;
    int64 for 64-bit keys, int32 otherwise. Its null-flag bytes (1 =
    NULL, -1 when NULLs come first), None for a key without validity.
    Then the dead-row bytes."""
    words, flags = [], []
    for data, valid, ascending, nulls_first in keys:
        if data.dtype.is_floating_point:
            kd = _float_sort_bits(data)
            if data.dtype == torch.float64:
                if not ascending:
                    kd = ~kd
                kd = kd ^ _SIGN  # unsigned order as signed
            else:
                if not ascending:
                    kd = kd ^ 0xFFFFFFFF  # 32-bit complement
                kd = (kd - (1 << 31)).to(torch.int32)
        elif data.dtype == torch.bool:
            kd = (data if ascending else ~data).to(torch.int32)
        else:
            kd = data if ascending else _invert(data)
            if kd.dtype != I64:
                kd = kd.to(torch.int32)
        words.append(kd)
        flag = None
        if valid is not None:
            flag = (~valid).to(torch.int8)  # 1 = null
            if nulls_first:
                flag = -flag
        flags.append(flag)
    return words, flags, (~live).to(torch.int8)


def order_words(keys, live: torch.Tensor):
    """K10 wrapper: the ORDER BY words, null flags and dead-row bytes of
    ``sort_perm`` (see ``order_words_plain``) in one pass; plain version
    on the CPU, CUDA kernel (``csrc/order_words.cu``) on the card, one
    launch per ``MAX_KEY_PARTS`` keys (each also writes the same dead
    bytes)."""
    if _on_cpu(live, *(t for d, v, _a, _f in keys for t in (d, v))):
        return order_words_plain(keys, live)
    keys = _dense_valid(keys)
    n = live.shape[0]
    _check("order_words.live", live, torch.bool, n)
    dev = live.device
    words, flags = [], []
    dead = torch.empty(n, dtype=torch.int8, device=dev)
    batches = [
        keys[lo: lo + MAX_KEY_PARTS]
        for lo in range(0, max(len(keys), 1), MAX_KEY_PARTS)
    ]
    for bi, batch in enumerate(batches):
        rows = []
        for i, (data, valid, ascending, nulls_first) in enumerate(batch):
            col = _col_desc(f"order_words[{bi * MAX_KEY_PARTS + i}]", data, valid, n)
            wd = I64 if data.dtype in _WIDE_KEYS else torch.int32
            word = torch.empty(n, dtype=wd, device=dev)
            flag = (
                None if valid is None
                else torch.empty(n, dtype=torch.int8, device=dev)
            )
            words.append(word)
            flags.append(flag)
            rows.append([
                col[0], col[1], word.data_ptr(),
                0 if flag is None else flag.data_ptr(), col[2], col[3],
                int(bool(ascending)), int(bool(nulls_first)),
            ])
        desc = _host_table(rows) if rows else torch.zeros((1, 8), dtype=I64)
        native.call(
            "order_words", "order_words_launch", desc, len(rows), live, n, dead,
        )
        order_words.launches += 1
    return words, flags, dead


order_words.launches = 0


def sort_perm(keys, live: torch.Tensor) -> torch.Tensor:
    """Permutation ordering rows by the sort keys, dead rows last.

    Each key is (data, valid, ascending, nulls_first). ``order_words``
    (K10) builds every key's order word and null-flag bytes and the
    dead-row bytes in one pass; then iterated stable ``torch.sort``
    passes, last key first, two per key — data then null flag — and the
    dead pass last, as in the JAX package."""
    n = live.shape[0]
    words, flags, dead = order_words(keys, live)
    perm = torch.arange(n, dtype=I64, device=live.device)
    for kd, flag in reversed(list(zip(words, flags))):
        perm = perm[torch.sort(kd[perm], stable=True).indices]
        if flag is not None:
            perm = perm[torch.sort(flag[perm], stable=True).indices]
    return perm[torch.sort(dead[perm], stable=True).indices]


def _invert(data: torch.Tensor) -> torch.Tensor:
    if data.dtype == torch.bool:
        return ~data
    return -data  # int64 min overflow is accepted (reference wraps too)


def _float_sort_bits(data: torch.Tensor) -> torch.Tensor:
    """Monotone unsigned encoding of a float column (u64 for float64,
    u32 in the low bits for float32): unsigned compare == float total
    order, -0.0 == +0.0, NaN canonicalized above +inf."""
    if data.dtype == torch.float32:
        bits = _canonical_float(data).contiguous().view(torch.int32).to(I64)
        bits = bits & 0xFFFFFFFF
        negative = (bits & 0x80000000) != 0
        return bits ^ torch.where(
            negative, torch.full_like(bits, 0xFFFFFFFF),
            torch.full_like(bits, 0x80000000),
        )
    bits = _canonical_float(data).contiguous().view(I64)
    negative = bits < 0
    return bits ^ torch.where(
        negative, torch.full_like(bits, -1), torch.full_like(bits, _SIGN)
    )


# ---- equi-join -------------------------------------------------------------


def join_ranges(build_key, build_live, probe_key, probe_live):
    """Sorted-range probe (port of ``kernels.py:join_ranges``).

    Returns (order, lo, cnt): ``order`` sorts the build side by key
    (unsigned, dead rows last, stable), ``lo[i]``/``cnt[i]`` give each
    probe row's match range inside the sorted build side. The two stable
    sorts are torch ops; the probe is ``join_probe`` (K3)."""
    o1 = _argsort_u64(build_key)
    order = o1[_argsort_flag((~build_live)[o1])]
    sorted_key = build_key[order]
    n_build_live = build_live.to(I64).sum().reshape(1)
    lo, cnt = join_probe(
        sorted_key, n_build_live, probe_key.contiguous(),
        probe_live.contiguous(),
    )
    return order, lo, cnt


def _bisect(keys: torch.Tensor, v: torch.Tensor, n_live: torch.Tensor,
            right: bool) -> torch.Tensor:
    """Vectorized binary search of every ``v`` over ``keys[:n_live]``
    (signed order): first index with key > v (``right``) or >= v."""
    m = keys.shape[0]
    a = torch.zeros_like(v)
    b = n_live.reshape(()).expand_as(v).clone()
    for _ in range(m.bit_length()):
        active = a < b
        mid = (a + b) >> 1
        k = keys[mid.clamp(max=max(m - 1, 0))]
        go_right = (k <= v) if right else (k < v)
        a = torch.where(active & go_right, mid + 1, a)
        b = torch.where(active & ~go_right, mid, b)
    return a


def join_probe_plain(sorted_key, n_build_live, probe_key, probe_live):
    """Plain torch version of K3: the same two binary searches over the
    live prefix, one vectorized bisection step per key-count bit. Equal
    to the JAX package's searchsorted over the dead-tail-pinned keys,
    clamped to the live prefix."""
    keys = sorted_key ^ _SIGN  # unsigned order as signed
    pk = probe_key ^ _SIGN
    lo = _bisect(keys, pk, n_build_live, right=False)
    hi = _bisect(keys, pk, n_build_live, right=True)
    cnt = torch.where(probe_live, hi - lo, torch.zeros_like(lo))
    return lo, cnt


def join_probe(sorted_key, n_build_live, probe_key, probe_live):
    """K3 wrapper: (lo, cnt) per probe row; plain version on the CPU,
    CUDA kernel (``csrc/join_probe.cu``) on the card."""
    if _on_cpu(sorted_key, n_build_live, probe_key, probe_live):
        return join_probe_plain(sorted_key, n_build_live, probe_key, probe_live)
    n = probe_key.shape[0]
    _check("join_probe.sorted_key", sorted_key, I64, sorted_key.shape[0])
    _check("join_probe.n_build_live", n_build_live, I64, 1)
    _check("join_probe.probe_key", probe_key, I64, n)
    _check("join_probe.probe_live", probe_live, torch.bool, n)
    dev = probe_key.device
    m = sorted_key.shape[0]
    # the key-range directory: 2^log_b + 1 positions, one entry per 8 to
    # 16 build rows, int32 while the positions fit
    log_b = max(m.bit_length() - 4, 1)
    wide = m >= 1 << 31
    directory = torch.empty(
        (1 << log_b) + 1, dtype=I64 if wide else torch.int32, device=dev
    )
    lo = torch.empty(n, dtype=I64, device=dev)
    cnt = torch.empty(n, dtype=I64, device=dev)
    native.call(
        "join_probe", "join_probe_launch",
        sorted_key, n_build_live, probe_key, probe_live, n, log_b, directory,
        int(wide), lo, cnt,
    )
    join_probe.launches += 1
    return lo, cnt


join_probe.launches = 0


def expand_matches_plain(order, lo, cnt, out_capacity: int):
    """Plain torch version of K4: each output position finds its probe
    row by a cumsum over marks at the rows' start offsets. Equal to the
    JAX package at every position (dead positions past ``total`` point
    at the last probe row, as its clipped searchsorted does)."""
    dev = cnt.device
    n, m = cnt.shape[0], order.shape[0]
    j = torch.arange(out_capacity, dtype=I64, device=dev)
    if n == 0:
        z = torch.zeros(out_capacity, dtype=I64, device=dev)
        return z, z.clone(), torch.zeros(out_capacity, dtype=torch.bool, device=dev)
    inclusive = torch.cumsum(cnt, 0)
    total = inclusive[-1]
    excl = inclusive - cnt
    live = j < total
    rows = torch.nonzero(cnt > 0).reshape(-1)
    probe_idx = torch.full((out_capacity,), n - 1, dtype=I64, device=dev)
    if rows.numel():
        marks = torch.zeros(out_capacity + 1, dtype=I64, device=dev)
        marks[excl[rows].clamp(max=out_capacity)] = 1
        seg = torch.cumsum(marks[:out_capacity], 0) - 1
        owner = rows[seg.clamp(0, rows.numel() - 1)]
        probe_idx = torch.where(live, owner, probe_idx)
    build_pos = lo[probe_idx] + (j - excl[probe_idx])
    if m:
        build_idx = order[build_pos.clamp(0, m - 1)]
    else:
        build_idx = torch.zeros(out_capacity, dtype=I64, device=dev)
    return probe_idx, build_idx, live


#: probe rows a block of K4 covers and the largest count it writes itself
#: (TILE and HEAVY in csrc/expand_matches.cu): they size the kernel's
#: look-back words and its heavy-row descriptors, whose lengths the
#: kernel checks against its own constants
EXPAND_TILE = 2048
EXPAND_HEAVY = 32


def expand_matches(order, lo, cnt, out_capacity: int):
    """Expand per-probe match ranges into (probe_idx, build_idx,
    out_live) at ``out_capacity`` (port of ``kernels.py:expand_matches``).
    K4 wrapper: plain version on the CPU, CUDA kernel
    (``csrc/expand_matches.cu``: one look-back pass over tiles of
    ``cnt`` that writes each tile's pairs, then one grid for rows of more
    than ``EXPAND_HEAVY`` matches and the dead tail) on the card. Dead
    positions hold probe row ``n - 1`` and build row 0."""
    if _on_cpu(order, lo, cnt):
        return expand_matches_plain(order, lo, cnt, out_capacity)
    n = cnt.shape[0]
    _check("expand_matches.order", order, I64, order.shape[0])
    _check("expand_matches.lo", lo, I64, n)
    _check("expand_matches.cnt", cnt, I64, n)
    if out_capacity >= 1 << 33:
        raise ValueError(f"expand_matches: out_capacity {out_capacity} >= 2^33")
    dev = cnt.device
    tiles = -(-n // EXPAND_TILE)
    state = torch.empty(tiles + 3, dtype=I64, device=dev)
    # each heavy row below out_capacity covers more than EXPAND_HEAVY slots
    heavy = torch.empty(
        (min(n, out_capacity // (EXPAND_HEAVY + 1) + 1), 5), dtype=I64, device=dev)
    probe_idx = torch.empty(out_capacity, dtype=I64, device=dev)
    build_idx = torch.empty(out_capacity, dtype=I64, device=dev)
    out_live = torch.empty(out_capacity, dtype=torch.bool, device=dev)
    native.call(
        "expand_matches", "expand_matches_launch",
        order, lo, cnt, n, out_capacity, state, state.shape[0], heavy,
        heavy.shape[0], probe_idx, build_idx, out_live,
    )
    expand_matches.launches += 1
    return probe_idx, build_idx, out_live


expand_matches.launches = 0


# ---- join-side match marks ---------------------------------------------------


def range_any_plain(cnt: torch.Tensor, out_live: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K5 (port of ``kernels.py:range_any``):
    ``matched[p] = any(out_live[off[p] .. off[p] + cnt[p]))`` where
    ``off`` is the exclusive prefix sum of ``cnt``, read as a difference
    of the inclusive prefix count of ``out_live``. Both prefix sums are
    int64 (the JAX package's int32 count would wrap beyond 2^31
    expanded rows); range ends are clamped to ``out_live``'s length."""
    m = out_live.shape[0]
    if m == 0:
        return torch.zeros(cnt.shape, dtype=torch.bool, device=cnt.device)
    offsets = torch.cumsum(cnt, 0)
    c = torch.cumsum(out_live.to(I64), 0)
    hi = _range_gather(c, torch.clamp(offsets, max=m))
    lo = _range_gather(c, torch.clamp(offsets - cnt, max=m))
    return (hi - lo) > 0


def _range_gather(cs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """cs[idx - 1], 0 for idx == 0 (prefix-sum boundary read)."""
    at = torch.clamp(idx - 1, 0, max(cs.shape[0] - 1, 0))
    return torch.where(idx > 0, cs[at], torch.zeros_like(idx))


def range_any(cnt: torch.Tensor, out_live: torch.Tensor) -> torch.Tensor:
    """Per-probe "any live expanded output in my range" over the
    expansion that ``cnt`` produced (port of ``kernels.py:range_any``).
    K5 wrapper: plain version on the CPU, CUDA kernel
    (``csrc/range_any.cu``) on the card; the exclusive prefix sum of
    ``cnt`` is a torch cumsum either way, as for K4."""
    if _on_cpu(cnt, out_live):
        return range_any_plain(cnt, out_live)
    n, m = cnt.shape[0], out_live.shape[0]
    _check("range_any.cnt", cnt, I64, n)
    _check("range_any.out_live", out_live, torch.bool, m)
    dev = cnt.device
    offsets = torch.cumsum(cnt, 0) - cnt
    matched = torch.empty(n, dtype=torch.bool, device=dev)
    # ranges never overlap, so at most m // RANGE_ANY_SHORT + 1 of them
    # are longer than the per-thread scan
    long_cap = max(min(n, m // RANGE_ANY_SHORT + 1), 1)
    long_rows = torch.empty(long_cap, dtype=I64, device=dev)
    n_long = torch.zeros(1, dtype=I64, device=dev)
    native.call(
        "range_any", "range_any_launch",
        cnt, offsets, n, out_live, m, RANGE_ANY_SHORT, matched, long_rows,
        long_cap, n_long,
    )
    range_any.launches += 1
    return matched


range_any.launches = 0
#: range length one K5 thread scans; a probe row whose range is longer
#: and whose head is dead goes to the kernel's block-wide pass
RANGE_ANY_SHORT = 64


def scatter_any_plain(idx: torch.Tensor, flags: torch.Tensor, capacity: int) -> torch.Tensor:
    """Plain torch version of K6 (port of ``kernels.py:scatter_any``):
    ``out[b] = any(flags[j] for idx[j] == b)`` for b in [0, capacity).
    Indices under a false flag, and indices outside [0, capacity), mark
    nothing (dead expansion rows carry clamped placeholders)."""
    out = torch.zeros(capacity, dtype=torch.bool, device=idx.device)
    hit = flags & (idx >= 0) & (idx < capacity)
    out[idx[hit]] = True
    return out


def scatter_any(idx: torch.Tensor, flags: torch.Tensor, capacity: int) -> torch.Tensor:
    """Per-slot "any flagged index lands here" for unsorted ``idx``
    (port of ``kernels.py:scatter_any``). K6 wrapper: plain version on
    the CPU, CUDA kernel (``csrc/scatter_any.cu``) on the card."""
    if _on_cpu(idx, flags):
        return scatter_any_plain(idx, flags, capacity)
    m = idx.shape[0]
    _check("scatter_any.idx", idx, I64, m)
    _check("scatter_any.flags", flags, torch.bool, m)
    out = torch.zeros(capacity, dtype=torch.bool, device=idx.device)
    native.call("scatter_any", "scatter_any_launch", idx, flags, m, capacity, out)
    scatter_any.launches += 1
    return out


scatter_any.launches = 0

# ---- window functions --------------------------------------------------------


def window_peers_plain(gid_sorted, keys, perm, pend, with_dense: bool = False):
    """Plain torch version of W1 (port of ``window.py:94-122`` and
    ``:181-182``): (peer_start, peer_end, dense) of the sorted rows.

    A sorted row is a peer boundary when it is the first row, its
    partition id differs from the previous row's, or any ORDER BY key
    part ``(data, valid|None)`` (original row order, read through
    ``perm``) differs in its ``normalize_key`` bits or NULL flag.
    ``peer_start`` is the last boundary at or before the row,
    ``peer_end`` the next boundary after it (n when none) capped at
    ``pend``, ``dense`` the count of boundaries at or before the row
    (None unless ``with_dense``). Boundary positions come from one
    cumsum and gathers instead of the JAX package's max/min scans."""
    n = gid_sorted.shape[0]
    dev = gid_sorted.device
    pos = torch.arange(n, dtype=I64, device=dev)
    peer_b = (pos == 0) | (gid_sorted != torch.roll(gid_sorted, 1))
    for data, valid in keys:
        bits, flag = normalize_key(data, valid)
        bs = bits[perm]
        peer_b = peer_b | (bs != torch.roll(bs, 1))
        if valid is not None:
            fl = flag[perm]
            peer_b = peer_b | (fl != torch.roll(fl, 1))
    count = torch.cumsum(peer_b.to(I64), 0)
    if n == 0:
        return pos, pos.clone(), (count if with_dense else None)
    bpos = torch.nonzero(peer_b).reshape(-1)
    nb = bpos.shape[0]
    peer_start = bpos[count - 1]
    nxt = torch.where(
        count < nb, bpos[count.clamp(max=nb - 1)], torch.full_like(count, n)
    )
    peer_end = torch.minimum(nxt, pend)
    return peer_start, peer_end, (count if with_dense else None)


#: rows a tile of W1's look-back pass, and tiles a block of its close pass
#: (TILE and CLOSE_TILES in csrc/window_peers.cu): they size its scratch,
#: whose length the kernel checks against its own constants
PEERS_TILE = 2048
PEERS_CLOSE_TILES = 8


def window_peers(gid_sorted, keys, perm, pend, with_dense: bool = False):
    """W1 wrapper: (peer_start, peer_end, dense) of a window's sorted rows
    (see ``window_peers_plain``); plain version on the CPU, CUDA kernel
    (``csrc/window_peers.cu``) on the card, which reads the keys in
    original order through ``perm``."""
    if _on_cpu(gid_sorted, perm, pend, *(t for col in keys for t in col)):
        return window_peers_plain(gid_sorted, keys, perm, pend, with_dense)
    if len(keys) > MAX_KEY_PARTS:
        raise ValueError(f"window_peers: at most {MAX_KEY_PARTS} key parts")
    n = gid_sorted.shape[0]
    _check("window_peers.gid_sorted", gid_sorted, I64, n)
    _check("window_peers.perm", perm, I64, n)
    _check("window_peers.pend", pend, I64, n)
    keys = _dense_valid(keys)
    rows = [_col_desc(f"window_peers[{i}]", d, v, n) for i, (d, v) in enumerate(keys)]
    desc = _host_table(rows) if rows else torch.zeros((1, 4), dtype=I64)
    dev = gid_sorted.device
    # look-back words (two a tile), the close pass's words (one a group of
    # PEERS_CLOSE_TILES tiles), two counters, two records a tile, then a
    # validity bitmap for each nullable part
    tiles = -(-n // PEERS_TILE)
    groups = -(-tiles // PEERS_CLOSE_TILES)
    nullable = sum(v is not None for _, v in keys)
    state = torch.empty(4 * tiles + groups + 2 + nullable * -(-n // 64),
                        dtype=I64, device=dev)
    peer_start = torch.empty(n, dtype=I64, device=dev)
    peer_end = torch.empty(n, dtype=I64, device=dev)
    dense = torch.empty(n, dtype=I64, device=dev) if with_dense else None
    native.call(
        "window_peers", "window_peers_launch", desc, len(rows), gid_sorted,
        perm, pend, n, state, state.shape[0], peer_start, peer_end, dense,
    )
    window_peers.launches += 1
    return peer_start, peer_end, dense


window_peers.launches = 0


def _seg_scan_plain(vals: torch.Tensor, gid: torch.Tensor, combine):
    """Segmented inclusive scan by non-decreasing ``gid`` in log steps:
    each position combines with the one ``d`` back while both lie in one
    segment (``combine(earlier, later)`` elementwise)."""
    n = vals.shape[0]
    m = vals
    d = 1
    while d < n:
        joined = combine(m[:-d], m[d:])
        inside = gid[d:] == gid[:-d]
        if m.dim() == 2:
            inside = inside[:, None]
        m = torch.cat([m[:d], torch.where(inside, joined, m[d:])])
        d <<= 1
    return m


def range_sum_plain(lanes, gid, lo, hi):
    """Plain torch version of W2 (port of ``window.py:_range_sum``): per
    lane, the sum of the sorted values over each row's frame [lo, hi).
    Integer lanes: a cumsum difference (exact mod 2^64, as in the JAX
    package). float64 lanes: a segmented scan by ``gid`` (log steps, so
    the order of addition differs from the JAX package's
    associative_scan), the frame's start read only inside the row's
    partition."""
    out = []
    for vals in lanes:
        n = vals.shape[0]
        zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
        if n == 0:
            out.append(vals.clone())
            continue
        hi_at = (hi - 1).clamp(0, n - 1)
        lo_at = (lo - 1).clamp(0, n - 1)
        if vals.dtype.is_floating_point:
            cs = _seg_scan_plain(vals, gid, torch.add)
            bot = torch.where((lo > 0) & (gid[lo_at] == gid), cs[lo_at], zero)
        else:
            cs = torch.cumsum(vals, 0)
            bot = torch.where(lo > 0, cs[lo_at], zero)
        top = torch.where(hi > 0, cs[hi_at], zero)
        out.append(torch.where(hi > lo, top - bot, zero))
    return out


#: rows a block of W2 covers (TILE in csrc/range_sum.cu)
RANGE_SUM_TILE = 2048


def range_sum(lanes, gid, lo, hi):
    """W2 wrapper: frame sums of int64 or float64 lanes (see
    ``range_sum_plain``) over the same frames, which window.py clips to
    each row's partition; all lanes in one launch. Plain version on the
    CPU, CUDA kernel (``csrc/range_sum.cu``) on the card."""
    if _on_cpu(gid, lo, hi, *lanes):
        return range_sum_plain(lanes, gid, lo, hi)
    n = gid.shape[0]
    _check("range_sum.gid", gid, I64, n)
    _check("range_sum.lo", lo, I64, n)
    _check("range_sum.hi", hi, I64, n)
    dev = gid.device
    outs, rows = [], []
    for i, vals in enumerate(lanes):
        if vals.dtype not in (I64, torch.float64):
            raise TypeError(f"range_sum[{i}]: int64 or float64, got {vals.dtype}")
        _check(f"range_sum[{i}]", vals, vals.dtype, n)
        out = torch.empty(n, dtype=vals.dtype, device=dev)
        outs.append(out)
        rows.append([vals.data_ptr(), _TYPE_CODES[vals.dtype], out.data_ptr()])
    tiles = max(-(-n // RANGE_SUM_TILE), 1)
    heads = torch.empty(max(-(-n // 32), 1), dtype=torch.int32, device=dev)
    tile_f = torch.empty(tiles, dtype=torch.int32, device=dev)
    tile_v = torch.empty(tiles * len(rows), dtype=I64, device=dev)
    cs = torch.empty(max(n, 1) * len(rows), dtype=I64, device=dev)
    native.call(
        "range_sum", "range_sum_launch", _host_table(rows), len(rows), gid,
        lo, hi, n, heads, tile_f, tile_v, cs,
    )
    range_sum.launches += 1
    return outs


range_sum.launches = 0


def _limb_pick(a: torch.Tensor, b: torch.Tensor, is_min: bool) -> torch.Tensor:
    """The lesser (``is_min``) or greater of two-limb decimals [m, 2]:
    lexicographic over (hi signed, lo canonical)."""
    if is_min:
        a_better = (a[:, 0] < b[:, 0]) | ((a[:, 0] == b[:, 0]) & (a[:, 1] < b[:, 1]))
    else:
        a_better = (a[:, 0] > b[:, 0]) | ((a[:, 0] == b[:, 0]) & (a[:, 1] > b[:, 1]))
    return torch.where(a_better[:, None], a, b)


def _limb_fill(is_min: bool) -> tuple[int, int]:
    """The two-limb fill of ``window.py:_range_minmax_limbs``."""
    return ((1 << 63) - 1, 0xFFFFFFFF) if is_min else (-(1 << 63), 0)


def range_minmax_plain(vals, gid, lo, hi, fill, is_min: bool):
    """Plain torch version of W3 (port of ``window.py:_range_minmax`` and
    ``_range_minmax_limbs``): a segmented running min/max of the
    contribution-masked sorted values (non-contributing rows hold
    ``fill``) read at hi-1; an empty frame gives ``fill``. ``vals`` is
    [n] int64 or float64 (NaN propagating, -0.0 below +0.0) or [n, 2]
    limbs (``fill`` then the pair of ``_limb_fill``)."""
    n = vals.shape[0]
    if vals.dim() == 2:
        fill_t = torch.tensor(fill, dtype=I64, device=vals.device)
        scan = _seg_scan_plain(vals, gid, lambda a, b: _limb_pick(a, b, is_min))
        ok = (hi > lo)[:, None]
    else:
        fill_t = torch.tensor(fill, dtype=vals.dtype, device=vals.device)
        scan = _seg_scan_plain(vals, gid, lambda a, b: _minmax_pair(a, b, is_min))
        ok = hi > lo
    if n == 0:
        return vals.clone()
    return torch.where(ok, scan[(hi - 1).clamp(0, n - 1)], fill_t)


def range_minmax(vals, gid, lo, hi, fill, is_min: bool):
    """W3 wrapper (see ``range_minmax_plain``): plain version on the CPU,
    CUDA kernel (``csrc/range_minmax.cu``) on the card."""
    if _on_cpu(vals, gid, lo, hi):
        return range_minmax_plain(vals, gid, lo, hi, fill, is_min)
    n = gid.shape[0]
    _check("range_minmax.gid", gid, I64, n)
    _check("range_minmax.lo", lo, I64, n)
    _check("range_minmax.hi", hi, I64, n)
    if not vals.is_contiguous() or vals.shape[0] != n:
        raise ValueError("range_minmax: contiguous values of the rows' length")
    if vals.dim() == 2:
        if vals.dtype != I64 or vals.shape[1] != 2:
            raise TypeError("range_minmax: limbs must be int64 [n, 2]")
        code, (fill_hi, fill_lo) = 100, fill
    elif vals.dtype == I64:
        code, fill_hi, fill_lo = _TYPE_CODES[I64], int(fill), 0
    elif vals.dtype == torch.float64:
        code, fill_lo = _TYPE_CODES[torch.float64], 0
        fill_hi = struct.unpack("<q", struct.pack("<d", float(fill)))[0]
    else:
        raise TypeError(f"range_minmax: int64, float64 or limbs, got {vals.dtype}")
    dev = gid.device
    lanes = 2 if vals.dim() == 2 else 1
    tiles = max((n + 2047) // 2048, 1)
    tile_f = torch.empty(tiles, dtype=torch.int32, device=dev)
    tile_v = torch.empty((tiles, lanes), dtype=I64, device=dev)
    scan = torch.empty_like(vals)
    out = torch.empty_like(vals)
    native.call(
        "range_minmax", "range_minmax_launch", vals, code, gid, lo, hi, n,
        fill_hi, fill_lo, int(is_min), tile_f, tile_v, scan, out,
    )
    range_minmax.launches += 1
    return out


range_minmax.launches = 0


def seg_searchsorted_plain(w, target, lo0, hi0, left: bool):
    """Plain torch version of W4 (port of ``window.py:_seg_searchsorted``):
    per row, the first position in ``[lo0, hi0)`` whose sorted key ``w``
    is >= the row's ``target`` (``left``), else > it; a fixed log2(n)
    bisection steps over the whole page, as in the JAX package."""
    n = w.shape[0]
    lo, hi = lo0.clone(), hi0.clone()
    for _ in range(max(n.bit_length(), 1)):
        cont = lo < hi
        mid = (lo + hi) // 2
        vm = w[mid.clamp(0, max(n - 1, 0))] if n else target
        go = (vm < target) if left else (vm <= target)
        lo = torch.where(cont & go, mid + 1, lo)
        hi = torch.where(cont & ~go, mid, hi)
    return lo


def seg_searchsorted(w, target, lo0, hi0, left: bool):
    """W4 wrapper: per-row binary search of ``target`` inside the row's
    own sorted range of ``w`` (int64 or float64, see
    ``seg_searchsorted_plain``); plain version on the CPU, CUDA kernel
    (``csrc/seg_searchsorted.cu``) on the card."""
    if _on_cpu(w, target, lo0, hi0):
        return seg_searchsorted_plain(w, target, lo0, hi0, left)
    n = w.shape[0]
    if w.dtype not in (I64, torch.float64):
        raise TypeError(f"seg_searchsorted: int64 or float64, got {w.dtype}")
    _check("seg_searchsorted.w", w, w.dtype, n)
    _check("seg_searchsorted.target", target, w.dtype, n)
    _check("seg_searchsorted.lo0", lo0, I64, n)
    _check("seg_searchsorted.hi0", hi0, I64, n)
    out = torch.empty(n, dtype=I64, device=w.device)
    native.call(
        "seg_searchsorted", "seg_searchsorted_launch", w, target,
        _TYPE_CODES[w.dtype], lo0, hi0, n, int(bool(left)), out,
    )
    seg_searchsorted.launches += 1
    return out


seg_searchsorted.launches = 0


# ---- order bits, arg-extreme and first index --------------------------------


def order_bits(data: torch.Tensor) -> torch.Tensor:
    """Monotone order bits (port of ``kernels.py:order_bits``) in the
    port's signed form: the JAX package's u64 bits with bit 63 flipped
    (``^ _SIGN``), so that signed int64 order is value order. Integers
    are their own int64 value, bools 0/1 flipped, floats
    ``_float_sort_bits`` flipped (NaN largest, -0.0 equal to 0.0)."""
    if data.dtype.is_floating_point:
        return _float_sort_bits(data) ^ _SIGN
    if data.dtype == torch.bool:
        return data.to(I64) ^ _SIGN
    return data.to(I64)


def seg_arg_extreme_plain(keys: torch.Tensor, contrib: torch.Tensor,
                          perm: torch.Tensor, starts: torch.Tensor,
                          ends: torch.Tensor, is_min: bool) -> torch.Tensor:
    """Plain torch version of A3 (port of ``kernels.py:seg_arg_extreme``):
    for each group (sorted positions ``[starts[g], ends[g])`` of
    ``perm``), the original row of its best contributing row: the least
    (``is_min``) or greatest ``order_bits`` key, ties to the first
    sorted position. ``keys`` and ``contrib`` are in original row order.
    A group without a contributing row gives the row at its first
    position (the JAX package gives another row there: callers mask such
    groups with count > 0)."""
    cap = starts.shape[0]
    n = perm.shape[0]
    if cap == 0 or n == 0:
        return torch.zeros(cap, dtype=I64, device=perm.device)
    n_end = int(ends[-1])
    kb = order_bits(keys)[perm[:n_end]]
    cs = contrib[perm[:n_end]]
    worst = (1 << 63) - 1 if is_min else -(1 << 63)
    best = seg_minmax_plain(
        torch.where(cs, kb, torch.full_like(kb, worst)), starts, ends, worst,
        is_min,
    )
    # group of each sorted position (dense contiguous ranges)
    marks = torch.zeros(n_end + 1, dtype=I64, device=perm.device)
    marks.index_add_(0, ends.clamp(max=n_end), torch.ones_like(ends))
    seg = torch.cumsum(marks[:n_end], 0)
    pos = torch.arange(n_end, dtype=I64, device=perm.device)
    hit = cs & (kb == best[seg.clamp(max=cap - 1)])
    first = seg_minmax_plain(
        torch.where(hit, pos, torch.full_like(pos, n)), starts, ends, n, True,
    )
    at = torch.where(first < n, first, starts)
    return perm[at.clamp(0, max(n - 1, 0))]


#: sorted positions a tile of A3's pass (TILE in csrc/seg_arg_extreme.cu):
#: it sizes the carries, whose length the kernel checks
ARG_TILE = 2048


def seg_arg_extreme(keys: torch.Tensor, contrib: torch.Tensor, info: GroupInfo,
                    is_min: bool) -> torch.Tensor:
    """A3 wrapper: the original row of each group's key-extremal
    contributing row (see ``seg_arg_extreme_plain``); keys of any
    integer, bool or float dtype, read through ``info.perm`` and encoded
    as ``order_bits`` inside the kernel. Plain version on the CPU, CUDA
    kernel (``csrc/seg_arg_extreme.cu``) on the card."""
    perm, starts, ends = info.perm, info.starts, info.ends
    if _on_cpu(keys, contrib, perm, starts, ends):
        return seg_arg_extreme_plain(keys, contrib, perm, starts, ends, is_min)
    n = perm.shape[0]
    code = _TYPE_CODES.get(keys.dtype)
    if code is None:
        raise TypeError(f"seg_arg_extreme: unsupported keys {keys.dtype}")
    _check("seg_arg_extreme.keys", keys, keys.dtype, n)
    contrib = contrib.contiguous()
    _check("seg_arg_extreme.contrib", contrib, torch.bool, n)
    _check("seg_arg_extreme.perm", perm, I64, n)
    cap = starts.shape[0]
    _check("seg_arg_extreme.starts", starts, I64, cap)
    _check("seg_arg_extreme.ends", ends, I64, cap)
    # five carries a tile (its first and last groups' key and position,
    # the group it closes), then contrib as a bitmap
    state = torch.empty(5 * -(-n // ARG_TILE) + -(-n // 64), dtype=I64,
                        device=perm.device)
    out = torch.empty(cap, dtype=I64, device=perm.device)
    native.call(
        "seg_arg_extreme", "seg_arg_extreme_launch", keys, code, contrib,
        perm, starts, ends, n, cap, int(bool(is_min)), state, state.shape[0],
        out,
    )
    seg_arg_extreme.launches += 1
    return out


seg_arg_extreme.launches = 0


def seg_first_index(contrib_sorted: torch.Tensor, info: GroupInfo):
    """Original row of the first contributing row per group (port of
    ``kernels.py:seg_first_index``; ``n`` when the group has none), and
    whether it has one: ``seg_minmax`` (K9 on the card) over the masked
    sorted positions, then a gather of ``info.perm``."""
    n = contrib_sorted.shape[0]
    pos = torch.arange(n, dtype=I64, device=contrib_sorted.device)
    masked = torch.where(contrib_sorted, pos, torch.full_like(pos, n))
    first_pos = seg_minmax(masked, info.starts, info.ends, n, True)
    has = first_pos < n
    rows = info.perm[first_pos.clamp(0, max(n - 1, 0))]
    return torch.where(has, rows, torch.full_like(rows, n)), has


# ---- HyperLogLog ------------------------------------------------------------

_HASH_1 = _u64(0xBF58476D1CE4E5B9)
_HASH_2 = _u64(0x94D049BB133111EB)


def dev_hash64(data: torch.Tensor) -> torch.Tensor:
    """Device-side 64-bit value hash of an HLL lane (port of
    ``aggregates.py:dev_hash64``, u64 bits in int64): the splitmix64
    finalizer over the value's bits. A two-limb decimal is ``(hi << 32)
    + lo`` (wrapping); floats canonicalize only -0.0 (NaN payloads hash
    as they are) and widen to float64; integers widen to int64."""
    if data.dim() == 2:
        v = (data[:, 0].to(I64) << 32) + data[:, 1].to(I64)
    elif data.dtype.is_floating_point:
        f = torch.where(data == 0.0, torch.zeros_like(data), data)
        v = f.to(torch.float64).contiguous().view(I64)
    else:
        v = data.to(I64)
    v = v ^ _shr(v, 30)
    v = v * _HASH_1
    v = v ^ _shr(v, 27)
    v = v * _HASH_2
    return v ^ _shr(v, 31)


def clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of the u64 bits carried in int64 (port of
    ``aggregates.py:_clz64``, a binary descent; 64 for 0)."""
    zero = x == 0
    n = torch.zeros(x.shape, dtype=I64, device=x.device)
    for s in (32, 16, 8, 4, 2, 1):
        no_high = _shr(x, 64 - s) == 0
        n = n + no_high.to(I64) * s
        x = torch.where(no_high, x << s, x)
    return torch.where(zero, torch.full_like(n, 64), n)


def _hll_bucket_rho(h: torch.Tensor, m: int):
    b = int(m).bit_length() - 1
    bucket = _shr(h, 64 - b)
    rho = (clz64(h << b) + 1).clamp(1, 64 - b + 1)
    return bucket, rho


def hll_registers_plain(lane: torch.Tensor, contrib: torch.Tensor,
                        group: torch.Tensor | None, m: int, caps: int,
                        hashed: bool) -> torch.Tensor:
    """Plain torch version of A1 (port of ``aggregates.py:_hll_registers``):
    int8[caps, m] registers, each the largest ``rho`` of the contributing
    rows whose (group, bucket) it is. ``lane`` holds u64 hash bits, or
    values to hash with ``dev_hash64`` when ``hashed`` is False; rows of
    a group outside [0, caps) are dropped (``group`` None: all rows in
    group 0). As the JAX package, scatter-free: one sort of
    ``key * 64 + 63 - rho`` and a search for each register's run."""
    h = lane if hashed else dev_hash64(lane)
    bucket, rho = _hll_bucket_rho(h, m)
    key = bucket if group is None else group.to(I64) * m + bucket
    dead = caps * m
    key = torch.where(contrib, key, torch.full_like(key, dead))
    if group is not None:
        key = torch.where((group < 0) | (group >= caps),
                          torch.full_like(key, dead), key)
    combined = key * 64 + (63 - rho)
    sc = torch.sort(combined).values
    targets = torch.arange(caps * m, dtype=I64, device=h.device) * 64
    pos = torch.searchsorted(sc, targets)
    n = sc.shape[0]
    if n == 0:
        return torch.zeros((caps, m), dtype=torch.int8, device=h.device)
    found = sc[pos.clamp(0, n - 1)]
    hit = (pos < n) & ((found >> 6) == (targets >> 6))
    reg = torch.where(hit, 63 - (found & 63), torch.zeros_like(found))
    return reg.to(torch.int8).reshape(caps, m)


def hll_registers(lane: torch.Tensor, contrib: torch.Tensor,
                  group: torch.Tensor | None, m: int, caps: int,
                  hashed: bool) -> torch.Tensor:
    """A1 wrapper: HLL registers (see ``hll_registers_plain``) in
    original row order, no sort; the kernel applies ``dev_hash64`` to an
    int64 or float64 value lane itself. Plain version on the CPU, CUDA
    kernel (``csrc/hll.cu``) on the card."""
    if _on_cpu(lane, contrib, group):
        return hll_registers_plain(lane, contrib, group, m, caps, hashed)
    if m & (m - 1) or not 16 <= m <= 65536:
        raise ValueError(f"hll_registers: m must be a power of two, got {m}")
    if lane.dim() == 2:
        lane = (lane[:, 0].to(I64) << 32) + lane[:, 1].to(I64)
    elif not hashed and lane.dtype != torch.float64:
        lane = lane.to(torch.float64 if lane.dtype.is_floating_point else I64)
    n = lane.shape[0]
    lane = lane.contiguous()
    if hashed and lane.dtype != I64:
        raise TypeError(f"hll_registers: hash lane must be int64, got {lane.dtype}")
    contrib = contrib.contiguous()
    _check("hll_registers.contrib", contrib, torch.bool, n)
    if group is not None:
        _check("hll_registers.group", group, I64, n)
    reg = torch.zeros((caps, m), dtype=torch.int8, device=lane.device)
    mode = 0 if hashed else (2 if lane.dtype == torch.float64 else 1)
    native.call(
        "hll", "hll_registers_launch", lane, mode, contrib, group, n, m,
        caps, reg,
    )
    hll_registers.launches += 1
    return reg


hll_registers.launches = 0


def hll_estimate_plain(reg: torch.Tensor) -> torch.Tensor:
    """Plain torch version of A2 (port of ``aggregates.py:_hll_estimate``):
    registers int8[c, m] -> int64[c] estimates, with the small-range
    linear-counting correction, rounded half to even."""
    m = reg.shape[-1]
    alpha = 0.7213 / (1.0 + 1.079 / m)
    inv = torch.pow(2.0, -reg.to(torch.float64)).sum(-1)
    # tensor divisions (a Python number over a tensor multiplies by the
    # reciprocal, which rounds differently)
    raw = torch.full_like(inv, alpha * m * m) / inv
    v = (reg == 0).sum(-1).to(torch.float64)
    ratio = torch.where(
        v > 0, torch.full_like(v, float(m)) / v.clamp(min=1.0), torch.ones_like(v),
    )
    lin = m * torch.log(ratio)
    est = torch.where((raw <= 2.5 * m) & (v > 0), lin, raw)
    return torch.round(est).to(I64)


def hll_estimate(reg: torch.Tensor) -> torch.Tensor:
    """A2 wrapper: one estimate per register row (see
    ``hll_estimate_plain``); plain version on the CPU, CUDA kernel
    (``csrc/hll.cu``, one warp per row) on the card."""
    if _on_cpu(reg):
        return hll_estimate_plain(reg)
    if reg.dtype != torch.int8 or reg.dim() != 2 or not reg.is_contiguous():
        raise TypeError("hll_estimate: contiguous int8[c, m] registers")
    c, m = reg.shape
    out = torch.empty(c, dtype=I64, device=reg.device)
    native.call("hll", "hll_estimate_launch", reg, c, m, out)
    hll_estimate.launches += 1
    return out


hll_estimate.launches = 0

# ---- the PARTIAL/FINAL sketches ---------------------------------------------


def hll_merge_plain(states: torch.Tensor, contrib: torch.Tensor,
                    group: torch.Tensor | None, caps: int) -> torch.Tensor:
    """Plain torch version of A4 (port of ``aggregates.py:_hll_merge``):
    int8[caps, m] registers, each the max of the register over the
    contributing partial rows of its group (a non-contributing row counts
    as 0; ``group`` None: every row in group 0, else clipped into
    [0, caps)). Registers are never negative, so starting from zeros
    equals the JAX package's max."""
    n, m = states.shape
    live = torch.where(contrib[:, None], states, torch.zeros_like(states))
    out = torch.zeros((caps, m), dtype=states.dtype, device=states.device)
    if n == 0:
        return out
    if group is None:
        gid = torch.zeros(n, dtype=I64, device=states.device)
    else:
        gid = group.to(I64).clamp(0, caps - 1)
    return out.scatter_reduce_(
        0, gid[:, None].expand(n, m), live, "amax", include_self=True
    )


def hll_merge(states: torch.Tensor, contrib: torch.Tensor,
              group: torch.Tensor | None, caps: int) -> torch.Tensor:
    """A4 wrapper: the FINAL register max (see ``hll_merge_plain``) over
    partial rows in their original order; plain version on the CPU, CUDA
    kernel (``csrc/hll_merge.cu``) on the card."""
    if _on_cpu(states, contrib, group):
        return hll_merge_plain(states, contrib, group, caps)
    n, m = states.shape
    if states.dtype != torch.int8 or m % 4:
        raise TypeError(f"hll_merge: int8[n, m] registers, m % 4 == 0; got "
                        f"{states.dtype}{tuple(states.shape)}")
    states = states.contiguous()
    contrib = contrib.contiguous()
    _check("hll_merge.contrib", contrib, torch.bool, n)
    if group is not None:
        group = group.to(I64).contiguous()
        _check("hll_merge.group", group, I64, n)
    out = torch.zeros((caps, m), dtype=torch.int8, device=states.device)
    native.call("hll_merge", "hll_merge_launch", states, contrib, group, n,
                m, caps, out)
    hll_merge.launches += 1
    return out


hll_merge.launches = 0


def _f64(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float64, device=like.device)


def quant_summary_plain(vd: torch.Tensor, p: torch.Tensor, starts: torch.Tensor,
                        cnt: torch.Tensor, k: int) -> torch.Tensor:
    """Plain torch version of A5 (port of ``aggregates.py:_quant_summary``
    after its sort): float64[caps, k + 1], point i of group g the value at
    sorted position ``starts[g] + off`` of ``p``, with ``off =
    clip(round((i + 0.5) / k * cnt - 0.5), 0, max(cnt - 1, 0))`` rounded
    half to even, and the count as lane k. With no rows every point is
    0.0 (the JAX package cannot trace that case)."""
    n = vd.shape[0]
    caps = starts.shape[0]
    dev = vd.device
    c = cnt.to(torch.float64)
    if n == 0:
        pts = torch.zeros((caps, k), dtype=torch.float64, device=dev)
    else:
        i = torch.arange(k, dtype=torch.float64, device=dev)
        # tensor divisions: k is a power of two, so (i + 0.5) / k is
        # exact either way, but the form stays the JAX package's
        frac = (i + 0.5) / _f64(float(k), i)
        offs = torch.round(frac[None, :] * c[:, None] - 0.5)
        offs = torch.minimum(
            offs.clamp(min=0.0), (cnt - 1).clamp(min=0).to(torch.float64)[:, None]
        ).to(I64)
        at = (starts[:, None] + offs).clamp(0, n - 1)
        pts = vd[p[at]].to(torch.float64)
    return torch.cat([pts, c[:, None]], dim=1)


def quant_summary(vd: torch.Tensor, p: torch.Tensor, starts: torch.Tensor,
                  cnt: torch.Tensor, k: int) -> torch.Tensor:
    """A5 wrapper: the k-point summary of every group (see
    ``quant_summary_plain``), the offsets, the two-level gather and the
    count lane in one pass; plain version on the CPU, CUDA kernel
    (``csrc/quant_summary.cu``) on the card."""
    if _on_cpu(vd, p, starts, cnt):
        return quant_summary_plain(vd, p, starts, cnt, k)
    if vd.dim() != 1:
        raise TypeError("quant_summary: a one-lane value column")
    if vd.dtype not in (I64, torch.float64):
        vd = vd.to(torch.float64 if vd.dtype.is_floating_point else I64)
    vd = vd.contiguous()
    n = vd.shape[0]
    caps = starts.shape[0]
    _check("quant_summary.p", p, I64, n)
    starts = starts.contiguous()
    cnt = cnt.to(I64).contiguous()
    _check("quant_summary.starts", starts, I64, caps)
    _check("quant_summary.cnt", cnt, I64, caps)
    out = torch.empty((caps, k + 1), dtype=torch.float64, device=vd.device)
    native.call("quant_summary", "quant_summary_launch", vd,
                int(vd.dtype == torch.float64), p, n, starts, cnt, caps, k,
                out)
    quant_summary.launches += 1
    return out


quant_summary.launches = 0


def _quant_order(states: torch.Tensor, group: torch.Tensor | None):
    """The merge order of the summaries' n * k points: two stable sorts,
    by value (``order_bits``) then by group, as the JAX package's."""
    n, k1 = states.shape
    k = k1 - 1
    vbits = order_bits(states[:, :k]).reshape(-1)
    p = torch.sort(vbits, stable=True).indices
    del vbits
    if group is not None:
        p = p[torch.sort(group[p // k], stable=True).indices]
    return p


def quant_merge_plain(states: torch.Tensor, eff: torch.Tensor,
                      group: torch.Tensor | None, caps: int,
                      q: torch.Tensor):
    """Plain torch version of A6 (port of ``aggregates.py:_quant_merge``):
    (float64[caps] value, bool[caps] has). Each point of a partial row
    weighs ``count / k`` when the row contributes; over the points sorted
    by (group, value), a group answers the first point whose running
    weight within the group reaches ``q * total - 1e-9`` with a positive
    weight (the JAX form: a global cumsum minus each group's base).
    ``group`` is clipped into [0, caps) (None: one group); ``q`` a
    one-element float64 tensor."""
    n, k1 = states.shape
    k = k1 - 1
    dev = states.device
    if n == 0 or k == 0:
        return (torch.zeros(caps, dtype=torch.float64, device=dev),
                torch.zeros(caps, dtype=torch.bool, device=dev))
    nk = n * k
    cnt = states[:, k]
    w = torch.where(eff & (cnt > 0), cnt / _f64(float(k), cnt),
                    torch.zeros_like(cnt))
    vals = states[:, :k].reshape(-1)
    wts = w.repeat_interleave(k)
    if group is None:
        gid_f = torch.zeros(nk, dtype=I64, device=dev)
    else:
        gid_f = group.to(I64).repeat_interleave(k)
    p = _quant_order(states, None if group is None else group.to(I64))
    gs = gid_f[p]
    ws = wts[p]
    cum = torch.cumsum(ws, 0)
    starts = torch.searchsorted(gs, torch.arange(caps, dtype=I64, device=dev))
    base = torch.where(starts > 0, cum[(starts - 1).clamp(0, nk - 1)],
                       torch.zeros_like(cum[:1]))
    total = torch.zeros(caps, dtype=torch.float64, device=dev).index_add_(
        0, gs, ws)
    adj = cum - base[gs]
    target = q.reshape(-1)[0].to(torch.float64) * total
    reached = adj >= target[gs] - 1e-9
    idx = torch.arange(nk, dtype=I64, device=dev)
    cand = torch.where(reached & (ws > 0), idx, torch.full_like(idx, nk))
    first = torch.full((caps,), nk, dtype=I64, device=dev).scatter_reduce_(
        0, gs, cand, "amin")
    at = first.clamp(0, nk - 1)
    return vals[p[at]], total > 0


def _a6_staged_points(k: int, counts: torch.Tensor | None, n: int) -> int:
    """The points of one group that A6 stages in shared memory: the rows
    that 99% of the groups with rows fit in (``counts``: rows per group;
    None: one group of ``n`` rows), k points each. One host sync. A
    larger group reads its points from device memory on every pass, and
    the kernel clamps this to a block's shared memory."""
    if counts is None:
        return n * k
    present = (counts > 0).sum()
    at = counts.shape[0] - present + (present * 99 + 99) // 100 - 1
    return int(torch.sort(counts).values[at]) * k


def quant_merge(states: torch.Tensor, eff: torch.Tensor,
                group: torch.Tensor | None, caps: int, q: torch.Tensor):
    """A6 wrapper: the FINAL weighted rank pick (see
    ``quant_merge_plain``). Plain version on the CPU. On the card the
    partial rows (not their points) are ordered by group with one stable
    ``torch.sort``, and the kernel (``csrc/quant_merge.cu``, one block
    per group) finds each group's pick by a weighted radix select over
    the order bits of its points. ``group`` must lie in [0, caps), as the
    plain version's does; ``k`` must be a power of two."""
    if _on_cpu(states, eff, group, q):
        return quant_merge_plain(states, eff, group, caps, q)
    n, k1 = states.shape
    k = k1 - 1
    dev = states.device
    if states.dtype != torch.float64:
        raise TypeError(f"quant_merge: float64 summaries, got {states.dtype}")
    if n == 0 or k == 0 or caps == 0:
        return (torch.zeros(caps, dtype=torch.float64, device=dev),
                torch.zeros(caps, dtype=torch.bool, device=dev))
    if k & (k - 1):
        raise ValueError(f"quant_merge: k = {k} is not a power of two")
    if n * k >= 1 << 32:
        raise ValueError(f"quant_merge: {n} x {k} points (the kernel counts "
                         "a group's points in 32 bits)")
    states = states.contiguous()
    eff = eff.contiguous()
    _check("quant_merge.eff", eff, torch.bool, n)
    # no group: the kernel takes every row as group 0's, in row order
    rows = seg_lo = seg_hi = last_group = counts = None
    if group is not None:
        group = group.to(I64).contiguous()
        _check("quant_merge.group", group, I64, n)
        # rows by group, each group's rows in row order (flat index order)
        ordered, rows = torch.sort(group.to(torch.int32), stable=True)
        # (bincount would sync to size its output)
        counts = torch.zeros(caps, dtype=I64, device=dev).index_add_(
            0, group, torch.ones_like(group))
        seg_hi = torch.cumsum(counts, 0)
        seg_lo = seg_hi - counts
        last_group = ordered[-1:].to(I64)
    q = q.reshape(-1)[:1].to(torch.float64).contiguous()
    last_flat = torch.empty(1, dtype=I64, device=dev)
    out = torch.empty(caps, dtype=torch.float64, device=dev)
    has = torch.empty(caps, dtype=torch.bool, device=dev)
    native.call("quant_merge", "quant_merge_launch", states, k, n, eff, rows,
                seg_lo, seg_hi, last_group, caps,
                _a6_staged_points(k, counts, n), q,
                last_flat, out, has)
    quant_merge.launches += 1
    return out, has


quant_merge.launches = 0

# ---- the mesh: exchange packing and scatter reductions ---------------------


def umod(h: torch.Tensor, n: int) -> torch.Tensor:
    """The unsigned residue ``h mod n`` of u64 bits carried in int64 (the
    JAX package's ``h % jnp.uint64(n)``), as int64 in [0, n). torch's
    ``%`` is signed: a hash with bit 63 set would land elsewhere."""
    return (_shr(h, 1) % n * 2 + (h & 1)) % n


def _segment_identity(op: str, dtype: torch.dtype):
    """The value an empty slot holds: 0, or the dtype's extreme (+-inf
    for floats) that a min or max leaves alone."""
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _f64_order_key(x: torch.Tensor) -> torch.Tensor:
    """float64 bits -> signed total-order key (-0.0 < +0.0); the map is
    its own inverse on non-NaN bits."""
    b = x.contiguous().view(I64)
    return torch.where(b >= 0, b, b ^ ((1 << 63) - 1))


def segment_reduce_plain(vals: torch.Tensor, group: torch.Tensor,
                         num_segments: int, op: str) -> torch.Tensor:
    """Plain torch version of M2 (``kernels.py:seg_sum``/``seg_min``/
    ``seg_max``): ``op`` in sum, min, max of ``vals`` by ``group`` into
    ``num_segments`` slots; ids outside [0, num_segments) drop and an
    empty slot holds the identity. float64 min/max reduce the total-order
    key of the bits, so -0.0 < +0.0 and a NaN makes its slot NaN (the
    canonical quiet NaN), as XLA's min/max do."""
    keep = (group >= 0) & (group < num_segments)
    g = group[keep].to(I64)
    v = vals[keep]
    if op == "sum":
        out = torch.zeros(num_segments, dtype=vals.dtype, device=vals.device)
        return out.index_add_(0, g, v)
    reduce = "amin" if op == "min" else "amax"
    if vals.dtype != torch.float64:
        out = torch.full((num_segments,), _segment_identity(op, vals.dtype),
                         dtype=vals.dtype, device=vals.device)
        return out.scatter_reduce_(0, g, v, reduce, include_self=True)
    ident = _f64_order_key(torch.tensor(
        [_segment_identity(op, vals.dtype)], dtype=torch.float64,
        device=vals.device))
    nan_key = (-(1 << 63)) if op == "min" else (1 << 63) - 1
    key = torch.where(torch.isnan(v), torch.full(v.shape, nan_key, dtype=I64,
                                                 device=v.device),
                      _f64_order_key(v))
    out = ident.expand(num_segments).clone()
    out.scatter_reduce_(0, g, key, reduce, include_self=True)
    res = _f64_order_key(out.view(torch.float64)).view(torch.float64)
    return torch.where(torch.isnan(res), torch.full_like(res, float("nan")), res)


_SEGMENT_OPS = {"sum": 0, "min": 1, "max": 2}


def segment_reduce(vals: torch.Tensor, group: torch.Tensor,
                   num_segments: int, op: str) -> torch.Tensor:
    """M2 wrapper: scatter reduction ``op`` (sum, min or max) of int64 or
    float64 ``vals`` by int32 or int64 ``group`` into ``num_segments``
    slots; out-of-range ids drop, empty slots hold the identity. Plain
    version on the CPU, CUDA kernel (``csrc/segment_reduce.cu``) on the
    card."""
    if op not in _SEGMENT_OPS:
        raise ValueError(f"segment_reduce: op must be sum, min or max: {op}")
    if _on_cpu(vals, group):
        return segment_reduce_plain(vals, group, num_segments, op)
    if vals.dtype not in (I64, torch.float64):
        raise TypeError(f"segment_reduce: int64 or float64 values, got {vals.dtype}")
    if group.dtype not in (I64, torch.int32):
        raise TypeError(f"segment_reduce: int32 or int64 ids, got {group.dtype}")
    n = vals.shape[0]
    _check("segment_reduce.vals", vals, vals.dtype, n)
    _check("segment_reduce.group", group, group.dtype, n)
    out = torch.empty(num_segments, dtype=vals.dtype, device=vals.device)
    native.call(
        "segment_reduce", "segment_reduce_launch", vals, group, n,
        num_segments, int(vals.dtype == torch.float64), int(group.dtype == I64),
        _SEGMENT_OPS[op], out,
    )
    segment_reduce.launches += 1
    return out


segment_reduce.launches = 0


def partition_pack_plain(dest: torch.Tensor, live: torch.Tensor, payload,
                         n_parts: int, bucket: int):
    """Plain torch version of M1 (``parallel/exchange.py:
    partition_exchange`` before its all_to_all): the JAX one-hot cumsum
    rank. Returns (buckets: one [n_parts * bucket, ...] tensor per payload
    column, sent_live [n_parts * bucket] bool, counts [n_parts] int64)."""
    dev = dest.device
    d = dest.to(I64)
    valid = live & (d >= 0) & (d < n_parts)
    dc = d.clamp(0, n_parts - 1)
    # [n_parts, n]: each destination's one-hot row, scanned along rows
    oh = ((torch.arange(n_parts, device=dev)[:, None] == dc[None, :])
          & valid[None, :]).to(I64)
    rank = torch.cumsum(oh, 1) - oh
    pos = torch.gather(rank, 0, dc[None, :])[0]
    counts = oh.sum(1)
    in_range = valid & (pos < bucket)
    total = n_parts * bucket
    flat = torch.where(in_range, dc * bucket + pos, torch.full_like(pos, total))
    buckets = []
    for arr in payload:
        out = torch.zeros((total + 1,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                          device=dev)
        out[flat] = arr
        buckets.append(out[:total])
    sent = torch.zeros(total + 1, dtype=torch.bool, device=dev)
    sent[flat] = True
    return buckets, sent[:total], counts


#: payload columns one M1 launch writes (MAX_COLS in csrc/partition_pack.cu)
PACK_MAX_COLS = 32
#: rows a block of M1 covers (TILE in csrc/partition_pack.cu)
PACK_TILE = 4096


def partition_pack(dest: torch.Tensor, live: torch.Tensor, payload,
                   n_parts: int, bucket: int):
    """M1 wrapper: a shard's live rows packed stably by ``dest`` into
    ``n_parts`` buckets of ``bucket`` slots (row order within a bucket,
    overflowing rows dropped): (buckets, sent_live, counts) as
    ``partition_pack_plain``. Plain version on the CPU, CUDA kernel
    (``csrc/partition_pack.cu``) on the card: one wrapper call is one
    launch (its pack pass over the rows and its pass over the bucket
    tails; both again per further ``PACK_MAX_COLS`` payload columns). The
    kernel writes every slot, so the buckets are allocated empty; int32
    and int64 ``dest`` go to it as they are."""
    if _on_cpu(dest, live, *payload):
        return partition_pack_plain(dest, live, payload, n_parts, bucket)
    if not 1 <= n_parts <= 64:
        raise ValueError(f"partition_pack: 1 to 64 destinations, got {n_parts}")
    n = dest.shape[0]
    dev = dest.device
    if dest.dtype not in (torch.int32, I64):
        dest = dest.to(I64)
    dest = dest.contiguous()
    _check("partition_pack.live", live, torch.bool, n)
    total = n_parts * bucket
    # contiguous copies stay alive in ``cols`` while the kernel reads them
    cols = [arr.contiguous() for arr in payload]
    buckets, desc = [], []
    for i, arr in enumerate(cols):
        if arr.shape[0] != n:
            raise ValueError(f"partition_pack: payload {i} has {arr.shape[0]} rows, not {n}")
        width = arr.element_size() * math.prod(arr.shape[1:])
        if width not in (1, 2, 4, 8, 16):
            raise TypeError(f"partition_pack: payload {i} rows of {width} bytes")
        out = torch.empty((total,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                          device=dev)
        buckets.append(out)
        desc.append([arr.data_ptr(), out.data_ptr(), width])
    sent = torch.empty(total, dtype=torch.bool, device=dev)
    counts = torch.empty(n_parts, dtype=I64, device=dev)
    state = torch.empty(-(-n // PACK_TILE) * n_parts + 1, dtype=I64, device=dev)
    batches = [desc[i: i + PACK_MAX_COLS]
               for i in range(0, len(desc), PACK_MAX_COLS)] or [[]]
    for b, batch in enumerate(batches):
        table = _host_table(batch) if batch else torch.zeros((0, 3), dtype=I64)
        # the first batch writes the flags, every batch its own columns
        native.call("partition_pack", "partition_pack_launch", dest,
                    int(dest.dtype == I64), live, n, n_parts, bucket, state,
                    counts, table, len(batch), sent if b == 0 else None)
    partition_pack.launches += 1
    return buckets, sent, counts


partition_pack.launches = 0


#: the wrappers whose kernels the main path must launch
KERNELS = {
    "group_ids": group_ids,
    "seg_sum": seg_sum,
    "join_probe": join_probe,
    "expand_matches": expand_matches,
    "range_any": range_any,
    "scatter_any": scatter_any,
    "hash_keys": hash_keys,
    "pack_words": pack_keys,
    "seg_minmax": seg_minmax,
    "order_words": order_words,
    "window_peers": window_peers,
    "range_sum": range_sum,
    "range_minmax": range_minmax,
    "seg_searchsorted": seg_searchsorted,
    "hll_registers": hll_registers,
    "hll_estimate": hll_estimate,
    "seg_arg_extreme": seg_arg_extreme,
    "hll_merge": hll_merge,
    "quant_summary": quant_summary,
    "quant_merge": quant_merge,
    "partition_pack": partition_pack,
    "segment_reduce": segment_reduce,
}


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
