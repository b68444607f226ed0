#!/usr/bin/env python3
"""Drive the PyTorch port (``trino_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the hand-written CUDA kernels from ``trino_tpu_torch/csrc`` with
   nvcc for sm_90a (all sources in parallel).
3. Kernel phases: each kernel (K1 group_ids, K2 seg_sum, K3 join_probe,
   K4 expand_matches, K5 range_any, K6 scatter_any, K7 hash_keys, K8
   pack_words, K9 seg_minmax, K10 order_words, W1 window_peers, W2
   range_sum, W3 range_minmax, W4 seg_searchsorted, A1 hll_registers, A2
   hll_estimate, A3 seg_arg_extreme, A4 hll_merge, A5 quant_summary, A6
   quant_merge, M1 partition_pack, M2 segment_reduce) runs on the card at
   the main path's
   shapes (TPC-H SF10 scale: 60M rows with 4 and with 1.5M groups, and 8M
   partsupp rows in 2M groups; a 15M-row build side against a 60M-row
   probe, also with uniform u64 keys, with one build key on 30% of the
   build rows and with the probes in key order; that probe's matches
   expanded, and 60M probe rows of 0-1 matches with 16 rows of 1M
   matches each expanded from a 15M-row order; 15M probe rows of 1-7
   matches each, ~60M expanded positions, also with one hot probe row
   owning 10% of them; 60M indices into 15M slots; 60M rows of two and
   of three join-key parts; 60M rows of one and of three GROUP BY keys to
   pack; 15M orders rows of two ORDER BY keys. TPC-DS SF10 scale: 28.8M store_sales rows in 120 store
   partitions under a RANGE 6 preceding frame, also with a float64 key
   and values holding NaN, -0.0 and a partition of 1e18s; q51's 5.5M rows
   in 180K item partitions of decimal(38,2) limbs; 28.8M store_sales rows
   into HLL registers globally (4096, also with every row one hot value)
   and in 180K items (512), the estimates of those 180K x 512 registers,
   and the arg-extreme of 28.8M rows in 180K and in 120 groups over int64
   and float64 keys with ties, NaN, -0.0 and groups with no contributing
   row; the FINAL register max of five chunks' partial registers of 180K
   items x 512, of 5 x 4096 globally and with one group holding every
   partial row; the quantile summaries of one 5.8M-row chunk in 180K
   items (k = 256) and globally (k = 1024); their merge over 5 x 180K
   partial rows of 256 points and over one group of 5 x 1024. The mesh at
   SF10 on 8 shards: one 7.5M-row shard of Q3's lineitem exchange packed
   into 8 buckets, also with one destination owning 60% so that it
   overflows; 60M int64 and float64 values scattered into 16 and into
   1.5M slots, float64 min/max with NaN and -0.0, and an 8-slot
   histogram of 60M destinations), is held
   against its plain torch version on the same inputs
   (integers, booleans, positions, registers, estimates, summaries,
   picks, min/max and sort words exactly, float64 group sums to relative 1e-12 and float64 frame
   sums to relative 1e-9 each; K1's representative flags and K10's
   permutation too), and is timed beside the plain version, one PyTorch
   library call that computes the same function where there is one, and
   the least time the card could take (bytes each input read once and
   each output written once, over 3.35 TB/s of HBM; K5 counts the
   out_live bytes up to each range's first live position, where its scan
   stops; K4 ``lo`` of the matching rows and the rows of ``order`` their
   ranges cover). Beside each K1 case a bare ``group[perm] = gid_sorted``
   (``index_put_``) is timed: the inverse permutation's store alone,
   part of K1's work; beside each K4 case one torch gather of ``order``
   at each matching row's ``lo``, K4's random reads alone; beside K1's
   Q1 case, ``stage._presort_shared``'s
   stacked gather of five int64 columns is timed against one gather per
   column,
   and ``kernels.count_true`` (a torch sum) over a 60M-row mask.
4. Main path, TPC-H: ``QueryRunner.tpch("sf1")`` on cuda runs TPC-H Q1,
   Q3, Q18, Q4, Q17, Q21, a full outer join and Q2, Q9, Q11, Q13, Q14,
   Q16, Q20, Q22 (tables resident on the card; Q11's FRACTION is 0.0001 /
   SF, as TPC-H sets it); ``QueryRunner.tpch("sf10")`` runs Q1, Q3 and
   Q18 (``SF10_QUERIES``; the other SF10 runs were cut to keep the script
   inside its time limit). Rows must equal the exact numpy reference
   (``trino_tpu_torch.testing.numpy_reference.rows_match``: Q14's and
   Q17's one DOUBLE to relative 1e-12), cold and in 3 warm runs; one more
   warm run stops at the result page, before the rows are built. Then the
   SF10 runner runs Q1, Q3 and Q18 again under ``hbm_budget_bytes`` = 1 GiB
   (cold and 2 warm, against the same references): each must take its
   spill path (Q1 the streamed chain with its PARTIAL/FINAL split, Q3 a
   streamed probe or grace join, Q18 the streamed chain and the streamed
   semi join) and keep the tracked working set within the budget.
5. Main path, TPC-DS: the TPC-H runner is released, then
   ``QueryRunner.tpcds("sf1")`` and ``QueryRunner.tpcds("sf10")`` run
   q3, q98, q51 over 1999 (its text's months 1200-1211 count from 1900;
   this generator counts from 1990) and the totals of its windowed
   relation, q86 (ROLLUP, grouping(), rank()), a RANGE offset window
   over all of store_sales (``numpy_reference.RANGE7_SQL``) and the
   aggregate functions' statements (``statements.SKETCH_CARD``:
   approx_distinct, approx_percentile, max_by/min_by, arbitrary,
   bool_or/bool_and and the variance family over store_sales, TPC-DS
   q17's store/returns relation and, at SF1 only, q39's inventory
   relation), each held against its exact numpy reference (q98's DOUBLE
   to relative 1e-12, the sums of ds_q39_inv's million doubles to
   relative 1e-9, every other DOUBLE exactly), cold and in 3 warm runs
   at SF1 and 1 at SF10 (``DS_WARM_RUNS``), all under ``query_max_memory_per_node``'s 2GB default: at SF10 the
   joins of q98, q51, its totals, q86 and ds_sketch_global exceed it and
   are revoked into the spill tier (each must show a revocation); any
   ExceededMemoryLimitError outside ``OVER_CAP_RAISES`` fails the run.
   Then ds_sketch_item runs under ``hbm_budget_bytes`` (128 MiB at SF1,
   1 GiB at SF10): store_sales streams in the number of chunks that
   ``spill.chunk_rows_for`` gives, and the rows equal the chunked numpy
   twin (``numpy_reference.chunked_percentile`` over the same chunk
   bounds; every other column the resident answer), each percentile
   within the summaries' rank bound. The peak device memory of each
   scale is printed. On both main paths a scale's set-up comes before
   its first run, on ``SETUP_WORKERS`` host threads: every column of the
   tables its statements name is generated, then the numpy references
   are computed. Each path runs with every kernel's launch count and
   every spill path's entry count set to 0 just before it: K1-K10 must be
   launched on the TPC-H path and W1-W4 and A1-A6 on the TPC-DS path;
   the launches and spill entries of each query's runs, and the calls of
   count_true, blocked_sum and _presort_shared on each path, are
   printed.
6. Mesh path, run between the TPC-H and TPC-DS paths (``MESH_SHARDS`` =
   8 shards on ``cuda:0``, one process driving a device list): new mesh
   runners over the TPC-H path's SF10 and SF1 metadata (their planner
   statistics warm; the single-device runners are released first, the
   metadata as the mesh path finishes with it) and a new TPC-DS SF1
   runner run
   Q1, Q3 and Q18 at SF10 (cold, 3 warm, one to the result page), the
   SF1 statements (cold, 1 warm, one to the page), an ORDER BY over all
   of lineitem that must take a range exchange (its keys in numpy's
   lexsort order), a 6M-row skewed join through the memory connector
   that must take the skew split, and TPC-DS q3 and q86 at SF1, each
   against its numpy reference, with its exchanges, bytes moved,
   escalations, host syncs, skew splits and range exchanges printed, and
   the peak device memory per phase. M1, M2, K1-K4 and K7 must be
   launched on it.
7. Prints one ``{"kernels": [...]}`` line, the nvidia-smi line again, and
   as the last line ``{"ok": true, "device": {...}}``.

Any build failure, launch error or mismatch exits non-zero. Without CUDA,
or without the package beside this file, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

#: H100 SXM HBM3 rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: TPC-H SF10 row counts the kernel phases are sized at
LINEITEM_ROWS = 60_000_000
ORDERS_ROWS = 15_000_000
PARTSUPP_ROWS = 8_000_000
PART_ROWS = 2_000_000
#: TPC-DS SF10 shapes of the window kernel phases: store_sales (the RANGE
#: offset window over 120 stores and the sales days 1998-01-02 to
#: 2002-12-30) and q51's windowed relation over 180K items
DS_SALES_ROWS = 28_800_000
DS_STORES = 120
DS_ITEMS = 180_000
DS_DAYS = 1824
Q51_ROWS = 5_500_000
Q51_ITEMS = 180_000
#: the TPC-H queries that string predicates, DISTINCT aggregates and the
#: cross join brought onto the card
NEW_QUERIES = ("q02", "q09", "q11", "q13", "q14", "q16", "q20", "q22")
SEED = 20261017


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def timed_ms(torch, fn, reps: int = 5) -> float:
    """Mean device time of one call, CUDA events around ``reps`` calls
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def same(torch, a, b) -> bool:
    return bool(torch.equal(a, b))


# ---- kernel phases ----------------------------------------------------------


def group_case(torch, np, K, shapes, dev, n_groups: int, rows: int = LINEITEM_ROWS):
    """Sorted Q1/Q3-like grouping inputs: packed key words with liveness
    folded in (the group_by hot path), ~3% dead rows."""
    rng = np.random.default_rng(SEED + n_groups)
    keys = torch.from_numpy(
        rng.integers(0, n_groups, size=rows, dtype=np.int64)
    ).to(dev)
    live = torch.from_numpy(rng.random(rows) >= 0.03).to(dev)
    width = max(1, int(n_groups - 1).bit_length())
    words, folded, total_bits = K._pack_words((keys,), (None,), live, (width,))
    if not folded:
        fail("group_case: the key pack did not fold liveness in")
    flipped, perm = torch.sort(words[0] ^ K._SIGN, stable=True)
    ps = (flipped ^ K._SIGN).contiguous()
    live_s = K._shr(ps, total_bits) == 0
    capacity = shapes.table_bucket(n_groups, 0)
    return ps, live_s, perm, capacity


def k1_phase(torch, K, ps, live_s, perm, capacity) -> tuple[dict, tuple]:
    """K1 against its plain version, beside a bare ``group[perm] =
    gid_sorted`` (``index_put_``): the inverse permutation's scattered
    store alone, part of K1's work."""
    n = ps.shape[0]
    got = K.group_ids(ps, None, live_s, perm, capacity, with_rep=True)
    want = K.group_ids_plain(ps, None, live_s, perm, capacity, with_rep=True)
    torch.cuda.synchronize()
    # every field, the representative flag `rep` included
    for name, a, b in zip(K.GroupInfo._fields, got, want):
        if not same(torch, a, b):
            fail(f"group_ids: {name} differs from the plain version")
    if int(got.rep.sum()) != min(int(got.num_groups), capacity):
        fail("group_ids: rep does not mark one row per group")
    n_live = int(live_s.sum())
    live_words = ps[:n_live]
    group = torch.empty_like(got.gid_sorted)
    return {
        "scatter_ms": timed_ms(
            torch, lambda: group.index_put_((perm,), got.gid_sorted)),
        "max_abs_err": 0,
        "ms": timed_ms(torch, lambda: K.group_ids(ps, None, live_s, perm, capacity)),
        "plain_ms": timed_ms(torch, lambda: K.group_ids_plain(ps, None, live_s, perm, capacity)),
        # with the representative flags (a DISTINCT's dedupe)
        "rep_ms": timed_ms(torch, lambda: K.group_ids(
            ps, None, live_s, perm, capacity, with_rep=True)),
        "library_ms": timed_ms(torch, lambda: torch.unique_consecutive(
            live_words, return_inverse=True, return_counts=True)),
        # words, perm (8 B) + live_s (1 B) in; gid_sorted, group (8 B) out;
        # starts/ends/owner (8 B per slot) and num_groups out
        "bound_ms": bound_ms(n * (8 + 1 + 8) + n * 16 + capacity * 24 + 8),
        "rows": n, "capacity": capacity,
        "groups": int(got.num_groups),
    }, got


def k2_phase(torch, np, K, info, dtype_name: str, n_groups: int) -> dict:
    rng = np.random.default_rng(SEED + 7 + n_groups)
    n = info.perm.shape[0]
    dev = info.perm.device
    if dtype_name == "int64":
        # Q1/Q3's sums are 32-bit decimal limbs in int64
        vals = torch.from_numpy(
            rng.integers(0, 1 << 32, size=n, dtype=np.int64)
        ).to(dev)
    else:
        vals = torch.from_numpy(rng.normal(size=n) * 1e6).to(dev)
    starts, ends = info.starts, info.ends
    got = K.seg_sum(vals, starts, ends)
    want = K.seg_sum_plain(vals, starts, ends)
    torch.cuda.synchronize()
    if dtype_name == "int64":
        if not same(torch, got, want):
            fail(f"seg_sum int64 ({n_groups} groups) differs from the plain version")
        err = 0
    else:
        err = float((got - want).abs().max())
        tol = 1e-12 * float(want.abs().max()) + 1e-9
        if err > tol:
            fail(f"seg_sum float64 ({n_groups} groups): max error {err} > {tol}")
    cap = starts.shape[0]
    library = None
    if dtype_name == "float64":
        n_end = int(ends[-1])
        lengths = (ends - starts)
        seg_vals = vals[:n_end]
        library = timed_ms(torch, lambda: torch.segment_reduce(
            seg_vals, "sum", lengths=lengths))
    return {
        "max_abs_err": err,
        "ms": timed_ms(torch, lambda: K.seg_sum(vals, starts, ends)),
        "plain_ms": timed_ms(torch, lambda: K.seg_sum_plain(vals, starts, ends)),
        "library_ms": library,
        # values (8 B/row) and starts/ends (16 B/slot) in, sums out
        "bound_ms": bound_ms(n * 8 + cap * 24),
        "rows": n, "capacity": cap, "dtype": dtype_name,
    }


def presort_phase(torch, np, perm) -> dict:
    """``stage._presort_shared``'s stacked gather at Q1's SF10 shape: the
    five int64 value columns of Q1's sums (quantity, price, discount,
    discounted price, charge) gathered into group order by ``perm`` as
    one [5, n] stack, beside one gather per column."""
    rng = np.random.default_rng(SEED + 300)
    n = perm.shape[0]
    xs = [torch.from_numpy(rng.integers(0, 1 << 40, size=n)).to(perm.device)
          for _ in range(5)]
    stacked = torch.stack(xs)[:, perm]
    for i, x in enumerate(xs):
        if not same(torch, stacked[i], x[perm]):
            fail("presort_shared: the stacked gather differs from a column gather")
    return {
        "rows": n, "columns": len(xs),
        "ms": timed_ms(torch, lambda: torch.stack(xs)[:, perm]),
        "per_column_ms": timed_ms(torch, lambda: [x[perm] for x in xs]),
        # the columns and perm read once, the gathered columns written once
        "bound_ms": bound_ms(n * 8 * len(xs) * 2 + n * 8),
    }


#: K3's cases besides Q3's: uniform u64 keys (multi-column keys after
#: K7's hash; bit 63 set on half), one build key on 30% of the build rows,
#: and the probes in key order (lineitem's l_orderkey order)
JOIN_KINDS = ("hashed", "hot", "sorted")


def join_case(torch, np, K, dev, kind: str = "q3"):
    """Q3-like join inputs: 15M build keys (sparse order keys, 1%
    duplicated, ~half dead after the date filter) against 60M probe keys
    (~half dead, 2% without a match), in probe order random; or one of
    ``JOIN_KINDS`` built the same way from other build keys or with the
    probes sorted."""
    rng = np.random.default_rng(SEED + 3)
    other = np.random.default_rng(SEED + 33)
    m, n = ORDERS_ROWS, LINEITEM_ROWS
    build = np.arange(m, dtype=np.int64) * 4 + 1
    if kind == "hashed":
        build = other.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                               size=m, dtype=np.int64, endpoint=True)
    dup = rng.integers(0, m, size=m // 100)
    build[rng.integers(0, m, size=m // 100)] = build[dup]
    if kind == "hot":
        build[other.random(m) < 0.3] = build[m // 2]
    build = build[rng.permutation(m)]
    probe = build[rng.integers(0, m, size=n)]
    probe[rng.random(n) < 0.02] += 2  # keys no build row has
    bk = torch.from_numpy(build).to(dev)
    bl = torch.from_numpy(rng.random(m) >= 0.5).to(dev)
    pk = torch.from_numpy(probe).to(dev)
    if kind == "sorted":
        pk = torch.sort(pk).values
    pl = torch.from_numpy(rng.random(n) >= 0.46).to(dev)
    o1 = K._argsort_u64(bk)
    order = o1[K._argsort_flag((~bl)[o1])]
    sorted_key = bk[order].contiguous()
    nbl = bl.to(torch.int64).sum().reshape(1)
    return order, sorted_key, nbl, pk, pl


def k3_phase(torch, K, order, sorted_key, nbl, pk, pl) -> tuple[dict, tuple]:
    lo, cnt = K.join_probe(sorted_key, nbl, pk, pl)
    lo_p, cnt_p = K.join_probe_plain(sorted_key, nbl, pk, pl)
    torch.cuda.synchronize()
    if not (same(torch, lo, lo_p) and same(torch, cnt, cnt_p)):
        fail("join_probe differs from the plain version")
    n, n_live = pk.shape[0], int(nbl)
    live_keys = (sorted_key[:n_live] ^ K._SIGN).contiguous()
    pkf = (pk ^ K._SIGN).contiguous()

    def library():
        a = torch.searchsorted(live_keys, pkf)
        b = torch.searchsorted(live_keys, pkf, right=True)
        return a, b

    return {
        "max_abs_err": 0,
        "ms": timed_ms(torch, lambda: K.join_probe(sorted_key, nbl, pk, pl)),
        "plain_ms": timed_ms(torch, lambda: K.join_probe_plain(sorted_key, nbl, pk, pl)),
        "library_ms": timed_ms(torch, library),
        # probe keys (8 B) + flags (1 B), the live build keys (8 B; the
        # dead tail is never read) and n_build_live in; lo, cnt out
        "bound_ms": bound_ms(n * 9 + n_live * 8 + 8 + n * 16),
        "build_rows": sorted_key.shape[0], "probe_rows": n,
        "build_live": n_live,
    }, (lo, cnt)


def k4_phase(torch, K, shapes, order, lo, cnt) -> dict:
    total = int(cnt.sum())
    out_cap = shapes.bucket(max(total, 1))
    got = K.expand_matches(order, lo, cnt, out_cap)
    want = K.expand_matches_plain(order, lo, cnt, out_cap)
    torch.cuda.synchronize()
    live = want[2]
    if not same(torch, got[2], live):
        fail("expand_matches: out_live differs from the plain version")
    for name, a, b in (("probe_idx", got[0], want[0]), ("build_idx", got[1], want[1])):
        if not same(torch, a[live], b[live]):
            fail(f"expand_matches: {name} differs from the plain version")
    n, m = cnt.shape[0], order.shape[0]
    rows = torch.arange(n, dtype=torch.int64, device=cnt.device)

    def library():
        excl = torch.cumsum(cnt, 0) - cnt
        p = torch.repeat_interleave(rows, cnt, output_size=total)
        j = torch.arange(total, dtype=torch.int64, device=cnt.device)
        return p, order[lo[p] + (j - excl[p])]

    # the random reads of `order` alone, one per matching row, as one torch
    # gather (its index read and its result written): part of K4's work
    hit = cnt > 0
    first = lo[hit]
    matching = first.shape[0]
    # the rows of `order` some matching range covers: a +1/-1 at each
    # range's ends, then a running sum
    edges = torch.zeros(m + 1, dtype=torch.int32, device=cnt.device)
    ones = torch.ones(matching, dtype=torch.int32, device=cnt.device)
    edges.index_add_(0, first, ones)
    edges.index_add_(0, first + cnt[hit], -ones)
    covered = int((torch.cumsum(edges[:m], 0) > 0).sum()) if m else 0
    del edges, ones
    return {
        "max_abs_err": 0,
        "ms": timed_ms(torch, lambda: K.expand_matches(order, lo, cnt, out_cap)),
        "plain_ms": timed_ms(torch, lambda: K.expand_matches_plain(order, lo, cnt, out_cap)),
        "library_ms": timed_ms(torch, library),
        "gather_ms": timed_ms(torch, lambda: order[first]),
        # cnt (8 B/probe row), lo of the matching rows and the rows of
        # order their ranges cover (8 B each) in; probe_idx, build_idx
        # (16 B) and out_live (1 B) per output slot out
        "bound_ms": bound_ms(n * 8 + matching * 8 + covered * 8 + out_cap * 17),
        "probe_rows": n, "matching_rows": matching, "order_rows_read": covered,
        "matches": total, "out_capacity": out_cap,
    }


#: K4's skew case: 16 evenly spaced probe rows of this many matches
K4_HOT_ROWS = 16
K4_HOT_MATCHES = 1_000_000


def k4_skew_case(torch, np, dev):
    """K4 inputs with hot rows: 60M probe rows of 0 or 1 match (about
    half 1) and ``K4_HOT_ROWS`` evenly spaced rows of ``K4_HOT_MATCHES``,
    each ``lo`` drawn so that its range lies inside a 15M-row ``order``
    (~46M outputs)."""
    rng = np.random.default_rng(SEED + 44)
    m, n = ORDERS_ROWS, LINEITEM_ROWS
    cnt = (rng.random(n) < 0.5).astype(np.int64)
    cnt[np.arange(K4_HOT_ROWS) * (n // K4_HOT_ROWS) + n // (2 * K4_HOT_ROWS)] = (
        K4_HOT_MATCHES)
    lo = (rng.random(n) * (m - cnt + 1)).astype(np.int64)
    order = torch.from_numpy(rng.permutation(m).astype(np.int64)).to(dev)
    return order, torch.from_numpy(lo).to(dev), torch.from_numpy(cnt).to(dev)


def range_any_case(torch, np, dev, hot: bool):
    """K5 inputs at SF10 shapes: 15M probe rows (orders) with 1-7 matches
    each (lines per order), ~60M expanded positions in a bucketed
    capacity, about half of them live. ``hot``: one probe row owns 10%
    of the positions, all dead but its last, so its whole range is read."""
    from trino_tpu_torch.exec import shapes

    rng = np.random.default_rng(SEED + 5 + hot)
    cnt = rng.integers(1, 8, size=ORDERS_ROWS).astype(np.int64)
    if hot:
        cnt[ORDERS_ROWS // 2] = int(cnt.sum()) // 9
    total = int(cnt.sum())
    live = np.zeros(shapes.bucket(total), dtype=np.bool_)
    live[:total] = rng.random(total) >= 0.5
    if hot:
        off = int(cnt[: ORDERS_ROWS // 2].sum())
        end = off + int(cnt[ORDERS_ROWS // 2])
        live[off:end] = False
        live[end - 1] = True
    return torch.from_numpy(cnt).to(dev), torch.from_numpy(live).to(dev)


def range_any_needed_bytes(torch, cnt, out_live) -> int:
    """out_live bytes an early-stopping scan must read: each range up to
    and including its first live position, all of it when none is."""
    total = int(cnt.sum())
    live = out_live[:total].to(torch.int64)
    before = torch.cumsum(live, 0) - live  # live positions before j
    rows = torch.arange(cnt.shape[0], dtype=torch.int64, device=cnt.device)
    owner = torch.repeat_interleave(rows, cnt, output_size=total)
    start = torch.cumsum(cnt, 0) - cnt
    first_or_earlier = before == before[start][owner]
    return int(first_or_earlier.sum())


def k5_phase(torch, K, cnt, out_live) -> dict:
    got = K.range_any(cnt, out_live)
    want = K.range_any_plain(cnt, out_live)
    torch.cuda.synchronize()
    if not same(torch, got, want):
        fail("range_any differs from the plain version")
    n, total = cnt.shape[0], int(cnt.sum())
    seg = out_live[:total]

    def library():
        return torch.segment_reduce(
            seg.float(), "max", lengths=cnt, unsafe=True, initial=0
        )

    lib = library()
    if not same(torch, lib > 0, want):
        fail("range_any: the segment_reduce yardstick disagrees")
    return {
        "max_abs_err": 0,
        "ms": timed_ms(torch, lambda: K.range_any(cnt, out_live)),
        "plain_ms": timed_ms(torch, lambda: K.range_any_plain(cnt, out_live)),
        "library_ms": timed_ms(torch, library),
        # cnt (8 B) in and matched (1 B) out per probe row; out_live up to
        # each range's first live position
        "bound_ms": bound_ms(n * 9 + range_any_needed_bytes(torch, cnt, out_live)),
        "probe_rows": n, "positions": total,
        "out_capacity": out_live.shape[0], "matched": int(want.sum()),
    }


def scatter_any_case(torch, np, dev):
    """K6 inputs at SF10 shapes: 60M indices (lineitem -> orders) into
    15M slots, about half flagged; unflagged positions carry 0, the
    expansion's placeholder for dead rows."""
    rng = np.random.default_rng(SEED + 6)
    idx = rng.integers(0, ORDERS_ROWS, size=LINEITEM_ROWS).astype(np.int64)
    flags = rng.random(LINEITEM_ROWS) >= 0.5
    idx[~flags] = 0
    return torch.from_numpy(idx).to(dev), torch.from_numpy(flags).to(dev)


def k6_phase(torch, K, idx, flags) -> dict:
    cap = ORDERS_ROWS
    got = K.scatter_any(idx, flags, cap)
    want = K.scatter_any_plain(idx, flags, cap)
    torch.cuda.synchronize()
    if not same(torch, got, want):
        fail("scatter_any differs from the plain version")
    m = idx.shape[0]
    flags8 = flags.to(torch.int8)

    def library():
        return torch.zeros(cap, dtype=torch.int8, device=idx.device).scatter_reduce_(
            0, idx, flags8, "amax"
        )

    if not same(torch, library() > 0, want):
        fail("scatter_any: the scatter_reduce yardstick disagrees")
    flagged = int(flags.sum())
    return {
        "max_abs_err": 0,
        "ms": timed_ms(torch, lambda: K.scatter_any(idx, flags, cap)),
        "plain_ms": timed_ms(torch, lambda: K.scatter_any_plain(idx, flags, cap)),
        "library_ms": timed_ms(torch, library),
        # flags (1 B/position), idx (8 B) where flagged, out (1 B/slot)
        "bound_ms": bound_ms(m + 8 * flagged + cap),
        "positions": m, "flagged": flagged, "capacity": cap,
        "marked": int(want.sum()),
    }


def hash_case(torch, np, dev, three: bool):
    """K7 inputs at SF10 shape: Q9's two-key lineitem-partsupp join keys
    (60M l_partkey, l_suppkey); with ``three``, a float64 part (with
    -0.0 and NaN) and a nullable int32 part beside them."""
    rng = np.random.default_rng(SEED + 70 + three)
    n = LINEITEM_ROWS
    cols = [
        (torch.from_numpy(rng.integers(1, 2_000_001, size=n)).to(dev), None),
        (torch.from_numpy(rng.integers(1, 100_001, size=n)).to(dev), None),
    ]
    if three:
        f = rng.integers(90_000, 10_495_000, size=n) / 100.0
        f[rng.random(n) < 0.01] = -0.0
        f[rng.random(n) < 0.01] = np.nan
        cols[1] = (torch.from_numpy(f).to(dev), None)
        cols.append((
            torch.from_numpy(rng.integers(8000, 11000, size=n).astype(np.int32)).to(dev),
            torch.from_numpy(rng.random(n) >= 0.1).to(dev),
        ))
    return cols


def col_bytes(cols) -> int:
    """Bytes of key columns read once: data and validity."""
    return sum(
        d.numel() * d.element_size() + (0 if v is None else v.numel())
        for d, v in cols
    )


def k7_phase(torch, K, cols) -> dict:
    got = K.hash_keys(cols)
    want = K.hash_keys_plain(cols)
    torch.cuda.synchronize()
    if not same(torch, got, want):
        fail("hash_keys differs from the plain version")
    n = cols[0][0].shape[0]
    return {
        "max_abs_err": 0,
        "ms": timed_ms(torch, lambda: K.hash_keys(cols)),
        "plain_ms": timed_ms(torch, lambda: K.hash_keys_plain(cols)),
        "library_ms": None,  # no single PyTorch call hashes key columns
        # key parts (and validity) in, one u64 hash per row out
        "bound_ms": bound_ms(col_bytes(cols) + n * 8),
        "rows": n, "parts": len(cols),
    }


def pack_case(torch, np, dev, three: bool):
    """K8 inputs at SF10 shape: Q18's l_orderkey (60M rows) narrowed to
    its value range, the live bit folded in; with ``three``, three
    nullable keys (int32, int64, int64) packed with their null flags
    into one word."""
    rng = np.random.default_rng(SEED + 80 + three)
    n = LINEITEM_ROWS
    live = torch.from_numpy(rng.random(n) >= 0.03).to(dev)
    if not three:
        keys = rng.integers(0, 60_000_000, size=n)
        return [(torch.from_numpy(keys).to(dev), None)], live, (26,)
    cols = [
        (torch.from_numpy(rng.integers(0, 4096, size=n).astype(np.int32)).to(dev),
         torch.from_numpy(rng.random(n) >= 0.05).to(dev)),
        (torch.from_numpy(rng.integers(0, 1 << 20, size=n)).to(dev),
         torch.from_numpy(rng.random(n) >= 0.05).to(dev)),
        (torch.from_numpy(rng.integers(0, 1 << 25, size=n)).to(dev),
         torch.from_numpy(rng.random(n) >= 0.05).to(dev)),
    ]
    return cols, live, (12, 20, 25)


def k8_phase(torch, K, cols, live, widths) -> dict:
    got = K.pack_keys(cols, live, widths)
    want = K.pack_keys_plain(cols, live, widths)
    torch.cuda.synchronize()
    if got[1:] != want[1:] or len(got[0]) != len(want[0]) or not all(
        same(torch, a, b) for a, b in zip(got[0], want[0])
    ):
        fail(f"pack_words {widths} differs from the plain version")
    n = live.shape[0]
    return {
        "max_abs_err": 0,
        "ms": timed_ms(torch, lambda: K.pack_keys(cols, live, widths)),
        "plain_ms": timed_ms(torch, lambda: K.pack_keys_plain(cols, live, widths)),
        "library_ms": None,  # no single PyTorch call packs keys
        # keys, validity and live in; the packed words out
        "bound_ms": bound_ms(col_bytes(cols) + n + n * 8 * len(got[0])),
        "rows": n, "keys": len(cols), "words": len(got[0]),
        "live_folded": got[1],
    }


def nan_equal(torch, a, b) -> bool:
    """Exact equality with NaN equal to NaN and the sign of zero kept."""
    if a.dtype.is_floating_point:
        if not same(torch, torch.isnan(a), torch.isnan(b)):
            return False
        num = ~torch.isnan(a)
        a, b = a[num], b[num]
        if not same(torch, torch.signbit(a), torch.signbit(b)):
            return False
    return same(torch, a, b)


def k9_phase(torch, np, K, info, dtype_name: str, tag: int) -> dict:
    """K9 over group-sorted values of ``info``'s groups: 30% of the rows
    do not contribute (they hold the fill); float64 values carry -0.0
    and, in a few groups, NaN."""
    rng = np.random.default_rng(SEED + 90 + tag)
    n = info.perm.shape[0]
    dev = info.perm.device
    if dtype_name == "int64":
        v = torch.from_numpy(rng.integers(0, 100_000_000, size=n)).to(dev)
        fill = (1 << 63) - 1
    else:
        x = rng.integers(100, 100_000, size=n) / 100.0
        x[rng.random(n) < 0.01] = -0.0
        x[rng.random(n) < 1e-6] = np.nan
        v = torch.from_numpy(x).to(dev)
        fill = float("inf")
    contrib = torch.from_numpy(rng.random(n) >= 0.3).to(dev)
    vals = torch.where(contrib, v, torch.tensor(fill, dtype=v.dtype, device=dev))
    starts, ends = info.starts, info.ends
    got = K.seg_minmax(vals, starts, ends, fill, True)
    want = K.seg_minmax_plain(vals, starts, ends, fill, True)
    torch.cuda.synchronize()
    if not nan_equal(torch, got, want):
        fail(f"seg_minmax {dtype_name} differs from the plain version")
    cap = starts.shape[0]
    gid = info.gid_sorted

    def library():  # what the port called before K9
        out = torch.full((cap + 1,), fill, dtype=vals.dtype, device=dev)
        return out.scatter_reduce_(0, gid, vals, reduce="amin", include_self=True)

    case = {
        "max_abs_err": 0,
        "ms": timed_ms(torch, lambda: K.seg_minmax(vals, starts, ends, fill, True)),
        "plain_ms": timed_ms(torch, lambda: K.seg_minmax_plain(vals, starts, ends, fill, True)),
        "library_ms": timed_ms(torch, library),
        # values (8 B/row) and ends (8 B/slot) in, one value per slot out
        "bound_ms": bound_ms(n * 8 + cap * 16),
        "rows": n, "capacity": cap, "groups": int(info.num_groups),
        "dtype": dtype_name, "nan_groups": int(torch.isnan(got).sum()),
    }
    if dtype_name == "float64":
        n_end = int(ends[-1])
        lengths = ends - starts
        seg_vals = vals[:n_end]
        case["segment_reduce_ms"] = timed_ms(torch, lambda: torch.segment_reduce(
            seg_vals, "min", lengths=lengths))
    return case


def order_case(torch, np, dev):
    """K10 inputs at SF10 shape: 15M orders rows ordered by o_totalprice
    DESC (float64, 5% NULL) then o_orderdate ASC (int32), ~10% dead."""
    rng = np.random.default_rng(SEED + 100)
    n = ORDERS_ROWS
    price = torch.from_numpy(rng.integers(85_000, 55_000_000, size=n) / 100.0).to(dev)
    valid = torch.from_numpy(rng.random(n) >= 0.05).to(dev)
    date = torch.from_numpy(rng.integers(8035, 10591, size=n).astype(np.int32)).to(dev)
    live = torch.from_numpy(rng.random(n) >= 0.1).to(dev)
    return [(price, valid, False, True), (date, None, True, False)], live


def perm_from_words(torch, words, flags, dead):
    """sort_perm's stable sort passes over order words, as the port runs
    them after K10."""
    n = dead.shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=dead.device)
    for kd, flag in reversed(list(zip(words, flags))):
        perm = perm[torch.sort(kd[perm], stable=True).indices]
        if flag is not None:
            perm = perm[torch.sort(flag[perm], stable=True).indices]
    return perm[torch.sort(dead[perm], stable=True).indices]


def k10_phase(torch, K, keys, live) -> dict:
    got = K.order_words(keys, live)
    want = K.order_words_plain(keys, live)
    torch.cuda.synchronize()
    ok = all(same(torch, a, b) for a, b in zip(got[0], want[0]))
    ok = ok and all(
        (a is None) == (b is None) and (a is None or same(torch, a, b))
        for a, b in zip(got[1], want[1])
    )
    if not (ok and same(torch, got[2], want[2])):
        fail("order_words differs from the plain version")
    perm = K.sort_perm(keys, live)
    if not same(torch, perm, perm_from_words(torch, *want)):
        fail("sort_perm over K10's words differs from the plain version's")
    n = live.shape[0]
    word_bytes = sum(w.numel() * w.element_size() for w in got[0])
    flag_bytes = sum(f.numel() for f in got[1] if f is not None)
    return {
        "max_abs_err": 0,
        "ms": timed_ms(torch, lambda: K.order_words(keys, live)),
        "plain_ms": timed_ms(torch, lambda: K.order_words_plain(keys, live)),
        "library_ms": None,  # no single PyTorch call builds sort words
        "sort_perm_ms": timed_ms(torch, lambda: K.sort_perm(keys, live)),
        # keys, validity and live in; words, flags and dead bytes out
        "bound_ms": bound_ms(
            sum(d.numel() * d.element_size() + (0 if v is None else v.numel())
                for d, v, _a, _f in keys) + n + word_bytes + flag_bytes + n
        ),
        "rows": n, "keys": len(keys),
    }


# ---- window kernel phases ----------------------------------------------------


def partition_bounds(torch, gid):
    """Each sorted row's partition start and end from non-decreasing ids."""
    n = gid.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=gid.device)
    first = torch.ones(n, dtype=torch.bool, device=gid.device)
    first[1:] = gid[1:] != gid[:-1]
    starts = pos[first]
    ends = torch.cat([starts[1:], torch.tensor([n], device=gid.device)])
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    return starts[seg].contiguous(), ends[seg].contiguous()


def range7_case(torch, np, dev):
    """ds_range7's window at SF10: 28.8M store_sales rows sorted by
    (store, sold date), 120 partitions, the date key in original row
    order behind a random permutation, and the RANGE frame of
    `6 preceding and current row` (found with the row-offset
    searchsorted yardstick)."""
    rng = np.random.default_rng(SEED + 200)
    n = DS_SALES_ROWS
    store = torch.from_numpy(np.sort(rng.integers(0, DS_STORES, size=n))).to(dev)
    day = torch.from_numpy(rng.integers(0, DS_DAYS, size=n) + 2450816).to(dev)
    order = torch.sort(store * 4096 + (day - 2450816)).indices
    gid, w = store.contiguous(), day[order].contiguous()
    perm = torch.from_numpy(rng.permutation(n)).to(dev)
    key = torch.empty_like(w)
    key[perm] = w  # the key column in original row order
    pstart, pend = partition_bounds(torch, gid)
    paid = torch.from_numpy(rng.integers(0, 2_000_000, size=n)).to(dev)
    return gid, key, perm, w, pstart, pend, paid


def window_float_values(torch, np, dev, n):
    """float64 window values in (1, 1000) with NaN and -0.0, and a
    validity with 5% NULLs (W1's nullable float64 key), on ``dev``."""
    rng = np.random.default_rng(SEED + 201)
    x = rng.uniform(1.0, 1000.0, size=n)
    x[rng.random(n) < 1e-6] = np.nan
    x[rng.random(n) < 0.01] = -0.0
    valid = rng.random(n) >= 0.05
    return torch.from_numpy(x).to(dev), torch.from_numpy(valid).to(dev)


def long_peers_case(torch, np, dev):
    """ds_range7's 28.8M rows in 120 partitions ordered by a key of 4
    values a partition (a rank over a quarter): peer groups of ~60K rows,
    ~30 tiles of 2048 each, the key in original row order behind a random
    permutation."""
    rng = np.random.default_rng(SEED + 202)
    n = DS_SALES_ROWS
    store = torch.from_numpy(rng.integers(0, DS_STORES, size=n)).to(dev)
    quarter = torch.from_numpy(rng.integers(0, 4, size=n)).to(dev)
    both = torch.sort(store * 4 + quarter).values
    gid, w = (both // 4).contiguous(), (both % 4).contiguous()
    perm = torch.from_numpy(rng.permutation(n)).to(dev)
    key = torch.empty_like(w)
    key[perm] = w
    _, pend = partition_bounds(torch, gid)
    return gid, key, perm, pend


def encoded_search(torch, gid, w, target, right: bool):
    """The row-offset searchsorted yardstick: partition id and key in
    one monotone int64, one torch.searchsorted over all rows."""
    off = 1 << 20
    enc = gid * (1 << 40) + (w - w.min() + off)
    tgt = gid * (1 << 40) + (target - w.min() + off)
    return torch.searchsorted(enc, tgt, right=right)


def w1_phase(torch, K, gid, keys, perm, pend, with_dense) -> dict:
    got = K.window_peers(gid, keys, perm, pend, with_dense)
    want = K.window_peers_plain(gid, keys, perm, pend, with_dense)
    torch.cuda.synchronize()
    for name, a, b in zip(("peer_start", "peer_end", "dense"), got, want):
        if (a is None) != (b is None) or (a is not None and not same(torch, a, b)):
            fail(f"window_peers: {name} differs from the plain version")
    n = gid.shape[0]
    key_bytes = sum(
        d.shape[0] * d.element_size() + (0 if v is None else v.shape[0])
        for d, v in keys
    )

    def gather():  # the random reads alone: each key part and validity
        return [t[perm] for col in keys for t in col if t is not None]

    return {
        "max_abs_err": 0,
        "ms": timed_ms(torch, lambda: K.window_peers(gid, keys, perm, pend, with_dense)),
        "plain_ms": timed_ms(torch, lambda: K.window_peers_plain(gid, keys, perm, pend, with_dense)),
        "library_ms": None,  # no PyTorch call finds peer groups
        "gather_ms": timed_ms(torch, gather),
        # gid, perm, pend (8 B each) and the keys in; peer_start and
        # peer_end (8 B each) and dense (8 B) out
        "bound_ms": bound_ms(n * 24 + key_bytes + n * (24 if with_dense else 16)),
        "rows": n, "key_parts": len(keys),
        "peer_groups": int(got[0].unique_consecutive().numel()),
    }


def w2_phase(torch, K, lanes, gid, lo, hi, library) -> dict:
    got = K.range_sum(lanes, gid, lo, hi)
    want = K.range_sum_plain(lanes, gid, lo, hi)
    torch.cuda.synchronize()
    err = 0.0
    for a, b in zip(got, want):
        if a.dtype.is_floating_point:
            num = ~torch.isnan(b)
            if not same(torch, torch.isnan(a), ~num):
                fail("range_sum: NaN positions differ from the plain version")
            # each frame to relative 1e-9 of its own sum: a small
            # partition beside a partition of 1e18s keeps its precision
            d = (a[num] - b[num]).abs()
            bad = d > 1e-9 * b[num].abs()
            if bool(bad.any()):
                fail(f"range_sum float64: {int(bad.sum())} frames beyond "
                     "relative 1e-9 of the plain version")
            err = max(err, float(d.max()) if d.numel() else 0.0)
        elif not same(torch, a, b):
            fail("range_sum: an integer lane differs from the plain version")
    n = gid.shape[0]
    # gid decides a frame sum only where a lane is float64 (int64 lanes
    # scan globally and take a plain difference)
    any_float = any(v.dtype.is_floating_point for v in lanes)
    return {
        "max_abs_err": err,
        "ms": timed_ms(torch, lambda: K.range_sum(lanes, gid, lo, hi)),
        "plain_ms": timed_ms(torch, lambda: K.range_sum_plain(lanes, gid, lo, hi)),
        "library_ms": None if library is None else timed_ms(torch, library),
        # per lane the values in and the sums out (8 B each); lo and hi,
        # and gid when a lane is float64
        "bound_ms": bound_ms(n * 16 * len(lanes) + n * 16 + (n * 8 if any_float else 0)),
        "rows": n, "lanes": len(lanes),
    }


def cumsum_frames(torch, lanes, lo, hi):
    """The int64 yardstick of W2: torch.cumsum and the frame gathers."""
    out = []
    for v in lanes:
        cs = torch.cumsum(v, 0)
        top = cs[(hi - 1).clamp(min=0)]
        bot = torch.where(lo > 0, cs[(lo - 1).clamp(min=0)], 0)
        out.append(torch.where(hi > lo, top - bot, 0))
    return out


def w3_phase(torch, K, vals, gid, lo, hi, fill, is_min, library) -> dict:
    got = K.range_minmax(vals, gid, lo, hi, fill, is_min)
    want = K.range_minmax_plain(vals, gid, lo, hi, fill, is_min)
    torch.cuda.synchronize()
    if not nan_equal(torch, got, want):
        fail(f"range_minmax {vals.dtype} {tuple(vals.shape)} differs from the plain version")
    n = gid.shape[0]
    width = vals.numel() // max(n, 1) * vals.element_size()
    return {
        "max_abs_err": 0,
        "ms": timed_ms(torch, lambda: K.range_minmax(vals, gid, lo, hi, fill, is_min)),
        "plain_ms": timed_ms(torch, lambda: K.range_minmax_plain(vals, gid, lo, hi, fill, is_min)),
        "library_ms": None if library is None else timed_ms(torch, library),
        # values in and results out; gid, lo and hi
        "bound_ms": bound_ms(n * 2 * width + n * 24),
        "rows": n,
    }


def w4_phase(torch, K, gid, w, target, pstart, pend, left) -> dict:
    got = K.seg_searchsorted(w, target, pstart, pend, left)
    want = K.seg_searchsorted_plain(w, target, pstart, pend, left)
    lib = encoded_search(torch, gid, w, target, right=not left)
    torch.cuda.synchronize()
    if not same(torch, got, want):
        fail("seg_searchsorted differs from the plain version")
    if not same(torch, lib, want):
        fail("seg_searchsorted: the searchsorted yardstick disagrees")
    n = w.shape[0]
    return {
        "max_abs_err": 0,
        "ms": timed_ms(torch, lambda: K.seg_searchsorted(w, target, pstart, pend, left)),
        "plain_ms": timed_ms(torch, lambda: K.seg_searchsorted_plain(w, target, pstart, pend, left)),
        "library_ms": timed_ms(torch, lambda: encoded_search(torch, gid, w, target, not left)),
        # w, target, lo0, hi0 in (8 B each), positions out
        "bound_ms": bound_ms(n * 40),
        "rows": n,
    }


def window_phases(torch, np, K, dev) -> dict:
    """W1-W4 at the TPC-DS SF10 shapes of the main path."""
    out = {}
    r7 = range7_case(torch, np, dev)
    gid, key, perm, w, pstart, pend, paid = r7
    n = gid.shape[0]
    out["w1"] = w1_case(torch, np, K, None, dev, case=r7)
    lo = encoded_search(torch, gid, w, w - 6, right=False)
    hi = encoded_search(torch, gid, w, w, right=True)
    out["w4_left"] = w4_phase(torch, K, gid, w, w - 6, pstart, pend, True)
    out["w4_right"] = w4_phase(torch, K, gid, w, w, pstart, pend, False)
    ones = torch.ones(n, dtype=torch.int64, device=dev)
    lanes = [ones, paid]
    out["w2"] = w2_phase(torch, K, lanes, gid, lo, hi,
                         lambda: cumsum_frames(torch, lanes, lo, hi))
    # float64 ROWS frames, NaN and -0.0, and a partition of 1e18s
    x, x_valid = window_float_values(torch, np, dev, n)
    fx = torch.where(gid == 0, torch.full_like(x, 1e18), x)
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    rlo = torch.maximum(pos - 2, pstart)
    rhi = torch.minimum(pos + 3, pend)
    counts = torch.bincount(gid)
    lengths = counts[counts > 0]
    out["w2_float"] = w2_phase(
        torch, K, [fx], gid, rlo, rhi,
        lambda: torch.segment_reduce(fx, "sum", lengths=lengths))
    # running max of int64 and float64 (NaN, -0.0) over prefix frames
    iv = paid - 1_000_000
    big = 1 << 40
    out["w3_int"] = w3_phase(
        torch, K, iv, gid, pstart, pos + 1, -(1 << 63), False,
        lambda: torch.cummax(gid * big + (iv + (1 << 39)), 0).values)
    out["w3_float"] = w3_phase(
        torch, K, x, gid, pstart, pos + 1, float("-inf"), False, None)
    out["w1_float"] = w1_float_case(torch, np, K, None, dev, case=r7,
                                    values=(x, x_valid))
    del r7, gid, key, perm, w, pstart, pend, paid, lo, hi, ones, lanes, fx, pos
    del rlo, rhi, iv, x, x_valid
    torch.cuda.empty_cache()
    out["w1_long"] = w1_long_case(torch, np, K, None, dev)
    torch.cuda.empty_cache()
    # q51's windowed relation: 5.5M rows over 180K items, decimal(38,2)
    # running sums and running maxima over two limbs
    rng = np.random.default_rng(SEED + 203)
    m = Q51_ROWS
    item = torch.from_numpy(np.sort(rng.integers(0, Q51_ITEMS, size=m))).to(dev)
    qs, qe = partition_bounds(torch, item)
    qpos = torch.arange(m, dtype=torch.int64, device=dev)
    wide = rng.integers(0, 1 << 44, size=m)
    limbs = torch.from_numpy(np.stack([wide >> 32, wide & 0xFFFFFFFF], axis=-1)).to(dev)
    hi_l, lo_l = limbs[:, 0].contiguous(), limbs[:, 1].contiguous()
    cnt = torch.ones(m, dtype=torch.int64, device=dev)
    q51_lanes = [cnt, hi_l, lo_l]
    out["w2_q51"] = w2_phase(torch, K, q51_lanes, item, qs, qpos + 1,
                             lambda: cumsum_frames(torch, q51_lanes, qs, qpos + 1))
    out["w3_q51"] = w3_phase(torch, K, limbs, item, qs, qpos + 1,
                             K._limb_fill(False), False, None)
    return out


def a1_phase(torch, K, lane, contrib, group, m, caps, hashed) -> dict:
    """A1 against its plain version (on the card: at 180K x 512 registers
    its sort and searches are too large for the host), timed beside
    ``scatter_reduce_`` amax over (group * m + bucket, rho) once the
    hashes and rho are built."""
    got = K.hll_registers(lane, contrib, group, m, caps, hashed)
    want = K.hll_registers_plain(lane, contrib, group, m, caps, hashed)
    torch.cuda.synchronize()
    if not same(torch, got, want):
        fail(f"hll_registers (m={m}, {caps} groups) differs from the plain version")
    h = lane if hashed else K.dev_hash64(lane)
    bucket, rho = K._hll_bucket_rho(h, m)
    key = bucket if group is None else group * m + bucket
    key = torch.where(contrib, key, torch.full_like(key, caps * m))
    rho8 = rho.to(torch.int8)

    def library():
        out = torch.zeros(caps * m + 1, dtype=torch.int8, device=lane.device)
        return out.scatter_reduce_(0, key, rho8, reduce="amax")

    if not same(torch, library()[:-1].reshape(caps, m), got):
        fail("hll_registers: the scatter_reduce_ yardstick computes another function")
    n = lane.shape[0]
    del h, bucket, rho
    return {
        "max_abs_err": 0,
        "ms": timed_ms(torch, lambda: K.hll_registers(lane, contrib, group, m, caps, hashed)),
        "plain_ms": timed_ms(torch, lambda: K.hll_registers_plain(
            lane, contrib, group, m, caps, hashed)),
        "library_ms": timed_ms(torch, library),
        # the lane (8 B), contrib (1 B) and group id (8 B) read once, the
        # int8 registers written once
        "bound_ms": bound_ms(n * (8 + 1 + (0 if group is None else 8)) + caps * m),
        "rows": n, "groups": caps, "m": m,
        "max_register": int(got.max()) if got.numel() else 0,
    }, got


def a2_phase(torch, K, reg) -> dict:
    got = K.hll_estimate(reg)
    want = K.hll_estimate_plain(reg)
    torch.cuda.synchronize()
    if not same(torch, got, want):
        fail("hll_estimate differs from the plain version")
    c, m = reg.shape
    return {
        "max_abs_err": 0,
        "ms": timed_ms(torch, lambda: K.hll_estimate(reg)),
        "plain_ms": timed_ms(torch, lambda: K.hll_estimate_plain(reg)),
        "library_ms": None,  # no PyTorch call estimates a cardinality
        # the registers read once, one int64 estimate written per row
        "bound_ms": bound_ms(c * m + c * 8),
        "rows": c, "m": m,
        "linear_counting_rows": int(((reg == 0).sum(1) > 0).sum()),
    }


def a3_phase(torch, np, K, info, dtype_name: str, tag: int) -> dict:
    """A3 over ``info``'s groups: int64 keys with ties and the would-be
    sentinels, or float64 keys holding NaN, -0.0 and ties; ~30% of the
    rows do not contribute and every seventh group has no contributing
    row. Held against the plain version for min and max."""
    rng = np.random.default_rng(SEED + 400 + tag)
    n = info.perm.shape[0]
    dev = info.perm.device
    if dtype_name == "int64":
        x = rng.integers(0, 100_000, size=n).astype(np.int64)
        x[rng.random(n) < 1e-4] = np.iinfo(np.int64).max
        x[rng.random(n) < 1e-4] = np.iinfo(np.int64).min
    else:
        x = rng.integers(-50_000, 50_000, size=n) / 100.0
        x[rng.random(n) < 0.01] = -0.0
        x[rng.random(n) < 1e-6] = np.nan
    keys = torch.from_numpy(x).to(dev)
    contrib = torch.from_numpy(rng.random(n) >= 0.3).to(dev)
    contrib &= info.group % 7 != 3
    for is_min in (True, False):
        got = K.seg_arg_extreme(keys, contrib, info, is_min)
        want = K.seg_arg_extreme_plain(keys, contrib, info.perm, info.starts,
                                       info.ends, is_min)
        torch.cuda.synchronize()
        if not same(torch, got, want):
            fail(f"seg_arg_extreme {dtype_name} is_min={is_min} differs from "
                 "the plain version")
    cap = info.starts.shape[0]
    perm, starts, ends = info.perm, info.starts, info.ends
    n_live = int(ends[-1])
    n_contrib = int(contrib[perm[:n_live]].sum())
    return {
        "max_abs_err": 0,
        "ms": timed_ms(torch, lambda: K.seg_arg_extreme(keys, contrib, info, False)),
        "plain_ms": timed_ms(torch, lambda: K.seg_arg_extreme_plain(
            keys, contrib, perm, starts, ends, False)),
        "library_ms": None,  # no PyTorch call takes a segmented argmax
        # the random reads alone: the key and contrib through perm
        "gather_ms": timed_ms(torch, lambda: (keys[perm], contrib[perm])),
        # perm (8 B) and contrib (1 B) of each live row and the key (8 B)
        # of each contributing live row read once; starts and ends read,
        # the rows written once (8 B a slot each)
        "bound_ms": bound_ms(n_live * 9 + n_contrib * 8 + cap * 24),
        "rows": n, "live_rows": n_live, "contributing_rows": n_contrib,
        "capacity": cap, "groups": int(info.num_groups),
        "dtype": dtype_name,
    }


def agg_phases(torch, np, K, shapes, dev) -> dict:
    """A1-A3 at the TPC-DS SF10 shapes of the new statements: 28.8M
    store_sales rows, globally (m = 4096, an int64 value lane that A1
    hashes, and a lane where every row holds one hot hash) and in 180K
    items (m = 512); A2 over the 180K x 512 registers; A3 over 28.8M rows
    in 180K and in 120 groups."""
    out = {}
    rng = np.random.default_rng(SEED + 500)
    n = DS_SALES_ROWS
    cust = torch.from_numpy(rng.integers(1, 1_000_001, size=n).astype(np.int64)).to(dev)
    info, live = a3_group_case(torch, np, K, shapes, dev, DS_ITEMS)
    out["a1_global"], _ = a1_phase(torch, K, cust, live, None, 4096, 1, False)
    hot = torch.full((n,), 0x1234_5678_9ABC_DEF0, dtype=torch.int64, device=dev)
    out["a1_hot"], _ = a1_phase(torch, K, hot, live, None, 4096, 1, True)
    del hot
    caps = info.starts.shape[0]
    out["a1_grouped"], reg = a1_phase(torch, K, cust, live, info.group, 512, caps,
                                      False)
    out["a2"] = a2_phase(torch, K, reg)
    del reg, cust
    torch.cuda.empty_cache()
    out["a3_items_int"] = a3_phase(torch, np, K, info, "int64", 1)
    out["a3_items_float"] = a3_phase(torch, np, K, info, "float64", 2)
    del info, live
    info, _ = a3_group_case(torch, np, K, shapes, dev, DS_STORES)
    out["a3_stores_int"] = a3_phase(torch, np, K, info, "int64", 3)
    out["a3_stores_float"] = a3_phase(torch, np, K, info, "float64", 4)
    del info
    torch.cuda.empty_cache()
    return out


def a4_phase(torch, K, states, contrib, group, caps) -> dict:
    """A4 against its plain version, timed beside ``scatter_reduce_``
    amax of the int8 registers over (group * m + register)."""
    got = K.hll_merge(states, contrib, group, caps)
    want = K.hll_merge_plain(states, contrib, group, caps)
    torch.cuda.synchronize()
    if not same(torch, got, want):
        fail(f"hll_merge ({states.shape[0]} rows into {caps} groups) differs "
             "from the plain version")
    n, m = states.shape
    gid = (torch.zeros(n, dtype=torch.int64, device=states.device)
           if group is None else group.clamp(0, caps - 1))
    idx = (gid[:, None] * m + torch.arange(m, device=states.device)).reshape(-1)
    live = torch.where(contrib[:, None], states, torch.zeros_like(states)).reshape(-1)

    def library():
        out = torch.zeros(caps * m, dtype=torch.int8, device=states.device)
        return out.scatter_reduce_(0, idx, live, reduce="amax")

    if not same(torch, library().reshape(caps, m), got):
        fail("hll_merge: the scatter_reduce_ yardstick computes another function")
    case = {
        "max_abs_err": 0,
        "ms": timed_ms(torch, lambda: K.hll_merge(states, contrib, group, caps)),
        "plain_ms": timed_ms(torch, lambda: K.hll_merge_plain(
            states, contrib, group, caps)),
        "library_ms": timed_ms(torch, library),
        # the states (m B), contrib (1 B) and group id (8 B) of each
        # partial row read once, the merged registers written once
        "bound_ms": bound_ms(n * (m + 1 + (0 if group is None else 8)) + caps * m),
        "rows": n, "groups": caps, "m": m,
    }
    del idx, live
    return case


def a5_phase(torch, np, K, A, shapes, dev, rows, n_groups, k) -> dict:
    """A5 over one chunk of ``rows`` store_sales-like rows (int64 net
    paid) in ``n_groups`` items (0: the global form), after the
    summary's three stable sorts, against its plain version."""
    rng = np.random.default_rng(SEED + 700 + k)
    vd = torch.from_numpy(rng.integers(0, 2_000_000, size=rows)).to(dev)
    eff = torch.from_numpy(rng.random(rows) >= 0.02).to(dev)
    if n_groups:
        item = torch.from_numpy(rng.integers(0, n_groups, size=rows)).to(dev)
        cap = shapes.table_bucket(n_groups, 0)
        info = K.group_by([(item, None)], torch.ones_like(eff), cap,
                          widths=(int(n_groups - 1).bit_length(),))
        starts = info.starts
    else:
        info, cap = None, 1
        starts = torch.zeros(1, dtype=torch.int64, device=dev)
    p = A._quant_sorted_perm(vd, eff, info)
    cnt = A._Reducer(info, cap, eff).count()[: starts.shape[0]].contiguous()
    got = K.quant_summary(vd, p, starts, cnt, k)
    want = K.quant_summary_plain(vd, p, starts, cnt, k)
    torch.cuda.synchronize()
    if not same(torch, got.view(torch.int64), want.view(torch.int64)):
        fail(f"quant_summary ({rows} rows, {n_groups} groups, k={k}) differs "
             "from the plain version")
    caps = starts.shape[0]
    return {
        "max_abs_err": 0,
        "ms": timed_ms(torch, lambda: K.quant_summary(vd, p, starts, cnt, k)),
        "plain_ms": timed_ms(torch, lambda: K.quant_summary_plain(vd, p, starts, cnt, k)),
        "library_ms": None,  # no PyTorch call builds the k-point summary
        # values and the sorted order (8 B each a row) read once, starts
        # and counts (16 B a group), the float64 summary written once
        "bound_ms": bound_ms(rows * 16 + caps * 16 + caps * (k + 1) * 8),
        "rows": rows, "groups": caps, "k": k,
    }


def a6_case(torch, np, dev, chunks, n_groups, k):
    """A6 inputs: the summaries of ``chunks`` chunks, one partial row per
    group and chunk (0 groups: the global form), each row's points
    sorted as ``quant_summary`` leaves them; counts 1-63."""
    rng = np.random.default_rng(SEED + 800 + k)
    rows = chunks * max(n_groups, 1)
    pts = torch.sort(torch.from_numpy(
        rng.integers(0, 2_000_000, size=(rows, k)).astype(np.float64)).to(dev), 1).values
    cnt = torch.from_numpy(rng.integers(1, 64, size=rows).astype(np.float64)).to(dev)
    states = torch.cat([pts, cnt[:, None]], 1).contiguous()
    del pts
    eff = torch.ones(rows, dtype=torch.bool, device=dev)
    group = None
    if n_groups:
        group = torch.arange(n_groups, dtype=torch.int64, device=dev).repeat(chunks)
    q = torch.tensor([0.5], dtype=torch.float64, device=dev)
    return states, eff, group, q


def a6_phase(torch, np, K, dev, chunks, n_groups, caps, k) -> dict:
    """A6 over ``a6_case``'s summaries against its plain version. The
    wrapper's time includes its stable sort of the partial rows by
    group."""
    states, eff, group, q = a6_case(torch, np, dev, chunks, n_groups, k)
    rows = states.shape[0]
    got, has = K.quant_merge(states, eff, group, caps, q)
    want, whas = K.quant_merge_plain(states, eff, group, caps, q)
    torch.cuda.synchronize()
    if not (same(torch, has, whas)
            and same(torch, got.view(torch.int64), want.view(torch.int64))):
        fail(f"quant_merge ({rows} partial rows x {k} points) differs from the "
             "plain version")
    case = {
        "max_abs_err": 0,
        "ms": timed_ms(torch, lambda: K.quant_merge(states, eff, group, caps, q), reps=3),
        "plain_ms": timed_ms(torch, lambda: K.quant_merge_plain(
            states, eff, group, caps, q), reps=3),
        "library_ms": None,  # no PyTorch call merges weighted summaries
        # the summaries, flags and group ids read once; a value and a flag
        # written per group
        "bound_ms": bound_ms(rows * ((k + 1) * 8 + 1 + (8 if group is not None else 0))
                             + caps * 9),
        "partial_rows": rows, "points": rows * k, "groups": caps,
    }
    del states, got, want
    torch.cuda.empty_cache()
    return case


def split_phases(torch, np, K, A, shapes, dev) -> dict:
    """A4-A6 at the SF10 shapes of the budgeted ds_sketch_item and
    ds_sketch_global: five chunks' partial registers of 180K items x 512
    (and globally 5 x 4096, and one group holding every partial row);
    one 5.8M-row chunk's summaries in 180K items (k = 256) and globally
    (k = 1024); the merge of 5 x 180K partial summaries of 256 points and
    of one group's 5 x 1024."""
    out = {}
    rng = np.random.default_rng(SEED + 900)
    chunks = 5
    cap = shapes.table_bucket(DS_ITEMS, 0)
    states = torch.from_numpy(
        rng.integers(0, 24, size=(chunks * DS_ITEMS, 512)).astype(np.int8)).to(dev)
    states[states < 12] = 0  # most registers of an item's chunk stay empty
    contrib = torch.ones(chunks * DS_ITEMS, dtype=torch.bool, device=dev)
    group = torch.arange(DS_ITEMS, dtype=torch.int64, device=dev).repeat(chunks)
    out["a4_grouped"] = a4_phase(torch, K, states, contrib, group, cap)
    out["a4_hot"] = a4_phase(torch, K, states, contrib, torch.zeros_like(group), 1024)
    del states, group, contrib
    glob = torch.from_numpy(
        rng.integers(0, 30, size=(chunks, 4096)).astype(np.int8)).to(dev)
    out["a4_global"] = a4_phase(
        torch, K, glob, torch.ones(chunks, dtype=torch.bool, device=dev), None, 1)
    torch.cuda.empty_cache()
    chunk_rows = DS_SALES_ROWS // chunks
    out["a5_grouped"] = a5_phase(torch, np, K, A, shapes, dev, chunk_rows, DS_ITEMS, 256)
    out["a5_global"] = a5_phase(torch, np, K, A, shapes, dev, chunk_rows, 0, 1024)
    torch.cuda.empty_cache()
    out["a6_grouped"] = a6_grouped_case(torch, np, K, shapes, dev, chunks)
    out["a6_global"] = a6_global_case(torch, np, K, shapes, dev, chunks)
    return out


def count_true_phase(torch, np, K, dev) -> dict:
    """``kernels.count_true`` (a torch sum; the JAX package's blocked
    reduce only worked around an XLA bug) over a 60M-row bool mask."""
    rng = np.random.default_rng(SEED + 600)
    mask = torch.from_numpy(rng.random(LINEITEM_ROWS) >= 0.4).to(dev)
    if int(K.count_true(mask)) != int(mask.sum()):
        fail("count_true miscounts")
    return {
        "rows": LINEITEM_ROWS,
        "ms": timed_ms(torch, lambda: K.count_true(mask)),
        "blocked_sum_ms": timed_ms(torch, lambda: K.blocked_sum(mask)),
        # the mask read once (1 B a row), one int64 written
        "bound_ms": bound_ms(LINEITEM_ROWS + 8),
    }


# ---- main path ---------------------------------------------------------------


#: Q11's FRACTION per scale (TPC-H 2.4.11.3: 0.0001 / SF), so that SF10's
#: answer has rows to compare
Q11_FRACTION = {"sf1": "0.0001000000", "sf10": "0.0000100000"}
#: the TPC-H queries that also run at SF10: BASELINE.json's main path
#: (Q1, Q3) and Q18, whose c_name is hash-coded there. The other SF10
#: runs were cut to keep the script inside its time limit once the
#: aggregate functions' statements joined the TPC-DS path (most of their
#: time was cold planner statistics).
SF10_QUERIES = ("q01", "q03", "q18")


# ---- the mesh's kernels: M1 partition_pack and M2 segment_reduce -----------

#: shards of the mesh path: 8 on one card, as the JAX package's mesh tests
#: run 8 shards on one CPU (the skew split needs n > 4 to trip)
MESH_SHARDS = 8


def m1_case(torch, np, K, shapes, dev, hot: bool):
    """One shard of lineitem's Q3 exchange at SF10 on 8 shards: 7.5M rows
    padded to the shard capacity, l_orderkey, l_extendedprice and
    l_discount as int64, ~54% live (l_shipdate > 1995-03-15), the
    destination the unsigned hash of the key modulo 8; ``hot``: one
    destination owns 60% of the rows, so the default bucket overflows."""
    from trino_tpu_torch.page import pad_capacity

    rows = LINEITEM_ROWS // MESH_SHARDS
    cap = pad_capacity(rows)
    rng = np.random.default_rng(SEED + 700 + int(hot))
    live = np.zeros(cap, dtype=bool)
    live[:rows] = rng.random(rows) < 0.54
    key = torch.from_numpy(rng.integers(1, 60_000_000, cap, dtype=np.int64)).to(dev)
    payload = [
        key,
        torch.from_numpy(rng.integers(90_000, 10_500_000, cap, dtype=np.int64)).to(dev),
        torch.from_numpy(rng.integers(0, 11, cap, dtype=np.int64)).to(dev),
    ]
    dest = K.umod(K.hash_keys([(key, None)]), MESH_SHARDS)
    if hot:
        dest = torch.where(torch.from_numpy(rng.random(cap) < 0.6).to(dev),
                           torch.full_like(dest, 5), dest)
    bucket = shapes.exchange_bucket(cap, MESH_SHARDS)
    return dest, torch.from_numpy(live).to(dev), payload, bucket


def m1_phase(torch, K, dest, live, payload, bucket, hot: bool) -> dict:
    n = dest.shape[0]
    got = K.partition_pack(dest, live, payload, MESH_SHARDS, bucket)
    want = K.partition_pack_plain(dest, live, payload, MESH_SHARDS, bucket)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got[0], want[0])):
        if not same(torch, a, b):
            fail(f"partition_pack: bucket column {i} differs from the plain version")
    if not same(torch, got[1], want[1]) or not same(torch, got[2], want[2]):
        fail("partition_pack: sent-live flags or counts differ from the plain version")
    overflowed = bool((got[2] > bucket).any())
    if overflowed != hot:
        fail(f"partition_pack: overflow {overflowed}, expected {hot}")
    width = sum(p.element_size() for p in payload)
    slots = MESH_SHARDS * bucket
    # dest is read only for live rows, and the payload only for live rows
    # that fit their bucket
    n_live = int(live.sum())
    n_fit = int(want[2].clamp(max=bucket).sum())
    return {
        "max_abs_err": 0,
        "ms": timed_ms(torch, lambda: K.partition_pack(
            dest, live, payload, MESH_SHARDS, bucket)),
        "plain_ms": timed_ms(torch, lambda: K.partition_pack_plain(
            dest, live, payload, MESH_SHARDS, bucket)),
        "library_ms": None,  # no one PyTorch call packs rows stably
        # live (1 B) for every row, dest for live rows and the payload
        # for the rows that fit in; the zero-filled buckets, the
        # sent-live flags and the counts out
        "bound_ms": bound_ms(n + n_live * dest.element_size() + n_fit * width
                             + slots * (width + 1) + MESH_SHARDS * 8),
        "rows": n, "bucket": bucket, "live": n_live, "fit": n_fit,
        "overflowed": overflowed,
    }


def m2_case(torch, np, dev, n_seg: int, dtype_name: str, special: bool = False):
    """60M values (lineitem at SF10) with int64 group ids in [0, n_seg):
    int64 32-bit decimal limbs, or float64 (``special``: NaN, -0.0 and
    +0.0 among them)."""
    rng = np.random.default_rng(SEED + 800 + n_seg + int(special))
    ids = torch.from_numpy(rng.integers(0, n_seg, LINEITEM_ROWS, dtype=np.int64)).to(dev)
    if dtype_name == "int64":
        vals = rng.integers(0, 1 << 32, LINEITEM_ROWS, dtype=np.int64)
    else:
        vals = rng.normal(size=LINEITEM_ROWS) * 1e6
        if special:
            vals[rng.random(LINEITEM_ROWS) < 1e-6] = np.nan
            vals[rng.random(LINEITEM_ROWS) < 0.05] = -0.0
            vals[rng.random(LINEITEM_ROWS) < 0.05] = 0.0
    return torch.from_numpy(vals).to(dev), ids


def m2_phase(torch, K, vals, ids, n_seg: int, op: str) -> dict:
    got = K.segment_reduce(vals, ids, n_seg, op)
    want = K.segment_reduce_plain(vals, ids, n_seg, op)
    torch.cuda.synchronize()
    tag = f"segment_reduce {op} {vals.dtype} into {n_seg}"
    err = 0
    if vals.dtype == torch.float64 and op == "sum":
        err = float((got - want).abs().max())
        tol = 1e-12 * float(want.abs().max()) + 1e-9
        if err > tol:
            fail(f"{tag}: max error {err} > {tol}")
    elif vals.dtype == torch.float64:
        if not same(torch, torch.isnan(got), torch.isnan(want)):
            fail(f"{tag}: NaN slots differ from the plain version")
        ok = ~torch.isnan(want)
        if not same(torch, got[ok], want[ok]) or not same(
                torch, torch.signbit(got[ok]), torch.signbit(want[ok])):
            fail(f"{tag}: differs from the plain version")
    elif not same(torch, got, want):
        fail(f"{tag}: differs from the plain version")
    if op == "sum":
        def library():
            return torch.zeros(n_seg, dtype=vals.dtype, device=vals.device
                               ).index_add_(0, ids, vals)
    else:
        def library():
            return torch.empty(n_seg, dtype=vals.dtype, device=vals.device
                               ).scatter_reduce_(0, ids, vals, "amin" if op == "min"
                                                 else "amax", include_self=False)
    n = vals.shape[0]
    return {
        "max_abs_err": err,
        "ms": timed_ms(torch, lambda: K.segment_reduce(vals, ids, n_seg, op)),
        "plain_ms": timed_ms(torch, lambda: K.segment_reduce_plain(vals, ids, n_seg, op)),
        "library_ms": timed_ms(torch, library),
        # values and ids (8 B each) in, the slots (8 B) out
        "bound_ms": bound_ms(n * 16 + n_seg * 8),
        "rows": n, "segments": n_seg, "op": op, "dtype": str(vals.dtype),
    }


def mesh_kernel_phases(torch, np, K, shapes, dev) -> dict:
    out = {}
    out["m1"] = m1_phase(torch, K, *m1_case(torch, np, K, shapes, dev, False), False)
    out["m1_hot"] = m1_phase(torch, K, *m1_case(torch, np, K, shapes, dev, True), True)
    torch.cuda.empty_cache()
    for n_seg in (16, 1_500_000):
        for dt in ("int64", "float64"):
            vals, ids = m2_case(torch, np, dev, n_seg, dt)
            out[f"m2_{dt}_{n_seg}"] = m2_phase(torch, K, vals, ids, n_seg, "sum")
            del vals, ids
    vals, ids = m2_case(torch, np, dev, 16, "float64", special=True)
    out["m2_min"] = m2_phase(torch, K, vals, ids, 16, "min")
    out["m2_max"] = m2_phase(torch, K, vals, ids, 16, "max")
    del vals, ids
    # _dest_counts' histogram: live flags of 60M rows by destination
    rng = np.random.default_rng(SEED + 900)
    dest = torch.from_numpy(rng.integers(0, MESH_SHARDS, LINEITEM_ROWS,
                                         dtype=np.int64)).to(dev)
    live = torch.from_numpy((rng.random(LINEITEM_ROWS) < 0.9).astype(np.int64)).to(dev)
    out["m2_hist"] = m2_phase(torch, K, live, dest, MESH_SHARDS, "sum")
    del dest, live
    torch.cuda.empty_cache()
    return out


#: host threads for a scale's set-up
def k4_q3_case(torch, np, K, shapes, dev) -> dict:
    """K4 on the matches of ``join_case``'s Q3 probe."""
    order, sorted_key, nbl, pk, pl = join_case(torch, np, K, dev)
    lo, cnt = K.join_probe(sorted_key, nbl, pk, pl)
    del sorted_key, nbl, pk, pl
    return k4_phase(torch, K, shapes, order, lo, cnt)


def k4_skew_phase(torch, np, K, shapes, dev) -> dict:
    """K4 on ``k4_skew_case``'s hot rows."""
    return k4_phase(torch, K, shapes, *k4_skew_case(torch, np, dev))


def a6_grouped_case(torch, np, K, shapes, dev, chunks=5, items=DS_ITEMS) -> dict:
    """A6 over ``chunks`` partial rows of 256 points for each of
    ``items`` groups (ds_sketch_item's FINAL)."""
    return a6_phase(torch, np, K, dev, chunks, items,
                    shapes.table_bucket(items, 0), 256)


def a6_global_case(torch, np, K, shapes, dev, chunks=5) -> dict:
    """A6 over one group of ``chunks`` rows of 1024 points."""
    return a6_phase(torch, np, K, dev, chunks, 0, 1, 1024)


def a3_group_case(torch, np, K, shapes, dev, n_groups: int):
    """The groupings of ``agg_phases`` (A1's and A3's): 28.8M store_sales
    rows, 3% dead, by item (180K groups) or by store (120). Returns the
    GroupInfo and the live rows."""
    rng = np.random.default_rng(SEED + 510 + n_groups)
    n = DS_SALES_ROWS
    live = torch.from_numpy(rng.random(n) >= 0.03).to(dev)
    key = torch.from_numpy(rng.integers(0, n_groups, size=n).astype(np.int64)).to(dev)
    cap = shapes.table_bucket(n_groups, 0) if n_groups == DS_ITEMS else 128
    info = K.group_by([(key, None)], live, cap,
                      widths=(int(n_groups - 1).bit_length(),))
    return info, live


def a3_items_int_case(torch, np, K, shapes, dev) -> dict:
    info, _ = a3_group_case(torch, np, K, shapes, dev, DS_ITEMS)
    return a3_phase(torch, np, K, info, "int64", 1)


def a3_items_float_case(torch, np, K, shapes, dev) -> dict:
    info, _ = a3_group_case(torch, np, K, shapes, dev, DS_ITEMS)
    return a3_phase(torch, np, K, info, "float64", 2)


def a3_stores_int_case(torch, np, K, shapes, dev) -> dict:
    info, _ = a3_group_case(torch, np, K, shapes, dev, DS_STORES)
    return a3_phase(torch, np, K, info, "int64", 3)


def a3_stores_float_case(torch, np, K, shapes, dev) -> dict:
    info, _ = a3_group_case(torch, np, K, shapes, dev, DS_STORES)
    return a3_phase(torch, np, K, info, "float64", 4)


def w1_case(torch, np, K, shapes, dev, case=None) -> dict:
    """W1 on ds_range7's one int64 key (``case``: ``range7_case``'s
    inputs, built here when not given)."""
    gid, key, perm, _w, _pstart, pend, _paid = case or range7_case(torch, np, dev)
    return w1_phase(torch, K, gid, [(key, None)], perm, pend, False)


def w1_float_case(torch, np, K, shapes, dev, case=None, values=None) -> dict:
    """W1 on ds_range7's rows with a nullable float64 key, with dense
    (``values``: ``window_float_values``' data and validity)."""
    gid, _key, perm, _w, _pstart, pend, _paid = case or range7_case(torch, np, dev)
    x, valid = values or window_float_values(torch, np, dev, gid.shape[0])
    return w1_phase(torch, K, gid, [(x, valid)], perm, pend, True)


def w1_long_case(torch, np, K, shapes, dev) -> dict:
    """W1 on ``long_peers_case``'s peer groups of ~60K rows."""
    gid, key, perm, pend = long_peers_case(torch, np, dev)
    return w1_phase(torch, K, gid, [(key, None)], perm, pend, False)


#: kernel cases by name, each ``fn(torch, np, K, shapes, dev, **options)``
#: returning its phase's dict (the kernel held against its plain version,
#: then timed). ``kernel_ab.py`` times them on two trees; a redesign adds
#: its kernel's cases here.
KERNEL_CASES = {
    "k4_q3": k4_q3_case,
    "k4_skew": k4_skew_phase,
    "a6_grouped": a6_grouped_case,
    "a6_global": a6_global_case,
    "a3_items_int": a3_items_int_case,
    "a3_items_float": a3_items_float_case,
    "a3_stores_int": a3_stores_int_case,
    "a3_stores_float": a3_stores_float_case,
    "w1": w1_case,
    "w1_float": w1_float_case,
    "w1_long": w1_long_case,
}


SETUP_WORKERS = 4


def set_up(connector, scale, data, statements) -> dict:
    """A scale's set-up, before its first run, on SETUP_WORKERS host
    threads (numpy's generators, sorts, gathers and ufuncs release the
    GIL): every column of each table that a statement names, each
    generated from its own seed, so the order does not change the data
    (a cold run's column statistics read all columns of a scanned table);
    then each ``(name, sql, ref)``'s numpy reference ``ref(data)``, which
    it returns by name."""
    sqls = [sql for _, sql, _ in statements]
    tables = [t for t in connector.list_tables(scale)
              if any(re.search(rf"\b{t}\b", sql) for sql in sqls)]
    columns = [(t, c) for t in tables
               for c in connector.table_schema(scale, t).column_names]
    with ThreadPoolExecutor(SETUP_WORKERS) as pool:
        list(pool.map(lambda tc: data.column(*tc), columns))
        futures = {name: pool.submit(ref, data) for name, _, ref in statements}
        return {name: f.result() for name, f in futures.items()}


def run_query(torch, K, runner, name, sql, scale, R, want, warm_runs=3,
              label="") -> dict:
    """One statement: a cold run checked against its numpy reference
    ``want``, then ``warm_runs`` warm runs that must
    give the same rows, then one to the result page. The entries into
    each spill path in these runs are printed and returned."""
    from trino_tpu_torch.exec import spill

    before = {k: fn.launches for k, fn in K.KERNELS.items()}
    spill.reset_entries()
    tc = time.perf_counter()
    rows = runner.execute(sql).rows
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - tc) * 1e3
    if not R.rows_match(name, rows, want):
        fail(f"{name} at {scale}{label}: rows differ from the numpy reference"
             f"\n got  {rows[:3]}\n want {want[:3]}")
    warm = []
    for _ in range(warm_runs):
        tw = time.perf_counter()
        again = runner.execute(sql).rows
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - tw) * 1e3)
        if again != rows:
            fail(f"{name} at {scale}: a warm run's rows differ")
    per_query = {k: fn.launches - before[k] for k, fn in K.KERNELS.items()}
    # one more warm run that stops at the result page: what the host's
    # conversion of the page into Python rows adds to a warm run
    tp = time.perf_counter()
    runner.execute_page(sql)
    torch.cuda.synchronize()
    page_ms = (time.perf_counter() - tp) * 1e3
    entries = dict(spill.ENTRIES)
    runs = warm_runs + 2
    print(f"main path {name} {scale}{label}: {len(rows)} rows equal the numpy "
          f"reference; cold {cold_ms:.1f} ms, warm median "
          f"{statistics.median(warm):.2f} ms (range {min(warm):.2f}-"
          f"{max(warm):.2f}), to the result page {page_ms:.2f} ms; "
          f"launches in {runs} runs {per_query}; spill entries {entries}",
          flush=True)
    return {
        "rows": len(rows), "cold_ms": cold_ms, "warm_ms": warm,
        "warm_median_ms": statistics.median(warm), "page_ms": page_ms,
        f"launches_{runs}_runs": per_query, "spill_entries": entries,
    }


def spill_paths_taken(entries) -> list[str]:
    from trino_tpu_torch.exec import spill

    return [k for k in spill.PATHS if entries.get(k)]


def main_path(torch, K, QueryRunner, QUERIES, R, keep) -> dict:
    """The TPC-H path: every statement at SF1, SF10_QUERIES at SF10. Each
    scale's metadata (its connector's generated data and the planner's
    column statistics), session, statements and references go into
    ``keep`` for the mesh path; the runners and their device tables are
    released."""
    results = {}
    for scale in ("sf1", "sf10"):
        fraction = Q11_FRACTION[scale]
        queries = [
            ("q01", QUERIES["q01"], R.q01),
            ("q03", QUERIES["q03"], R.q03),
            ("q18", QUERIES["q18"], R.q18),
            ("q04", QUERIES["q04"], R.q04),
            ("q17", QUERIES["q17"], R.q17),
            ("q21", QUERIES["q21"], R.q21),
            ("fj", R.FJ_SQL, R.fj),
        ] + [
            ("q11", R.q11_sql(fraction), lambda d, f=fraction: R.q11(d, f))
            if q == "q11" else (q, QUERIES[q], getattr(R, q))
            for q in NEW_QUERIES
        ]
        if scale == "sf10":
            queries = [q for q in queries if q[0] in SF10_QUERIES]
        t0 = time.perf_counter()
        runner = QueryRunner.tpch(scale)
        if runner.device.type != "cuda":
            fail(f"runner for {scale} is on {runner.device}")
        connector = runner.metadata.connector("tpch")
        data = connector.data(scale)
        torch.cuda.reset_peak_memory_stats()
        wants = set_up(connector, scale, data, queries)
        for name, sql, _ in queries:
            results[f"{name}_{scale}"] = run_query(
                torch, K, runner, name, sql, scale, R, wants[name])
        if scale == "sf10":
            results.update(budgeted_tpch(torch, K, runner, queries, wants, R))
        results[f"{scale}_peak_bytes"] = torch.cuda.max_memory_allocated()
        results[f"{scale}_seconds"] = time.perf_counter() - t0
        print(f"TPC-H {scale}: peak device memory "
              f"{results[f'{scale}_peak_bytes'] / 1e9:.2f} GB, "
              f"{results[f'{scale}_seconds']:.1f} s", flush=True)
        keep[scale] = (runner.metadata, runner.session, data, queries, wants)
        del runner, connector, data
        torch.cuda.empty_cache()
    return results


#: the TPC-H budget at SF10: lineitem streams in about ten chunks
TPCH_BUDGET = 1 << 30
#: the spill paths each budgeted TPC-H statement must enter: all of one
#: of the alternatives
BUDGETED_PATHS = {
    "q01": [{"run_chain_streamed"}],
    "q03": [{"streamed_probe_join"}, {"grace_join"}],
    "q18": [{"run_chain_streamed", "streamed_semi_join"}],
}


def budgeted_tpch(torch, K, runner, queries, wants, R) -> dict:
    """Q1, Q3 and Q18 again on the SF10 runner under hbm_budget_bytes =
    1 GiB (its planner statistics are warm): cold plus two warm runs, rows
    equal to the resident runs' numpy references, the tracked working
    set within the budget, and each statement through its spill path."""
    out = {}
    ex = runner.executor
    runner.session.properties["hbm_budget_bytes"] = TPCH_BUDGET
    try:
        for name, sql, _ in queries:
            ex.memory_pool.reset_peak()
            res = run_query(torch, K, runner, name, sql, "sf10", R,
                            wants[name], warm_runs=2,
                            label=f" under hbm_budget_bytes={TPCH_BUDGET}")
            hwm = ex.tracked_bytes_hwm
            res["tracked_bytes_hwm"] = hwm
            taken = spill_paths_taken(res["spill_entries"])
            if not any(alt <= set(taken) for alt in BUDGETED_PATHS[name]):
                fail(f"budgeted {name} took none of {BUDGETED_PATHS[name]}: "
                     f"{res['spill_entries']}")
            if hwm > TPCH_BUDGET:
                fail(f"budgeted {name}: tracked working set {hwm} B exceeds "
                     f"the budget {TPCH_BUDGET} B")
            print(f"budgeted {name} sf10: tracked working set "
                  f"{hwm / 2**20:.1f} MiB of {TPCH_BUDGET / 2**20:.0f} MiB; "
                  f"paths {taken}", flush=True)
            out[f"{name}_sf10_budget"] = res
    finally:
        runner.session.properties.pop("hbm_budget_bytes")
    return out


#: q51 runs over 1999 (d_month_seq 108-119): its text's 1200-1211 counts
#: months from 1900, this generator from 1990, so as written it selects
#: no rows at any scale
Q51_MONTH = 108


#: the statements whose join exceeds query_max_memory_per_node's 2GB
#: default at SF10 (PERF.md 4): revoked into the spill tier, they must
#: take at least one spill path there
REVOKED_AT = {
    (name, "sf10") for name in (
        "ds_q98", "ds_q51", "ds_q51_totals", "ds_q86", "ds_sketch_global",
    )
}
#: statements expected to raise ExceededMemoryLimitError under the default
#: cap: an over-cap join of a kind the spill tier does not revoke (only
#: inner and left equi-joins are revocable); any other raise fails the run
OVER_CAP_RAISES: set = set()
#: ds_sketch_item's budget per scale: store_sales streams in four or five
#: chunks through the PARTIAL/FINAL split
SKETCH_BUDGET = {"sf1": 128 << 20, "sf10": 1 << 30}


#: inventory has 2.349B rows at SF10 (four int64 columns: ~75 GB, more
#: than the card holds), so q39's relation runs at SF1 only
SKIPPED_AT = {("ds_q39_inv", "sf10")}


def budgeted_sketch_item(torch, K, runner, data, sql, scale, R, np) -> dict:
    """ds_sketch_item under SKETCH_BUDGET: store_sales streams in as many
    chunks as ``chunk_rows_for`` and the pruned scan's ``row_bytes`` give;
    the rows equal the chunked numpy twin (the percentile merged from the
    chunks' summaries over the same chunk bounds, every other column the
    resident answer), and each percentile lies within the summaries' rank
    bound of the exact one."""
    from trino_tpu_torch.exec import spill
    from trino_tpu_torch.plan import nodes as P

    budget = SKETCH_BUDGET[scale]
    stack, scans = [runner.plan_sql(sql)], []
    while stack:
        nd = stack.pop()
        if isinstance(nd, P.TableScan):
            scans.append(nd)
        stack.extend(nd.sources)
    (scan,) = scans
    per_row = spill.row_bytes(scan.outputs)
    chunk_rows = spill.chunk_rows_for(budget, per_row)
    n = runner.metadata.connector("tpcds").row_count(scan.schema, scan.table)
    chunks = -(-n // chunk_rows)
    want = R.ds_sketch_item(data, chunk_rows)
    runner.session.properties["hbm_budget_bytes"] = budget
    try:
        res = run_query(torch, K, runner, "ds_sketch_item", sql, scale, R,
                        want, warm_runs=2,
                        label=f" under hbm_budget_bytes={budget}")
    finally:
        runner.session.properties.pop("hbm_budget_bytes")
    runs = 4  # cold, two warm and one to the result page
    if res["spill_entries"]["scan_chunks"] != chunks * runs:
        fail(f"ds_sketch_item {scale}: {res['spill_entries']['scan_chunks']} "
             f"chunks streamed in {runs} runs, not {runs} x {chunks} "
             f"({n} rows of {per_row} B in chunks of {chunk_rows})")
    item = np.asarray(data.column("store_sales", "ss_item_sk")).astype(np.int64)
    paid = np.asarray(data.column("store_sales", "ss_net_paid")).astype(np.int64)
    picks = np.asarray([int(row[3].scaleb(2)) for row in want])
    errors = R.percentile_rank_errors(item, paid, picks, 0.5, chunks)
    if errors:
        fail(f"ds_sketch_item {scale}: {errors} percentiles outside the rank bound")
    print(f"budgeted ds_sketch_item {scale}: {chunks} chunks of {chunk_rows} "
          f"rows ({per_row} B a row) per run; every percentile within the "
          "rank bound of the exact one", flush=True)
    return dict(res, chunks=chunks, chunk_rows=chunk_rows, row_bytes=per_row)


#: warm runs of each TPC-DS statement per scale. One at SF10: with three
#: the script took 1214.2 s and 1233.6 s on two hosts, past its 1200 s
#: limit (PERF.md §5); the warm runs of q86, q51, its totals and
#: ds_sketch_global take 3-11 s each there
DS_WARM_RUNS = {"sf1": 3, "sf10": 1}


def tpcds_path(torch, K, QueryRunner, DS_QUERIES, SKETCH_CARD, R,
               ExceededMemoryLimitError, np) -> dict:
    """The TPC-DS path at SF1 and SF10: a star join (q3), a window sum
    over aggregates (q98), a FULL join under running sums and running
    maxima over decimal(38,2) (q51 and the totals of its windowed
    relation), ROLLUP with grouping() and rank() (q86), a RANGE offset
    window over all of store_sales (RANGE7_SQL) and the aggregate
    functions' statements, all under query_max_memory_per_node's 2GB
    default: a join over it is revoked into the spill tier (REVOKED_AT
    must take a spill path), and only OVER_CAP_RAISES may raise. Then
    ds_sketch_item under SKETCH_BUDGET."""
    statements = [
        ("ds_q03", DS_QUERIES["q3"], R.ds_q03),
        ("ds_q98", DS_QUERIES["q98"], R.ds_q98),
        ("ds_q51", R.q51_sql(Q51_MONTH), lambda d: R.ds_q51(d, Q51_MONTH)),
        ("ds_q51_totals", R.q51_totals_sql(Q51_MONTH),
         lambda d: R.ds_q51_totals(d, Q51_MONTH)),
        ("ds_q86", DS_QUERIES["q86"], R.ds_q86),
        ("ds_range7", R.RANGE7_SQL, R.ds_range7),
    ] + [(name, SKETCH_CARD[name], getattr(R, name)) for name in SKETCH_CARD]
    results = {}
    for scale in ("sf1", "sf10"):
        t0 = time.perf_counter()
        runner = QueryRunner.tpcds(scale)
        if runner.device.type != "cuda":
            fail(f"TPC-DS runner for {scale} is on {runner.device}")
        connector = runner.metadata.connector("tpcds")
        data = connector.data(scale)
        torch.cuda.reset_peak_memory_stats()
        wants = set_up(connector, scale, data,
                       [s for s in statements if (s[0], scale) not in SKIPPED_AT])
        for name, sql, _ in statements:
            if (name, scale) in SKIPPED_AT:
                continue
            try:
                res = run_query(torch, K, runner, name, sql, scale, R,
                                wants[name], warm_runs=DS_WARM_RUNS[scale])
            except ExceededMemoryLimitError as e:
                if (name, scale) not in OVER_CAP_RAISES:
                    raise
                print(f"main path {name} {scale}: raises under the default "
                      f"cap, as expected: {str(e)[:160]}", flush=True)
                results[f"{name}_{scale}"] = {"raised": str(e)[:300]}
                continue
            taken = spill_paths_taken(res["spill_entries"])
            if (name, scale) in REVOKED_AT and "revocations" not in taken:
                fail(f"{name} at {scale}: no join was revoked into the spill "
                     f"tier: {res['spill_entries']}")
            results[f"{name}_{scale}"] = res
        results[f"ds_sketch_item_{scale}_budget"] = budgeted_sketch_item(
            torch, K, runner, data, SKETCH_CARD["ds_sketch_item"], scale, R, np)
        results[f"{scale}_peak_bytes"] = torch.cuda.max_memory_allocated()
        results[f"{scale}_seconds"] = time.perf_counter() - t0
        print(f"TPC-DS {scale}: peak device memory "
              f"{results[f'{scale}_peak_bytes'] / 1e9:.2f} GB, "
              f"{results[f'{scale}_seconds']:.1f} s", flush=True)
        del runner, connector, data
        torch.cuda.empty_cache()
    return results


# ---- the mesh path ------------------------------------------------------------

#: the ORDER BY over all of lineitem that must take a range exchange
MESH_ORDER_SQL = (
    "select l_orderkey, l_linenumber, l_quantity from lineitem "
    "order by l_orderkey desc, l_linenumber"
)
#: the skewed join of the memory connector: probe rows at SF1 scale
SKEW_PROBE_ROWS = 6_000_000


def release(torch) -> None:
    """Free the device memory of released runners: an executor and its
    runner hold each other, so their tensors go with the cycle collector,
    then the caching allocator's blocks."""
    gc.collect()
    torch.cuda.empty_cache()


def mesh_stats(ex) -> dict:
    return {
        "exchanges": ex.exchange_stats["exchanges"],
        "bytes": ex.exchange_stats["bytes"],
        "escalations": ex.exchange_escalations,
        "host_syncs": ex.host_syncs,
        "skew_joins": ex.skew_joins,
        "range_exchanges": ex.range_exchanges,
    }


def mesh_query(torch, K, runner, name, sql, scale, R, want,
               warm_runs) -> dict:
    """``run_query`` on a mesh runner, with the executor's exchanges,
    bytes moved, escalations, host syncs, skew splits and range exchanges
    over its runs."""
    before = mesh_stats(runner.executor)
    res = run_query(torch, K, runner, name, sql, scale, R,
                    want, warm_runs=warm_runs,
                    label=f" on the {MESH_SHARDS}-shard mesh")
    after = mesh_stats(runner.executor)
    runs = warm_runs + 2
    res["mesh"] = {k: after[k] - before[k] for k in after}
    res["mesh"]["runs"] = runs
    print(f"mesh {name} {scale}: in {runs} runs {res['mesh']}", flush=True)
    return res


def mesh_runner(QueryRunner, make_mesh, md, session):
    runner = QueryRunner(md, session, mesh=make_mesh(MESH_SHARDS))
    if [d.type for d in runner.mesh.devices] != ["cuda"] * MESH_SHARDS:
        fail(f"the mesh is on {runner.mesh.devices}")
    return runner


def mesh_order_by(torch, np, runner, data) -> dict:
    """MESH_ORDER_SQL to the result page: it must take a range exchange,
    and the keys must come out in numpy's lexsort order."""
    ex = runner.executor
    before = ex.range_exchanges
    tc = time.perf_counter()
    _, page = runner.execute_page(MESH_ORDER_SQL)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - tc) * 1e3
    if ex.range_exchanges == before:
        fail("the mesh ORDER BY over lineitem took no range exchange")
    key = np.asarray(data.column("lineitem", "l_orderkey")).astype(np.int64)
    line = np.asarray(data.column("lineitem", "l_linenumber")).astype(np.int64)
    order = np.lexsort((line, -key))
    live = page.mask.cpu().numpy()
    got_key = page.column("l_orderkey").data.cpu().numpy()[live]
    got_line = page.column("l_linenumber").data.cpu().numpy()[live]
    if not (np.array_equal(got_key, key[order])
            and np.array_equal(got_line, line[order])):
        fail("the mesh ORDER BY over lineitem is out of order")
    print(f"mesh order_by sf1: {len(order)} rows in order through "
          f"{ex.range_exchanges - before} range exchange(s), cold {ms:.1f} ms "
          "to the result page", flush=True)
    return {"rows": int(len(order)), "cold_page_ms": ms,
            "range_exchanges": ex.range_exchanges - before}


def mesh_skew_join(torch, np, K, QueryRunner, make_mesh, R) -> dict:
    """The skewed join of test_parallel.py at SF1 scale: 6M probe rows,
    90% on key 7 (default_rng(5)), against 1000 build rows, PARTITIONED;
    it must take the skew split and equal its numpy count and sum."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.connectors.base import TableSchema
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.metadata import Metadata, Session

    n = SKEW_PROBE_ROWS
    rng = np.random.default_rng(5)
    keys = np.where(rng.random(n) < 0.9, 7, rng.integers(0, 1000, n)).astype(np.int64)
    md = Metadata()
    md.register_catalog("memory", MemoryConnector())
    conn = md.connector("memory")
    conn.create_table("default", "probe", TableSchema(
        "probe", [("k", T.BIGINT), ("v", T.BIGINT)]))
    conn.insert("default", "probe", {"k": keys, "v": np.arange(n, dtype=np.int64)})
    conn.create_table("default", "build", TableSchema(
        "build", [("k", T.BIGINT), ("w", T.BIGINT)]))
    conn.insert("default", "build", {"k": np.arange(1000, dtype=np.int64),
                                     "w": np.arange(1000, dtype=np.int64) * 10})
    runner = mesh_runner(QueryRunner, make_mesh, md,
                         Session(catalog="memory", schema="default"))
    runner.session.properties["join_distribution_type"] = "PARTITIONED"
    sql = "select count(*), sum(w) from probe, build where probe.k = build.k"
    want = [(n, int(np.sum(keys * 10)))]
    res = mesh_query(torch, K, runner, "skew_join", sql, "sf1", R,
                     want, warm_runs=1)
    if res["mesh"]["skew_joins"] < res["mesh"]["runs"]:
        fail(f"the skewed join did not take the skew split: {res['mesh']}")
    return res


def mesh_path(torch, np, K, QueryRunner, make_mesh, R, DS_QUERIES,
              tpch_keep) -> dict:
    """The mesh path: 8 shards on one card. SF10 Q1, Q3 and Q18 over the
    SF10 metadata of the TPC-H path (cold, 3 warm, one to the result
    page), the SF1 statements of the TPC-H path (cold, one warm, one to
    the page) and an ORDER BY over all of lineitem at SF1, the skewed
    join, and TPC-DS q3 and q86 at SF1 on a new TPC-DS runner; every
    statement against its numpy reference. The TPC-H metadata is
    released as it is used, before the TPC-DS path runs."""
    results = {}
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    for scale, warm in (("sf10", 3), ("sf1", 1)):
        md, session, data, queries, wants = tpch_keep.pop(scale)
        runner = mesh_runner(QueryRunner, make_mesh, md, session)
        for name, sql, _ in queries:
            results[f"{name}_{scale}_mesh"] = mesh_query(
                torch, K, runner, name, sql, scale, R, wants[name], warm)
        if scale == "sf1":
            results["order_by_sf1_mesh"] = mesh_order_by(torch, np, runner, data)
        results[f"{scale}_peak_bytes"] = torch.cuda.max_memory_allocated()
        print(f"mesh TPC-H {scale}: peak device memory "
              f"{results[f'{scale}_peak_bytes'] / 1e9:.2f} GB", flush=True)
        del runner, md, session, data
        release(torch)
        torch.cuda.reset_peak_memory_stats()
    results["skew_join_sf1_mesh"] = mesh_skew_join(
        torch, np, K, QueryRunner, make_mesh, R)
    release(torch)
    runner = QueryRunner.tpcds("sf1", mesh=make_mesh(MESH_SHARDS))
    data = runner.metadata.connector("tpcds").data("sf1")
    for name, sql, ref in (("ds_q03", DS_QUERIES["q3"], R.ds_q03),
                           ("ds_q86", DS_QUERIES["q86"], R.ds_q86)):
        results[f"{name}_sf1_mesh"] = mesh_query(
            torch, K, runner, name, sql, "sf1", R, ref(data), 1)
    results["ds_sf1_peak_bytes"] = torch.cuda.max_memory_allocated()
    del runner, data
    release(torch)
    results["seconds"] = time.perf_counter() - t0
    print(f"mesh path: {results['seconds']:.1f} s", flush=True)
    return results


#: the kernels each path must launch
TPCH_KERNELS = (
    "group_ids", "seg_sum", "join_probe", "expand_matches", "range_any",
    "scatter_any", "hash_keys", "pack_words", "seg_minmax", "order_words",
)
TPCDS_KERNELS = (
    "window_peers", "range_sum", "range_minmax", "seg_searchsorted",
    "hll_registers", "hll_estimate", "seg_arg_extreme", "hll_merge",
    "quant_summary", "quant_merge",
)
MESH_KERNELS = (
    "partition_pack", "segment_reduce", "group_ids", "seg_sum", "join_probe",
    "expand_matches", "hash_keys",
)


def drive(torch, K, stage, label, kernels, fn):
    """Run one path with every launch count set to 0 just before it;
    fail if one of ``kernels`` was never launched in it. Also counts the
    calls of count_true, blocked_sum and stage._presort_shared (torch
    ops, not kernels)."""
    from trino_tpu_torch.exec import spill

    K.reset_launches()
    spill.reset_entries()
    counted = (K.count_true, K.blocked_sum, stage._presort_shared)
    for f in counted:
        f.calls = 0
    out = fn()
    launches = {k: f.launches for k, f in K.KERNELS.items()}
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        fail(f"kernels never launched on the {label} path: {missing}")
    calls = {f.__name__: f.calls for f in counted}
    print(f"{label} path launches: {launches}; calls {calls}", flush=True)
    return out, launches, calls


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "trino_tpu_torch")):
        print("chip_smoke: trino_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    # generated TPC-H columns stay in memory: no disk cache for this run
    os.environ["TRINO_TPU_DATA_CACHE"] = "off"
    import numpy as np

    from trino_tpu_torch.connectors.tpcds.queries import QUERIES as DS_QUERIES
    from trino_tpu_torch.connectors.tpch.queries import QUERIES
    from trino_tpu_torch.engine import QueryRunner
    from trino_tpu_torch.exec import aggregates as A
    from trino_tpu_torch.exec import kernels as K
    from trino_tpu_torch.exec import native, shapes, stage
    from trino_tpu_torch.memory import ExceededMemoryLimitError
    from trino_tpu_torch.parallel import make_mesh
    from trino_tpu_torch.testing import numpy_reference as R
    from trino_tpu_torch.testing.statements import SKETCH_CARD

    smi = nvidia_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    build = native.build_all()
    print(f"kernel build: {build['seconds']:.1f} s (nvcc, sm_90a): "
          f"{', '.join(build['built']) or 'up to date'}", flush=True)
    dev = torch.device("cuda")

    # ---- kernel phases
    entries = {}
    ps, live_s, perm, cap = group_case(torch, np, K, shapes, dev, 4)
    k1_q1, info_q1 = k1_phase(torch, K, ps, live_s, perm, cap)
    k2_q1 = k2_phase(torch, np, K, info_q1, "int64", 4)
    k2_q1f = k2_phase(torch, np, K, info_q1, "float64", 4)
    k9_q1 = k9_phase(torch, np, K, info_q1, "int64", 1)
    k9_q1f = k9_phase(torch, np, K, info_q1, "float64", 2)
    presort = presort_phase(torch, np, perm)
    print("presort_shared " + json.dumps(presort), flush=True)
    del ps, live_s, perm
    ps, live_s, perm, cap = group_case(torch, np, K, shapes, dev, 1_500_000)
    k1_q3, info_q3 = k1_phase(torch, K, ps, live_s, perm, cap)
    k2_q3 = k2_phase(torch, np, K, info_q3, "int64", 1_500_000)
    k2_q3f = k2_phase(torch, np, K, info_q3, "float64", 1_500_000)
    k9_q3 = k9_phase(torch, np, K, info_q3, "int64", 3)
    k9_q3f = k9_phase(torch, np, K, info_q3, "float64", 4)
    del ps, live_s, perm, info_q1, info_q3
    ps, live_s, perm, cap = group_case(
        torch, np, K, shapes, dev, PART_ROWS, rows=PARTSUPP_ROWS)
    k1_q2, info_q2 = k1_phase(torch, K, ps, live_s, perm, cap)
    k9_q2 = k9_phase(torch, np, K, info_q2, "int64", 5)
    del ps, live_s, perm, info_q2
    k7 = k7_phase(torch, K, hash_case(torch, np, dev, three=False))
    k7_3 = k7_phase(torch, K, hash_case(torch, np, dev, three=True))
    k8 = k8_phase(torch, K, *pack_case(torch, np, dev, three=False))
    k8_3 = k8_phase(torch, K, *pack_case(torch, np, dev, three=True))
    k10 = k10_phase(torch, K, *order_case(torch, np, dev))
    torch.cuda.empty_cache()
    order, sorted_key, nbl, pk, pl = join_case(torch, np, K, dev)
    k3, (lo, cnt) = k3_phase(torch, K, order, sorted_key, nbl, pk, pl)
    k4 = k4_phase(torch, K, shapes, order, lo, cnt)
    del order, sorted_key, nbl, pk, pl, lo, cnt
    k4_skew = k4_skew_phase(torch, np, K, shapes, dev)
    torch.cuda.empty_cache()
    k3_kinds = {}
    for kind in JOIN_KINDS:
        k3_kinds[kind], _ = k3_phase(torch, K, *join_case(torch, np, K, dev, kind))
    torch.cuda.empty_cache()
    cnt, out_live = range_any_case(torch, np, dev, hot=False)
    k5 = k5_phase(torch, K, cnt, out_live)
    cnt, out_live = range_any_case(torch, np, dev, hot=True)
    k5_hot = k5_phase(torch, K, cnt, out_live)
    del cnt, out_live
    idx, flags = scatter_any_case(torch, np, dev)
    k6 = k6_phase(torch, K, idx, flags)
    del idx, flags
    torch.cuda.empty_cache()
    wk = window_phases(torch, np, K, dev)
    torch.cuda.empty_cache()
    ak = agg_phases(torch, np, K, shapes, dev)
    torch.cuda.empty_cache()
    sk = split_phases(torch, np, K, A, shapes, dev)
    mk = mesh_kernel_phases(torch, np, K, shapes, dev)
    counting = count_true_phase(torch, np, K, dev)
    print("count_true " + json.dumps(counting), flush=True)
    torch.cuda.empty_cache()
    sources = {
        "group_ids": ("trino_tpu_torch/csrc/group_ids.cu",
                      "trino_tpu/exec/kernels.py:166"),
        "seg_sum": ("trino_tpu_torch/csrc/seg_sum.cu",
                    "trino_tpu/exec/kernels.py:348"),
        "join_probe": ("trino_tpu_torch/csrc/join_probe.cu",
                       "trino_tpu/exec/kernels.py:577"),
        "expand_matches": ("trino_tpu_torch/csrc/expand_matches.cu",
                           "trino_tpu/exec/kernels.py:620"),
        "range_any": ("trino_tpu_torch/csrc/range_any.cu",
                      "trino_tpu/exec/kernels.py:489"),
        "scatter_any": ("trino_tpu_torch/csrc/scatter_any.cu",
                        "trino_tpu/exec/kernels.py:502"),
        "hash_keys": ("trino_tpu_torch/csrc/hash_keys.cu",
                      "trino_tpu/exec/kernels.py:124"),
        "pack_words": ("trino_tpu_torch/csrc/pack_words.cu",
                       "trino_tpu/exec/kernels.py:266"),
        "seg_minmax": ("trino_tpu_torch/csrc/seg_minmax.cu",
                       "trino_tpu/exec/kernels.py:384"),
        "order_words": ("trino_tpu_torch/csrc/order_words.cu",
                        "trino_tpu/exec/kernels.py:515"),
        "window_peers": ("trino_tpu_torch/csrc/window_peers.cu",
                         "trino_tpu/exec/window.py:94"),
        "range_sum": ("trino_tpu_torch/csrc/range_sum.cu",
                      "trino_tpu/exec/window.py:429"),
        "range_minmax": ("trino_tpu_torch/csrc/range_minmax.cu",
                         "trino_tpu/exec/window.py:464"),
        "seg_searchsorted": ("trino_tpu_torch/csrc/seg_searchsorted.cu",
                             "trino_tpu/exec/window.py:412"),
        "hll_registers": ("trino_tpu_torch/csrc/hll.cu",
                          "trino_tpu/exec/aggregates.py:460"),
        "hll_estimate": ("trino_tpu_torch/csrc/hll.cu",
                         "trino_tpu/exec/aggregates.py:489"),
        "seg_arg_extreme": ("trino_tpu_torch/csrc/seg_arg_extreme.cu",
                            "trino_tpu/exec/kernels.py:414"),
        "hll_merge": ("trino_tpu_torch/csrc/hll_merge.cu",
                      "trino_tpu/exec/aggregates.py:503"),
        "quant_summary": ("trino_tpu_torch/csrc/quant_summary.cu",
                          "trino_tpu/exec/aggregates.py:527"),
        "quant_merge": ("trino_tpu_torch/csrc/quant_merge.cu",
                        "trino_tpu/exec/aggregates.py:555"),
        "partition_pack": ("trino_tpu_torch/csrc/partition_pack.cu",
                           "trino_tpu/parallel/exchange.py:25"),
        "segment_reduce": ("trino_tpu_torch/csrc/segment_reduce.cu",
                           "trino_tpu/exec/kernels.py:650"),
    }
    rows = f"{LINEITEM_ROWS / 1e6:g}M rows"
    join = f"{ORDERS_ROWS / 1e6:g}M build, {LINEITEM_ROWS / 1e6:g}M probe"
    entries["group_ids"] = dict(
        k1_q1, case=f"{rows}, 4 groups",
        cases=[dict(k1_q3, case=f"{rows}, 1.5M groups"),
               dict(k1_q2, case=f"{PARTSUPP_ROWS / 1e6:g}M rows, "
                    f"{PART_ROWS / 1e6:g}M groups (Q2's shape)")])
    entries["seg_sum"] = dict(k2_q1, case=f"{rows}, 4 groups, int64",
                              cases=[dict(k2_q3, case=f"{rows}, 1.5M groups, int64"),
                                     dict(k2_q1f, case=f"{rows}, 4 groups, float64"),
                                     dict(k2_q3f, case=f"{rows}, 1.5M groups, float64")])
    entries["join_probe"] = dict(k3, case=join, cases=[
        dict(k3_kinds["hashed"], case=f"{join}, uniform u64 keys (hashed, "
             "bit 63 on half)"),
        dict(k3_kinds["hot"], case=f"{join}, one build key on 30% of the "
             "build rows"),
        dict(k3_kinds["sorted"], case=f"{join}, probes in key order")])
    entries["expand_matches"] = dict(k4, case=join, cases=[dict(
        k4_skew, case=f"{LINEITEM_ROWS / 1e6:g}M probe rows of 0-1 matches and "
        f"{K4_HOT_ROWS} of {K4_HOT_MATCHES / 1e6:g}M into a "
        f"{ORDERS_ROWS / 1e6:g}M-row order")])
    expand = f"{ORDERS_ROWS / 1e6:g}M probe rows of 1-7 matches"
    entries["range_any"] = dict(
        k5, case=f"{expand}, {k5['positions'] / 1e6:.1f}M positions",
        cases=[dict(k5_hot, case=f"{expand} + one probe row owning 10% "
                    f"of {k5_hot['positions'] / 1e6:.1f}M positions")])
    entries["scatter_any"] = dict(
        k6, case=f"{LINEITEM_ROWS / 1e6:g}M indices into "
                 f"{ORDERS_ROWS / 1e6:g}M slots")
    entries["hash_keys"] = dict(
        k7, case=f"{rows} x 2 int64 parts (Q9's l_partkey, l_suppkey)",
        cases=[dict(k7_3, case=f"{rows} x 3 parts: int64, float64 with "
                    "-0.0 and NaN, nullable int32")])
    entries["pack_words"] = dict(
        k8, case=f"{rows}, one 26-bit key, live bit folded (Q18's l_orderkey)",
        cases=[dict(k8_3, case=f"{rows}, 3 nullable keys (12, 20, 25 bits) "
                    "in one word")])
    entries["seg_minmax"] = dict(
        k9_q1, case=f"{rows}, 4 groups, int64 min",
        cases=[dict(k9_q3, case=f"{rows}, 1.5M groups, int64 min"),
               dict(k9_q1f, case=f"{rows}, 4 groups, float64 min"),
               dict(k9_q3f, case=f"{rows}, 1.5M groups, float64 min"),
               dict(k9_q2, case=f"{PARTSUPP_ROWS / 1e6:g}M rows, "
                    f"{PART_ROWS / 1e6:g}M groups, int64 min (Q2's shape)")])
    entries["order_words"] = dict(
        k10, case=f"{ORDERS_ROWS / 1e6:g}M rows: float64 DESC with NULLs, "
                  "int32 ASC, 10% dead")
    sales = f"{DS_SALES_ROWS / 1e6:g}M rows in {DS_STORES} partitions"
    q51 = f"{Q51_ROWS / 1e6:g}M rows in {Q51_ITEMS // 1000}K partitions"
    entries["window_peers"] = dict(
        wk["w1"], case=f"{sales}, one int64 key (ds_range7)",
        cases=[dict(wk["w1_float"], case=f"{sales}, a nullable float64 key "
                    "with NaN and -0.0, dense count"),
               dict(wk["w1_long"], case=f"{sales}, an int64 key of 4 values "
                    "a partition (peer groups of ~60K rows)")])
    entries["range_sum"] = dict(
        wk["w2"], case=f"{sales}, RANGE 6 preceding frames, count and "
                       "int64 lanes (ds_range7)",
        cases=[dict(wk["w2_float"], case=f"{sales}, ROWS frames, float64 with "
                    "NaN, -0.0 and a partition of 1e18s (library: "
                    "segment_reduce)"),
               dict(wk["w2_q51"], case=f"{q51}, running frames, count and two "
                    "limb lanes (q51)")])
    entries["range_minmax"] = dict(
        wk["w3_q51"], case=f"{q51}, running max over decimal(38,2) limbs (q51)",
        cases=[dict(wk["w3_int"], case=f"{sales}, running max, int64 "
                    "(library: cummax over gid-offset keys)"),
               dict(wk["w3_float"], case=f"{sales}, running max, float64 with "
                    "NaN and -0.0")])
    entries["seg_searchsorted"] = dict(
        wk["w4_left"], case=f"{sales}, left search of key - 6 (ds_range7)",
        cases=[dict(wk["w4_right"], case=f"{sales}, right search of key")])
    ss = f"{DS_SALES_ROWS / 1e6:g}M store_sales rows"
    items = f"{DS_ITEMS // 1000}K items"
    entries["hll_registers"] = dict(
        ak["a1_grouped"], case=f"{ss} in {items} x 512 registers, int64 values "
                               "hashed in the kernel (ds_sketch_item)",
        cases=[dict(ak["a1_global"], case=f"{ss}, one group x 4096 registers "
                    "(ds_sketch_global)"),
               dict(ak["a1_hot"], case=f"{ss}, 4096 registers, every row one "
                    "hot hash")])
    entries["hll_estimate"] = dict(
        ak["a2"], case=f"{items} x 512 registers (ds_sketch_item)")
    entries["seg_arg_extreme"] = dict(
        ak["a3_items_int"], case=f"{ss} in {items}, int64 keys with ties "
                                 "and sentinel values, max_by",
        cases=[dict(ak["a3_items_float"], case=f"{ss} in {items}, float64 "
                    "keys with NaN and -0.0"),
               dict(ak["a3_stores_int"], case=f"{ss} in {DS_STORES} groups, "
                    "int64 keys"),
               dict(ak["a3_stores_float"], case=f"{ss} in {DS_STORES} groups, "
                    "float64 keys")])
    chunks5 = f"five chunks' partial rows of {items}"
    entries["hll_merge"] = dict(
        sk["a4_grouped"], case=f"{chunks5} x 512 registers (ds_sketch_item's FINAL)",
        cases=[dict(sk["a4_global"], case="5 x 4096 registers into one "
                    "(ds_sketch_global's FINAL)"),
               dict(sk["a4_hot"], case=f"{chunks5} x 512, one group holding "
                    "every partial row")])
    entries["quant_summary"] = dict(
        sk["a5_grouped"], case=f"one {DS_SALES_ROWS // 5 / 1e6:g}M-row chunk in "
                               f"{items}, k = 256 (ds_sketch_item's PARTIAL)",
        cases=[dict(sk["a5_global"], case=f"one {DS_SALES_ROWS // 5 / 1e6:g}M-row "
                    "chunk, one group, k = 1024")])
    entries["quant_merge"] = dict(
        sk["a6_grouped"], case=f"{chunks5} x 256 points (~230M), q = 0.5 "
                               "(ds_sketch_item's FINAL; with its row sort)",
        cases=[dict(sk["a6_global"], case="one group of 5 x 1024 points")])
    shard = (f"one {LINEITEM_ROWS // MESH_SHARDS / 1e6:g}M-row shard of Q3's "
             f"lineitem exchange (3 int64 columns, 54% live) to {MESH_SHARDS} "
             f"buckets of {mk['m1']['bucket']}")
    entries["partition_pack"] = dict(
        mk["m1"], case=shard,
        cases=[dict(mk["m1_hot"], case=f"{shard}, one destination owning 60% "
                    "(overflows, rows dropped)")])
    entries["segment_reduce"] = dict(
        mk["m2_int64_16"], case=f"{rows} int64 into 16 slots, sum (q1_step's shape)",
        cases=[dict(mk["m2_float64_16"], case=f"{rows} float64 into 16 slots, sum"),
               dict(mk["m2_int64_1500000"], case=f"{rows} int64 into 1.5M slots, sum"),
               dict(mk["m2_float64_1500000"], case=f"{rows} float64 into 1.5M slots, sum"),
               dict(mk["m2_min"], case=f"{rows} float64 with NaN and -0.0 into 16 slots, min"),
               dict(mk["m2_max"], case=f"{rows} float64 with NaN and -0.0 into 16 slots, max"),
               dict(mk["m2_hist"], case=f"{rows}: live flags by destination into "
                    f"{MESH_SHARDS} slots (_dest_counts)")])

    def gathered(c):
        return f", gather {c['gather_ms']:.3f} ms" if "gather_ms" in c else ""

    for name, e in entries.items():
        print(f"kernel {name} [{e['case']}]: {e['ms']:.3f} ms, plain "
              f"{e['plain_ms']:.3f} ms, library {e['library_ms']} ms, bound "
              f"{e['bound_ms']:.3f} ms{gathered(e)}; equal to the plain version",
              flush=True)
        for c in e.get("cases", []):
            print(f"kernel {name} [{c['case']}]: {c['ms']:.3f} ms, plain "
                  f"{c['plain_ms']:.3f} ms, library {c['library_ms']} ms, "
                  f"bound {c['bound_ms']:.3f} ms{gathered(c)}; max_abs_err "
                  f"{c['max_abs_err']}", flush=True)

    # ---- main path: TPC-H, then TPC-DS, each with the counts set to 0
    # the TPC-H metadata (generated data, planner statistics) the mesh path
    # reuses and then releases, before the TPC-DS path
    tpch_keep = {}
    path, tpch_launches, tpch_calls = drive(
        torch, K, stage, "TPC-H", TPCH_KERNELS,
        lambda: main_path(torch, K, QueryRunner, QUERIES, R, tpch_keep))
    print("main_path " + json.dumps(path, sort_keys=True), flush=True)
    m_path, mesh_launches, mesh_calls = drive(
        torch, K, stage, "mesh", MESH_KERNELS,
        lambda: mesh_path(torch, np, K, QueryRunner, make_mesh, R, DS_QUERIES,
                          tpch_keep))
    print("mesh_path " + json.dumps(m_path, sort_keys=True), flush=True)
    ds_path, ds_launches, ds_calls = drive(
        torch, K, stage, "TPC-DS", TPCDS_KERNELS,
        lambda: tpcds_path(torch, K, QueryRunner, DS_QUERIES, SKETCH_CARD, R,
                           ExceededMemoryLimitError, np))
    print("tpcds_path " + json.dumps(ds_path, sort_keys=True), flush=True)
    launches = {
        k: tpch_launches[k] + ds_launches[k] + mesh_launches[k]
        for k in K.KERNELS
    }
    print("calls on the paths " + json.dumps(
        {k: tpch_calls[k] + ds_calls[k] + mesh_calls[k] for k in tpch_calls}),
        flush=True)
    print(f"total seconds: {time.perf_counter() - t0:.1f}", flush=True)

    kernels = []
    for name, e in entries.items():
        src, replaces = sources[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "launches_tpch": tpch_launches[name],
            "launches_tpcds": ds_launches[name],
            "launches_mesh": mesh_launches[name],
            "max_abs_err": e["max_abs_err"], "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": "bytes", "library_ms": e["library_ms"],
            "case": e["case"],
            "cases": [
                {k: c[k] for k in ("case", "max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "library_ms", "rep_ms",
                                   "segment_reduce_ms", "scatter_ms",
                                   "gather_ms")
                 if k in c}
                for c in e.get("cases", [])
            ],
            **{k: e[k] for k in ("sort_perm_ms", "rep_ms", "scatter_ms",
                                 "gather_ms")
               if k in e},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
