"""Bigger-than-device execution: streamed scans, chunked chains,
streamed-probe joins and grace-hash joins — the port of
``trino_tpu/exec/spill.py``.

- The "disk" tier is host RAM: device memory is the scarce resource,
  host memory stands in for spill files.
- The streaming unit is a fixed-size row chunk: the connector yields row
  ranges (``Split``s) and each chunk runs the same chain at the same
  capacity.
- Partial/final decomposition reuses ``plan/distribute.py``'s
  ``_split_aggregate``: a chunk is to the budget what a shard is to the
  mesh.
- The grace-hash join partitions both sides by key hash on the host and
  joins partition pairs on the device, recursing into partitions whose
  measured bytes the first estimate undercounted, and streaming chunk
  pairs for a single hot key.

Activated by the ``hbm_budget_bytes`` session property (0 = resident).
The budget is a planning target, not an allocator: the executor sizes
chunks and partitions so that no single device working set exceeds it,
and reserves every working set through the query's memory context,
which enforces the per-node cap and keeps the high-water mark
(``ex.tracked_bytes_hwm``). The memory governor also enters this tier
by revocation: a resident join that would breach
``query_max_memory_per_node`` re-enters here with the cap as budget.

Two choices of the port keep host work off the streamed path; neither
changes a row:

- A VARCHAR column of a streamed scan is encoded once per executor
  against a dictionary of the whole column (``LocalExecutor.chunk_codes``),
  so every chunk slices host codes instead of sorting its strings.
- A host run keeps a VARCHAR column's device encoding (dictionary codes,
  or a hash pool's [hash, id] lanes) with the dictionary or pool; runs
  that share it concatenate their codes, and only runs with different
  encodings decode to strings and re-encode, as the JAX package always
  does. Partition hashing and run merging read the values through the
  encoding.

The chunk producer (``scan_chunk_pages``) runs one chunk ahead in a
thread that does host work only (slicing, encoding, padding into pinned
buffers on CUDA); the upload is issued by the consumer on its own
stream, so a buffer the consumer frees is never read by a copy in
flight on another stream.
"""

from __future__ import annotations

import queue as _queue
import threading as _threading
import zlib

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.connectors.base import Split
from trino_tpu_torch.page import (
    Column, HashStringPool, Page, StringDictionary, pad_capacity,
)
from trino_tpu_torch.plan import nodes as P

__all__ = [
    "scan_bytes", "row_bytes", "est_output_bytes", "run_chain_streamed",
    "streamed_probe_join", "grace_join", "streamed_semi_join", "ENTRIES",
]

#: minimum chunk size — tiny chunks drown in per-launch latency
MIN_CHUNK_ROWS = 1 << 16

#: a single streamed working set targets this fraction of the budget
#: (several arrays are alive at once inside a chain)
CHUNK_BUDGET_FRACTION = 4

#: entries into each spill path since the last ``reset_entries()``:
#: the streamed chain, the streamed probe and semi joins, the grace
#: join, the chunked cross join and the revocations of over-cap joins;
#: and the scan chunks streamed
ENTRIES = {
    "run_chain_streamed": 0, "streamed_probe_join": 0,
    "streamed_semi_join": 0, "grace_join": 0, "chunked_cross_join": 0,
    "revocations": 0,
}
#: the spill paths among ENTRIES (the other count is chunks streamed)
PATHS = tuple(ENTRIES)
ENTRIES["scan_chunks"] = 0


def reset_entries() -> None:
    for k in ENTRIES:
        ENTRIES[k] = 0


def _col_bytes(t: T.DataType) -> int:
    """Device bytes per row of a column (varchar = int32 codes). A
    SketchType column counts its dtype's itemsize, not times its lanes,
    as the JAX package counts it."""
    if isinstance(t, T.VarcharType):
        return 4
    return int(np.dtype(t.np_dtype).itemsize)


def row_bytes(outputs: dict[str, T.DataType]) -> int:
    return max(sum(_col_bytes(t) for t in outputs.values()), 1)


def scan_bytes(metadata, node: P.TableScan) -> int:
    """Estimated device-resident bytes of a table scan."""
    try:
        n = metadata.connector(node.catalog).row_count(node.schema, node.table)
    except Exception:
        return 0
    return n * row_bytes(node.outputs)


def est_output_bytes(ex, node: P.PlanNode) -> int:
    """Estimated bytes of a node's output (stats-based rows x width)."""
    from trino_tpu_torch.plan.stats import estimate

    rows = estimate(node, ex.metadata).rows
    return int(rows) * row_bytes(node.outputs)


def chunk_rows_for(budget: int, per_row: int) -> int:
    target = max(budget // CHUNK_BUDGET_FRACTION, 1)
    return max(pad_capacity(target // max(per_row, 1)), MIN_CHUNK_ROWS)


def _note(ex, nbytes: int) -> None:
    """Account one transient streamed working set against the query's
    memory context: the reserve enforces query_max_memory_per_node and
    records the high-water mark; the immediate free mirrors its
    lifetime (the tensors are dead once the chain returns)."""
    ctx = ex.memory_ctx.child("spill")
    ctx.reserve(nbytes)
    ctx.free(nbytes)


def _page_bytes(page: Page) -> int:
    return page.capacity * row_bytes(
        {n: c.type for n, c in zip(page.names, page.columns)}
    )


# ---- scan chunk source -------------------------------------------------------


def _host_buffer(values: np.ndarray, dtype, capacity: int, pin: bool):
    """``values`` padded with zeros to ``capacity`` rows, as a torch host
    tensor (page-locked when ``pin``, so that the upload is a real
    asynchronous copy)."""
    shape = (capacity,) + tuple(values.shape[1:])
    buf = torch.empty(shape, dtype=dtype, pin_memory=pin)
    arr = buf.numpy()
    n = len(values)
    arr[:n] = values
    arr[n:] = 0
    return buf


def scan_chunk_pages(ex, node: P.TableScan, chunk_rows: int):
    """Yield device Pages of ``chunk_rows`` rows each — the streamed scan
    path. Never touches the executor's resident scan cache; every chunk
    has the same capacity.

    Double-buffered: a producer thread prepares chunk k+1's host buffers
    (slicing, VARCHAR codes, padding, pinning) while the consumer runs
    chunk k; the consumer uploads each chunk on its own stream."""
    from trino_tpu_torch.page import torch_dtype

    connector = ex.metadata.connector(node.catalog)
    n = connector.row_count(node.schema, node.table)
    names = list(node.assignments)
    dev = ex.device
    pin = dev.type == "cuda"

    def build_host(start: int):
        count = min(chunk_rows, n - start) if n else 0
        count = max(count, 0)
        split = Split(node.table, start, count)
        cols_raw = connector.scan(
            node.schema, node.table, list(node.assignments.values()), split
        )
        cols = []
        for sym, cname in node.assignments.items():
            t = node.outputs[sym]
            v = cols_raw[cname]
            valid = None
            if isinstance(v, tuple):
                v, valid = v
            dictionary = None
            if t.is_dictionary:
                dictionary, codes = ex.chunk_codes(node, cname)
                v = codes[start:start + count]
            data = _host_buffer(
                np.asarray(v, dtype=t.np_dtype), torch_dtype(t.np_dtype),
                chunk_rows, pin,
            )
            vbuf = None
            if valid is not None:
                vbuf = _host_buffer(
                    np.asarray(valid, dtype=np.bool_), torch.bool,
                    chunk_rows, pin,
                )
            cols.append((t, data, vbuf, dictionary))
        return count, cols

    def upload(item) -> Page:
        count, cols = item
        columns = [
            Column(
                t, data.to(dev, non_blocking=True),
                None if valid is None else valid.to(dev, non_blocking=True),
                dictionary,
            )
            for t, data, valid, dictionary in cols
        ]
        mask = torch.zeros(chunk_rows, dtype=torch.bool, device=dev)
        mask[:count] = True
        page = Page(names, columns, mask, known_rows=count, packed=True)
        # the in-flight chunk plus the one being consumed are both
        # device-resident while overlapped
        _note(ex, 2 * _page_bytes(page))
        return page

    if n == 0:
        ENTRIES["scan_chunks"] += 1
        yield upload(build_host(0))
        return
    starts = list(range(0, n, chunk_rows))
    q: _queue.Queue = _queue.Queue(maxsize=1)
    stop = _threading.Event()

    def produce():
        try:
            for start in starts:
                if stop.is_set():
                    return
                q.put(build_host(start))
            q.put(None)
        except BaseException as e:  # surfaced in the consumer
            q.put(e)

    t = _threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            ENTRIES["scan_chunks"] += 1
            yield upload(item)
    finally:
        # unblock the producer if the consumer stops early (Limit)
        stop.set()
        while t.is_alive():
            try:
                q.get_nowait()
            except _queue.Empty:
                pass
            t.join(timeout=0.05)


# ---- host accumulation (the spill-file analog) --------------------------------


class HostRun:
    """A spilled batch: packed host columns. ``encodings`` holds, per
    column, the StringDictionary (values are int32 codes) or
    HashStringPool (values are [n, 2] hash/id lanes) the values are
    coded in, or None (plain values; VARCHAR as Python strings)."""

    __slots__ = ("names", "types", "columns", "n_rows", "encodings")

    def __init__(self, names, types, columns, n_rows, encodings=None):
        self.names = names
        self.types = types
        self.columns = columns  # [(values[np], valid[np]|None)]
        self.n_rows = n_rows
        self.encodings = encodings or [None] * len(columns)


def _decode(values: np.ndarray, enc) -> np.ndarray:
    if isinstance(enc, StringDictionary):
        return enc.values[values].astype(object)
    return enc.values[values[:, 1]].astype(object)


def _decoded(run: HostRun, which=None) -> HostRun:
    """The run with its coded columns (those in ``which``, default all)
    decoded to strings."""
    cols, encs = [], []
    for i, ((v, x), enc) in enumerate(zip(run.columns, run.encodings)):
        if enc is not None and (which is None or i in which):
            v, enc = _decode(v, enc), None
        cols.append((v, x))
        encs.append(enc)
    return HostRun(run.names, run.types, cols, run.n_rows, encs)


def _unify_encodings(runs: list[HostRun]) -> list[HostRun]:
    """Decode every column whose runs do not all share one encoding."""
    if len(runs) < 2:
        return runs
    mixed = {
        i for i in range(len(runs[0].columns))
        if any(r.encodings[i] is not runs[0].encodings[i] for r in runs)
    }
    if not mixed:
        return runs
    return [_decoded(r, mixed) for r in runs]


def page_to_host(page: Page) -> HostRun:
    k = page.known_rows if page.packed else None
    if k is None:
        sel = torch.nonzero(page.mask).reshape(-1)
        n = int(sel.shape[0])

        def take(x):
            return x[sel].cpu().numpy()
    else:
        n = k

        def take(x):
            return x[:k].cpu().numpy()
    cols, encs = [], []
    for c in page.columns:
        data = take(c.data)
        valid = None if c.valid is None else take(c.valid)
        enc = c.dictionary if c.dictionary is not None else c.hash_pool
        cols.append((data, valid))
        encs.append(enc)
    return HostRun(
        list(page.names), [c.type for c in page.columns], cols, n, encs,
    )


def host_concat_to_page(ex, runs: list[HostRun]) -> Page:
    """Concatenate host runs into ONE device page (the unspill /
    merge-read step). A VARCHAR column whose runs share one encoding
    keeps it; otherwise it re-encodes into one fresh dictionary over the
    full result."""
    runs = _unify_encodings(runs)
    first = runs[0]
    total = sum(r.n_rows for r in runs)
    cap = pad_capacity(total)
    dev = ex.device
    cols = []
    for i, t in enumerate(first.types):
        vals = np.concatenate([r.columns[i][0] for r in runs])
        if any(r.columns[i][1] is not None for r in runs):
            valid = np.concatenate([
                (
                    np.ones(r.n_rows, dtype=bool)
                    if r.columns[i][1] is None else r.columns[i][1]
                )
                for r in runs
            ])
        else:
            valid = None
        enc = first.encodings[i]
        if isinstance(enc, StringDictionary):
            col = Column.from_numpy(
                t, vals, valid=valid, capacity=cap, dictionary=enc,
                device=dev,
            )
        elif isinstance(enc, HashStringPool):
            data = np.zeros((cap, 2), dtype=np.int64)
            data[:total] = vals
            v = None
            if valid is not None:
                v = np.zeros(cap, dtype=np.bool_)
                v[:total] = valid
                v = torch.from_numpy(v).to(dev)
            col = Column(t, torch.from_numpy(data).to(dev), v, None, enc)
        else:
            col = Column.from_numpy(t, vals, valid=valid, capacity=cap,
                                    device=dev)
        cols.append(col)
    mask = torch.zeros(cap, dtype=torch.bool, device=dev)
    mask[:total] = True
    page = Page(list(first.names), cols, mask, known_rows=total, packed=True)
    _note(ex, _page_bytes(page))
    return page


def _empty_run(outputs: dict[str, T.DataType]) -> HostRun:
    return HostRun(
        list(outputs),
        list(outputs.values()),
        [
            (
                np.empty(
                    (0, t.lanes) if isinstance(t, T.SketchType) else 0,
                    dtype=object if isinstance(t, T.VarcharType)
                    else t.np_dtype,
                ),
                None,
            )
            for t in outputs.values()
        ],
        0,
    )


# ---- streamed chains -----------------------------------------------------------


def _split_chain(chain: list[P.PlanNode]):
    """(per_chunk_nodes, final_nodes, merge_keys): the per-chunk part is
    row-local (or a PARTIAL aggregate / partial TopN/Limit/Sort); the
    final part runs once over the combined chunk outputs. ``merge_keys``
    is set for a full Sort: each chunk sorts on the device, runs spill
    sorted, and the combine step merges runs on the host."""
    from trino_tpu_torch.exec.local import _splittable
    from trino_tpu_torch.plan.distribute import _split_aggregate

    for i, nd in enumerate(chain):
        if isinstance(nd, P.Aggregate):
            if (
                nd.step == "SINGLE"
                and not any(c.distinct for c in nd.aggregates.values())
                and _splittable(nd)
            ):
                partial, final = _split_aggregate(nd)
                partial.est_groups = nd.est_groups
                partial.key_ranges = nd.key_ranges
                final.est_groups = nd.est_groups
                final.key_ranges = nd.key_ranges
                return chain[:i] + [partial], [final] + chain[i + 1:], None
            return chain[:i], chain[i:], None
        if isinstance(nd, P.TopN):
            # a chunk-local TopN bounds each chunk's contribution; the
            # final TopN re-ranks the concatenation
            return chain[: i + 1], chain[i:], None
        if isinstance(nd, P.Sort):
            return chain[: i + 1], chain[i + 1:], list(nd.keys)
        if isinstance(nd, P.Limit):
            per = P.Limit(
                dict(nd.outputs), source=None,
                count=nd.count + nd.offset if nd.count >= 0 else -1,
                offset=0,
            )
            return chain[:i] + [per], chain[i:], None
    return list(chain), [], None


def _order_bits_np(values: np.ndarray) -> np.ndarray | None:
    """Monotone u64 encoding on the host (kernels.order_bits analog);
    None for types without a single-lane encoding."""
    if values.dtype == object or values.ndim != 1:
        return None
    if values.dtype.kind == "f":
        b = values.astype(np.float64).view(np.uint64)
        sign = (b >> np.uint64(63)).astype(bool)
        with np.errstate(over="ignore"):
            return np.where(
                sign, ~b, b | np.uint64(0x8000000000000000)
            )
    if values.dtype == np.bool_:
        return values.astype(np.uint64)
    with np.errstate(over="ignore"):
        return values.astype(np.int64).view(np.uint64) ^ np.uint64(
            0x8000000000000000
        )


def merge_sorted_runs(runs: list, keys) -> "HostRun":
    """Merge device-sorted host runs into one globally ordered run.

    Single non-nullable numeric key: a k-way merge by iterated pairwise
    vectorized merges on u64 rank arrays (log2(k) passes of searchsorted
    and a gather). Everything else (multi-key, nullable, varchar,
    two-limb): one host lexsort over the concatenation. A VARCHAR key
    whose runs share one sorted dictionary sorts by its codes (code
    order is string order); a hash-coded key decodes first."""
    runs = [r for r in runs if r.n_rows] or runs[:1]
    if len(runs) == 1:
        return runs[0]
    runs = _unify_encodings(runs)
    first = runs[0]
    idx_of = {n: i for i, n in enumerate(first.names)}
    pooled = {
        idx_of[k.symbol] for k in keys
        if isinstance(first.encodings[idx_of[k.symbol]], HashStringPool)
    }
    if pooled:
        runs = [_decoded(r, pooled) for r in runs]
        first = runs[0]

    def take(run, order):
        return HostRun(
            list(run.names), list(run.types),
            [
                (v[order], None if valid is None else valid[order])
                for v, valid in run.columns
            ],
            len(order), list(run.encodings),
        )

    def concat(a, b):
        cols = []
        for (va, xa), (vb, xb) in zip(a.columns, b.columns):
            if va.dtype == object or vb.dtype == object:
                v = np.concatenate([va.astype(object), vb.astype(object)])
            else:
                v = np.concatenate([va, vb])
            if xa is not None or xb is not None:
                x = np.concatenate([
                    xa if xa is not None else np.ones(len(va), dtype=bool),
                    xb if xb is not None else np.ones(len(vb), dtype=bool),
                ])
            else:
                x = None
            cols.append((v, x))
        return HostRun(
            list(a.names), list(a.types), cols, a.n_rows + b.n_rows,
            list(a.encodings),
        )

    k0 = keys[0]
    ci = idx_of[k0.symbol]
    single = (
        len(keys) == 1
        and first.columns[ci][1] is None
        and _order_bits_np(first.columns[ci][0]) is not None
    )
    if single:
        items = []
        for r in runs:
            bits = _order_bits_np(r.columns[ci][0])
            if not k0.ascending:
                bits = ~bits
            items.append((bits, r))
        while len(items) > 1:
            nxt = []
            for j in range(0, len(items) - 1, 2):
                ba, ra = items[j]
                bb, rb = items[j + 1]
                # stable pairwise merge: run a's rows precede equal rows
                # of run b
                pos_a = np.arange(len(ba)) + np.searchsorted(bb, ba, "left")
                pos_b = np.arange(len(bb)) + np.searchsorted(ba, bb, "right")
                m = len(ba) + len(bb)
                order = np.empty(m, dtype=np.int64)
                order[pos_a] = np.arange(len(ba))
                order[pos_b] = len(ba) + np.arange(len(bb))
                merged = take(concat(ra, rb), order)
                bits = np.empty(m, dtype=np.uint64)
                bits[pos_a] = ba
                bits[pos_b] = bb
                nxt.append((bits, merged))
            if len(items) % 2:
                nxt.append(items[-1])
            items = nxt
        return items[0][1]

    # general path: host lexsort over the concatenation
    combined = runs[0]
    for r in runs[1:]:
        combined = concat(combined, r)
    lanes = []
    for k in reversed(keys):
        i = idx_of[k.symbol]
        values, valid = combined.columns[i]
        if values.dtype == object:
            _u, codes = np.unique(values.astype(str), return_inverse=True)
            lane_list = [codes if k.ascending else -codes]
        elif values.ndim == 2:
            hi, lo = values[:, 0], values[:, 1]
            if k.ascending:
                lane_list = [lo, hi]
            else:
                with np.errstate(over="ignore"):
                    lane_list = [-lo, -hi]
        else:
            bits = _order_bits_np(values)
            lane_list = [bits if k.ascending else ~bits]
        for lane in lane_list:
            lanes.append(lane)
        if valid is not None:
            nf = (
                k.nulls_first if k.nulls_first is not None
                else not k.ascending
            )
            nulls = (~valid).astype(np.int8)
            lanes.append(-nulls if nf else nulls)
    order = np.lexsort(lanes)
    return take(combined, order)


def run_chain_streamed(ex, chain: list[P.PlanNode], scan: P.TableScan) -> Page:
    """Execute chain-over-scan without ever materializing the table:
    stream chunks, run the per-chunk part, spill outputs to the host,
    then run the final part over the merged result."""
    ENTRIES["run_chain_streamed"] += 1
    budget = ex.hbm_budget()
    chunk_rows = chunk_rows_for(budget, row_bytes(scan.outputs))
    per_chunk, final, merge_keys = _split_chain(chain)
    limit_needed = None
    if per_chunk and isinstance(per_chunk[-1], P.Limit):
        c = per_chunk[-1].count
        limit_needed = c if c >= 0 else None
    runs: list[HostRun] = []
    collected = 0
    for page in scan_chunk_pages(ex, scan, chunk_rows):
        out = ex._run_chain(list(per_chunk), page) if per_chunk else page
        out = ex._compact(out)
        run = page_to_host(out)
        if run.n_rows:
            runs.append(run)
            collected += run.n_rows
        if limit_needed is not None and collected >= limit_needed:
            break
    if not runs:
        out_node = (per_chunk or [scan])[-1]
        runs = [_empty_run(out_node.outputs)]
    if merge_keys is not None and len(runs) > 1:
        runs = [merge_sorted_runs(runs, merge_keys)]
    combined = host_concat_to_page(ex, runs)
    if final:
        return ex._run_chain(list(final), combined)
    return combined


# ---- streamed-probe join ---------------------------------------------------------


def streamed_probe_join(
    ex, node: P.Join, probe_chain: list[P.PlanNode],
    probe_scan: P.TableScan, build: Page,
) -> Page:
    """Join a bigger-than-budget probe against a resident build side, one
    chunk at a time. Valid for inner and left joins: every probe row is
    judged independently against the full build."""
    ENTRIES["streamed_probe_join"] += 1
    budget = ex.hbm_budget()
    chunk_rows = chunk_rows_for(budget, row_bytes(probe_scan.outputs))
    runs: list[HostRun] = []
    for page in scan_chunk_pages(ex, probe_scan, chunk_rows):
        probe = ex._run_chain(list(probe_chain), page) if probe_chain else page
        probe = ex._compact(probe)
        joined = ex._equi_join(node, probe, build)
        _note(ex, _page_bytes(joined))
        run = page_to_host(ex._compact(joined))
        if run.n_rows:
            runs.append(run)
    if not runs:
        runs = [_empty_run(node.outputs)]
    return host_concat_to_page(ex, runs)


def streamed_semi_join(
    ex, node: P.SemiJoin, source_chain: list[P.PlanNode],
    source_scan: P.TableScan, filt: Page,
) -> Page:
    """Chunked semi join: the match column is row-local given the (small,
    resident) filter side."""
    ENTRIES["streamed_semi_join"] += 1
    budget = ex.hbm_budget()
    chunk_rows = chunk_rows_for(budget, row_bytes(source_scan.outputs))
    runs: list[HostRun] = []
    for page in scan_chunk_pages(ex, source_scan, chunk_rows):
        src = ex._run_chain(list(source_chain), page) if source_chain else page
        src = ex._compact(src)
        out = ex._semi_join_pages(node, src, filt)
        run = page_to_host(ex._compact(out))
        if run.n_rows:
            runs.append(run)
    if not runs:
        runs = [_empty_run(node.outputs)]
    return host_concat_to_page(ex, runs)


# ---- grace-hash join ---------------------------------------------------------------

_MIX_1 = np.uint64(0xFF51AFD7ED558CCD)
_MIX_2 = np.uint64(0xC4CEB9FE1A85EC53)


def _host_mix64(h: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = h ^ (h >> np.uint64(33))
        h = h * _MIX_1
        h = h ^ (h >> np.uint64(33))
        h = h * _MIX_2
        h = h ^ (h >> np.uint64(33))
    return h


def _crc_bits(strings) -> np.ndarray:
    return np.fromiter(
        (zlib.crc32(str(v).encode()) for v in strings),
        dtype=np.uint64, count=len(strings),
    )


def _host_partition_ids(
    run: HostRun, key_syms: list[str], parts: int, salt: int = 0
):
    """Partition id per row from the combined key hash (numpy: the
    spill-write pass). ``salt`` decorrelates recursive sub-partitioning
    levels: a level-d split re-hashes so an over-full bucket spreads
    instead of collapsing into one sub-bucket again."""
    h = np.full(run.n_rows, np.uint64(salt * 0x9E3779B97F4A7C15 % (1 << 64)),
                dtype=np.uint64)
    for s in key_syms:
        i = run.names.index(s)
        vals, valid = run.columns[i]
        enc = run.encodings[i]
        if enc is not None:
            # hash the string VALUE (each distinct string once): codes
            # differ between sides and would split equal keys across
            # partitions
            if isinstance(enc, StringDictionary):
                bits = _crc_bits(enc.values)[vals]
            else:
                bits = _crc_bits(enc.values)[vals[:, 1]]
        elif vals.dtype == object or vals.dtype.kind in ("U", "S"):
            bits = _crc_bits(vals)
        elif vals.dtype.kind == "f":
            v64 = vals.astype(np.float64)  # f32 widens exactly
            v64 = np.where(
                v64 == 0.0, 0.0, np.where(np.isnan(v64), np.nan, v64)
            )
            bits = v64.view(np.uint64)
        else:
            bits = vals.astype(np.int64).view(np.uint64)
        if valid is not None:
            bits = np.where(valid, bits, np.uint64(0))
        with np.errstate(over="ignore"):
            h = _host_mix64(h ^ _host_mix64(bits))
    return (h % np.uint64(parts)).astype(np.int64)


def _split_run(run: HostRun, part_ids: np.ndarray, parts: int):
    out = []
    for p in range(parts):
        sel = part_ids == p
        cols = [
            (vals[sel], None if valid is None else valid[sel])
            for vals, valid in run.columns
        ]
        out.append(HostRun(
            run.names, run.types, cols, int(sel.sum()), list(run.encodings),
        ))
    return out


def _host_chunks(ex, node: P.PlanNode, chunk_rows: int):
    """Stream ANY plan subtree to host chunks: chains over scans go chunk
    by chunk; everything else executes resident and spills once."""
    chain, scan = ex._streamable(node)
    if scan is not None:
        for page in scan_chunk_pages(ex, scan, chunk_rows):
            out = ex._run_chain(list(chain), page) if chain else page
            run = page_to_host(ex._compact(out))
            if run.n_rows:
                yield run
        return
    page = ex._compact(ex.execute(node))
    run = page_to_host(page)
    if run.n_rows:
        yield run


def grace_join(ex, node: P.Join) -> Page:
    """Both sides exceed the budget: hash-partition both to host RAM and
    join partition pairs on the device. The partition count is sized so
    that one pair's working set fits the chunk budget; key-hash
    co-partitioning puts matching rows in the same pair."""
    ENTRIES["grace_join"] += 1
    budget = ex.hbm_budget()
    l_bytes = est_output_bytes(ex, node.left)
    r_bytes = est_output_bytes(ex, node.right)
    pair_budget = max(budget // CHUNK_BUDGET_FRACTION, 1)
    parts = max(int(np.ceil((l_bytes + r_bytes) / pair_budget)), 2)
    # an explicit session setting (tests, operators) overrides: an
    # under-sized first pass exercises the recursive sub-partitioning
    forced = int(ex.session.properties.get("grace_partitions", 0) or 0)
    if forced:
        parts = forced
    chunk_rows = chunk_rows_for(budget, max(row_bytes(node.left.outputs), 1))
    lkeys = [a for a, _ in node.criteria]
    rkeys = [b for _, b in node.criteria]
    l_parts: list[list[HostRun]] = [[] for _ in range(parts)]
    r_parts: list[list[HostRun]] = [[] for _ in range(parts)]
    for side, keys, acc in (
        (node.left, lkeys, l_parts), (node.right, rkeys, r_parts),
    ):
        for run in _host_chunks(ex, side, chunk_rows):
            ids = _host_partition_ids(run, keys, parts)
            for p, piece in enumerate(_split_run(run, ids, parts)):
                if piece.n_rows:
                    acc[p].append(piece)
    runs: list[HostRun] = []
    for p in range(parts):
        _grace_pair(
            ex, node, lkeys, rkeys, l_parts[p], r_parts[p],
            pair_budget, 1, runs,
        )
    if not runs:
        runs = [_empty_run(node.outputs)]
    return host_concat_to_page(ex, runs)


#: recursion bound for under-split grace partitions; beyond it the
#: hot-key fallback streams the pair in chunk pairs
GRACE_MAX_DEPTH = 5


def _run_bytes(run: HostRun) -> int:
    return sum(
        v.nbytes + (0 if x is None else x.nbytes)
        for v, x in run.columns
    ) if run.n_rows else 0


def _grace_pair(
    ex, node: P.Join, lkeys, rkeys, lp: list[HostRun], rp: list[HostRun],
    pair_budget: int, depth: int, out_runs: list[HostRun],
) -> None:
    """Join one co-partitioned pair, recursively sub-partitioning any pair
    whose MEASURED bytes exceed the pair budget (the estimate that sized
    the first pass gets no trust beyond it). A pair that re-hashing cannot
    split (a single hot key) streams chunk pairs for an inner join, or
    joins oversized with the overage in the high-water mark."""
    if not lp and (node.kind != "full" or not rp):
        return
    if not rp and node.kind == "inner":
        return
    l_bytes = sum(_run_bytes(r) for r in lp)
    r_bytes = sum(_run_bytes(r) for r in rp)
    if l_bytes + r_bytes > pair_budget:
        if depth < GRACE_MAX_DEPTH:
            sub = 4
            lsub: list[list[HostRun]] = [[] for _ in range(sub)]
            rsub: list[list[HostRun]] = [[] for _ in range(sub)]
            for side_runs, keys, acc in (
                (lp, lkeys, lsub), (rp, rkeys, rsub),
            ):
                for run in side_runs:
                    ids = _host_partition_ids(run, keys, sub, salt=depth)
                    for q, piece in enumerate(_split_run(run, ids, sub)):
                        if piece.n_rows:
                            acc[q].append(piece)
            bucket_bytes = [
                sum(_run_bytes(r) for r in lsub[q])
                + sum(_run_bytes(r) for r in rsub[q])
                for q in range(sub)
            ]
            if max(bucket_bytes) < (l_bytes + r_bytes):
                # the split separated at least one key: recurse
                ex.grace_recursion_hwm = max(ex.grace_recursion_hwm, depth + 1)
                for q in range(sub):
                    _grace_pair(
                        ex, node, lkeys, rkeys, lsub[q], rsub[q],
                        pair_budget, depth + 1, out_runs,
                    )
                return
        if node.kind == "inner" and node.filter is None:
            # single hot key (re-hashing cannot split it, or the depth
            # cap was hit): every probe chunk joins every build chunk;
            # co-partitioned on one key, so the union is the exact join
            _grace_hot_pair(ex, node, lp, rp, pair_budget, out_runs)
            return
        # an outer or filtered hot pair joins oversized; the high-water
        # mark records the overage
    lpr = lp or [_empty_run(node.left.outputs)]
    rpr = rp or [_empty_run(node.right.outputs)]
    probe = host_concat_to_page(ex, lpr)
    build = host_concat_to_page(ex, rpr)
    joined = ex._equi_join(node, probe, build)
    _note(ex, _page_bytes(joined))
    run = page_to_host(ex._compact(joined))
    if run.n_rows:
        out_runs.append(run)


def _grace_hot_pair(
    ex, node: P.Join, lp: list[HostRun], rp: list[HostRun],
    pair_budget: int, out_runs: list[HostRun],
) -> None:
    """Hot-key pair: both sides chunk to the pair budget and every (probe
    chunk, build chunk) combination joins on the device — a blocked
    nested loop over the one key's rows."""
    ex.grace_hot_pairs += 1
    half = max(pair_budget // 2, 1)

    def chunks(runs, outputs):
        per = row_bytes(outputs)
        target = max(half // max(per, 1), 1024)
        acc: list[HostRun] = []
        acc_rows = 0
        for r in runs:
            acc.append(r)
            acc_rows += r.n_rows
            if acc_rows >= target:
                yield acc, acc_rows
                acc, acc_rows = [], 0
        if acc_rows:
            yield acc, acc_rows

    build_chunks = list(chunks(rp, node.right.outputs))
    for l_runs, _n in chunks(lp, node.left.outputs):
        probe = host_concat_to_page(ex, l_runs)
        for b_runs, _m in build_chunks:
            build = host_concat_to_page(ex, b_runs)
            joined = ex._equi_join(node, probe, build)
            _note(ex, _page_bytes(joined))
            run = page_to_host(ex._compact(joined))
            if run.n_rows:
                out_runs.append(run)
