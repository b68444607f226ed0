"""Single-fragment plan execution over device pages — the port of
``trino_tpu/exec/local.py`` for the TPC-H path.

Each plan node consumes whole device Pages and produces one. Host syncs
happen only at capacity decisions (aggregate overflow flags, join
fan-out, live-row counts), as in the JAX package. Implemented nodes:
TableScan (VARCHAR dictionary- or hash-coded), the fused
Filter/Project/Aggregate/Sort/TopN/Limit chains, inner, LEFT, RIGHT and
FULL equi-Join (dynamic filtering for inner joins, residual filters),
the cross join (chunked through host runs beyond
``cross_join_chunk_rows``),
SemiJoin (IN, NOT IN, EXISTS and NOT EXISTS, with and without a
correlated residual filter, IN with three-valued NULL semantics),
Window (``exec/window.py``), GroupId (grouping sets), Union (INTERSECT
and EXCEPT plan as a union below an aggregate), Exchange, Values and
Output. Every other node type raises NotImplementedError naming it.
PyTorch runs eagerly, so there is no jit cache and no program catalog;
the learned aggregate capacities and filter selectivities are kept per
executor as in the JAX package.

Memory-bounded execution (``exec/spill.py``): under ``hbm_budget_bytes``
a chain over a large scan streams in chunks with a per-chunk PARTIAL and
one FINAL, an inner or left join whose sides exceed the budget becomes a
streamed probe join or a grace-hash join, a semi join over a large
source streams, and a cross join chunks under the budget. With no
budget, an inner or left join whose working set would breach
``query_max_memory_per_node`` is revoked into the same tier with the cap
standing in as the budget. ``max_chunk_rows`` chunks a SINGLE grouped
aggregation over wider pages into PARTIALs and one FINAL.
"""

from __future__ import annotations

import threading

import torch
import numpy as np

from trino_tpu_torch import memory
from trino_tpu_torch import types as T
from trino_tpu_torch.exec import kernels as K
from trino_tpu_torch.exec import shapes, stage
from trino_tpu_torch.expr.compiler import ColumnLayout, compile_expr
from trino_tpu_torch.expr.ir import Call, Cast, InputRef, RowExpression
from trino_tpu_torch.metadata import Metadata, Session
from trino_tpu_torch.page import (
    Column, HashCollision, HashStringPool, Page, StringDictionary,
    pad_capacity, unify_dictionaries,
)
from trino_tpu_torch.plan import nodes as P

__all__ = ["LocalExecutor"]

I64 = torch.int64


def _hash_varchar_column(t, values, valid, capacity, device) -> Column:
    """A hash-coded varchar column: [hash64, source_row_id] lanes and a
    host string pool (one hash pass and a one-time injectivity proof, no
    sorted-dictionary build). On a hash collision, dictionary coding."""
    pool = HashStringPool(values)
    try:
        pool.verify_injective()
    except HashCollision:
        return Column.from_numpy(
            t, values, valid=valid, capacity=capacity, device=device
        )
    n = len(values)
    data = np.zeros((capacity, 2), dtype=np.int64)
    data[:n, 0] = pool.hashes()
    data[:n, 1] = np.arange(n)
    col_valid = None
    if valid is not None:
        v = np.zeros(capacity, dtype=np.bool_)
        v[:n] = valid
        col_valid = torch.from_numpy(v).to(device)
    return Column(t, torch.from_numpy(data).to(device), col_valid, None, pool)


def _scan_column(t, raw, capacity, device, hashed: bool = False) -> Column:
    """One scanned connector value -> device Column. ``raw`` is either a
    host array or a (values, valid) tuple."""
    valid = None
    if isinstance(raw, tuple):
        raw, valid = raw
    if hashed:
        return _hash_varchar_column(
            t, np.asarray(raw, dtype=object), valid, capacity, device
        )
    return Column.from_numpy(
        t, raw, valid=valid, capacity=capacity, device=device
    )


class LocalExecutor:
    """Executes a logical plan tree on one torch device.

    Scanned tables stay resident on the device across queries (the
    per-executor scan cache), so repeated queries pay no host-to-device
    transfer."""

    def __init__(self, metadata: Metadata, session: Session, device):
        self.metadata = metadata
        self.session = session
        self.device = torch.device(device)
        #: (catalog, schema, table) -> {column: Column, "": mask, "#rows": n}
        self._scan_cache: dict = {}
        #: learned per-chain state: ("caps", ...) -> capacities,
        #: ("selectivity", ...) -> fraction of rows a leading filter kept
        self._learned: dict = {}
        #: worker-local memory pool; joins reserve their working set
        self.memory_pool = memory.MemoryPool(
            limit_provider=self._per_node_cap
        )
        self.memory_ctx = self.memory_pool.query_context("adhoc")
        #: joins revoked into the spill tier by memory pressure
        self.memory_revocations = 0
        #: revocation budget in force while a revoked subtree runs (makes
        #: hbm_budget() nonzero so the spill paths chunk under it)
        self._revoked_budget = 0
        #: grace-join counters (exec/spill.py writes these)
        self.grace_recursion_hwm = 0
        self.grace_hot_pairs = 0
        #: (catalog, schema, table, column) -> (StringDictionary, int32
        #: codes): a streamed scan's VARCHAR column, encoded once
        self._chunk_codes: dict = {}
        self._chunk_codes_lock = threading.Lock()

    def hbm_budget(self) -> int:
        """Device-memory budget in bytes (session ``hbm_budget_bytes``;
        0 = resident mode). While a memory-revoked subtree runs, the
        per-node cap stands in as the budget so the whole subtree
        degrades into the spill tier."""
        from trino_tpu_torch import session_properties as SP

        budget = int(SP.get(self.session, "hbm_budget_bytes"))
        return budget or self._revoked_budget

    @property
    def tracked_bytes_hwm(self) -> int:
        """Largest tracked device working set this executor reserved (the
        memory pool's lifetime high-water mark; the budget-tier tests
        assert it stays within hbm_budget_bytes)."""
        return self.memory_pool.peak_bytes

    def chunk_codes(self, node: P.TableScan, cname: str):
        """(StringDictionary, int32 codes) of a VARCHAR column of the
        whole table, computed once per executor: each streamed chunk
        slices its codes, so no chunk sorts strings (the rows are those
        of per-chunk dictionaries)."""
        key = (node.catalog, node.schema, node.table, cname)
        with self._chunk_codes_lock:
            hit = self._chunk_codes.get(key)
            if hit is None:
                raw = self.metadata.connector(node.catalog).scan(
                    node.schema, node.table, [cname]
                )[cname]
                if isinstance(raw, tuple):
                    raw = raw[0]
                hit = StringDictionary.from_strings(raw)
                self._chunk_codes[key] = hit
            return hit

    def _per_node_cap(self) -> int:
        """query_max_memory_per_node in bytes (0 = unlimited)."""
        from trino_tpu_torch import session_properties as SP

        return SP.parse_data_size(
            SP.get(self.session, "query_max_memory_per_node")
        )

    def execute(self, node: P.PlanNode) -> Page:
        if isinstance(node, stage.FUSABLE):
            chain: list[P.PlanNode] = []
            cur = node
            while isinstance(cur, stage.FUSABLE):
                chain.append(cur)
                cur = cur.sources[0]
            if isinstance(cur, P.TableScan):
                budget = self.hbm_budget()
                if budget:
                    from trino_tpu_torch.exec import spill

                    if spill.scan_bytes(self.metadata, cur) > budget // 4:
                        return spill.run_chain_streamed(
                            self, list(reversed(chain)), cur
                        )
            base = self.execute(cur)
            return self._run_chain(list(reversed(chain)), base)
        m = getattr(self, f"_{type(node).__name__}", None)
        if m is None:
            raise NotImplementedError(f"no executor for {type(node).__name__}")
        return m(node)

    # ---- fused pipelines -------------------------------------------------

    @staticmethod
    def _node_key(n: P.PlanNode):
        if isinstance(n, P.Filter):
            return ("F", repr(n.predicate))
        if isinstance(n, P.Project):
            return ("P", tuple((s, repr(e)) for s, e in n.assignments.items()))
        if isinstance(n, P.Aggregate):
            return (
                "A", tuple(n.group_keys),
                tuple(
                    (s, a.name, a.distinct, repr(a.args), repr(a.filter))
                    for s, a in n.aggregates.items()
                ),
                n.step,
                None if n.key_ranges is None else tuple(
                    sorted(n.key_ranges.items())
                ),
            )
        if isinstance(n, (P.Sort, P.TopN)):
            return (
                "S",
                tuple((k.symbol, k.ascending, k.nulls_first) for k in n.keys),
                getattr(n, "count", None),
            )
        if isinstance(n, P.Limit):
            return ("L", n.count, n.offset)
        raise NotImplementedError(type(n).__name__)

    def _run_chain(self, chain: list[P.PlanNode], page: Page) -> Page:
        """Run an operator chain. Grouped aggregations retry with 8x
        larger slot tables when the overflow flag trips; the learned
        capacity persists per chain shape. A selective leading Filter
        over a large page runs (and compacts) first, so the rest of the
        chain works at the smaller capacity."""
        if (
            len(chain) > 1
            and isinstance(chain[0], P.Filter)
            and page.capacity >= (1 << 18)
            and any(
                isinstance(n, (P.Aggregate, P.Sort, P.TopN))
                for n in chain[1:]
            )
        ):
            skey = ("selectivity", self._node_key(chain[0]), page.capacity)
            sel = self._learned.get(skey)
            if sel is None or sel <= 0.5:
                filtered = self._run_chain(chain[:1], page)
                self._learned[skey] = filtered.num_rows() / page.capacity
                return self._run_chain(chain[1:], filtered)
        from trino_tpu_torch import session_properties as SP

        chunk_rows = int(SP.get(self.session, "max_chunk_rows"))
        if chunk_rows > 0 and page.capacity > chunk_rows:
            # only SINGLE grouped aggregations chunk: the FINAL combine
            # over the partial states holds O(distinct keys)
            agg_i = next(
                (
                    i for i, n in enumerate(chain)
                    if isinstance(n, P.Aggregate)
                    and n.group_keys and n.step == "SINGLE"
                ),
                None,
            )
            if (
                agg_i is not None
                and not any(
                    c.distinct for c in chain[agg_i].aggregates.values()
                )
                # every node before it must be row-local: a Limit, Sort
                # or TopN there is global, not per chunk
                and all(
                    isinstance(n, (P.Filter, P.Project))
                    for n in chain[:agg_i]
                )
                and _splittable(chain[agg_i])
            ):
                return self._run_chain_chunked(chain, page, agg_i, chunk_rows)
        caps_key = (
            "caps", tuple(self._node_key(n) for n in chain), page.capacity
        )
        learned = self._learned.get(caps_key)
        if learned is not None:
            caps = {i: list(v) for i, v in learned.items()}
        else:
            caps = stage.plan_capacities(chain, page.capacity)
        while True:
            env, mask, flags, out_layout = self._dispatch_chain(
                chain, page, caps
            )
            # one host sync fetches the overflow flags AND the live count
            synced = torch.stack(
                [K.count_true(mask)]
                + [flags[i].to(I64) for i in sorted(flags)]
            ).cpu().tolist()
            n_live = synced[0]
            overflowed = [
                i for i, v in zip(sorted(flags), synced[1:]) if v
            ]
            if overflowed:
                for i in overflowed:
                    cap, mx = caps[i]
                    if cap >= mx:
                        raise RuntimeError(
                            "aggregation table overflow at max capacity"
                        )
                    caps[i][0] = min(cap * 8, mx)
                self._learned[caps_key] = {
                    i: list(v) for i, v in caps.items()
                }
                continue
            return self._finalize_chain(chain, env, mask, n_live, out_layout)

    def _run_chain_chunked(
        self, chain: list[P.PlanNode], page: Page, agg_i: int, chunk_rows: int
    ) -> Page:
        """Partial-aggregate fixed-size row chunks, concatenate the
        partial states, FINAL-combine (grace aggregation)."""
        from trino_tpu_torch.plan.distribute import _split_aggregate

        partial, final = _split_aggregate(chain[agg_i])
        pre = chain[:agg_i]
        post = chain[agg_i + 1:]
        partials = []
        for lo in range(0, page.capacity, chunk_rows):
            hi = min(lo + chunk_rows, page.capacity)
            partials.append(
                self._run_chain(pre + [partial], _slice_page(page, lo, hi))
            )
        combined = _concat_pages(partials)
        return self._run_chain([final] + post, combined)

    def _dispatch_chain(self, chain, page: Page, caps):
        in_layout = stage.ChainLayout(
            names=list(page.names),
            types={n: c.type for n, c in zip(page.names, page.columns)},
            dicts={n: c.dictionary for n, c in zip(page.names, page.columns)},
            capacity=page.capacity,
            device=self.device,
            pools={
                n: c.hash_pool for n, c in zip(page.names, page.columns)
                if c.hash_pool is not None
            },
        )
        fn, out_layout = stage.build_chain(chain, in_layout, caps)
        env, mask, flags = fn(self._env(page), page.mask)
        return env, mask, flags, out_layout

    def _finalize_chain(self, chain, env, mask, n_live: int, out_layout):
        cols = [
            Column(
                out_layout.types[s], env[s][0], env[s][1],
                out_layout.dicts.get(s), out_layout.pools.get(s),
            )
            for s in out_layout.names
        ]
        out = Page(list(out_layout.names), cols, mask)
        out.known_rows = n_live
        # chains ending in a sort emit live rows first
        out.packed = isinstance(chain[-1], (P.Sort, P.TopN))
        if pad_capacity(out.known_rows) < out.capacity:
            out = self._compact(out)
        return out

    # ---- expression evaluation ------------------------------------------

    def _layout(self, page: Page) -> ColumnLayout:
        return ColumnLayout(
            types={n: c.type for n, c in zip(page.names, page.columns)},
            dictionaries={
                n: c.dictionary for n, c in zip(page.names, page.columns)
            },
            device=self.device,
        )

    def _env(self, page: Page) -> dict:
        return {n: (c.data, c.valid) for n, c in zip(page.names, page.columns)}

    # ---- leaf nodes ------------------------------------------------------

    def _TableScan(self, node: P.TableScan) -> Page:
        if node.split is not None:
            raise NotImplementedError("_TableScan: split scans")
        connector = self.metadata.connector(node.catalog)
        if node.domains and node.assignments and getattr(
            connector, "supports_domains", False
        ):
            raise NotImplementedError("_TableScan: domain-pruned scans")
        if not connector.cacheable:
            cache = {}  # live views re-scan per query
        else:
            cache = self._scan_cache.setdefault(
                (node.catalog, node.schema, node.table), {}
            )
        hashed_syms = set(node.hash_varchar or [])

        # hash-coded and dictionary-coded variants of a column cache
        # under distinct keys (a symbol's encoding is plan-dependent)
        def ckey(sym, cname):
            return f"#hash:{cname}" if sym in hashed_syms else cname

        missing = [
            (s, c) for s, c in node.assignments.items()
            if ckey(s, c) not in cache
        ]
        if missing or "" not in cache:
            cols = connector.scan(
                node.schema, node.table, [c for _, c in missing]
            )
            if missing:
                first = cols[missing[0][1]]
                n = len(first[0] if isinstance(first, tuple) else first)
            else:
                n = connector.row_count(node.schema, node.table)
            cap = shapes.bucket(n)
            if "" not in cache:
                mask = torch.zeros(cap, dtype=torch.bool, device=self.device)
                mask[:n] = True
                cache[""] = mask
            for sym, cname in missing:
                cache[ckey(sym, cname)] = _scan_column(
                    node.outputs[sym], cols[cname], cap, self.device,
                    hashed=sym in hashed_syms,
                )
            cache["#rows"] = n
        names = list(node.assignments)
        columns = [cache[ckey(s, c)] for s, c in node.assignments.items()]
        return Page(
            names, columns, cache[""], known_rows=cache["#rows"], packed=True,
        )

    def _Exchange(self, node: P.Exchange) -> Page:
        # single-device execution: every exchange is the identity
        return self.execute(node.source)

    def _Values(self, node: P.Values) -> Page:
        n = len(node.rows)
        cap = shapes.bucket(max(n, 8))
        mask = torch.zeros(cap, dtype=torch.bool, device=self.device)
        mask[:n] = True
        names, cols = [], []
        for i, (sym, t) in enumerate(node.outputs.items()):
            if isinstance(t, (T.ArrayType, T.MapType, T.RowType)):
                raise NotImplementedError(f"_Values: {t}")
            vals = [r[i] for r in node.rows]
            nulls = np.asarray([v is None for v in vals], dtype=np.bool_)
            filled = [0 if v is None else v for v in vals]
            dictionary = None
            if isinstance(t, T.VarcharType):
                dictionary, codes = StringDictionary.from_strings(
                    np.asarray(
                        ["" if nulls[j] else str(v)
                         for j, v in enumerate(filled)] or [""],
                        dtype=object,
                    )
                )
                data = np.zeros(cap, dtype=np.int32)
                data[:n] = codes[:n]
            elif isinstance(t, T.DecimalType) and t.is_long:
                data = np.zeros((cap, 2), dtype=np.int64)
                iv = np.asarray(filled, dtype=np.int64)
                data[:n, 0] = iv >> 32
                data[:n, 1] = iv & 0xFFFFFFFF
            else:
                data = np.zeros(cap, dtype=t.np_dtype)
                data[:n] = np.asarray(filled, dtype=t.np_dtype)
            valid = None
            if nulls.any():
                v = np.ones(cap, dtype=np.bool_)
                v[:n] = ~nulls
                valid = torch.from_numpy(v).to(self.device)
            names.append(sym)
            cols.append(Column(
                t, torch.from_numpy(data).to(self.device), valid, dictionary
            ))
        return Page(names, cols, mask, known_rows=n, packed=True)

    def _Output(self, node: P.Output) -> Page:
        page = self.execute(node.source)
        cols = [page.column(s) for s in node.symbols]
        return Page(
            list(node.names), cols, page.mask,
            known_rows=page.known_rows, packed=page.packed,
        )

    def _compact(self, page: Page, extra_capacity: int = 0) -> Page:
        """Gather live rows to the front and shrink capacity (Page.compact
        analog). Syncs the count only when the producer did not record
        it."""
        n_live = page.num_rows()
        cap = shapes.bucket(n_live + extra_capacity)
        if page.packed and cap >= page.capacity:
            return page
        limit = cap if cap < page.capacity else page.capacity
        perm = torch.sort(
            (~page.mask).to(torch.int8), stable=True
        ).indices[:limit]
        cols = [
            Column(
                c.type, c.data[perm], None if c.valid is None else c.valid[perm],
                c.dictionary, c.hash_pool,
            )
            for c in page.columns
        ]
        out = Page(list(page.names), cols, page.mask[perm])
        out.known_rows = n_live
        out.packed = True
        return out

    # ---- joins -----------------------------------------------------------

    def _Join(self, node: P.Join) -> Page:
        if node.kind == "right":
            node = P.Join(
                node.outputs, kind="left", left=node.right, right=node.left,
                criteria=[(r, l) for l, r in node.criteria],
                filter=node.filter,
                df_range_keep=None, df_keep_frac=None,
            )
        if node.kind != "cross" and (
            node.kind not in ("inner", "left", "full") or not node.criteria
        ):
            raise NotImplementedError(
                f"_Join: {node.kind} join"
                + ("" if node.criteria else " without equi-criteria")
            )
        budget = self.hbm_budget()
        revocable = node.kind in ("inner", "left") and bool(node.criteria)
        if budget and revocable:
            plan = self._plan_budget_join(node, budget)
            if plan is not None:
                return plan
        if not budget and revocable:
            plan = self._maybe_revoke_join(node)
            if plan is not None:
                return plan
        left = self._compact(self.execute(node.left))
        right = self._compact(self.execute(node.right))
        if node.kind == "cross":
            return self._cross_join(node, left, right)
        try:
            return self._equi_join(node, left, right)
        except memory.ExceededMemoryLimitError:
            # reactive revocation: the resident working set (padded
            # capacities) breached the per-node cap although the
            # live-row estimate fit. The failed reserve recorded
            # nothing, so the join re-plans through the spill tier.
            if budget or not revocable:
                raise
            plan = self._maybe_revoke_join(node, force=True)
            if plan is None:
                raise
            return plan

    def _plan_budget_join(self, node: P.Join, budget: int) -> Page | None:
        """Memory-scaled join strategies: a streamed probe against a
        resident build when only the probe exceeds the budget's slab,
        grace-hash partitioning when the build does. None when the
        resident path fits."""
        from trino_tpu_torch.exec import spill

        l_bytes = spill.est_output_bytes(self, node.left)
        r_bytes = spill.est_output_bytes(self, node.right)
        slab = budget // 4
        if l_bytes <= slab and r_bytes <= slab:
            return None
        probe_chain, probe_scan = self._streamable(node.left)
        if l_bytes > slab and r_bytes <= slab and probe_scan is not None:
            build = self._compact(self.execute(node.right))
            return spill.streamed_probe_join(
                self, node, probe_chain, probe_scan, build
            )
        # grace-hash handles inner AND left joins: each partition pair
        # covers its key range alone, so an unmatched probe row is
        # emitted exactly once
        return spill.grace_join(self, node)

    def _maybe_revoke_join(self, node: P.Join, force: bool = False) -> Page | None:
        """Memory revocation: with no session budget, a hash join whose
        estimated resident working set would breach
        query_max_memory_per_node switches into the spill tier — the cap
        standing in as the budget for the whole subtree — instead of
        failing at reservation. ``force`` skips the estimate (the
        reactive path, after a resident reserve raised). Only when even
        the revoked path cannot fit does the pool raise."""
        cap = self.memory_pool.limit_bytes()
        if not cap:
            return None
        from trino_tpu_torch.exec import spill

        est = (
            spill.est_output_bytes(self, node.left)
            + spill.est_output_bytes(self, node.right)
            + spill.est_output_bytes(self, node)
        )
        if not force and est <= max(cap - self.memory_pool.reserved_bytes, 0):
            return None
        prev = self._revoked_budget
        self._revoked_budget = cap
        try:
            plan = self._plan_budget_join(node, cap)
            if plan is not None:
                self.memory_revocations += 1
                spill.ENTRIES["revocations"] += 1
            return plan
        finally:
            self._revoked_budget = prev

    @staticmethod
    def _streamable(node: P.PlanNode):
        """(chain, scan) when the subtree is a chain of row-local
        operators over a TableScan — the shape the chunked scan can
        stream; (None, None) otherwise. Aggregates reduce cardinality
        and stream on their own through execute(); a Limit, TopN or Sort
        is global, and per-chunk copies concatenated would drop its
        truncation."""
        chain: list[P.PlanNode] = []
        cur = node
        while isinstance(cur, stage.FUSABLE):
            chain.append(cur)
            cur = cur.sources[0]
        if isinstance(cur, P.TableScan):
            if any(
                isinstance(n, (P.Aggregate, P.Limit, P.TopN, P.Sort))
                for n in chain
            ):
                return None, None
            return list(reversed(chain)), cur
        return None, None

    def _cross_join(self, node: P.Join, left: Page, right: Page) -> Page:
        """Every (left row, right row) pair of two compacted pages, at a
        bucketed capacity: output position j pairs left row j // n_r with
        right row j % n_r. Beyond ``cross_join_chunk_rows`` output rows
        (or the budget's slab) the larger side is chunked and the pieces
        spill to host runs."""
        from trino_tpu_torch import session_properties as SP

        n_l, n_r = left.num_rows(), right.num_rows()
        limit = int(SP.get(self.session, "cross_join_chunk_rows"))
        budget = self.hbm_budget()
        if budget:
            from trino_tpu_torch.exec import spill

            limit = min(
                limit,
                max(
                    (budget // spill.CHUNK_BUDGET_FRACTION)
                    // spill.row_bytes(node.outputs),
                    1 << 16,
                ),
            )
        if n_l * n_r > limit and max(n_l, n_r) > 1:
            return self._cross_join_chunked(node, left, right, limit)
        cap = shapes.bucket(max(n_l * n_r, 1))
        j = torch.arange(cap, dtype=I64, device=self.device)
        li = (j // max(n_r, 1)).clamp(0, max(left.capacity - 1, 0))
        ri = (j % max(n_r, 1)).clamp(0, max(right.capacity - 1, 0))
        names, cols = [], []
        for page, idx in ((left, li), (right, ri)):
            for nm, c in zip(page.names, page.columns):
                names.append(nm)
                cols.append(Column(
                    c.type, c.data[idx],
                    None if c.valid is None else c.valid[idx],
                    c.dictionary, c.hash_pool,
                ))
        return Page(names, cols, j < n_l * n_r, known_rows=n_l * n_r, packed=True)

    def _cross_join_chunked(self, node: P.Join, left: Page, right: Page,
                            limit: int) -> Page:
        """The chunked cross join: the LARGER side in row ranges (chunking
        the left against a right that alone exceeds the limit would
        recurse with one-row chunks forever), each piece's pairs spilled
        to a host run, the runs concatenated once."""
        from trino_tpu_torch.exec import spill

        spill.ENTRIES["chunked_cross_join"] += 1
        n_l, n_r = left.num_rows(), right.num_rows()
        chunk_left = n_l >= n_r
        n_big = n_l if chunk_left else n_r
        n_other = n_r if chunk_left else n_l
        rows_per = max(limit // max(n_other, 1), 1)
        runs = []
        for lo in range(0, n_big, rows_per):
            hi = min(lo + rows_per, n_big)
            if chunk_left:
                out = self._cross_join(
                    node, self._compact(_slice_page(left, lo, hi)), right,
                )
            else:
                out = self._cross_join(
                    node, left, self._compact(_slice_page(right, lo, hi)),
                )
            run = spill.page_to_host(self._compact(out))
            if run.n_rows:
                runs.append(run)
        if not runs:
            runs = [spill._empty_run(node.outputs)]
        return spill.host_concat_to_page(self, runs)

    def _unify_join_dicts(self, probe: Page, build: Page, criteria):
        """Remap VARCHAR key pairs onto shared dictionaries. Hash-coded
        pairs need no remap (hash codes are global) but must pass the
        cross-pool injectivity proof."""
        for lsym, rsym in criteria:
            pc, bc = probe.column(lsym), build.column(rsym)
            if pc.hash_pool is not None and bc.hash_pool is not None:
                pc.hash_pool.verify_joinable(bc.hash_pool)
                continue
            if pc.hash_pool is not None or bc.hash_pool is not None:
                raise NotImplementedError(
                    "join between hash-coded and dictionary-coded varchar "
                    "(the planner co-encodes join pairs)"
                )
            if pc.dictionary is not None or bc.dictionary is not None:
                pc2, bc2 = unify_dictionaries(pc, bc)
                probe.columns[probe.names.index(lsym)] = pc2
                build.columns[build.names.index(rsym)] = bc2

    @staticmethod
    def _join_keys(probe: Page, build: Page, criteria):
        """Combined u64 keys (in int64) for probe/build sides.

        Single fixed-width key -> exact; multi-column (including
        two-limb decimal keys) -> hash-combined and ``verify`` is True
        (matches re-checked after expansion). A hash-coded varchar key
        contributes its hash lane only (the id lane is row identity)."""
        pv = bv = None
        p_parts: list = []
        b_parts: list = []
        for l, r in criteria:
            pc, bc = probe.column(l), build.column(r)
            pv = _and_mask(pv, pc.valid)
            bv = _and_mask(bv, bc.valid)
            if pc.hash_pool is not None:
                p_parts.append(pc.data[:, 0])
                b_parts.append(bc.data[:, 0])
            else:
                p_parts.extend(K.limb_parts(pc.data))
                b_parts.extend(K.limb_parts(bc.data))
        if len(p_parts) == 1:
            pk, _ = K.normalize_key(p_parts[0], None)
            bk, _ = K.normalize_key(b_parts[0], None)
            verify = False
        else:
            pk = K.hash_keys([(d, None) for d in p_parts])
            bk = K.hash_keys([(d, None) for d in b_parts])
            verify = True
        pairs = list(zip(p_parts, b_parts))
        return pk, bk, pv, bv, pairs, verify

    #: probes below this skip dynamic filtering
    DF_MIN_PROBE = 1 << 17
    #: apply the filter only when it drops at least this fraction
    DF_MIN_DROP = 0.3

    def _df_pairs(self, criteria, probe: Page, build: Page):
        """Criteria usable for min/max dynamic filtering: plain integer
        domains."""
        pairs = []
        for ls, rs in criteria:
            pc, bc = probe.column(ls), build.column(rs)
            if pc.dictionary is not None or bc.dictionary is not None:
                continue
            if pc.data.dim() != 1:
                continue
            if pc.data.dtype.is_floating_point or pc.data.dtype == torch.bool:
                continue
            pairs.append((ls, rs))
        return pairs

    def _dynamic_filter(self, node: P.Join, probe: Page, build: Page) -> Page:
        """Prune probe rows whose key lies outside the build side's key
        range (inner joins only; gated by the planner's df_range_keep
        hint, as in the JAX package)."""
        from trino_tpu_torch import session_properties as SP

        if not SP.get(self.session, "dynamic_filtering_enabled"):
            return probe
        if node.kind != "inner" or probe.capacity < self.DF_MIN_PROBE:
            return probe
        if node.df_range_keep is None or node.df_range_keep > 0.7:
            return probe
        pairs = self._df_pairs(node.criteria, probe, build)
        if not pairs:
            return probe
        benv, penv = self._env(build), self._env(probe)
        keep = probe.mask
        for l, r in pairs:
            d, v = benv[r]
            live = build.mask if v is None else (build.mask & v)
            info = torch.iinfo(d.dtype)
            lo = torch.where(live, d, info.max).min()
            hi = torch.where(live, d, info.min).max()
            pd, pvd = penv[l]
            keep = keep & (pd >= lo) & (pd <= hi)
            if pvd is not None:
                keep = keep & pvd
        in_rows = probe.num_rows()
        kept = int(K.count_true(keep))
        if kept > (1.0 - self.DF_MIN_DROP) * in_rows:
            return probe
        filtered = Page(
            list(probe.names), list(probe.columns), keep, known_rows=kept,
        )
        return self._compact(filtered)

    def _join_count(self, criteria, probe: Page, build: Page):
        """Join phase A: build sort, per-probe match ranges and the one
        host sync that picks the output capacity (the build-side
        barrier). Returns (order, lo, cnt, total, pairs, verify)."""
        pk, bk, pv, bv, pairs, verify = self._join_keys(probe, build, criteria)
        probe_live = probe.mask if pv is None else (probe.mask & pv)
        build_live = build.mask if bv is None else (build.mask & bv)
        order, lo, cnt = K.join_ranges(bk, build_live, pk, probe_live)
        total = int(K.blocked_sum(cnt))
        return order, lo, cnt, total, pairs, verify

    @staticmethod
    def _expand_verified(order, lo, cnt, out_cap, pairs, verify):
        """Join phase B's expansion: (probe_idx, build_idx, out_live),
        with hash-combined keys re-checked part by part."""
        probe_idx, build_idx, out_live = K.expand_matches(
            order, lo, cnt, out_cap
        )
        if verify:
            for pd, bd in pairs:
                pb, _ = K.normalize_key(pd, None)
                bb, _ = K.normalize_key(bd, None)
                out_live = out_live & (pb[probe_idx] == bb[build_idx])
        return probe_idx, build_idx, out_live

    def _equi_join(self, node: P.Join, probe: Page, build: Page) -> Page:
        self._unify_join_dicts(probe, build, node.criteria)
        probe = self._dynamic_filter(node, probe, build)
        penv, benv = self._env(probe), self._env(build)
        order, lo, cnt, total, pairs, verify = self._join_count(
            node.criteria, probe, build
        )
        out_cap = shapes.bucket(max(total, 1))
        out_row = sum(
            (2 if (probe if s in probe.names else build)
             .column(s).data.dim() == 2 else 1) * 8
            for s in node.outputs
        )
        working_set = (
            _page_dev_bytes(probe) + _page_dev_bytes(build)
            + out_cap * (out_row + 8)
        )
        ctx = self.memory_ctx.child("join")
        ctx.reserve(working_set)
        ctx.free(working_set)
        # phase B: expansion, verification, gathers, residual filter
        probe_idx, build_idx, out_live = self._expand_verified(
            order, lo, cnt, out_cap, pairs, verify
        )
        probe_names = set(probe.names)
        inner, metas = {}, []
        for sym in node.outputs:
            from_probe = sym in probe_names
            c = (probe if from_probe else build).column(sym)
            idx = probe_idx if from_probe else build_idx
            inner[sym] = (c.data[idx], None if c.valid is None else c.valid[idx])
            metas.append((sym, from_probe, c))
        if node.filter is not None:
            filter_c = compile_expr(
                node.filter, _pair_layout(probe, build, self.device)
            )
            fenv = _gather_pair_env(
                penv, benv, probe_names, sorted(_expr_symbols(node.filter)),
                probe_idx, build_idx, base=inner,
            )
            fd, fv = filter_c.fn(fenv)
            out_live = out_live & (fd if fv is None else (fd & fv))
        # outer joins: unmatched rows follow as full-size sections with
        # NULLs for the far side (no data-dependent capacity, no sync)
        sections = {sym: [inner[sym]] for sym, _, _ in metas}
        masks = [out_live]
        if node.kind in ("left", "full"):
            matched = K.range_any(cnt, out_live)
            for sym, from_probe, c in metas:
                sections[sym].append(
                    penv[sym] if from_probe
                    else _null_section(c.data, probe.capacity)
                )
            masks.append(probe.mask & ~matched)
        if node.kind == "full":
            bmatched = K.scatter_any(build_idx, out_live, build.capacity)
            for sym, from_probe, c in metas:
                sections[sym].append(
                    _null_section(c.data, build.capacity) if from_probe
                    else benv[sym]
                )
            masks.append(build.mask & ~bmatched)
        cols = [
            Column(
                c.type, *_concat_sections(sections[sym]), c.dictionary,
                c.hash_pool,
            )
            for sym, _, c in metas
        ]
        mask = masks[0] if len(masks) == 1 else torch.cat(masks)
        out = Page([sym for sym, _, _ in metas], cols, mask)
        if node.kind == "inner" and node.filter is None and len(node.criteria) == 1:
            # exact single-key expansion emits matches as a dense prefix
            out.known_rows = total
            out.packed = True
        return out

    # ---- window / set operations -----------------------------------------

    def _GroupId(self, node: P.GroupId) -> Page:
        """Replicate the input once per grouping set with NULLed
        non-member keys and a BIGINT set-id column: one concatenation of
        k masked copies, padded to the capacity bucket; the aggregation
        above runs over the result."""
        src = self.execute(node.source)
        k = len(node.grouping_sets)
        in_cap = src.capacity
        out_cap = shapes.bucket(k * in_cap)
        keyed = set(s for st in node.grouping_sets for s in st)
        pad = out_cap - k * in_cap
        dev = self.device

        def tile(pieces, fill):
            if pad:
                pieces = pieces + [torch.full(
                    (pad,) + tuple(pieces[0].shape[1:]), fill,
                    dtype=pieces[0].dtype, device=dev,
                )]
            return torch.cat(pieces)

        names, cols = [], []
        for name, col in zip(src.names, src.columns):
            if name in keyed:
                valid_full = (
                    col.valid if col.valid is not None
                    else torch.ones(in_cap, dtype=torch.bool, device=dev)
                )
                none = torch.zeros(in_cap, dtype=torch.bool, device=dev)
                valid = tile(
                    [valid_full if name in st else none
                     for st in node.grouping_sets],
                    False,
                )
            else:
                valid = (
                    None if col.valid is None else tile([col.valid] * k, False)
                )
            names.append(name)
            cols.append(Column(
                col.type, tile([col.data] * k, 0), valid, col.dictionary,
                col.hash_pool,
            ))
        names.append(node.id_symbol)
        cols.append(Column(T.BIGINT, tile(
            [torch.full((in_cap,), i, dtype=I64, device=dev) for i in range(k)],
            0,
        )))
        mask = tile([src.mask] * k, False)
        return Page(names, cols, mask, known_rows=src.num_rows() * k)

    def _Window(self, node: P.Window) -> Page:
        """Run the window program over the source page and append one
        column per window function. Building the program is host work of
        microseconds (PyTorch runs eagerly), so nothing is cached."""
        from trino_tpu_torch.exec.window import build_window_program

        page = self.execute(node.source)
        hashed = frozenset(
            n for n, c in zip(page.names, page.columns)
            if c.hash_pool is not None
        )
        fn, out_meta = build_window_program(
            node,
            {n: c.type for n, c in zip(page.names, page.columns)},
            {n: c.dictionary for n, c in zip(page.names, page.columns)},
            page.capacity, hashed,
        )
        env2 = fn(self._env(page), page.mask)
        names = list(page.names)
        cols = list(page.columns)
        for sym, t, d in out_meta:
            names.append(sym)
            cols.append(Column(t, *env2[sym], d))
        return Page(
            names, cols, page.mask,
            known_rows=page.known_rows, packed=page.packed,
        )

    def _Union(self, node: P.Union) -> Page:
        """Concatenate the branches' pages. VARCHAR dictionaries merge per
        output column (one sorted dictionary, each branch remapped by a
        gather); hash-coded VARCHAR cannot merge and raises."""
        from trino_tpu_torch.exec.aggregates import _limb_encode
        from trino_tpu_torch.page import _remap

        pages = [self.execute(s) for s in node.all_sources]
        for sym, src_syms in node.symbol_map.items():
            cols = [p.column(s) for p, s in zip(pages, src_syms)]
            if any(c.hash_pool is not None for c in cols):
                raise NotImplementedError(
                    "hash-coded varchar columns cannot merge across "
                    "UNION branches (no shared dictionary)"
                )
            if any(c.dictionary is not None for c in cols):
                # a branch without a dictionary (typed NULL literals, a
                # global grouping set's NULLed keys) has an empty one
                empty = np.asarray([], dtype=object)
                merged = StringDictionary(np.unique(np.concatenate([
                    c.dictionary.values if c.dictionary is not None else empty
                    for c in cols
                ])))
                for p, s, c in zip(pages, src_syms, cols):
                    vals = (
                        c.dictionary.values if c.dictionary is not None
                        else empty
                    )
                    remap = np.searchsorted(merged.values, vals).astype(np.int32)
                    p.columns[p.names.index(s)] = _remap(c, remap, merged)
        names, cols = [], []
        for sym, src_syms in node.symbol_map.items():
            parts = [
                (p.column(s).data, p.column(s).valid)
                for p, s in zip(pages, src_syms)
            ]
            out_t = node.outputs[sym]
            if isinstance(out_t, T.DecimalType) and out_t.is_long:
                # a branch may carry the column 1-D (typed NULL literals,
                # short-encoded values): widen it to two limbs
                parts = [
                    (d if d.dim() == 2 else _limb_encode(d.to(I64)), v)
                    for d, v in parts
                ]
            data, valid = _concat_sections(parts)
            ref = pages[0].column(src_syms[0])
            names.append(sym)
            cols.append(Column(out_t, data, valid, ref.dictionary))
        mask = torch.cat([p.mask for p in pages])
        out = Page(names, cols, mask)
        if all(p.known_rows is not None for p in pages):
            out.known_rows = sum(p.known_rows for p in pages)
        return out

    # ---- semi join -------------------------------------------------------

    def _SemiJoin(self, node: P.SemiJoin) -> Page:
        budget = self.hbm_budget()
        if budget:
            from trino_tpu_torch.exec import spill

            src_chain, src_scan = self._streamable(node.source)
            if (
                src_scan is not None
                and spill.est_output_bytes(self, node.source) > budget // 4
                and spill.est_output_bytes(self, node.filter_source)
                <= budget // 4
            ):
                filt = self._compact(self.execute(node.filter_source))
                return spill.streamed_semi_join(
                    self, node, src_chain, src_scan, filt
                )
        source = self.execute(node.source)
        filt = self._compact(self.execute(node.filter_source))
        return self._semi_join_pages(node, source, filt)

    def _semi_join_pages(self, node: P.SemiJoin, source: Page, filt: Page) -> Page:
        self._unify_join_dicts(source, filt, node.keys)
        pv = bv = None
        for lsym, rsym in node.keys:
            pv = _and_mask(pv, source.column(lsym).valid)
            bv = _and_mask(bv, filt.column(rsym).valid)
        if len(node.keys) > 1 or node.filter is not None:
            # semiB: expand, verify, residual filter, then K5 per probe
            order, lo, cnt, total, pairs, verify = self._join_count(
                node.keys, source, filt
            )
            out_cap = shapes.bucket(max(total, 1))
            probe_idx, build_idx, out_live = self._expand_verified(
                order, lo, cnt, out_cap, pairs, verify
            )
            if node.filter is not None:
                filter_c = compile_expr(
                    node.filter, _pair_layout(source, filt, self.device)
                )
                fenv = _gather_pair_env(
                    self._env(source), self._env(filt), set(source.names),
                    sorted(_expr_symbols(node.filter)), probe_idx, build_idx,
                )
                fd, fv = filter_c.fn(fenv)
                out_live = out_live & (fd if fv is None else (fd & fv))
            matched = K.range_any(cnt, out_live)
        else:
            # semiA: single exact key, no filter: K3's counts suffice
            pk, bk, pv2, bv2, _, _ = self._join_keys(source, filt, node.keys)
            probe_live = source.mask if pv2 is None else (source.mask & pv2)
            build_live = filt.mask if bv2 is None else (filt.mask & bv2)
            _, _, cnt = K.join_ranges(bk, build_live, pk, probe_live)
            matched = cnt > 0
        valid = None
        if node.null_aware and filt.num_rows() == 0:
            # x IN (empty) is FALSE, even for NULL x (and NOT IN TRUE):
            # the 3VL valid mask must not apply over an empty build side
            pass
        elif node.null_aware:
            # IN 3VL: a NULL probe key with a nonempty (per-probe) set, or
            # no match while the set holds NULLs, is NULL. EXISTS is
            # two-valued.
            build_null_for = self._in_build_nulls(node, source, filt, bv)
            if pv is not None or build_null_for is not None:
                valid = torch.ones_like(matched)
                if build_null_for is not None:
                    valid = valid & (matched | ~build_null_for)
                if pv is not None:
                    if node.filter is None:
                        # the set is the whole (nonempty) build side
                        valid = valid & pv
                    else:
                        # a NULL probe key is FALSE, not NULL, when its
                        # correlated set filters down to empty
                        nonempty = self._correlated_nonempty(
                            node, source, filt, pv
                        )
                        valid = valid & (pv | ~nonempty)
        return Page(
            list(source.names) + [node.match_symbol],
            list(source.columns) + [Column(T.BOOLEAN, matched, valid, None)],
            source.mask, known_rows=source.known_rows, packed=source.packed,
        )

    def _in_build_nulls(self, node: P.SemiJoin, source: Page, filt: Page, bv):
        """Per-probe "the build side contributed a NULL key" vector for
        IN 3VL, or None when no NULL keys exist. With a correlated
        residual filter only NULL-key build rows that pass the filter
        against that probe row count."""
        if bv is None:
            return None
        null_rows = torch.nonzero(filt.mask & ~bv).reshape(-1).tolist()
        if not null_rows:
            return None
        cap = source.capacity
        if node.filter is None:
            return torch.ones(cap, dtype=torch.bool, device=self.device)
        any_null = torch.zeros(cap, dtype=torch.bool, device=self.device)
        probe_idx = torch.arange(cap, dtype=I64, device=self.device)
        for r in null_rows:
            build_idx = torch.full((cap,), r, dtype=I64, device=self.device)
            pair = _gather_pair_page(
                source, filt, probe_idx, build_idx, source.mask
            )
            fd, fv = self._eval(pair, node.filter)
            any_null = any_null | (fd if fv is None else (fd & fv))
        return any_null

    def _correlated_nonempty(self, node: P.SemiJoin, source: Page, filt: Page, pv):
        """Per-probe "some live build row passes the residual filter"
        vector: a correlated IN's per-probe set is empty when none does.
        Only NULL-key probe rows need it, so loop over those (usually
        few), evaluating the filter against the whole build page."""
        nonempty = torch.zeros(
            source.capacity, dtype=torch.bool, device=self.device
        )
        need = torch.nonzero(source.mask & ~pv).reshape(-1).tolist()
        build_idx = torch.arange(filt.capacity, dtype=I64, device=self.device)
        for i in need:
            probe_idx = torch.full(
                (filt.capacity,), i, dtype=I64, device=self.device
            )
            pair = _gather_pair_page(
                source, filt, probe_idx, build_idx, filt.mask
            )
            fd, fv = self._eval(pair, node.filter)
            passes = fd if fv is None else (fd & fv)
            nonempty[i] = bool((passes & filt.mask).any())
        return nonempty

    def _eval(self, page: Page, expr: RowExpression):
        """Evaluate one expression over a page; (data, valid) broadcast
        to the page capacity."""
        data, valid = compile_expr(expr, self._layout(page)).fn(self._env(page))
        cap = page.capacity
        if data.dim() == 0:
            data = data.expand(cap)
        if valid is not None and valid.dim() == 0:
            valid = valid.expand(cap)
        return data, valid


def _gather_pair_page(probe: Page, build: Page, probe_idx, build_idx, live) -> Page:
    """The (probe row, build row) pairs at the given indices as one page."""
    names, cols = [], []
    for page, idx in ((probe, probe_idx), (build, build_idx)):
        for n, c in zip(page.names, page.columns):
            names.append(n)
            cols.append(Column(
                c.type, c.data[idx],
                None if c.valid is None else c.valid[idx], c.dictionary,
                c.hash_pool,
            ))
    return Page(names, cols, live)


def _gather_pair_env(penv, benv, probe_names, syms, probe_idx, build_idx, base=None):
    """Expanded-pair environment for the given symbols."""
    fenv = dict(base or {})
    for sym in syms:
        if sym not in fenv:
            from_probe = sym in probe_names
            d, v = (penv if from_probe else benv)[sym]
            idx = probe_idx if from_probe else build_idx
            fenv[sym] = (d[idx], None if v is None else v[idx])
    return fenv


def _null_section(like: torch.Tensor, rows: int):
    """An all-NULL (data, valid) section of ``rows`` rows, keeping the
    trailing lanes of ``like`` (two-limb decimals stay [rows, 2])."""
    return (
        torch.zeros((rows,) + tuple(like.shape[1:]), dtype=like.dtype,
                    device=like.device),
        torch.zeros(rows, dtype=torch.bool, device=like.device),
    )


def _concat_sections(parts):
    """Concatenate (data, valid|None) sections; None = all-valid."""
    if len(parts) == 1:
        return parts[0]
    data = torch.cat([d for d, _ in parts])
    if all(v is None for _, v in parts):
        return data, None
    valids = [
        torch.ones(d.shape[0], dtype=torch.bool, device=d.device)
        if v is None else v
        for d, v in parts
    ]
    return data, torch.cat(valids)


def _splittable(agg: P.Aggregate) -> bool:
    """Whether the aggregation has a PARTIAL/FINAL split, probed before
    any chunk runs so that no computed partial is thrown away."""
    from trino_tpu_torch.plan.distribute import _split_aggregate

    try:
        _split_aggregate(agg)
        return True
    except NotImplementedError:
        return False


def _slice_page(page: Page, lo: int, hi: int) -> Page:
    """Row-range view of a page (tensor slices are views)."""
    cols = [
        Column(
            c.type, c.data[lo:hi],
            None if c.valid is None else c.valid[lo:hi],
            c.dictionary, c.hash_pool,
        )
        for c in page.columns
    ]
    return Page(list(page.names), cols, page.mask[lo:hi])


def _concat_pages(pages: list[Page]) -> Page:
    """Concatenate same-layout pages (chunk partials share column types
    and dictionaries by construction)."""
    if len(pages) == 1:
        return pages[0]
    first = pages[0]
    cols = []
    for i, c in enumerate(first.columns):
        data, valid = _concat_sections(
            [(p.columns[i].data, p.columns[i].valid) for p in pages]
        )
        cols.append(Column(c.type, data, valid, c.dictionary, c.hash_pool))
    mask = torch.cat([p.mask for p in pages])
    return Page(list(first.names), cols, mask)


def _page_dev_bytes(page: Page) -> int:
    """Device bytes of a page's tensors (mask + data + valids)."""
    total = page.mask.shape[0]
    for c in page.columns:
        total += c.data.numel() * c.data.element_size()
        if c.valid is not None:
            total += c.valid.shape[0]
    return total


def _pair_layout(a: Page, b: Page, device) -> ColumnLayout:
    """Expression layout over the columns of two pages (for residual
    join filters evaluated on matched pairs)."""
    return ColumnLayout(
        types={
            **{n: c.type for n, c in zip(a.names, a.columns)},
            **{n: c.type for n, c in zip(b.names, b.columns)},
        },
        dictionaries={
            **{n: c.dictionary for n, c in zip(a.names, a.columns)},
            **{n: c.dictionary for n, c in zip(b.names, b.columns)},
        },
        device=device,
    )


def _expr_symbols(e: RowExpression) -> set[str]:
    """Free input symbols of an expression tree."""
    out: set[str] = set()
    stack = [e]
    while stack:
        x = stack.pop()
        if isinstance(x, InputRef):
            out.add(x.name)
        elif isinstance(x, Call):
            stack.extend(x.args)
        elif isinstance(x, Cast):
            stack.append(x.arg)
    return out


def _and_mask(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b
