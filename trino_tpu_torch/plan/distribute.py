"""Distribution planning — the port of ``trino_tpu/plan/distribute.py``:
turn a single-node logical plan into a mesh-distributed plan.

The analog of the reference's exchange placement + fragmentation
(AddExchanges, MAIN/sql/planner/optimizations/AddExchanges.java:142;
PlanFragmenter, MAIN/sql/planner/PlanFragmenter.java:91), collapsed
into one bottom-up pass suited to a batch-synchronous SPMD engine:

- every node is assigned a distribution property: ``dist`` (rows
  sharded over the mesh) or ``single`` (one ordinary device page);
- grouped aggregations over distributed inputs split into a shard-local
  PARTIAL step, a hash ``Exchange`` on the group keys and a FINAL
  combine step (``_split_aggregate``: the reference's partial/final
  accumulator steps);
- TopN/Limit split into shard-local partials and a gathered final;
  ORDER BY range-partitions on its first key and gathers in order;
- joins get a ``distribution``: BROADCAST (build side replicated to
  every shard) when the build side is estimated small, else PARTITIONED
  (both sides hash-exchanged on the join keys inside the executor, so
  varchar join keys hash on unified dictionary codes);
- ``Exchange(single)`` marks the gather boundary; above it the plan
  runs on the ordinary local executor.

The chunked tier (``exec/spill.py``, the executor's ``max_chunk_rows``
branch) uses ``_split_aggregate`` too: a chunk is to the budget what a
shard is to the mesh.
"""

from __future__ import annotations

from dataclasses import replace as dc_replace

from trino_tpu_torch import types as T
from trino_tpu_torch.exec.aggregates import VARIANCE_FNS
from trino_tpu_torch.expr.ir import AggCall, Call, Cast, InputRef
from trino_tpu_torch.metadata import Metadata, Session
from trino_tpu_torch.plan import nodes as P
from trino_tpu_torch.plan import stats as S

__all__ = ["add_exchanges", "fragment_saltable", "_split_aggregate"]

#: builds beyond this many rows never broadcast regardless of the cost
#: model — each shard must hold a full replica in HBM (session
#: property ``broadcast_join_row_limit`` overrides)
DEFAULT_BROADCAST_ROW_LIMIT = 2_000_000


def fragment_saltable(root: P.PlanNode) -> tuple[bool, str]:
    """Whether a stage fragment may legally run SALTED — i.e. with one
    hot input partition split row-wise across salt tasks (the other
    aligned inputs replicated to every salt) and the sub-results simply
    unioned by the downstream exchange.

    A row split of one input distributes over filters, projections,
    inner joins (the replicated side sees every row), and PARTIAL
    aggregates (partials merge in the consumer's FINAL step) — exactly
    the operator set ``add_exchanges`` leaves inside a partitioned-join
    fragment. It does NOT distribute over outer/semi joins (preserved
    or marked rows would duplicate across salts), FINAL/SINGLE
    aggregates, window functions, or order/count-sensitive operators.
    Returns ``(ok, reason)`` with ``reason`` naming the first blocking
    operator."""
    verdict: list = [True, ""]
    seen: set[int] = set()

    def flag(msg: str) -> None:
        if verdict[0]:
            verdict[0], verdict[1] = False, msg

    def walk(n: P.PlanNode) -> None:
        if id(n) in seen:
            return
        seen.add(id(n))
        if isinstance(n, P.Join):
            if n.kind != "inner":
                flag(
                    f"{n.kind} join does not distribute over a row "
                    f"split of one input"
                )
        elif isinstance(n, P.Aggregate):
            if n.step != "PARTIAL":
                flag(
                    f"{n.step} aggregate does not merge across salted "
                    f"sub-partitions"
                )
        elif isinstance(n, (P.Sort, P.TopN)):
            flag("order-sensitive operator above the salted exchange")
        elif isinstance(n, P.Limit):
            flag("count-sensitive Limit above the salted exchange")
        elif isinstance(n, P.Window):
            flag("window functions require whole partitions")
        elif isinstance(n, P.SemiJoin):
            flag("semi-join marks do not merge across salted "
                 "sub-partitions")
        for s in n.sources:
            walk(s)

    walk(root)
    return bool(verdict[0]), str(verdict[1])


class _Ctx:
    """Distribution-planning context: metadata + mesh shape + session
    knobs + a shared stats cache."""

    def __init__(self, metadata: Metadata, n_shards: int, session):
        self.md = metadata
        self.n_shards = max(int(n_shards), 2)
        from trino_tpu_torch import session_properties as SP

        self.mode = str(
            SP.get(session, "join_distribution_type")
        ).upper()
        self.broadcast_limit = float(
            SP.get(session, "broadcast_join_row_limit")
        )
        self.stats_cache: dict = {}
        #: writer stages may fan out (hash / round-robin) only when the
        #: executor can run non-single exchanges host-side (fleet); a
        #: real device mesh gathers below the writer instead
        self.scaled_writers = False

    def rows(self, node: P.PlanNode) -> float:
        return S.estimate(node, self.md, self.stats_cache).rows

    def should_broadcast(self, probe: P.PlanNode, build: P.PlanNode) -> bool:
        """DetermineJoinDistributionType analog, with the exchange cost
        model of the collective fabric: PARTITIONED all_to_alls both
        sides once (cost ~ probe + build rows); BROADCAST all_gathers
        the build to every shard (cost ~ build * n_shards) and leaves
        the probe in place. Broadcast also removes a probe-side
        repartition ahead of downstream aggregations, so ties favor
        it."""
        if self.mode == "BROADCAST":
            return True
        if self.mode == "PARTITIONED":
            return False
        build_rows = self.rows(build)
        if build_rows > self.broadcast_limit:
            return False
        # an out-of-core storage probe must not be repartitioned: a
        # hash exchange materializes the WHOLE table through the spool
        # — exactly what streamed split-granular scans exist to avoid.
        # Replicate the (row-limit-bounded) build and leave the fact
        # table streaming in place.
        if self._streams_storage(probe):
            return True
        probe_rows = self.rows(probe)
        return build_rows * self.n_shards <= probe_rows + build_rows

    def _streams_storage(self, node: P.PlanNode) -> bool:
        """True when the subtree is a Filter/Project chain over a scan
        of a streamable storage connector (parquet)."""
        while isinstance(node, (P.Filter, P.Project)):
            node = node.source
        if not isinstance(node, P.TableScan):
            return False
        try:
            conn = self.md.connector(node.catalog)
        except KeyError:
            return False
        return bool(getattr(conn, "streamable", False))


def add_exchanges(
    plan: P.PlanNode,
    metadata: Metadata,
    n_shards: int = 8,
    session: Session | None = None,
    scaled_writers: bool = False,
) -> P.PlanNode:
    ctx = _Ctx(metadata, n_shards, session)
    ctx.scaled_writers = bool(scaled_writers)
    node, _ = _walk(plan, ctx)
    return node


def _gather(node: P.PlanNode) -> P.PlanNode:
    return P.Exchange(
        dict(node.outputs), source=node, partitioning="single",
    )


def _walk(node: P.PlanNode, ctx: _Ctx) -> tuple[P.PlanNode, str]:
    """Returns (rewritten node, distribution in {'dist', 'single'})."""
    if isinstance(node, P.TableScan):
        return node, "dist"
    if isinstance(node, P.Values):
        return node, "single"

    if isinstance(node, (P.Filter, P.Project, P.GroupId)):
        # GroupId is row-parallel: each shard replicates its own rows
        # per set; the aggregation above exchanges on (id, keys)
        src, d = _walk(node.source, ctx)
        return dc_replace(node, source=src), d

    if isinstance(node, P.Output):
        src, d = _walk(node.source, ctx)
        if d == "dist":
            src = _gather(src)
        return dc_replace(node, source=src), "single"

    if isinstance(node, P.Sort):
        src, d = _walk(node.source, ctx)
        if d == "dist":
            # distributed sort: range-partition on the first key
            # (sampled splitters), sort per shard, ordered gather —
            # the sort WORK distributes; only the ordered result
            # concatenates (MergeOperator/MergeSortedPages analog,
            # replacing the gather-raw-rows-then-sort plan)
            rng = P.Exchange(
                dict(src.outputs), source=src, partitioning="range",
                sort_keys=list(node.keys),
            )
            local = dc_replace(node, source=rng)
            return P.Exchange(
                dict(node.outputs), source=local, partitioning="single",
                ordered=True,
            ), "single"
        return dc_replace(node, source=src), "single"

    if isinstance(node, P.TopN):
        src, d = _walk(node.source, ctx)
        if d == "dist":
            partial = dc_replace(node, source=src)
            return dc_replace(node, source=_gather(partial)), "single"
        return dc_replace(node, source=src), "single"

    if isinstance(node, P.Limit):
        src, d = _walk(node.source, ctx)
        if d == "dist":
            partial = P.Limit(
                dict(node.outputs), source=src,
                count=node.count + node.offset if node.count >= 0 else -1,
                offset=0,
            )
            return dc_replace(node, source=_gather(partial)), "single"
        return dc_replace(node, source=src), "single"

    if isinstance(node, P.Aggregate):
        return _walk_aggregate(node, ctx)

    if isinstance(node, P.Join):
        return _walk_join(node, ctx)

    if isinstance(node, P.SemiJoin):
        src, sd = _walk(node.source, ctx)
        filt, fd = _walk(node.filter_source, ctx)
        if sd == "single":
            if fd == "dist":
                filt = _gather(filt)
            return dc_replace(node, source=src, filter_source=filt), "single"
        # source sharded; replicate the filter side to every shard
        bcast = P.Exchange(
            dict(filt.outputs), source=filt, partitioning="broadcast",
            input_dist=fd,
        )
        return dc_replace(node, source=src, filter_source=bcast), "dist"

    if isinstance(node, P.TableWriter):
        # TableWriterNode placement (MAIN/sql/planner/
        # AddExchanges.java visitTableWriter analog): with scaled
        # writers, partitioned targets hash-exchange on the partition
        # columns so each writer owns whole partitions (one file set
        # per partition per writer); unpartitioned targets round-robin
        # across task_writer_count writers. On a real device mesh the
        # writer runs host-side, so gather the child and write single.
        src, d = _walk(node.source, ctx)
        if d == "dist" and ctx.scaled_writers:
            pb = [str(k) for k in node.handle.get("partition_by") or []]
            if pb:
                ts_cols = [c for c, _ in node.handle["columns"]]
                pos = {c: i for i, c in enumerate(ts_cols)}
                hash_syms = [node.columns[pos[k]] for k in pb]
                ex = P.Exchange(
                    dict(src.outputs), source=src,
                    partitioning="hash", hash_symbols=hash_syms,
                )
            else:
                ex = P.Exchange(
                    dict(src.outputs), source=src,
                    partitioning="round_robin",
                )
            return dc_replace(node, source=ex), "dist"
        if d == "dist":
            src = _gather(src)
        return dc_replace(node, source=src), "single"

    if isinstance(node, P.TableFinish):
        # single coordinator-side commit task over the gathered
        # fragment stream
        src, d = _walk(node.source, ctx)
        if d == "dist":
            src = _gather(src)
        return dc_replace(node, source=src), "single"

    # unknown nodes: force single execution of every source
    srcs = []
    for s in node.sources:
        s2, d = _walk(s, ctx)
        srcs.append(_gather(s2) if d == "dist" else s2)
    if srcs:
        from trino_tpu_torch.plan.optimizer import _replace_sources

        node = _replace_sources(node, srcs)
    return node, "single"


# ---- joins -----------------------------------------------------------------

def _flip(node: P.Join) -> P.Join:
    return dc_replace(
        node, left=node.right, right=node.left,
        criteria=[(b, a) for a, b in node.criteria],
    )


def _walk_join(node: P.Join, ctx: _Ctx) -> tuple[P.PlanNode, str]:
    left, ld = _walk(node.left, ctx)
    right, rd = _walk(node.right, ctx)

    if ld == "single" and rd == "single":
        return dc_replace(node, left=left, right=right), "single"

    if node.kind == "cross":
        if ld == "single":
            # keep the sharded side streaming; replicate the single one
            # by flipping (cross join output columns come from
            # node.outputs, so side order is cosmetic)
            node, left, ld, right, rd = _flip(node), right, rd, left, ld
        bcast = P.Exchange(
            dict(right.outputs), source=right, partitioning="broadcast",
            input_dist=rd,
        )
        return dc_replace(
            node, left=left, right=bcast, distribution="BROADCAST"
        ), "dist"

    if node.kind in ("right", "full"):
        # both sides must be co-partitioned: a replicated build side
        # would emit its unmatched rows once per shard
        if ld == "single" or rd == "single":
            if ld == "dist":
                left = _gather(left)
            if rd == "dist":
                right = _gather(right)
            return dc_replace(node, left=left, right=right), "single"
        return dc_replace(
            node, left=left, right=right, distribution="PARTITIONED"
        ), "dist"

    if node.kind == "inner" and ld == "single":
        node, left, ld, right, rd = _flip(node), right, rd, left, ld
    if node.kind == "left" and ld == "single":
        # probe side must stay partitioned-or-single; gather the build
        if rd == "dist":
            right = _gather(right)
        return dc_replace(node, left=left, right=right), "single"

    small_build = rd == "single" or ctx.should_broadcast(left, right)
    if small_build:
        bcast = P.Exchange(
            dict(right.outputs), source=right, partitioning="broadcast",
            input_dist=rd,
        )
        return dc_replace(
            node, left=left, right=bcast, distribution="BROADCAST"
        ), "dist"
    return dc_replace(
        node, left=left, right=right, distribution="PARTITIONED"
    ), "dist"


def _two_level_distinct(node: P.Aggregate, src: P.PlanNode, dedupe_keys):
    """Skew-proof distinct aggregation: exchange on (group keys +
    distinct column) so a hot GROUP key spreads across shards by its
    distinct values, dedupe the colocated pairs globally, then run the
    remaining plain aggregation as a second partial/final exchange on
    the group keys alone (tiny: one row per group per shard).

    The raw-row route this replaces hashed on the group keys only —
    a 90%-one-key GROUP BY sent 90% of the pairs to one shard and
    escalated the exchange to SkewOverflow (VERDICT r3 weak #3;
    reference: pre-aggregation + MarkDistinct before the exchange).
    Applies when every aggregate is DISTINCT over the same single
    column list; returns None otherwise."""
    plain = {
        sym: AggCall(c.name, c.args, c.type, filter=c.filter)
        for sym, c in node.aggregates.items()
    }
    post = dc_replace(node, aggregates=plain, source=None)
    try:
        partial, final = _split_aggregate(post)
    except NotImplementedError:
        return None
    # shard-local dedupe, pair exchange, global dedupe
    pre = P.Aggregate(
        dict(src.outputs), source=src, group_keys=list(dedupe_keys),
        aggregates={}, step="PARTIAL",
    )
    ex1 = P.Exchange(
        dict(pre.outputs), source=pre, partitioning="hash",
        hash_symbols=list(dedupe_keys),
    )
    dedup = P.Aggregate(
        dict(ex1.outputs), source=ex1, group_keys=list(dedupe_keys),
        aggregates={}, step="PARTIAL",
    )
    partial = dc_replace(partial, source=dedup)
    ex2 = P.Exchange(
        dict(partial.outputs), source=partial, partitioning="hash",
        hash_symbols=list(node.group_keys),
    )
    return dc_replace(final, source=ex2)


# ---- aggregates ------------------------------------------------------------

def _walk_aggregate(node: P.Aggregate, ctx: _Ctx) -> tuple[P.PlanNode, str]:
    src, d = _walk(node.source, ctx)
    if d == "single":
        return dc_replace(node, source=src), "single"

    if any(c.distinct for c in node.aggregates.values()):
        # DISTINCT needs every row of a group on one shard. Instead of
        # exchanging RAW rows (O(data) shuffle), dedupe per shard first
        # when every distinct argument is a plain column: a shard-local
        # group-by over (group keys + distinct args) collapses
        # duplicates, so the exchange carries at most NDV rows per
        # shard (the MarkDistinct-before-exchange analog; VERDICT
        # flagged the raw-row route as a full-data shuffle).
        distinct_syms = []
        simple = True
        for c in node.aggregates.values():
            if not c.distinct:
                continue
            for a in c.args:
                if isinstance(a, InputRef):
                    distinct_syms.append(a.name)
                else:
                    simple = False
        if node.group_keys:
            if simple and distinct_syms:
                dedupe_keys = list(dict.fromkeys(
                    list(node.group_keys) + distinct_syms
                ))
                if set(dedupe_keys) == set(src.outputs) and not any(
                    not c.distinct for c in node.aggregates.values()
                ):
                    # only safe when NO aggregate needs the raw rows
                    # (a non-distinct agg alongside would lose rows)
                    two_level = _two_level_distinct(
                        node, src, dedupe_keys
                    )
                    if two_level is not None:
                        return two_level, "dist"
                    pre = P.Aggregate(
                        dict(src.outputs), source=src,
                        group_keys=dedupe_keys, aggregates={},
                        step="PARTIAL",
                    )
                    src = pre
            ex = P.Exchange(
                dict(src.outputs), source=src, partitioning="hash",
                hash_symbols=list(node.group_keys),
            )
            return dc_replace(node, source=ex), "dist"
        return dc_replace(node, source=_gather(src)), "single"

    try:
        partial, final = _split_aggregate(node)
    except NotImplementedError:
        # aggregates without a partial form (e.g. max_by pairs): route
        # raw rows by group-key hash and aggregate in one step
        if node.group_keys:
            ex = P.Exchange(
                dict(src.outputs), source=src, partitioning="hash",
                hash_symbols=list(node.group_keys),
            )
            return dc_replace(node, source=ex), "dist"
        return dc_replace(node, source=_gather(src)), "single"
    partial = dc_replace(partial, source=src)
    if node.group_keys:
        ex = P.Exchange(
            dict(partial.outputs), source=partial, partitioning="hash",
            hash_symbols=list(node.group_keys),
        )
        return dc_replace(final, source=ex), "dist"
    return dc_replace(final, source=_gather(partial)), "single"


#: aggregate functions whose partial state combines with the same
#: function (min of mins, etc.)
_SELF_COMBINING = {
    "min", "max", "any_value", "arbitrary", "bool_and", "bool_or",
}


def _split_aggregate(node: P.Aggregate) -> tuple[P.Aggregate, P.Aggregate]:
    """Decompose SINGLE aggregates into PARTIAL states + FINAL combines
    (the reference's partial/intermediate/final accumulator steps,
    MAIN/operator/aggregation/; AddExchanges splits the step the same
    way)."""
    partial_aggs: dict[str, AggCall] = {}
    final_aggs: dict[str, AggCall] = {}
    for sym, call in node.aggregates.items():
        name = call.name
        if name in ("count", "count_all", "count_if"):
            partial_aggs[sym] = call
            final_aggs[sym] = AggCall(
                "count_final", (InputRef(T.BIGINT, sym),), call.type
            )
        elif name == "sum":
            if isinstance(call.type, T.DecimalType) and call.type.is_long:
                # decimal(38): exact limb states travel as two BIGINTs
                # (the Int128 partial-state serialization analog)
                s_hi, s_lo = f"{sym}$hi", f"{sym}$lo"
                partial_aggs[s_hi] = AggCall(
                    "sum_hi32", call.args, T.BIGINT, filter=call.filter
                )
                partial_aggs[s_lo] = AggCall(
                    "sum_lo32", call.args, T.BIGINT, filter=call.filter
                )
                final_aggs[sym] = AggCall(
                    "decimal_sum_final",
                    (InputRef(T.BIGINT, s_hi), InputRef(T.BIGINT, s_lo)),
                    call.type,
                )
            else:
                partial_aggs[sym] = call
                final_aggs[sym] = AggCall(
                    "sum", (InputRef(call.type, sym),), call.type
                )
        elif name in _SELF_COMBINING:
            partial_aggs[sym] = call
            final_aggs[sym] = AggCall(
                name, (InputRef(call.type, sym),), call.type
            )
        elif name == "avg":
            if isinstance(call.type, T.DecimalType):
                # exact limb states: a plain int64 partial sum would
                # silently wrap past 2^63 (the local path is limb-exact,
                # the distributed/chunked path must match)
                s_hi, s_lo, s_cnt = f"{sym}$hi", f"{sym}$lo", f"{sym}$cnt"
                partial_aggs[s_hi] = AggCall(
                    "sum_hi32", call.args, T.BIGINT, filter=call.filter
                )
                partial_aggs[s_lo] = AggCall(
                    "sum_lo32", call.args, T.BIGINT, filter=call.filter
                )
                partial_aggs[s_cnt] = AggCall(
                    "count", call.args, T.BIGINT, filter=call.filter
                )
                final_aggs[sym] = AggCall(
                    "decimal_avg_final",
                    (
                        InputRef(T.BIGINT, s_hi),
                        InputRef(T.BIGINT, s_lo),
                        InputRef(T.BIGINT, s_cnt),
                    ),
                    call.type,
                )
            else:
                s_sum, s_cnt = f"{sym}$sum", f"{sym}$cnt"
                partial_aggs[s_sum] = AggCall(
                    "sum", call.args, T.DOUBLE, filter=call.filter
                )
                partial_aggs[s_cnt] = AggCall(
                    "count", call.args, T.BIGINT, filter=call.filter
                )
                final_aggs[sym] = AggCall(
                    "avg_final",
                    (InputRef(T.DOUBLE, s_sum), InputRef(T.BIGINT, s_cnt)),
                    call.type,
                )
        elif name in VARIANCE_FNS:
            xd = Cast(T.DOUBLE, call.args[0])
            xx = Call(T.DOUBLE, "multiply", (xd, xd))
            s_n, s_1, s_2 = f"{sym}$n", f"{sym}$s1", f"{sym}$s2"
            partial_aggs[s_n] = AggCall(
                "count", call.args, T.BIGINT, filter=call.filter
            )
            partial_aggs[s_1] = AggCall(
                "sum", (xd,), T.DOUBLE, filter=call.filter
            )
            partial_aggs[s_2] = AggCall(
                "sum", (xx,), T.DOUBLE, filter=call.filter
            )
            final_aggs[sym] = AggCall(
                f"var_final:{name}",
                (
                    InputRef(T.BIGINT, s_n),
                    InputRef(T.DOUBLE, s_1),
                    InputRef(T.DOUBLE, s_2),
                ),
                call.type,
            )
        elif name in ("max_by", "min_by"):
            # partial: per-shard extremal (value, key) pair; FINAL
            # re-runs the same extremal over the pairs (one row per
            # shard per group — no raw-row exchange, so a hot group
            # key cannot skew the shuffle)
            s_v, s_k = f"{sym}$v", f"{sym}$k"
            key_t = call.args[1].type
            partial_aggs[s_v] = call
            partial_aggs[s_k] = AggCall(
                "max" if name == "max_by" else "min",
                (call.args[1],), key_t, filter=call.filter,
            )
            final_aggs[sym] = AggCall(
                name,
                (InputRef(call.type, s_v), InputRef(key_t, s_k)),
                call.type,
            )
        elif name == "approx_distinct":
            # HLL registers as partial state: constant bytes per group
            # through the exchange regardless of NDV (reference:
            # ApproximateCountDistinctAggregations.java)
            from trino_tpu_torch.exec.aggregates import (
                HLL_GLOBAL_BUCKETS,
                HLL_GROUPED_BUCKETS,
            )

            m = HLL_GROUPED_BUCKETS if node.group_keys else HLL_GLOBAL_BUCKETS
            st = T.SketchType("hll", m)
            s_hll = f"{sym}$hll"
            partial_aggs[s_hll] = AggCall(
                "approx_distinct_partial", call.args, st, filter=call.filter
            )
            final_aggs[sym] = AggCall(
                "approx_distinct_final", (InputRef(st, s_hll),), T.BIGINT
            )
        elif name == "approx_percentile":
            # mergeable quantile summary (evenly-spaced order
            # statistics + count) replacing the exact holistic sort
            # when the plan splits (reference: qdigest partial state,
            # ApproximateDoublePercentileAggregations.java)
            from trino_tpu_torch.expr.ir import Literal

            if not isinstance(call.args[1], Literal) or isinstance(
                call.type, T.DecimalType
            ) and call.type.is_long:
                raise NotImplementedError(
                    "approx_percentile split needs a literal percentile"
                )
            from trino_tpu_torch.exec.aggregates import (
                QUANT_GLOBAL_POINTS,
                QUANT_GROUPED_POINTS,
            )

            k = (
                QUANT_GROUPED_POINTS if node.group_keys
                else QUANT_GLOBAL_POINTS
            )
            st = T.SketchType("quant", k + 1)
            s_qs = f"{sym}$qs"
            partial_aggs[s_qs] = AggCall(
                "approx_percentile_partial", call.args, st,
                filter=call.filter,
            )
            final_aggs[sym] = AggCall(
                "approx_percentile_final",
                (InputRef(st, s_qs), call.args[1]),
                call.type,
            )
        else:
            raise NotImplementedError(f"no partial split for {name}")

    key_types = {k: node.outputs[k] for k in node.group_keys}
    partial = P.Aggregate(
        {**key_types, **{s: a.type for s, a in partial_aggs.items()}},
        source=None,
        group_keys=list(node.group_keys),
        aggregates=partial_aggs,
        step="PARTIAL",
    )
    final = P.Aggregate(
        dict(node.outputs),
        source=None,
        group_keys=list(node.group_keys),
        aggregates=final_aggs,
        step="FINAL",
    )
    return partial, final
