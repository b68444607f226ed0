"""The PARTIAL/FINAL aggregate split — the part of
``trino_tpu/plan/distribute.py`` that one device needs.

``_split_aggregate`` decomposes a SINGLE aggregation into PARTIAL states
and FINAL combines (the reference's partial/intermediate/final
accumulator steps). The chunked tier (``exec/spill.py``, the executor's
``max_chunk_rows`` branch) runs the PARTIAL per row chunk and the FINAL
once over the concatenated partial states — a chunk is to the budget
what a shard is to the mesh. Exchange placement, the two-level DISTINCT
split and fragment salting wait for the multi-GPU slice.
"""

from __future__ import annotations

from trino_tpu_torch import types as T
from trino_tpu_torch.exec.aggregates import VARIANCE_FNS
from trino_tpu_torch.expr.ir import AggCall, Call, Cast, InputRef
from trino_tpu_torch.plan import nodes as P

__all__ = ["_split_aggregate"]

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
