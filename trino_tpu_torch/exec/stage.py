"""Pipeline builder: a chain of row-level operators becomes one function
over torch tensors — the port of ``trino_tpu/exec/stage.py``.

In the JAX package the chain Filter -> Project -> Aggregate -> Sort ->
Limit traces into one XLA program. PyTorch runs eagerly, so here the
chain is the same sequence of steps run one after another on the
executor's device; the operators, capacities and overflow flags are the
JAX package's. Chains break at joins and exchanges, where a host
decision picks the next capacity.

Aggregations inside a chain carry a static slot-table capacity; the
chain returns per-aggregate overflow flags and the caller re-runs it
with an 8x larger table when one trips (the FlatHash rehash analog).
DISTINCT aggregates dedupe through a second ``group_by``.
``approx_distinct`` hashes values, not codes: a dictionary or pool
column's lane gathers a content-hash table kept with its dictionary
(pool). A PARTIAL aggregation's sketch states (``T.SketchType``: int8
HLL registers or a float64 quantile summary per group) ride the output
page as ``[capacity, lanes]`` columns, as two-limb decimals do.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace as dc_replace

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.exec import kernels as K
from trino_tpu_torch.exec import shapes
from trino_tpu_torch.exec.aggregates import VARIANCE_FNS, _zero, compute_aggregate
from trino_tpu_torch.expr.compiler import (
    ColumnLayout, _dictionary_derived, compile_expr,
)
from trino_tpu_torch.expr.ir import InputRef
from trino_tpu_torch.page import StringDictionary, content_hash64, pad_capacity
from trino_tpu_torch.plan import nodes as P

__all__ = ["FUSABLE", "ChainLayout", "plan_capacities", "build_chain"]

#: node types that chain (single-source, static shapes)
FUSABLE = (P.Filter, P.Project, P.Aggregate, P.Sort, P.TopN, P.Limit)


@dataclass
class ChainLayout:
    """Host-side metadata flowing through the chain builder."""

    names: list[str]
    types: dict[str, T.DataType]
    dicts: dict[str, StringDictionary | None]
    capacity: int
    device: torch.device | str = "cpu"
    #: hash-coded varchar pools by symbol (data = [cap, 2] hash + id)
    pools: dict = field(default_factory=dict)

    def expr_layout(self) -> ColumnLayout:
        return ColumnLayout(
            types=dict(self.types), dictionaries=dict(self.dicts),
            device=self.device,
        )


def _key_width(t: T.DataType, dictionary, value_range=None) -> int:
    """Bit width that injectively covers a key column's values (narrowed
    to bit_length(hi - lo) by an exact value range)."""
    if dictionary is not None:
        return max(1, len(dictionary).bit_length())
    if isinstance(t, T.DecimalType) and t.is_long:
        raise NotImplementedError(
            "GROUP BY / DISTINCT on decimal(38) keys"
        )
    if isinstance(t, T.BooleanType):
        return 1
    dt = np.dtype(t.np_dtype)
    full = min(dt.itemsize * 8, 64)
    if value_range is not None:
        lo, hi = value_range
        return min(max(1, int(hi - lo).bit_length()), full)
    return full


def _shift_key(data, valid, value_range):
    """Shift an integer key column to its range origin so the low
    bit_length(hi-lo) bits are injective."""
    if value_range is None:
        return data, valid
    lo, _hi = value_range
    if lo == 0:
        return data, valid
    return data - lo, valid


def _bcast(data, valid, capacity):
    if data.dim() == 0:
        data = data.expand(capacity)
    if valid is not None and valid.dim() == 0:
        valid = valid.expand(capacity)
    return data, valid


def plan_capacities(
    chain: list[P.PlanNode], in_capacity: int, n_shards: int = 1
) -> dict[int, list[int]]:
    """Initial [capacity, max_capacity] per Aggregate position (from the
    planner's ``est_groups`` when present; wrong estimates are safe —
    the overflow flag triggers the retry-larger loop)."""
    caps: dict[int, list[int]] = {}
    cap = in_capacity
    for i, nd in enumerate(chain):
        if isinstance(nd, P.Aggregate):
            if not nd.group_keys:
                caps[i] = [1, 1]
                cap = 8
            else:
                max_cap = pad_capacity(max(2 * cap, 8))
                if nd.est_groups is not None:
                    est = nd.est_groups
                    if n_shards > 1 and nd.step in ("FINAL", "SINGLE"):
                        est = est / n_shards * 1.5
                    start = shapes.table_bucket(est, max_cap)
                else:
                    start = min(
                        shapes.bucket(max(cap // 16, 1024)), max_cap,
                    )
                caps[i] = [start, max_cap]
                cap = start
        elif isinstance(nd, P.TopN):
            cap = shapes.bucket(min(nd.count, cap))
    return caps


def build_chain(chain: list[P.PlanNode], layout: ChainLayout, caps: dict[int, list[int]]):
    """Build (fn, out_layout): ``fn(env, mask) -> (env', mask', flags)``;
    ``flags`` maps chain position -> overflow bool tensor for each
    grouped Aggregate."""
    steps = []
    for i, nd in enumerate(chain):
        if isinstance(nd, P.Filter):
            steps.append(_filter_step(nd, layout))
        elif isinstance(nd, P.Project):
            step, layout = _project_step(nd, layout)
            steps.append(step)
        elif isinstance(nd, P.Aggregate):
            step, layout = _aggregate_step(nd, layout, caps[i][0], i)
            steps.append(step)
        elif isinstance(nd, (P.Sort, P.TopN)):
            step, layout = _sort_step(nd, layout)
            steps.append(step)
        elif isinstance(nd, P.Limit):
            steps.append(_limit_step(nd))
        else:
            raise NotImplementedError(type(nd).__name__)

    def fn(env, mask):
        flags = {}
        for step in steps:
            env, mask, flags = step(env, mask, flags)
        return env, mask, flags

    return fn, layout


def _filter_step(nd: P.Filter, layout: ChainLayout):
    compiled = compile_expr(nd.predicate, layout.expr_layout())

    def step(env, mask, flags):
        data, valid = compiled.fn(env)
        keep = data if valid is None else (data & valid)
        return env, mask & keep, flags

    return step


def _project_step(nd: P.Project, layout: ChainLayout):
    compiled = {
        sym: compile_expr(e, layout.expr_layout())
        for sym, e in nd.assignments.items()
    }
    cap = layout.capacity
    out_layout = ChainLayout(
        names=list(nd.assignments),
        types={s: e.type for s, e in nd.assignments.items()},
        dicts={s: c.dictionary for s, c in compiled.items()},
        capacity=cap,
        device=layout.device,
        pools={
            s: layout.pools[e.name]
            for s, e in nd.assignments.items()
            if isinstance(e, InputRef) and e.name in layout.pools
        },
    )

    def step(env, mask, flags):
        env2 = {
            sym: _bcast(*c.fn(env), cap) for sym, c in compiled.items()
        }
        return env2, mask, flags

    return step, out_layout


def _aggregate_step(nd: P.Aggregate, layout: ChainLayout, capacity: int, pos: int):
    is_global = not nd.group_keys
    expr_layout = layout.expr_layout()
    agg_meta = []
    for sym, call in nd.aggregates.items():
        arg_c = [compile_expr(a, expr_layout) for a in call.args] or None
        filter_c = (
            compile_expr(call.filter, expr_layout)
            if call.filter is not None else None
        )
        agg_meta.append((sym, call, arg_c, filter_c))
    group_keys = list(nd.group_keys)
    in_cap = layout.capacity
    out_cap = 8 if is_global else capacity
    dev = layout.device
    hll_tables = _hll_tables(agg_meta, layout)

    out_layout = ChainLayout(
        names=group_keys + [sym for sym, *_ in agg_meta],
        types={
            **{s: layout.types[s] for s in group_keys},
            **{sym: call.type for sym, call, *_ in agg_meta},
        },
        dicts={
            **{s: layout.dicts[s] for s in group_keys},
            **{
                sym: (arg_c[0].dictionary if isinstance(call.type, T.VarcharType) and arg_c else None)
                for sym, call, arg_c, _ in agg_meta
            },
        },
        capacity=out_cap,
        device=dev,
        pools={s: layout.pools[s] for s in group_keys if s in layout.pools},
    )

    key_ranges = nd.key_ranges or {}

    def step(env, mask, flags):
        shifted = []
        width_list = []
        if is_global:
            info = None
            out_mask = torch.zeros(8, dtype=torch.bool, device=mask.device)
            out_mask[0] = True
            env2 = {}
        else:
            for s in group_keys:
                data, valid = env[s]
                if s in layout.pools:
                    # hash-coded varchar: the hash lane is the key (the
                    # id lane is row identity, not value identity)
                    shifted.append((data[:, 0], valid))
                    width_list.append(64)
                    continue
                shifted.append(_shift_key(data, valid, key_ranges.get(s)))
                width_list.append(
                    _key_width(
                        layout.types[s], layout.dicts.get(s),
                        key_ranges.get(s),
                    )
                )
            info = K.group_by(
                shifted, mask, capacity, widths=tuple(width_list),
            )
            flags = {**flags, pos: info.num_groups > capacity}
            env2 = {}
            occupied = (
                torch.arange(capacity, dtype=torch.int64, device=mask.device)
                < info.num_groups
            )
            own = info.owner.clamp(0, in_cap - 1)
            for s in group_keys:
                data, valid = env[s]
                env2[s] = (
                    data[own],
                    None if valid is None else (valid[own] & occupied),
                )
            out_mask = occupied
        cap_seg = 1 if is_global else capacity
        share = {"#mask": mask}  # per-step cache of sorted cols/counts
        prepared = []
        for sym, call, arg_c, filter_c in agg_meta:
            arg = None
            contrib = mask
            if arg_c is not None:
                vals = [_bcast(*c.fn(env), in_cap) for c in arg_c]
                arg = vals[0] if len(vals) == 1 else vals
            if (
                call.name in VARIANCE_FNS
                and isinstance(call.args[0].type, T.DecimalType)
            ):
                # variance of DECIMAL is computed as DOUBLE over the true
                # values, not the unscaled integers
                d, v = arg
                x = d.to(torch.float64)
                # a tensor division: over a Python number torch on cuda
                # multiplies by the reciprocal, which rounds differently
                arg = (x / torch.full_like(x, 10.0 ** call.args[0].type.scale), v)
            if filter_c is not None:
                fd, fv = filter_c.fn(env)
                contrib = contrib & (fd if fv is None else (fd & fv))
            if call.distinct:
                d_arg = arg
                if (
                    isinstance(call.args[0].type, T.VarcharType)
                    and arg[0].dim() == 2
                ):
                    # hash-coded varchar: dedupe on the hash lane
                    d_arg = (arg[0][:, 0], arg[1])
                    dwidth = 64
                else:
                    dwidth = _key_width(
                        call.args[0].type, arg_c[0].dictionary
                    )
                # shifted key pairs match the narrowed widths
                contrib = _dedupe(
                    shifted, d_arg, contrib, in_cap,
                    tuple(width_list) + (dwidth,),
                )
            if call.name in _HLL_NAMES:
                arg = _hll_lane(arg, hll_tables.get(sym), call.args[0].type)
            prepared.append((sym, call, arg, contrib))
        if info is not None:
            _presort_shared(prepared, info, share)
        for sym, call, arg, contrib in prepared:
            data, valid = compute_aggregate(
                call.name, call.type, arg, info, cap_seg, contrib,
                share=share,
            )
            if is_global:
                data = _pad_to(data, 8)
                valid = None if valid is None else _pad_to(valid, 8)
            env2[sym] = (data, valid)
        return env2, out_mask, flags

    return step, out_layout


#: the aggregates whose argument becomes an HLL hash lane: the resident
#: form and the PARTIAL of the split (its FINAL reads register states)
_HLL_NAMES = ("approx_distinct", "approx_distinct_partial")


def _hll_tables(agg_meta, layout: ChainLayout) -> dict:
    """Per approx_distinct aggregate over a VARCHAR: ("code", table) for
    a dictionary column, ("id", table) for a hash-coded column whose pool
    is reachable; the table holds ``content_hash64`` of the values (u64
    bits in int64) on the chain's device, kept with the dictionary
    (pool) so warm runs reuse it."""
    tables = {}
    for sym, call, arg_c, _f in agg_meta:
        if call.name not in _HLL_NAMES or not arg_c:
            continue
        d = arg_c[0].dictionary
        kind = "code"
        if d is None:
            a0 = call.args[0]
            d = layout.pools.get(a0.name) if isinstance(a0, InputRef) else None
            kind = "id"
        if d is None:
            continue

        def build(d=d):
            h = content_hash64(d.values) if len(d.values) else np.zeros(1, np.uint64)
            return torch.from_numpy(h.view(np.int64)).to(layout.device)

        tables[sym] = (kind, _dictionary_derived(
            d, ("content_hash64", str(layout.device)), build,
        ))
    return tables


def _hll_lane(arg, table, arg_type):
    """approx_distinct's argument as ((lane, hashed), valid): content
    hashes gathered by code or pool id; the raw hash lane of a pool that
    is not reachable; else the values, which ``hll_registers`` hashes
    (``dev_hash64``)."""
    d, v = arg
    if table is not None:
        kind, tbl = table
        idx = d[:, 1] if kind == "id" else d
        return (tbl[idx.long().clamp(0, tbl.shape[0] - 1)], True), v
    if d.dim() == 2 and isinstance(arg_type, T.VarcharType):
        # hash-coded column without a reachable pool: the process-local
        # hash lane (correct within one process)
        return (d[:, 0].contiguous(), True), v
    return (d, False), v


#: aggregates that read their arguments in original row order (or sort
#: them their own way): nothing of theirs is gathered in advance. The
#: sketches' PARTIAL and FINAL forms are among them (a FINAL reads its
#: [n, lanes] states in row order)
_ROW_ORDER = {
    "approx_distinct", "approx_percentile", "max_by", "min_by",
    "any_value", "arbitrary", "approx_distinct_partial",
    "approx_distinct_final", "approx_percentile_partial",
    "approx_percentile_final",
}


def _presort_shared(prepared, info, share):
    """Gather every column the step's aggregates need into group-sorted
    order, same-dtype columns stacked and gathered by ``perm`` in one
    index op, then unstacked into the ``share`` cache that the reducers
    of ``compute_aggregate`` consult (its keys mirror
    ``aggregates._Reducer``'s). The stack is [k, n], so each unstacked
    column is contiguous: torch's eager elementwise ops read a column
    of an [n, k] stack with stride k. ``calls`` counts its uses."""
    _presort_shared.calls += 1
    items: dict[int, torch.Tensor] = {}

    def want(x):
        if x is not None and id(x) not in items:
            items[id(x)] = x

    for _sym, call, arg, contrib in prepared:
        if call.name in _ROW_ORDER:
            continue
        eff = contrib
        if isinstance(arg, list):
            for d, v in arg:
                if v is not None:
                    key = ("nulled", id(d), id(v))
                    hit = share.get(key)
                    if hit is None:
                        hit = (d, v, torch.where(v, d, _zero(d)))
                        share[key] = hit
                    want(hit[2])
                else:
                    want(d)
        elif arg is not None:
            d, v = arg
            want(d)
            if v is not None:
                key = ("and", id(contrib), id(v))
                hit = share.get(key)
                if hit is None:
                    hit = (contrib, v, contrib & v)
                    share[key] = hit
                eff = hit[2]
        want(eff)

    by_dtype: dict[tuple, list] = {}
    for x in items.values():
        # [n, 2] decimal limbs cannot stack with 1-D columns
        by_dtype.setdefault((x.dtype, tuple(x.shape[1:])), []).append(x)
    for xs in by_dtype.values():
        if len(xs) == 1:
            x = xs[0]
            share[("sorted", id(x))] = (x, x[info.perm])
        else:
            stacked = torch.stack(xs)[:, info.perm]
            for i, x in enumerate(xs):
                share[("sorted", id(x))] = (x, stacked[i])


_presort_shared.calls = 0


def _dedupe(key_cols, arg, live, page_capacity, widths=None):
    """DISTINCT: keep one representative row per (group keys, value).

    Sort-based grouping is exact and dense, so a capacity equal to the
    page capacity never overflows (num_groups <= live rows). The
    representative of each group is K1's ``rep`` flag: the row at the
    group's first sorted position."""
    data, valid = arg
    live_d = live if valid is None else (live & valid)
    # the dedupe key value itself: NULL rows are excluded via live_d,
    # so it needs no null flag
    info2 = K.group_by(
        list(key_cols) + [(data, None)], live_d, page_capacity, widths=widths,
        with_rep=True,
    )
    return info2.rep


def _sort_step(nd, layout: ChainLayout):
    keys = []
    for k in nd.keys:
        nulls_first = k.nulls_first
        if nulls_first is None:
            # reference default: nulls are largest (ASC last, DESC first)
            nulls_first = not k.ascending
        keys.append((k.symbol, k.ascending, nulls_first))
    is_topn = isinstance(nd, P.TopN)
    in_cap = layout.capacity
    out_cap = pad_capacity(min(nd.count, in_cap)) if is_topn else in_cap
    out_layout = dc_replace(layout, capacity=out_cap) if is_topn else layout
    limit = out_cap if out_cap < in_cap else None
    count = nd.count if is_topn else None

    def step(env, mask, flags):
        sort_keys = []
        for s, asc, nf in keys:
            data, valid = env[s]
            if data.dim() == 2:
                # two-limb decimal: hi is the major key, lo minor
                sort_keys.append((data[:, 0], valid, asc, nf))
                sort_keys.append((data[:, 1], valid, asc, nf))
            else:
                sort_keys.append((data, valid, asc, nf))
        perm = K.sort_perm(sort_keys, mask)
        if limit is not None:
            perm = perm[:limit]
        env2 = {}
        for s, (data, valid) in env.items():
            env2[s] = (data[perm], None if valid is None else valid[perm])
        mask2 = mask[perm]
        if count is not None:
            mask2 = mask2 & (
                torch.arange(mask2.shape[0], device=mask2.device) < count
            )
        return env2, mask2, flags

    return step, out_layout


def _limit_step(nd: P.Limit):
    def step(env, mask, flags):
        rank = torch.cumsum(mask.to(torch.int64), 0)
        keep = mask & (rank > nd.offset)
        if nd.count >= 0:
            keep = keep & (rank <= nd.offset + nd.count)
        return env, keep, flags

    return step


def _pad_to(arr: torch.Tensor, capacity: int) -> torch.Tensor:
    n = arr.shape[0]
    if n >= capacity:
        return arr[:capacity]
    pad = torch.zeros(
        (capacity - n,) + tuple(arr.shape[1:]), dtype=arr.dtype,
        device=arr.device,
    )
    return torch.cat([arr, pad])
