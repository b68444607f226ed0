"""Aggregate function evaluation as sorted segment reductions — the port
of ``trino_tpu/exec/aggregates.py``: count, count_if, sum, avg, min and
max (decimal included, with exact two-limb sums), approx_distinct (HLL),
approx_percentile (the exact sorted-rank form), max_by and min_by,
any_value and arbitrary, bool_and and bool_or, and the variance family.

``kernels.group_by`` leaves each group as one contiguous run of the
sorted row order, so every sum is a gather into sorted order plus a
segmented sum (``kernels.seg_sum_ranges``, the K2 kernel on the card),
and every min/max one plus a segmented min/max (``kernels.seg_minmax``,
K9).
Work shared between the aggregates of one GROUP BY (the gather of a
column into group order, per-group counts, contribution masks) is
deduplicated through a per-step ``share`` cache keyed by object
identity. Global (ungrouped) aggregates are dense masked reductions.

The chunked tier (``exec/spill.py`` and ``max_chunk_rows``) splits an
aggregation with ``plan/distribute.py:_split_aggregate`` into PARTIAL
states and FINAL combines: HLL registers merged by a register max
(``kernels.hll_merge``, A4), mergeable quantile summaries
(``kernels.quant_summary``, A5) merged by a weighted rank pick
(``kernels.quant_merge``, A6), exact limb sums of long decimals
(``sum_hi32``/``sum_lo32``) and the variance moments (``var_final:``).
"""

from __future__ import annotations

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.exec import kernels as K
from trino_tpu_torch.expr.compiler import _div_round_half_up
from trino_tpu_torch.page import torch_dtype

__all__ = ["compute_aggregate", "VARIANCE_FNS"]

I64 = torch.int64

VARIANCE_FNS = {
    "stddev", "stddev_samp", "stddev_pop", "variance", "var_samp", "var_pop",
}

#: HLL register counts (relative standard error 1.04/sqrt(m)): a global
#: approx_distinct gets 4096 registers (~1.6%), a grouped one 512 (~4.6%)
#: to bound the per-group state at 512 bytes
HLL_GLOBAL_BUCKETS = 4096
HLL_GROUPED_BUCKETS = 512

#: quantile-summary sizes (rank error per chunk <= count/points). Both
#: are powers of two, so every weight count/k of the FINAL merge and
#: every sum of them is exact in float64
QUANT_GLOBAL_POINTS = 1024
QUANT_GROUPED_POINTS = 256


def _zero(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=like.dtype, device=like.device)


class _Reducer:
    """Segment reductions for one GROUP BY (``info`` set) or one global
    aggregate (``info`` None -> [1]-shaped dense reductions)."""

    def __init__(self, info: K.GroupInfo | None, capacity: int, contrib,
                 share: dict | None = None):
        self.info = info
        self.capacity = capacity
        self.contrib = contrib
        self.share = share if share is not None else {}
        self.contrib_s = None if info is None else self._sorted(contrib)

    def _sorted(self, x):
        key = ("sorted", id(x))
        hit = self.share.get(key)
        if hit is None or hit[0] is not x:
            hit = (x, x[self.info.perm])
            self.share[key] = hit
        return hit[1]

    def with_valid(self, valid):
        """Reducer whose contribution also requires ``valid`` (cached)."""
        if valid is None:
            return self
        key = ("and", id(self.contrib), id(valid))
        hit = self.share.get(key)
        if hit is None or hit[0] is not self.contrib or hit[1] is not valid:
            hit = (self.contrib, valid, self.contrib & valid)
            self.share[key] = hit
        return _Reducer(self.info, self.capacity, hit[2], self.share)

    def sum(self, data, dtype=None):
        """Masked per-group sum; ``dtype`` casts after the gather."""
        if self.info is None:
            x = data if dtype is None else data.to(dtype)
            return torch.where(self.contrib, x, _zero(x)).sum()[None]
        xs = self._sorted(data)
        if dtype is not None:
            xs = xs.to(dtype)
        masked = torch.where(self.contrib_s, xs, _zero(xs))
        return K.seg_sum_ranges(masked, self.info)

    def sum_limbs(self, data):
        """Exact (hi, lo) limb sums of an int64 column (or an already
        two-limb [n, 2] column); the split happens after the shared
        sorted gather."""
        if data.dim() == 2:
            hi_in, lo_in = data[:, 0], data[:, 1]
        else:
            hi_in = lo_in = None
        z = torch.zeros((), dtype=I64, device=data.device)
        if self.info is None:
            if hi_in is not None:
                hi = torch.where(self.contrib, hi_in, z).sum()[None]
                lo = torch.where(self.contrib, lo_in, z).sum()[None]
                return _limb_norm(hi, lo)
            masked = torch.where(self.contrib, data, z)
            hi = (masked >> 32).sum()[None]
            lo = (masked & 0xFFFFFFFF).sum()[None]
            return _limb_norm(hi, lo)
        if hi_in is not None:
            hs = torch.where(self.contrib_s, self._sorted(hi_in), z)
            ls = torch.where(self.contrib_s, self._sorted(lo_in), z)
            return _limb_norm(
                K.seg_sum_ranges(hs, self.info),
                K.seg_sum_ranges(ls, self.info),
            )
        xs = self._sorted(data)
        masked = torch.where(self.contrib_s, xs, z)
        hi = K.seg_sum_ranges(masked >> 32, self.info)
        lo = K.seg_sum_ranges(masked & 0xFFFFFFFF, self.info)
        return _limb_norm(hi, lo)

    def count(self):
        key = ("count", id(self.contrib))
        hit = self.share.get(key)
        if hit is None or hit[0] is not self.contrib:
            if self.info is None:
                cnt = self.contrib.to(I64).sum()[None]
            else:
                cnt = K.seg_sum_ranges(self.contrib_s.to(I64), self.info)
            hit = (self.contrib, cnt)
            self.share[key] = hit
        return hit[1]

    def minmax(self, data, fill, is_min: bool):
        """Per-group min/max: the contribution-masked values in group
        order through ``seg_minmax`` (K9 on the card), as the JAX
        package's segmented scan read at each group's end."""
        fill_t = torch.as_tensor(fill, dtype=data.dtype, device=data.device)
        if self.info is None:
            masked = torch.where(self.contrib, data, fill_t)
            red = torch.amin if is_min else torch.amax
            return red(masked, dim=0)[None]
        masked = torch.where(self.contrib_s, self._sorted(data), fill_t)
        return K.seg_minmax(
            masked, self.info.starts, self.info.ends, fill, is_min,
        )

    def first_value(self, data):
        """Value of the first contributing row per group (in scan order:
        the grouping sort is stable)."""
        n = data.shape[0]
        if self.info is None:
            idx = torch.arange(n, dtype=I64, device=data.device)
            first = torch.where(self.contrib, idx, torch.full_like(idx, n))
            return data[first.amin().clamp(0, max(n - 1, 0))[None]]
        rows, _ = K.seg_first_index(self.contrib_s, self.info)
        return data[rows.clamp(0, max(n - 1, 0))]


def compute_aggregate(
    name: str,
    out_type: T.DataType,
    arg,
    info: K.GroupInfo | None,
    capacity: int,
    contrib: torch.Tensor,
    share: dict | None = None,
):
    """Evaluate one aggregate: (data[capacity|1], valid | None)."""
    red = _Reducer(info, capacity, contrib, share)

    if name in _FINAL_COMBINES:
        return _FINAL_COMBINES[name](out_type, arg, red)
    if name.startswith("var_final:"):
        return _var_final(name[10:], arg, red)
    if isinstance(arg, list) and len(arg) == 1:
        arg = arg[0]
    if name == "count_all":
        return red.count(), None

    if name == "count_if":
        data, valid = arg
        eff = contrib & data
        if valid is not None:
            eff = eff & valid
        return _Reducer(info, capacity, eff, share).count(), None

    if name in ("approx_distinct", "approx_distinct_partial"):
        # HLL over prepared 64-bit hash lanes (exec.stage builds them:
        # content hashes for varchar, values for numerics, which A1
        # hashes with dev_hash64); the PARTIAL keeps the registers
        (data, hashed), valid = arg
        eff = contrib if valid is None else (contrib & valid)
        if isinstance(out_type, T.SketchType):
            m = out_type.lanes
        else:
            m = HLL_GLOBAL_BUCKETS if info is None else HLL_GROUPED_BUCKETS
        reg = K.hll_registers(
            data, eff, None if info is None else info.group, m,
            1 if info is None else capacity, hashed,
        )
        if name == "approx_distinct_partial":
            return reg, None
        return K.hll_estimate(reg), None

    if name == "approx_distinct_final":
        # register max over the member partial rows (A4), then A2
        data, valid = arg
        eff = contrib if valid is None else (contrib & valid)
        reg = K.hll_merge(
            data, eff, None if info is None else info.group,
            1 if info is None else capacity,
        )
        return K.hll_estimate(reg), None

    if name == "approx_percentile_partial":
        (vd, vv), _q = arg
        if vd.dim() == 2:
            # two-limb decimal values flatten to float64 for the summary
            # (the sketch is approximate by contract)
            vd = (
                vd[:, 0].to(torch.float64) * 4294967296.0
                + vd[:, 1].to(torch.float64)
            )
        eff = contrib if vv is None else (contrib & vv)
        k = out_type.lanes - 1
        return _quant_summary(vd, eff, info, capacity, k, red), None

    if name == "approx_percentile_final":
        (sd, sv), (qd, _qv) = arg
        return _quant_merge(sd, qd, contrib, sv, info, capacity, out_type)

    if name == "approx_percentile":
        return _percentile(arg, info, capacity, contrib, share)

    if name in ("max_by", "min_by"):
        return _arg_extreme(name == "min_by", arg, info, capacity, contrib, share)

    if name not in _PLAIN_AGGREGATES:
        raise NotImplementedError(f"compute_aggregate: {name}")

    data, valid = arg
    red = red.with_valid(valid)

    if name == "count":
        return red.count(), None

    cnt = red.count()
    nonempty = cnt > 0

    if name == "sum":
        if isinstance(out_type, T.DecimalType) and out_type.is_long:
            # decimal(38) sum: exact two-limb int64 accumulation
            hi, lo = red.sum_limbs(data)
            return torch.stack([hi, lo], dim=-1), nonempty
        cast = (
            torch_dtype(out_type.np_dtype)
            if isinstance(out_type, (T.DoubleType, T.RealType))
            else None
        )
        return red.sum(data, dtype=cast), nonempty

    if name == "avg":
        if isinstance(out_type, T.DecimalType):
            # exact limb sum, then exact 96/64 long division with
            # round-half-away
            hi, lo = red.sum_limbs(data)
            q = _limb_div_round(hi, lo, torch.clamp(cnt, min=1))
            if out_type.is_long:
                q = _limb_encode(q)
            return q, nonempty
        s = red.sum(data, dtype=torch.float64)
        return s / torch.clamp(cnt, min=1), nonempty

    if name in ("any_value", "arbitrary"):
        return red.first_value(data), nonempty

    if name in ("bool_and", "bool_or"):
        is_min = name == "bool_and"
        out = red.minmax(data.to(torch.int8), 1 if is_min else 0, is_min)
        return out.to(torch.bool), nonempty

    if name in VARIANCE_FNS:
        return _variance(name, data, red, cnt)

    is_min = name == "min"
    if data.dim() == 2:
        # two-limb decimal: extreme of hi, then extreme of lo among rows
        # at that hi
        hi, lo = data[:, 0], data[:, 1]
        iinfo = torch.iinfo(I64)
        m_hi = red.minmax(hi, iinfo.max if is_min else iinfo.min, is_min)
        if info is None:
            at_ext = hi == m_hi[0]
        else:
            at_ext = hi == m_hi[info.group.clamp(0, capacity - 1)]
        red2 = _Reducer(info, capacity, red.contrib & at_ext, share)
        m_lo = red2.minmax(lo, (1 << 32) if is_min else -1, is_min)
        return torch.stack([m_hi, m_lo], dim=-1), nonempty
    if data.dtype == torch.bool:
        out = red.minmax(data.to(torch.int8), 1 if is_min else 0, is_min)
        return out.to(torch.bool), nonempty
    if data.dtype.is_floating_point:
        fill = float("inf") if is_min else float("-inf")
    else:
        iinfo = torch.iinfo(data.dtype)
        fill = iinfo.max if is_min else iinfo.min
    return red.minmax(data, fill, is_min), nonempty


_PLAIN_AGGREGATES = {
    "count", "sum", "avg", "min", "max", "any_value", "arbitrary",
    "bool_and", "bool_or", *VARIANCE_FNS,
}


def _variance(name, data, red: _Reducer, cnt):
    """The variance family as the JAX package computes it: float64 sums
    ``s1`` and ``s2`` (K2 per group), ``m2 = s2 - s1^2 / n`` clamped at
    0, divided by n or n - 1; NULL below 1 or 2 rows. The squares are
    taken after the shared gather into group order."""
    if red.info is None:
        x = torch.where(red.contrib, data.to(torch.float64), 0.0)
        s1 = x.sum()[None]
        s2 = (x * x).sum()[None]
    else:
        xs = red._sorted(data).to(torch.float64)
        xs = torch.where(red.contrib_s, xs, _zero(xs))
        s1 = K.seg_sum_ranges(xs, red.info)
        s2 = K.seg_sum_ranges(xs * xs, red.info)
    n = cnt.to(torch.float64)
    m2 = (s2 - (s1 * s1) / n.clamp(min=1.0)).clamp(min=0.0)
    pop = name.endswith("_pop")
    denom = n if pop else n - 1.0
    var = m2 / denom.clamp(min=1.0)
    if name.startswith("stddev"):
        var = _sqrt(var)
    return var, cnt >= (1 if pop else 2)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as the JAX package's. torch's
    CPU kernel can be an ulp off (sqrt(2.0) gives 1.414213562373095);
    numpy's and CUDA's are IEEE square roots."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _stable_argsort(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bool:
        x = x.to(torch.int8)
    return torch.sort(x, stable=True).indices


def _quant_sorted_perm(vd, eff, info):
    """Permutation ordering rows (group asc, contributing first, value
    asc): three stable sorts, as the exact percentile's."""
    p = _stable_argsort(K.order_bits(vd))
    p = p[_stable_argsort((~eff)[p])]
    if info is not None:
        p = p[_stable_argsort(info.group[p])]
    return p


def _quant_summary(vd, eff, info, capacity, k, red):
    """Mergeable quantile summary: k evenly spaced order statistics per
    group and a count lane, float64[caps, k + 1] (``quant_summary``, A5
    on the card, over the order of ``_quant_sorted_perm``). The rank
    error after merging S chunks is at most total/k per chunk."""
    p = _quant_sorted_perm(vd, eff, info)
    cnt = _Reducer(red.info, capacity, eff, red.share).count()
    if info is None:
        starts = torch.zeros(1, dtype=I64, device=vd.device)
    else:
        starts = info.starts
    return K.quant_summary(vd, p, starts, cnt[: starts.shape[0]], k)


def _quant_merge(states, q, contrib, valid, info, capacity, out_type):
    """FINAL combine of quantile summaries: the member rows' points merge
    as a weighted quantile, each point weighing count/k (``quant_merge``,
    A6 on the card), cast to the output type."""
    eff = contrib if valid is None else (contrib & valid)
    if info is None:
        caps, group = 1, None
    else:
        caps, group = capacity, info.group.clamp(0, capacity - 1)
    qv = q.reshape(-1)[:1].to(torch.float64)
    out, has = K.quant_merge(states, eff, group, caps, qv)
    if isinstance(out_type, (T.DoubleType, T.RealType)):
        return out.to(torch_dtype(out_type.np_dtype)), has
    if isinstance(out_type, T.DecimalType) and out_type.is_long:
        return _limb_encode(torch.round(out).to(I64)), has
    return torch.round(out).to(I64).to(torch_dtype(out_type.np_dtype)), has


def _percentile(arg, info, capacity, contrib, share):
    """approx_percentile, exactly: rows re-sort (group, contributing
    first, value) with stable sorts and each group reads index
    ``round(q * (cnt - 1))`` (half to even) of its run, which occupies
    ``info``'s range of the group (the same rows, dead rows last)."""
    (vd, vv), (qd, _qv) = arg
    eff = contrib if vv is None else (contrib & vv)
    q = qd.reshape(-1)[0].to(torch.float64)
    n = vd.shape[0]
    if vd.dim() == 2:
        # two-limb decimal: order is (hi signed, lo canonical), so sort
        # by lo, then stably by hi
        p = _stable_argsort(K.order_bits(vd[:, 1]))
        p = p[_stable_argsort(K.order_bits(vd[p, 0]))]
    else:
        p = _stable_argsort(K.order_bits(vd))
    p = p[_stable_argsort((~eff)[p])]
    cnt = _Reducer(info, capacity, eff, share).count()
    if info is None:
        starts = torch.zeros(1, dtype=I64, device=vd.device)
    else:
        p = p[_stable_argsort(info.group[p])]
        starts = info.starts
    offs = torch.round(q * (cnt.to(torch.float64) - 1.0)).to(I64)
    offs = torch.minimum(offs.clamp(min=0), (cnt - 1).clamp(min=0))
    at = (starts + offs).clamp(0, max(n - 1, 0))
    return vd[p[at]], cnt > 0


def _arg_extreme(is_min, arg, info, capacity, contrib, share):
    """max_by / min_by: the value at the first contributing row whose key
    is greatest (least); a contributing row with a NULL key does not
    count. Global: a masked reduction over ``order_bits``; grouped:
    ``seg_arg_extreme`` (A3 on the card)."""
    (vd, vv), (kd, kv) = arg
    if kd.dim() == 2:
        raise NotImplementedError("max_by/min_by over a decimal(38) key")
    eff = contrib if kv is None else (contrib & kv)
    n = kd.shape[0]
    if info is None:
        kbits = K.order_bits(kd)
        worst = (1 << 63) - 1 if is_min else -(1 << 63)
        masked = torch.where(eff, kbits, torch.full_like(kbits, worst))
        m = masked.amin() if is_min else masked.amax()
        # the first contributing row at the extreme: a real key equal to
        # the sentinel must not lose to an excluded row
        idx = torch.argmax((eff & (masked == m)).to(torch.int8))[None]
        has = eff.any()[None]
    else:
        er = _Reducer(info, capacity, eff, share)
        idx = K.seg_arg_extreme(kd.contiguous(), eff, info, is_min)
        has = er.count() > 0
    at = idx.clamp(0, max(n - 1, 0))
    out = vd[at]
    return out, (has if vv is None else (has & vv[at]))


# ---- exact two-limb decimal helpers ----------------------------------------


def _limb_encode(q: torch.Tensor) -> torch.Tensor:
    """An int64 value as canonical two limbs (hi signed, lo in [0, 2^32))."""
    return torch.stack([q >> 32, q & 0xFFFFFFFF], dim=-1)


def _limb_norm(s_hi, s_lo):
    """Canonicalize limb sums: lo into [0, 2^32), carry into hi."""
    carry = s_lo >> 32
    lo = s_lo & 0xFFFFFFFF
    return s_hi + carry, lo


def _limb_div_round(hi, lo, cnt):
    """(hi*2^32 + lo) / cnt exactly, rounded half away from zero
    (schoolbook 96/64 long division in two int64 steps)."""
    q1 = torch.div(hi, cnt, rounding_mode="floor")
    r1 = hi - q1 * cnt  # in [0, cnt)
    rem = (r1 << 32) | lo
    q2 = torch.div(rem, cnt, rounding_mode="floor")
    r2 = rem - q2 * cnt
    q = (q1 << 32) + q2  # floor((hi*2^32+lo)/cnt)
    neg = (hi < 0) | ((hi == 0) & (lo < 0))
    bump = torch.where(neg, 2 * r2 > cnt, 2 * r2 >= cnt)
    return q + bump.to(q.dtype)


# ---- FINAL-step combines over partial states --------------------------------


def _state_sum(pair, red: _Reducer):
    data, valid = pair
    if valid is not None:
        key = ("nulled", id(data), id(valid))
        hit = red.share.get(key)
        if hit is None or hit[0] is not data or hit[1] is not valid:
            hit = (data, valid, torch.where(valid, data, _zero(data)))
            red.share[key] = hit
        data = hit[2]
    return red.sum(data)


def _count_final(out_type, args, red: _Reducer):
    """Sum of partial counts; never NULL (COUNT semantics)."""
    pair = args[0] if isinstance(args, list) else args
    return _state_sum(pair, red), None


def _avg_final(out_type, args, red: _Reducer):
    s = _state_sum(args[0], red)
    c = _state_sum(args[1], red)
    nonempty = c > 0
    if isinstance(out_type, T.DecimalType):
        q = _div_round_half_up(s, torch.clamp(c, min=1))
        if out_type.is_long:
            q = _limb_encode(q)
        return q, nonempty
    return s.to(torch.float64) / torch.clamp(c, min=1), nonempty


def _decimal_sum_final(out_type, args, red: _Reducer):
    """FINAL combine of long-decimal sums from (hi32, lo) partials."""
    s_hi = _state_sum(args[0], red)
    s_lo = _state_sum(args[1], red)
    hi, lo = _limb_norm(s_hi, s_lo)
    _, hv = args[0]
    cred = red.with_valid(hv)
    return torch.stack([hi, lo], dim=-1), cred.count() > 0


def _decimal_avg_final(out_type, args, red: _Reducer):
    """FINAL combine of decimal averages from limb partials + counts."""
    s_hi = _state_sum(args[0], red)
    s_lo = _state_sum(args[1], red)
    cnt = _state_sum(args[2], red)
    hi, lo = _limb_norm(s_hi, s_lo)
    nonempty = cnt > 0
    q = _limb_div_round(hi, lo, torch.clamp(cnt, min=1))
    if isinstance(out_type, T.DecimalType) and out_type.is_long:
        q = _limb_encode(q)
    return q, nonempty


def _var_final(kind, args, red: _Reducer):
    """FINAL combine of the variance family from partial (n, s1, s2):
    the state sums (K2), then the resident form's arithmetic."""
    n = _state_sum(args[0], red).to(torch.float64)
    s1 = _state_sum(args[1], red)
    s2 = _state_sum(args[2], red)
    m2 = (s2 - (s1 * s1) / n.clamp(min=1.0)).clamp(min=0.0)
    pop = kind.endswith("_pop")
    denom = n if pop else n - 1.0
    var = m2 / denom.clamp(min=1.0)
    if kind.startswith("stddev"):
        var = _sqrt(var)
    return var, n >= (1 if pop else 2)


def _limb_partial_sum(which: str):
    """PARTIAL limb sums of a decimal column: 'hi32' sums the
    sign-extended top 32 bits, 'lo32' the low 32 bits (both exact in
    int64 for any page; the two share the sorted gather)."""

    def fn(out_type, args, red: _Reducer):
        pair = args[0] if isinstance(args, list) else args
        data, valid = pair
        r = red.with_valid(valid)
        hi, lo = r.sum_limbs(data)
        # NULL when no row contributed, so the FINAL combine keeps SUM's
        # all-NULL-group semantics
        return (hi if which == "hi32" else lo), r.count() > 0

    return fn


_FINAL_COMBINES = {
    "count_final": _count_final,
    "avg_final": _avg_final,
    "decimal_sum_final": _decimal_sum_final,
    "decimal_avg_final": _decimal_avg_final,
    "sum_hi32": _limb_partial_sum("hi32"),
    "sum_lo32": _limb_partial_sum("lo32"),
}
