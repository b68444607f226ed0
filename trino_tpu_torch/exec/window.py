"""Window function evaluation — the torch port of
``trino_tpu/exec/window.py``: sort-based, scatter-free.

One program computes every window function of a ``Window`` node:

1. rows are permuted to (partition, order-keys) order — the ORDER BY
   keys are sorted first (``kernels.sort_perm``), then a stable partition
   grouping (``kernels.group_by`` with ``pre_perm``) leaves each
   partition as one contiguous, ordered run;
2. ranks and frames become position arithmetic over that run structure:
   peer groups come from W1 (``kernels.window_peers``), frame sums from W2
   (``range_sum``), running min/max from W3 (``range_minmax``) and RANGE
   offset bounds from W4 (``seg_searchsorted``);
3. results gather back to original row order through the inverse
   permutation.

It stays a plain function over tensors, as the JAX one is.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.exec import kernels as K
from trino_tpu_torch.exec.aggregates import (
    _limb_div_round,
    _limb_encode,
    _limb_norm,
)
from trino_tpu_torch.exec.stage import _key_width
from trino_tpu_torch.expr.compiler import _div_round_half_up
from trino_tpu_torch.expr.ir import Literal
from trino_tpu_torch.plan import nodes as P

__all__ = ["build_window_program"]

I64 = torch.int64
#: SQL default frame: RANGE BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW
_DEFAULT_FRAME = ("range", ("unbounded_preceding", None), ("current", None))


def build_window_program(node: P.Window, layout_types, layout_dicts,
                         capacity, hashed=frozenset()):
    """(fn, out_meta): ``fn(env, mask) -> env2`` adds one column per
    window function; ``out_meta`` is [(sym, type, dictionary)] for the
    new columns. ``hashed`` names the hash-coded VARCHAR columns: a
    partition key among them groups by its hash lane (as a GROUP BY
    does); an ORDER BY key among them raises."""
    part_syms = list(node.partition_by)
    order_keys = [
        (k.symbol, k.ascending, k.nulls_first) for k in node.order_keys
    ]
    if any(s in hashed for s, _a, _nf in order_keys):
        raise NotImplementedError(
            "window ORDER BY over a hash-coded varchar column"
        )
    widths = tuple(
        64 if s in hashed else _key_width(layout_types[s], layout_dicts.get(s))
        for s in part_syms
    )
    fns = dict(node.functions)
    with_dense = any(c.name == "dense_rank" for c in fns.values())
    out_meta = []
    for sym, call in fns.items():
        d = None
        if (
            isinstance(call.type, T.VarcharType)
            and call.args
            and hasattr(call.args[0], "name")
        ):
            d = layout_dicts.get(call.args[0].name)
        out_meta.append((sym, call.type, d))

    def fn(env, mask):
        n = mask.shape[0]
        dev = mask.device
        # 1. order-by sort first, stable partition grouping on top
        if order_keys:
            sk = []
            for s, asc, nf in order_keys:
                if nf is None:
                    nf = not asc  # reference default: nulls largest
                data, valid = env[s]
                if data.dim() == 2:
                    # two-limb decimal key: (hi, lo) lexicographic ==
                    # numeric order (hi signed, lo canonical)
                    sk.append((data[:, 0], valid, asc, nf))
                    sk.append((data[:, 1], None, asc, False))
                else:
                    sk.append((data, valid, asc, nf))
            pre = K.sort_perm(sk, mask)
        else:
            pre = None
        part_cols = [
            (env[s][0][:, 0], env[s][1]) if s in hashed else env[s]
            for s in part_syms
        ]
        info = K.group_by(part_cols, mask, n, widths=widths, pre_perm=pre)
        perm = info.perm
        pos = torch.arange(n, dtype=I64, device=dev)
        inv = torch.empty_like(perm)
        inv[perm] = pos
        live_s = mask[perm]
        # partition start/end per sorted row
        gid_c = info.gid_sorted.clamp(0, n - 1)
        pstart = info.starts[gid_c]
        pend = info.ends[gid_c]  # exclusive
        # peer groups: order-key ties within a partition (W1)
        peer_keys = []
        for s, _asc, _nf in order_keys:
            data, valid = env[s]
            parts = [data[:, 0], data[:, 1]] if data.dim() == 2 else [data]
            for i, p in enumerate(parts):
                peer_keys.append((p, valid if i == 0 else None))
        peer_start, peer_end, dense = K.window_peers(
            info.gid_sorted, peer_keys, perm, pend, with_dense,
        )
        row_number = pos - pstart + 1

        # RANGE-offset support: with exactly one numeric order key, the
        # key in sorted, direction-normalized form, so offset bounds
        # become segmented binary searches (W4)
        range_ctx = None
        if len(order_keys) == 1:
            s, asc, nf = order_keys[0]
            data, valid = env[s]
            t = layout_types.get(s)
            if data.dim() != 2 and data.dtype != torch.bool:
                scale = (
                    10 ** t.scale if isinstance(t, T.DecimalType) else 1
                )
                w = data[perm]
                if not asc:
                    w = -w
                vp = None
                if valid is not None:
                    vp = valid[perm]
                    nulls_first = nf if nf is not None else (not asc)
                    sent = _fill_for(w.dtype, not nulls_first)
                    w = torch.where(vp, w, torch.full_like(w, sent))
                range_ctx = (w, vp, scale)

        ctx = _Sorted(
            env, perm, info, pos, live_s, pstart, pend, peer_start,
            peer_end, dense, row_number, n, range_ctx,
        )
        env2 = dict(env)
        for sym, call in fns.items():
            data_s, valid_s = _eval_call(call, ctx)
            # back to original row order
            env2[sym] = (
                data_s[inv], None if valid_s is None else valid_s[inv]
            )
        return env2

    return fn, out_meta


class _Sorted(NamedTuple):
    """The sorted-space context every window function of a node reads."""

    env: dict
    perm: torch.Tensor
    info: K.GroupInfo
    pos: torch.Tensor
    live_s: torch.Tensor
    pstart: torch.Tensor
    pend: torch.Tensor
    peer_start: torch.Tensor
    peer_end: torch.Tensor
    dense: torch.Tensor | None
    row_number: torch.Tensor
    n: int
    range_ctx: tuple | None


def _clip(x, lo, hi):
    """``jnp.clip`` with tensor bounds: min(max(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _limb_lanes(data, contrib):
    """(hi, lo) int64 limb lanes of a decimal(38) argument, zero where a
    row does not contribute; the argument may already be two limbs."""
    if data.dim() == 2:
        zero = torch.zeros((), dtype=data.dtype, device=data.device)
        return (
            torch.where(contrib, data[:, 0], zero).contiguous(),
            torch.where(contrib, data[:, 1], zero).contiguous(),
        )
    masked = torch.where(contrib, data, torch.zeros_like(data)).to(I64)
    return masked >> 32, masked & 0xFFFFFFFF


def _eval_call(call, c: _Sorted):
    """One window function in sorted space."""
    name = call.name
    n = c.n
    pos, pstart, pend = c.pos, c.pstart, c.pend
    if name == "row_number":
        return c.row_number, None
    if name == "rank":
        return c.peer_start - pstart + 1, None
    if name == "dense_rank":
        return c.dense - c.dense[pstart.clamp(0, n - 1)] + 1, None
    if name == "percent_rank":
        # (rank - 1) / (partition rows - 1); 0 for single-row partitions
        size = (pend - pstart).to(torch.float64)
        rank = (c.peer_start - pstart + 1).to(torch.float64)
        return (
            torch.where(
                size > 1, (rank - 1) / torch.clamp(size - 1, min=1),
                torch.zeros_like(size),
            ),
            None,
        )
    if name == "cume_dist":
        # rows preceding or peer with current / partition rows
        size = (pend - pstart).to(torch.float64)
        return (
            (c.peer_end - pstart).to(torch.float64) / torch.clamp(size, min=1),
            None,
        )
    if name == "ntile":
        k = _const_arg(call.args[0])
        size = pend - pstart
        i = c.row_number - 1
        return (
            torch.div(i * k, torch.clamp(size, min=1), rounding_mode="floor")
            + 1,
            None,
        )
    if name in ("lead", "lag"):
        off = _const_arg(call.args[1]) if len(call.args) > 1 else 1
        step = off if name == "lead" else -off
        src = pos + step
        ok = (src >= pstart) & (src < pend)
        data, valid = _sorted_arg(c, call.args[0])
        at = src.clamp(0, n - 1)
        out = data[at]
        out_valid = ok if valid is None else (ok & valid[at])
        if len(call.args) > 2:
            dd, dv = _sorted_arg(c, call.args[2])
            out = torch.where(ok[:, None] if out.dim() == 2 else ok, out, dd)
            dval = torch.ones_like(ok) if dv is None else dv
            base = torch.ones_like(ok) if valid is None else valid[at]
            out_valid = torch.where(ok, base, dval)
        return out, out_valid
    frame = call.frame or _DEFAULT_FRAME
    mode, start, end = frame
    if name in ("min", "max") and start[0] != "unbounded_preceding":
        # running scans cover prefix frames only
        raise NotImplementedError(
            "min/max window frames must start UNBOUNDED PRECEDING"
        )
    # frame bounds as sorted positions [lo, hi) per row
    if mode == "range" and (
        start[0] in ("preceding", "following")
        or end[0] in ("preceding", "following")
    ):
        if c.range_ctx is None:
            raise NotImplementedError(
                "RANGE offset frames require exactly one numeric "
                "ORDER BY key"
            )
        w, vp, scale = c.range_ctx

        def rbound(b, is_lo):
            kind, off = b
            if kind == "unbounded_preceding":
                return pstart
            if kind == "unbounded_following":
                return pend
            if kind == "current":
                return c.peer_start if is_lo else c.peer_end
            delta = off * scale * (1 if kind == "following" else -1)
            target = w + torch.tensor(delta, device=w.device).to(w.dtype)
            return _seg_searchsorted(w, target, pstart, pend, is_lo)

        lo = rbound(start, True)
        hi = rbound(end, False)
        if vp is not None:
            # null-key rows: the frame is the null peer group
            lo = torch.where(vp, lo, c.peer_start)
            hi = torch.where(vp, hi, c.peer_end)
    else:
        lo = _bound_pos(start, c, mode, True)
        hi = _bound_pos(end, c, mode, False)
    lo = _clip(lo, pstart, pend)
    hi = _clip(hi, pstart, pend)

    if name in ("first_value", "last_value"):
        data, valid = _sorted_arg(c, call.args[0])
        at = (lo if name == "first_value" else hi - 1).clamp(0, n - 1)
        ok = hi > lo
        out_valid = ok if valid is None else (ok & valid[at])
        return data[at], out_valid
    if name == "nth_value":
        k = _const_arg(call.args[1])
        data, valid = _sorted_arg(c, call.args[0])
        at = (lo + k - 1).clamp(0, n - 1)
        ok = (lo + k - 1 < hi) if k >= 1 else torch.zeros_like(hi > lo)
        out_valid = ok if valid is None else (ok & valid[at])
        return data[at], out_valid
    # aggregates over the frame: the count lane rides in every W2 launch
    gid = c.info.gid_sorted
    if name == "count_all":
        contrib = c.live_s
        data = None
    else:
        data, valid = _sorted_arg(c, call.args[0] if call.args else None)
        contrib = c.live_s if valid is None else (c.live_s & valid)
    cnt_lane = contrib.to(I64)
    if name in ("count", "count_all"):
        (cnt,) = K.range_sum([cnt_lane], gid, lo, hi)
        return cnt, None
    long_dec = isinstance(call.type, T.DecimalType) and call.type.is_long
    if name == "sum":
        if long_dec:
            # exact limb window sums (frames bounded by the page, so both
            # 32-bit limb prefix sums stay within int64); the argument may
            # itself already be a two-limb column (sum(sum(decimal)) OVER)
            hi_in, lo_in = _limb_lanes(data, contrib)
            cnt, s_hi, s_lo = K.range_sum([cnt_lane, hi_in, lo_in], gid, lo, hi)
            carry = s_lo >> 32
            return (
                torch.stack([s_hi + carry, s_lo & 0xFFFFFFFF], dim=-1),
                cnt > 0,
            )
        lane = _sum_lane(data, contrib)
        cnt, s = K.range_sum([cnt_lane, lane], gid, lo, hi)
        return s.to(data.dtype), cnt > 0
    if name == "avg":
        if long_dec:
            # limb window sums + exact 96/64 divide
            hi_in, lo_in = _limb_lanes(data, contrib)
            cnt, s_hi, s_lo = K.range_sum([cnt_lane, hi_in, lo_in], gid, lo, hi)
            h2, l2 = _limb_norm(s_hi, s_lo)
            q = _limb_div_round(h2, l2, torch.clamp(cnt, min=1))
            return _limb_encode(q), cnt > 0
        if isinstance(call.type, T.DecimalType):
            cnt, s = K.range_sum([cnt_lane, _sum_lane(data, contrib)], gid, lo, hi)
            return _div_round_half_up(s, torch.clamp(cnt, min=1)), cnt > 0
        lane = _sum_lane(data.to(torch.float64), contrib)
        cnt, s = K.range_sum([cnt_lane, lane], gid, lo, hi)
        return s / torch.clamp(cnt, min=1), cnt > 0
    if name in ("min", "max"):
        (cnt,) = K.range_sum([cnt_lane], gid, lo, hi)
        return _range_minmax(data, contrib, lo, hi, gid, name == "min"), cnt > 0
    raise NotImplementedError(f"window function {name}")


def _sum_lane(data, contrib):
    """A window sum's value lane: float64 for floats, int64 otherwise
    (narrow integers widen; the result narrows back, wrapping as the JAX
    package's int64 cumsum cast to the input type does)."""
    if data.dtype.is_floating_point:
        return torch.where(
            contrib, data.to(torch.float64),
            torch.zeros((), dtype=torch.float64, device=data.device),
        )
    return torch.where(contrib, data, torch.zeros_like(data)).to(I64)


def _range_minmax(data, contrib, lo, hi, gid, is_min):
    """Running min/max through W3, which takes int64, float64 or two
    int64 limbs: narrower types widen (order preserving) and narrow
    back."""
    if data.dim() == 2:
        fill = K._limb_fill(is_min)
        fill_t = torch.tensor(fill, dtype=I64, device=data.device)
        masked = torch.where(contrib[:, None], data, fill_t).contiguous()
        return K.range_minmax(masked, gid, lo, hi, fill, is_min)
    fill = _fill_for(data.dtype, is_min)
    masked = torch.where(contrib, data, torch.full_like(data, fill))
    if data.dtype.is_floating_point:
        wide = masked.to(torch.float64)
    else:
        wide = masked.to(I64)
        fill = int(fill)
    out = K.range_minmax(wide.contiguous(), gid, lo, hi, fill, is_min)
    return out.to(data.dtype)


def _seg_searchsorted(w, target, lo0, hi0, left):
    """W4 over int64/float64 keys: narrower keys widen (order
    preserving) after the direction normalization and the offset were
    applied in their own type, as in the JAX package."""
    if w.dtype.is_floating_point:
        w, target = w.to(torch.float64), target.to(torch.float64)
    else:
        w, target = w.to(I64), target.to(I64)
    return K.seg_searchsorted(
        w.contiguous(), target.contiguous(), lo0.contiguous(),
        hi0.contiguous(), left,
    )


def _const_arg(ref) -> int:
    if isinstance(ref, Literal):
        return int(ref.value)
    raise NotImplementedError("window offset must be a literal")


def _sorted_arg(c: _Sorted, ref):
    if ref is None:
        return None, None
    n = c.n
    dev = c.perm.device
    if isinstance(ref, Literal):
        from trino_tpu_torch.page import torch_dtype

        dtype = torch_dtype(ref.type.np_dtype)
        if ref.value is None:
            return (
                torch.zeros(n, dtype=dtype, device=dev),
                torch.zeros(n, dtype=torch.bool, device=dev),
            )
        if not isinstance(ref.value, (int, float, bool)):
            raise NotImplementedError(
                f"literal window argument {ref.value!r}"
            )
        return torch.full((n,), ref.value, dtype=dtype, device=dev), None
    data, valid = c.env[ref.name]
    return data[c.perm], None if valid is None else valid[c.perm]


def _bound_pos(bound, c: _Sorted, mode, is_lo):
    kind, off = bound
    if kind == "unbounded_preceding":
        return c.pstart
    if kind == "unbounded_following":
        return c.pend
    if kind == "current":
        if mode == "range":
            # RANGE CURRENT ROW includes the whole peer group
            return c.peer_start if is_lo else c.peer_end
        return c.pos if is_lo else c.pos + 1
    if kind == "preceding":
        return c.pos - off if is_lo else c.pos - off + 1
    # following
    return c.pos + off if is_lo else c.pos + off + 1


def _fill_for(dtype, is_min):
    """The identity of a running min (``is_min``) or max of ``dtype``."""
    if dtype.is_floating_point:
        return float("inf") if is_min else float("-inf")
    if dtype == torch.bool:
        return bool(is_min)
    info = torch.iinfo(dtype)
    return info.max if is_min else info.min
