"""The port's window program and its kernels' plain versions (on the CPU)
against the JAX package's ``exec/window.py``.

The same inputs, made with numpy from fixed seeds, go through both
packages. ``test_window_program_matches_jax`` builds one ``Window`` node
per case with every window function the JAX package has (row_number,
rank, dense_rank, percent_rank, cume_dist, ntile, lead, lag, first_value,
last_value, nth_value, count, count_all, sum, avg, min, max) under ROWS,
RANGE and RANGE offset frames, ascending and descending keys with NULLs
first and last, INT64_MIN in a descending key, float64 keys and values
with NaN and -0.0, two-limb decimals, an empty page, one partition and
many. ``test_window_kernel_matches_jax`` holds W1-W4's plain versions
against the JAX lines and helpers they replace (``window.py:94-122``,
``_range_sum``, ``_range_minmax``, ``_range_minmax_limbs``,
``_seg_searchsorted``).

Tolerance: integers, decimals, ranks and positions must be equal; a
float64 frame sum or average to relative 1e-9, because the port's
segmented scan adds in another order than ``jax.lax.associative_scan``;
every other float (percent_rank, cume_dist, min, max, first_value) equal.
Only live rows are compared: dead rows carry no defined value.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trino_tpu import types as JT
from trino_tpu.exec import window as JW
from trino_tpu.expr import ir as JIR
from trino_tpu.plan import nodes as JP
from trino_tpu_torch import types as TT
from trino_tpu_torch.exec import kernels as TK
from trino_tpu_torch.exec import window as TW
from trino_tpu_torch.expr import ir as TIR
from trino_tpu_torch.plan import nodes as TP

from test_torch_tile_cases import PEER_CASES, peer_case

I64_MIN = np.iinfo(np.int64).min
N = 96

#: per scenario: partition key, ORDER BY keys (column, ascending,
#: nulls_first) and the value column's kind
SCENARIOS = {
    "asc_nulls_last": dict(part=["p"], order=[("k", True, False)], vals="float"),
    "desc_nulls_first": dict(part=["p"], order=[("k", False, True)], vals="float"),
    "desc_int64_min": dict(part=["p"], order=[("kmin", False, None)], vals="int"),
    "float_key": dict(part=["p"], order=[("f", True, None)], vals="float"),
    "float_key_desc": dict(part=["p"], order=[("f", False, True)], vals="int"),
    "decimal_key": dict(part=["p"], order=[("d", True, None)], vals="limbs"),
    "limb_key_values": dict(part=["p"], order=[("l", True, None)], vals="limbs"),
    "two_keys": dict(part=["p"], order=[("k", True, None), ("f", False, None)],
                     vals="decimal"),
    "one_partition": dict(part=[], order=[("k", True, None)], vals="float"),
    "many_partitions": dict(part=["q"], order=[("k", False, False)], vals="int"),
    "no_order": dict(part=["p"], order=[], vals="float"),
    "empty_page": dict(part=["p"], order=[("k", True, None)], vals="float",
                       empty=True),
}

#: per frame kind: the aggregates' frame and the prefix frame min/max take
FRAMES = {
    "rows": (("rows", ("preceding", 2), ("following", 1)),
             ("rows", ("unbounded_preceding", None), ("current", None))),
    "range": (None, None),
    "range_offset": (("range", ("preceding", 3), ("following", 2)),
                     ("range", ("unbounded_preceding", None), ("following", 2))),
}


def _columns(seed: int, empty: bool):
    """name -> (numpy data, numpy valid|None, torch type, jax type), and
    the live mask."""
    rng = np.random.default_rng(seed)
    live = np.zeros(N, dtype=np.bool_) if empty else rng.random(N) >= 0.2
    k = rng.integers(-4, 12, size=N).astype(np.int64)
    kmin = rng.choice(np.array([I64_MIN, -5, 0, 3, 9], dtype=np.int64), size=N)
    f = rng.choice(np.array([-1.5, -0.0, 0.0, 2.25, np.nan, 7.0]), size=N)
    d = rng.integers(-2_000, 2_000, size=N).astype(np.int64)  # decimal(12, 2)
    wide = rng.integers(-(1 << 40), 1 << 40, size=N).astype(np.int64)
    limbs = np.stack([wide >> 32, wide & 0xFFFFFFFF], axis=-1)
    v = rng.uniform(1.0, 100.0, size=N)
    v[rng.random(N) < 0.05] = np.nan
    v[rng.random(N) < 0.05] = -0.0
    cols = {
        "p": (rng.integers(0, 5, size=N).astype(np.int64), rng.random(N) >= 0.1, "bigint"),
        "q": (rng.integers(0, 40, size=N).astype(np.int64), None, "bigint"),
        "k": (k, rng.random(N) >= 0.15, "bigint"),
        "kmin": (kmin, None, "bigint"),
        "f": (f, rng.random(N) >= 0.1, "double"),
        "d": (d, rng.random(N) >= 0.1, "decimal(12,2)"),
        "l": (limbs, rng.random(N) >= 0.1, "decimal(38,2)"),
        "v_float": (v, rng.random(N) >= 0.1, "double"),
        "v_int": (rng.integers(-50, 50, size=N).astype(np.int64), rng.random(N) >= 0.1, "bigint"),
        "v_decimal": (d * 7, rng.random(N) >= 0.1, "decimal(12,2)"),
        "v_limbs": (limbs[::-1].copy(), rng.random(N) >= 0.1, "decimal(38,2)"),
    }
    return cols, live


def _type(pkg, name: str):
    if name.startswith("decimal"):
        p, s = name[8:-1].split(",")
        return pkg.DecimalType(int(p), int(s))
    return {"bigint": pkg.BIGINT, "double": pkg.DOUBLE}[name]


def _calls(pkg, ir, vcol: str, vtype: str, frame, prefix):
    """output symbol -> WindowCall of every function over value ``vcol``."""
    t = _type(pkg, vtype)
    v = ir.InputRef(type=t, name=vcol)
    lit = lambda x, ty: ir.Literal(type=ty, value=x)  # noqa: E731
    long_dec = isinstance(t, pkg.DecimalType) and t.is_long
    sum_t = pkg.DecimalType(38, t.scale) if isinstance(t, pkg.DecimalType) else t
    avg_t = t if isinstance(t, pkg.DecimalType) else pkg.DOUBLE
    calls = {
        "row_number": ("row_number", (), pkg.BIGINT, None),
        "rank": ("rank", (), pkg.BIGINT, None),
        "dense_rank": ("dense_rank", (), pkg.BIGINT, None),
        "percent_rank": ("percent_rank", (), pkg.DOUBLE, None),
        "cume_dist": ("cume_dist", (), pkg.DOUBLE, None),
        "ntile": ("ntile", (lit(3, pkg.BIGINT),), pkg.BIGINT, None),
        "lead": ("lead", (v,), t, None),
        "lag2": ("lag", (v, lit(2, pkg.BIGINT)), t, None),
        "count": ("count", (v,), pkg.BIGINT, frame),
        "count_all": ("count_all", (), pkg.BIGINT, frame),
        "sum": ("sum", (v,), sum_t, frame),
        "avg": ("avg", (v,), avg_t, frame),
        "first_value": ("first_value", (v,), t, frame),
        "last_value": ("last_value", (v,), t, frame),
        "nth_value": ("nth_value", (v, lit(2, pkg.BIGINT)), t, frame),
        "min": ("min", (v,), t, prefix),
        "max": ("max", (v,), t, prefix),
    }
    if not long_dec:
        calls["lag_default"] = (
            "lag", (v, lit(1, pkg.BIGINT), lit(0, t)), t, None
        )
    return calls


def _node(pkg, ir, nodes, sc, vcol, vtype, frame, prefix):
    return nodes.Window(
        outputs={},
        source=None,
        partition_by=list(sc["part"]),
        order_keys=[nodes.SortKey(s, a, nf) for s, a, nf in sc["order"]],
        functions={
            sym: nodes.WindowCall(name, args, t, fr)
            for sym, (name, args, t, fr) in _calls(
                pkg, ir, vcol, vtype, frame, prefix
            ).items()
        },
    )


def _compare(sym, got, want, live, rtol):
    gd, gv = got
    wd, wv = want
    gd = gd.numpy() if isinstance(gd, torch.Tensor) else np.asarray(gd)
    wd = np.asarray(wd)
    gv = None if gv is None else (gv.numpy() if isinstance(gv, torch.Tensor) else np.asarray(gv))
    wv = None if wv is None else np.asarray(wv)
    gvalid = np.ones(len(live), bool) if gv is None else gv
    wvalid = np.ones(len(live), bool) if wv is None else wv
    assert np.array_equal(gvalid[live], wvalid[live]), sym
    rows = live & wvalid
    a, b = gd[rows], wd[rows]
    if b.dtype.kind == "f":
        if rtol:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=sym)
        else:
            assert np.array_equal(a, b, equal_nan=True), sym
    else:
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), sym


CASES = [
    (sc, fr) for sc in SCENARIOS for fr in FRAMES
    if not (fr == "range_offset" and len(SCENARIOS[sc]["order"]) != 1)
    and not (fr == "range_offset" and SCENARIOS[sc]["order"][0][0] == "l")
]


@pytest.mark.parametrize("scenario,frame", CASES)
def test_window_program_matches_jax(scenario, frame):
    sc = SCENARIOS[scenario]
    cols, live = _columns(zlib.crc32(f"{scenario}/{frame}".encode()), sc.get("empty", False))
    vcol = {"float": "v_float", "int": "v_int", "decimal": "v_decimal",
            "limbs": "v_limbs"}[sc["vals"]]
    agg_frame, prefix = FRAMES[frame]
    vtype = cols[vcol][2]
    jnode = _node(JT, JIR, JP, sc, vcol, vtype, agg_frame, prefix)
    tnode = _node(TT, TIR, TP, sc, vcol, vtype, agg_frame, prefix)
    jtypes = {c: _type(JT, t) for c, (_, _, t) in cols.items()}
    ttypes = {c: _type(TT, t) for c, (_, _, t) in cols.items()}
    jfn, jmeta = JW.build_window_program(jnode, jtypes, {}, N)
    tfn, tmeta = TW.build_window_program(tnode, ttypes, {}, N)
    assert [s for s, _, _ in jmeta] == [s for s, _, _ in tmeta]
    jenv = {
        c: (jnp.asarray(d), None if v is None else jnp.asarray(v))
        for c, (d, v, _) in cols.items()
    }
    tenv = {
        c: (torch.from_numpy(d), None if v is None else torch.from_numpy(v))
        for c, (d, v, _) in cols.items()
    }
    want = jax.jit(jfn)(jenv, jnp.asarray(live))
    got = tfn(tenv, torch.from_numpy(live))
    for sym, _, _ in tmeta:
        name = tnode.functions[sym].name
        rtol = 1e-9 if name in ("sum", "avg") else 0
        _compare(sym, got[sym], want[sym], live, rtol)


# ---- the kernels' plain versions against the JAX lines and helpers -----------


def _sorted_case(seed: int, n: int):
    """Sorted partition ids (dead rows last, one id past the live ones),
    frame bounds inside each partition, and partition starts/ends."""
    rng = np.random.default_rng(seed)
    n_live = int(n * 0.85)
    sizes = rng.integers(1, 9, size=n)
    gid = np.repeat(np.arange(n), sizes)[:n_live].astype(np.int64)
    if n_live and rng.random() < 0.5:
        gid[: n_live // 2] = 0  # one huge partition beside small ones
        gid = np.maximum.accumulate(gid)
    gid = np.concatenate([gid, np.full(n - n_live, n, dtype=np.int64)])
    pos = np.arange(n)
    first = np.r_[True, gid[1:] != gid[:-1]] if n else np.zeros(0, bool)
    pstart = np.maximum.accumulate(np.where(first, pos, 0)) if n else pos
    last = np.r_[gid[1:] != gid[:-1], True] if n else np.zeros(0, bool)
    pend = (np.minimum.accumulate(np.where(last, pos + 1, n + 1)[::-1])[::-1]
            if n else pos)
    pend = np.minimum(pend, n)
    a = pstart + rng.integers(0, 4, size=n)
    b = pstart + rng.integers(0, 6, size=n)
    lo = np.clip(np.minimum(a, b), pstart, pend)
    hi = np.clip(np.maximum(a, b) + 1, pstart, pend)
    return gid, pstart, pend, lo, hi


def _jax_peers(gid, keys, perm, pend, n):
    """window.py:94-122 and :181-182, the JAX package's lines as written."""
    from trino_tpu.exec import kernels as JK

    pos = jnp.arange(n, dtype=jnp.int32)
    pboundary = (pos == 0) | (gid != jnp.roll(gid, 1))
    same_order = jnp.ones((n,), dtype=jnp.bool_)
    for data, valid in keys:
        bits, flag = JK.normalize_key(data, valid)
        bs = bits[perm]
        same_order = same_order & (bs == jnp.roll(bs, 1))
        if valid is not None:
            fl = flag[perm]
            same_order = same_order & (fl == jnp.roll(fl, 1))
    peer_b = pboundary | ~same_order
    peer_start = jax.lax.associative_scan(jnp.maximum, jnp.where(peer_b, pos, -1))
    nxt = jnp.concatenate([peer_b[1:], jnp.ones((1,), dtype=jnp.bool_)])
    rev = jnp.flip(jnp.where(nxt, pos + 1, n + 1))
    peer_end = jnp.flip(jax.lax.associative_scan(jnp.minimum, rev))
    peer_end = jnp.minimum(peer_end, pend)
    return peer_start, peer_end, jnp.cumsum(peer_b.astype(jnp.int64))


@pytest.mark.parametrize("name,n", [("edge", 2047), ("edge", 2048), ("edge", 2049)]
                         + [(c, 600) for c in PEER_CASES if c != "edge"])
def test_window_peers_tile_cases_match_jax(name, n):
    """W1's plain version on its tile shapes (``test_torch_tile_cases.py``)
    against the JAX lines (jitted: one compile a shape), with the dense
    count; n at a tile's size and one row either side for ``edge``."""
    gid, pend, perm, keys = peer_case(name, n, seed=n)
    t = torch.from_numpy
    got = TK.window_peers_plain(
        t(gid), [(t(d), None if v is None else t(v)) for d, v in keys],
        t(perm), t(pend), with_dense=True,
    )
    want = jax.jit(_jax_peers, static_argnums=4)(
        jnp.asarray(gid),
        [(jnp.asarray(d), None if v is None else jnp.asarray(v)) for d, v in keys],
        jnp.asarray(perm), jnp.asarray(pend), n,
    )
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


class _Info:
    def __init__(self, gid):
        self.gid_sorted = gid


KERNEL_CASES = [
    ("window_peers", "int_nulls"), ("window_peers", "float_nan_zero"),
    ("window_peers", "limbs"), ("window_peers", "no_keys"),
    ("range_sum", "int64"), ("range_sum", "float64"), ("range_sum", "limbs"),
    ("range_sum", "cross_partition_precision"),
    ("range_minmax", "int64"), ("range_minmax", "float64"),
    ("range_minmax", "limbs"),
    ("seg_searchsorted", "int64_left"), ("seg_searchsorted", "int64_right"),
    ("seg_searchsorted", "float64_left"), ("seg_searchsorted", "float64_right"),
]


@pytest.mark.parametrize("n", [1, 9, 600])
@pytest.mark.parametrize("kernel,case", KERNEL_CASES)
def test_window_kernel_matches_jax(kernel, case, n):
    rng = np.random.default_rng(zlib.crc32(f"{kernel}/{case}/{n}".encode()))
    gid, pstart, pend, lo, hi = _sorted_case(n, n)
    t = torch.from_numpy
    if kernel == "window_peers":
        perm = rng.permutation(n).astype(np.int64)
        keys = []
        if case == "int_nulls":
            keys = [(rng.integers(0, 3, size=n).astype(np.int64), rng.random(n) >= 0.3)]
        elif case == "float_nan_zero":
            keys = [(rng.choice(np.array([0.0, -0.0, np.nan, 1.5]), size=n), None),
                    (rng.integers(0, 2, size=n).astype(np.int32), None)]
        elif case == "limbs":
            hi_l = rng.integers(-2, 2, size=n).astype(np.int64)
            keys = [(hi_l, rng.random(n) >= 0.2),
                    (rng.integers(0, 3, size=n).astype(np.int64), None)]
        got = TK.window_peers_plain(
            t(gid), [(t(d), None if v is None else t(v)) for d, v in keys],
            t(perm), t(pend), with_dense=True,
        )
        want = _jax_peers(
            jnp.asarray(gid),
            [(jnp.asarray(d), None if v is None else jnp.asarray(v)) for d, v in keys],
            jnp.asarray(perm), jnp.asarray(pend), n,
        )
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))
        return
    if kernel == "range_sum":
        if case == "int64":
            vals = rng.integers(-(1 << 40), 1 << 40, size=n).astype(np.int64)
        elif case == "limbs":
            vals = rng.integers(0, 1 << 32, size=n).astype(np.int64)
        elif case == "float64":
            vals = rng.uniform(1.0, 1000.0, size=n)
            vals[rng.random(n) < 0.02] = -0.0
        else:
            # a partition of 1e18s right before small values: a global
            # cumsum difference would lose the small ones entirely
            vals = np.where(gid == gid[0], 1e18, rng.integers(1, 4, size=n) * 1.0)
        use_gid = vals.dtype.kind == "f"
        want = JW._range_sum(
            jnp.asarray(vals), jnp.asarray(lo), jnp.asarray(hi), n,
            gid=jnp.asarray(gid) if use_gid else None,
        )
        (got,) = TK.range_sum([t(vals)], t(gid), t(lo), t(hi))
        if use_gid:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=0)
        else:
            assert np.array_equal(got.numpy(), np.asarray(want))
        return
    if kernel == "range_minmax":
        lo = pstart.copy()  # prefix frames
        contrib = rng.random(n) >= 0.2
        for is_min in (True, False):
            if case == "limbs":
                wide = rng.integers(-(1 << 40), 1 << 40, size=n).astype(np.int64)
                data = np.stack([wide >> 32, wide & 0xFFFFFFFF], axis=-1)
                want = JW._range_minmax_limbs(
                    jnp.asarray(data), jnp.asarray(contrib), jnp.asarray(lo),
                    jnp.asarray(hi), _Info(jnp.asarray(gid)), is_min, n,
                )
                fill = TK._limb_fill(is_min)
                masked = np.where(contrib[:, None], data, np.asarray(fill))
                got = TK.range_minmax(t(masked), t(gid), t(lo), t(hi), fill, is_min)
                assert np.array_equal(got.numpy(), np.asarray(want))
                continue
            if case == "int64":
                data = rng.integers(-100, 100, size=n).astype(np.int64)
            else:
                data = rng.choice(np.array([-1.0, -0.0, 0.0, 2.5, np.nan]), size=n)
            want = JW._range_minmax(
                jnp.asarray(data), jnp.asarray(contrib), jnp.asarray(lo),
                jnp.asarray(hi), None, None, _Info(jnp.asarray(gid)), is_min, n,
            )
            fill = TW._fill_for(t(data).dtype, is_min)
            masked = np.where(contrib, data, fill)
            got = TK.range_minmax(t(masked), t(gid), t(lo), t(hi), fill, is_min)
            assert np.array_equal(got.numpy(), np.asarray(want), equal_nan=True)
        return
    # seg_searchsorted: a sorted key per partition, targets around it
    dtype, side = case.split("_")
    w = np.empty(n, dtype=np.int64)
    for start in np.unique(pstart):
        end = pend[start]
        w[start:end] = np.sort(rng.integers(-20, 20, size=end - start))
    target = w + rng.integers(-4, 5, size=n)
    if dtype == "float64":
        w, target = w.astype(np.float64) / 2, target.astype(np.float64) / 2
    left = side == "left"
    want = JW._seg_searchsorted(
        jnp.asarray(w), jnp.asarray(target), jnp.asarray(pstart),
        jnp.asarray(pend), left, n,
    )
    got = TK.seg_searchsorted(t(w), t(target), t(pstart), t(pend), left)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def _lane_values(rng, kind: str, n: int, gid):
    """One W2 value lane: int64 (wide values, wrapping sums) or float64
    (NaN and a partition of 1e18s beside small values). The floats are
    positive: a frame whose exact sum is 0 (-0.0s, or values that
    cancel) beside a nonzero prefix comes out as the residue of two
    prefix sums, which two orders of addition do not share to any
    relative tolerance (``KERNEL_CASES``' float64 case has -0.0)."""
    if kind == "int64":
        return rng.integers(-(1 << 62), 1 << 62, size=n).astype(np.int64)
    vals = rng.uniform(1.0, 1000.0, size=n)
    vals[rng.random(n) < 0.005] = np.nan
    if n:
        vals[gid == gid[0]] = 1e18
    return vals


@pytest.mark.parametrize("n", [9, 600, 5000])
@pytest.mark.parametrize("frames", ["offset", "running", "empty"])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_range_sum_lanes_match_jax(k, frames, n):
    """W2's plain version over 1, 2, 3 and 8 mixed int64/float64 lanes in
    one call, each lane against ``window._range_sum`` on its own: offset
    frames around each row, running frames from the partition start, and
    empty frames (hi <= lo) among offset ones."""
    rng = np.random.default_rng(zlib.crc32(f"lanes/{k}/{frames}/{n}".encode()))
    gid, pstart, pend, _lo, _hi = _sorted_case(n, n)
    pos = np.arange(n)
    if frames == "running":
        lo, hi = pstart.copy(), pos + 1
    else:
        lo = np.clip(pos - rng.integers(0, 40, size=n), pstart, pend)
        hi = np.clip(pos + rng.integers(1, 40, size=n), pstart, pend)
        if frames == "empty":
            empty = rng.random(n) < 0.4
            hi = np.where(empty, np.maximum(lo - rng.integers(0, 3, size=n), pstart), hi)
    kinds = ["float64" if (j + k) % 2 else "int64" for j in range(k)]
    lanes = [_lane_values(rng, kind, n, gid) for kind in kinds]
    t = torch.from_numpy
    got = TK.range_sum([t(v) for v in lanes], t(gid), t(lo), t(hi))
    assert len(got) == k
    for kind, vals, g in zip(kinds, lanes, got):
        is_f = kind == "float64"
        want = np.asarray(JW._range_sum(
            jnp.asarray(vals), jnp.asarray(lo), jnp.asarray(hi), n,
            gid=jnp.asarray(gid) if is_f else None,
        ))
        if is_f:
            np.testing.assert_allclose(g.numpy(), want, rtol=1e-9, atol=0)
        else:
            assert np.array_equal(g.numpy(), want)
