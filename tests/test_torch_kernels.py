"""The port's kernel functions (plain torch versions, on the CPU) against
the JAX package's ``exec/kernels.py``.

The same inputs, made with numpy from fixed seeds, go through both
packages. Integer outputs (every GroupInfo field, join order/lo/cnt,
permutations, packed words) must be equal; the match expansion is
compared under ``out_live``; float64 sums agree to relative 1e-12.
The port carries uint64 bits in int64 tensors and int64 indices where
the JAX package uses int32: values are compared, not dtypes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_join_keys import KEY_SETS, join_key_set
from test_torch_skew_cases import EXPAND_CASES, expand_case
from trino_tpu.exec import kernels as JK
from trino_tpu_torch.exec import kernels as TK

SIZES = [0, 1, 7, 4096]


def _np(x):
    """A JAX or torch array as numpy, uint64 viewed as int64."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    return a


def _key_case(case, n, seed):
    """(key columns [(data, valid|None)], live, capacity, widths)."""
    rng = np.random.default_rng(seed)
    live = rng.random(n) >= (0.25 if case != "all_live" else 0.0)
    if case in ("dups", "all_live"):
        cols = [(rng.integers(0, 5, size=n).astype(np.int64), None)]
        return cols, live, 16, (3,)
    if case == "nulls":
        valid = rng.random(n) >= 0.3
        cols = [(rng.integers(-3, 3, size=n).astype(np.int64), valid)]
        return cols, live, 16, None
    if case == "nulls_packed":
        valid = rng.random(n) >= 0.3
        cols = [(rng.integers(0, 7, size=n).astype(np.int64), valid)]
        return cols, live, 16, (3,)
    if case == "overflow":
        cols = [(rng.integers(0, 10 * max(n, 1), size=n).astype(np.int64), None)]
        return cols, live, 8, None
    if case == "u64_high":
        k = rng.integers(0, 50, size=n).astype(np.int64) | np.int64(-(1 << 63))
        return [(k, None)], live, 64, None
    if case == "packed63":
        # 62-bit keys + a null flag = 63 bits: liveness folds into bit 63
        valid = rng.random(n) >= 0.2
        k = rng.integers(0, 40, size=n).astype(np.int64) | np.int64(1 << 61)
        return [(k, valid)], live, 64, (62,)
    if case == "multiword":
        a = rng.integers(0, 9, size=n).astype(np.int64) << 35
        b = rng.integers(0, 9, size=n).astype(np.int64)
        return [(a, None), (b, None)], live, 128, (40, 40)
    if case == "two_keys":
        a = rng.normal(size=n).round(0)
        a[: n // 3] = -0.0
        b = rng.integers(0, 3, size=n).astype(np.int32)
        return [(a, None), (b, rng.random(n) >= 0.1)], live, 64, None
    raise AssertionError(case)


def _norm_both(cols):
    jn, tn = [], []
    for data, valid in cols:
        jb, jf = JK.normalize_key(
            jnp.asarray(data), None if valid is None else jnp.asarray(valid)
        )
        tb, tf = TK.normalize_key(
            torch.from_numpy(data), None if valid is None else torch.from_numpy(valid)
        )
        jn.append((jb, None if valid is None else jf))
        tn.append((tb, None if valid is None else tf))
    return jn, tn


def _assert_empty_info(info, capacity):
    for name in ("perm", "gid_sorted", "group", "rep"):
        assert getattr(info, name).shape == (0,), name
    for name in ("starts", "ends", "owner"):
        np.testing.assert_array_equal(
            _np(getattr(info, name)), np.zeros(capacity, np.int64), err_msg=name
        )
    assert int(info.num_groups) == 0


CASES = [
    "dups", "all_live", "nulls", "nulls_packed", "overflow", "u64_high",
    "packed63", "multiword", "two_keys",
]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", CASES)
def test_sort_group_matches_jax(case, n):
    cols, live, capacity, widths = _key_case(case, n, seed=n + len(case))
    jn, _tn = _norm_both(cols)
    got = TK.group_by(
        [(torch.from_numpy(d), None if v is None else torch.from_numpy(v))
         for d, v in cols],
        torch.from_numpy(live), capacity, widths=widths, with_rep=True,
    )
    if n == 0:
        # the JAX sort_group cannot trace an empty page (its gathers need
        # a row): the port's empty result is checked on its own terms
        _assert_empty_info(got, capacity)
        return
    want = JK.sort_group(
        tuple(b for b, _ in jn), tuple(f for _, f in jn), jnp.asarray(live),
        capacity, widths=widths,
    )
    for name, w, g in zip(TK.GroupInfo._fields, want, got):
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=name)
    # K1's representative flag is the JAX _dedupe's owner test
    owner, group = _np(want.owner), _np(want.group)
    np.testing.assert_array_equal(
        got.rep.numpy(),
        live & (owner[np.clip(group, 0, capacity - 1)] == np.arange(n)),
    )
    if case == "overflow" and n == 4096:
        assert int(got.num_groups) > capacity


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_seg_sum_ranges_matches_jax(dtype, n):
    cols, live, capacity, widths = _key_case("overflow" if n > 7 else "dups", n, 3)
    capacity = 4 * max(n, 1) if n > 7 else capacity
    jn, tn = _norm_both(cols)
    tinfo = TK.group_by(
        [(b, None) for b, _ in tn], torch.from_numpy(live), capacity,
    )
    if n == 0:
        z = torch.zeros(0, dtype=getattr(torch, dtype))
        np.testing.assert_array_equal(
            TK.seg_sum_ranges(z, tinfo).numpy(), np.zeros(capacity)
        )
        return
    jinfo = JK.sort_group(
        tuple(b for b, _ in jn), (None,) * len(jn), jnp.asarray(live), capacity,
    )
    rng = np.random.default_rng(n)
    if dtype == "int64":
        vals = rng.integers(-(1 << 62), 1 << 62, size=n, dtype=np.int64)
    else:
        vals = rng.normal(size=n) * 1e9
    perm = _np(tinfo.perm)
    contrib = live[perm]
    vs = np.where(contrib, vals[perm], 0).astype(vals.dtype)
    want = JK.seg_sum_ranges(jnp.asarray(vs), jinfo)
    got = TK.seg_sum_ranges(torch.from_numpy(vs), tinfo)
    if dtype == "int64":
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-3
        )


def _join_case(case, m, n, seed):
    if case in KEY_SETS:
        return join_key_set(case, m, n, seed)
    rng = np.random.default_rng(seed)
    if case == "hot_row":
        # one live probe row matches 60% of the build rows; the others
        # match about 0.1 rows each
        bk = rng.integers(0, 4 * m, size=m).astype(np.int64)
        bk[rng.random(m) < 0.6] = -5
        pk = rng.integers(0, 4 * m, size=n).astype(np.int64)
        pk[n // 3] = -5
        pl = rng.random(n) >= 0.2
        pl[n // 3] = True
        return bk, rng.random(m) >= 0.2, pk, pl
    hi = 30
    bk = rng.integers(0, hi, size=m).astype(np.int64)
    pk = rng.integers(0, hi + 5, size=n).astype(np.int64)
    if case == "u64_high":
        bk |= np.int64(-(1 << 63))
        pk |= np.int64(-(1 << 63))
        pk[::3] = -1  # the all-ones key (the JAX dead-key sentinel value)
    bl = rng.random(m) >= (1.0 if case == "all_dead_build" else 0.2)
    pl = rng.random(n) >= 0.2
    return bk, bl, pk, pl


JOIN_CASES = [
    ("dups", 4096, 4096), ("u64_high", 4096, 1000), ("all_dead_build", 64, 100),
    ("dups", 7, 0), ("dups", 0, 7), ("dups", 1, 1), ("u64_high", 7, 7),
    # the adversarial key sets of K3's key-range directory
    ("outlier", 3000, 4000), ("hot", 3000, 4000), ("hashed", 3000, 4000),
    ("outside", 3000, 2000), ("one_live", 3000, 4000), ("sorted", 3000, 4000),
    # K4's hot row: one probe row holding most of the outputs
    ("hot_row", 20_000, 4000),
]


@pytest.mark.parametrize("case,m,n", JOIN_CASES)
def test_join_ranges_and_expand_match_jax(case, m, n):
    bk, bl, pk, pl = _join_case(case, m, n, seed=m * 7 + n)
    if m == 0:
        # the JAX join_ranges cannot trace an empty build side: the
        # port's answer (no matches) is checked on its own terms
        to, tlo, tcnt = TK.join_ranges(
            torch.from_numpy(bk), torch.from_numpy(bl),
            torch.from_numpy(pk), torch.from_numpy(pl),
        )
        assert to.shape == (0,)
        np.testing.assert_array_equal(_np(tlo), np.zeros(n, np.int64))
        np.testing.assert_array_equal(_np(tcnt), np.zeros(n, np.int64))
        _p, _b, live = TK.expand_matches(to, tlo, tcnt, 8)
        assert not live.any()
        return
    jo, jlo, jcnt = JK.join_ranges(
        jnp.asarray(bk.view(np.uint64)), jnp.asarray(bl),
        jnp.asarray(pk.view(np.uint64)), jnp.asarray(pl),
    )
    to, tlo, tcnt = TK.join_ranges(
        torch.from_numpy(bk), torch.from_numpy(bl),
        torch.from_numpy(pk), torch.from_numpy(pl),
    )
    np.testing.assert_array_equal(_np(to), _np(jo))
    np.testing.assert_array_equal(_np(tlo), _np(jlo))
    np.testing.assert_array_equal(_np(tcnt), _np(jcnt))
    total = int(_np(tcnt).sum())
    out_cap = total + 9
    if n == 0:
        # the JAX expansion needs at least one probe row
        p, b, live = TK.expand_matches(to, tlo, tcnt, out_cap)
        assert not live.any() and p.shape == (out_cap,)
        return
    jp, jb, jl = JK.expand_matches(jo, jlo, jcnt, out_cap)
    tp, tb, tl = TK.expand_matches(to, tlo, tcnt, out_cap)
    live = _np(jl).astype(bool)
    np.testing.assert_array_equal(tl.numpy(), live)
    np.testing.assert_array_equal(_np(tp)[live], _np(jp)[live])
    np.testing.assert_array_equal(_np(tb)[live], _np(jb)[live])


@pytest.mark.parametrize("name", EXPAND_CASES)
def test_expand_cases_match_jax(name):
    """K4's plain version against JAX ``expand_matches`` on K4's
    adversarial cases (``test_torch_skew_cases.py``), the contract the
    card holds the kernel to: out_live everywhere, both indices at every
    live position."""
    order, lo, cnt, out_cap = expand_case(name, seed=3)
    tp, tb, tl = TK.expand_matches(
        torch.from_numpy(order), torch.from_numpy(lo), torch.from_numpy(cnt),
        out_cap)
    if cnt.size == 0:
        # the JAX expansion needs at least one probe row
        assert tp.shape == (out_cap,) and not tl.any()
        return
    jp, jb, jl = JK.expand_matches(
        jnp.asarray(order), jnp.asarray(lo), jnp.asarray(cnt), out_cap)
    live = _np(jl).astype(bool)
    np.testing.assert_array_equal(tl.numpy(), live)
    np.testing.assert_array_equal(_np(tp)[live], _np(jp)[live])
    np.testing.assert_array_equal(_np(tb)[live], _np(jb)[live])


def _sort_keys(n, seed):
    rng = np.random.default_rng(seed)
    ints = rng.integers(-5, 5, size=n).astype(np.int64)
    floats = rng.normal(size=n).round(1)
    if n:
        floats[:: max(n // 5, 1)] = np.nan
        floats[1:: max(n // 4, 1)] = -0.0
        ints[2:: max(n // 3, 1)] = np.iinfo(np.int64).min
    bools = rng.random(n) >= 0.5
    valid = rng.random(n) >= 0.2
    live = rng.random(n) >= 0.2
    return ints, floats, bools, valid, live


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("order", [
    (True, None), (False, None), (True, True), (False, False),
])
def test_sort_perm_matches_jax(n, order):
    asc, nulls_first = order
    ints, floats, bools, valid, live = _sort_keys(n, seed=n + 1)
    nf = (not asc) if nulls_first is None else nulls_first
    # INT64_MIN and INT32_MIN under DESC wrap, as the reference's -x does
    small = np.clip(ints, -5, 5)
    i32 = np.where(ints == np.iinfo(np.int64).min, np.iinfo(np.int32).min,
                   small).astype(np.int32)
    narrow = [
        (i32, valid, not asc, nf),
        (floats.astype(np.float32), None, not asc, nf),
        (small.astype(np.int16), None, asc, nf),
        (small.astype(np.int8), valid, not asc, not nf),
    ]
    spec = [(floats, None, asc, nf), (ints, valid, not asc, nf), (bools, None, asc, nf),
            *narrow]
    want = JK.sort_perm(
        [(jnp.asarray(d), None if v is None else jnp.asarray(v), a, f)
         for d, v, a, f in spec],
        jnp.asarray(live),
    )
    got = TK.sort_perm(
        [(torch.from_numpy(d), None if v is None else torch.from_numpy(v), a, f)
         for d, v, a, f in spec],
        torch.from_numpy(live),
    )
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", ["float64", "float32", "int32", "bool"])
def test_normalize_key_matches_jax(n, dtype):
    rng = np.random.default_rng(n)
    if dtype.startswith("float"):
        data = rng.normal(size=n).astype(dtype)
        if n:
            data[:: max(n // 3, 1)] = -0.0
            data[1:: max(n // 3, 1)] = np.nan
    elif dtype == "bool":
        data = rng.random(n) >= 0.5
    else:
        data = rng.integers(-9, 9, size=n).astype(dtype)
    valid = rng.random(n) >= 0.3
    for v in (None, valid):
        jb, jf = JK.normalize_key(jnp.asarray(data), None if v is None else jnp.asarray(v))
        tb, tf = TK.normalize_key(torch.from_numpy(data), None if v is None else torch.from_numpy(v))
        np.testing.assert_array_equal(_np(tb), _np(jb))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


@pytest.mark.parametrize("case", ["dups", "nulls_packed", "packed63", "multiword"])
def test_pack_words_matches_jax(case):
    cols, live, _cap, widths = _key_case(case, 4096, seed=11)
    jn, tn = _norm_both(cols)
    jw, jfold, jbits = JK._pack_words(
        tuple(b for b, _ in jn), tuple(f for _, f in jn), jnp.asarray(live), widths
    )
    tw, tfold, tbits = TK._pack_words(
        tuple(b for b, _ in tn), tuple(f for _, f in tn), torch.from_numpy(live), widths
    )
    assert (tfold, tbits, len(tw)) == (jfold, jbits, len(jw))
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(_np(a), _np(b))
    if case == "packed63":
        # the liveness bit is bit 63: dead rows carry the sign bit
        assert tbits == 63 and tfold
        np.testing.assert_array_equal(_np(tw[0]) < 0, ~live)


def _range_any_case(case, n, seed):
    """(cnt, out_live): per-probe match counts and the expanded liveness
    they index. ``out_live`` is longer than the total (a padded
    expansion capacity) except in "clamped", where it is shorter."""
    rng = np.random.default_rng(seed)
    cnt = rng.integers(0, 8, size=n).astype(np.int64)
    if case == "empty_ranges":
        cnt[rng.random(n) < 0.7] = 0
    if case == "hot" and n:
        cnt[n // 3] = 40 * n  # one probe owns most positions
    total = int(cnt.sum())
    m = max(total // 2, 1) if case == "clamped" else total + 9
    live = rng.random(m) >= 0.5
    if case == "all_dead":
        live[:] = False
    if case == "hot" and n:
        # the hot range is dead but for its last position
        off = int(cnt[: n // 3].sum())
        live[off: off + cnt[n // 3]] = False
        live[off + cnt[n // 3] - 1] = True
    return cnt, live


RANGE_ANY_CASES = [
    ("random", 0), ("random", 1), ("random", 4096), ("empty_ranges", 4096),
    ("all_dead", 4096), ("hot", 4096), ("hot", 1), ("clamped", 4096),
]


@pytest.mark.parametrize("case,n", RANGE_ANY_CASES)
def test_range_any_matches_jax(case, n):
    cnt, live = _range_any_case(case, n, seed=n + len(case))
    want = JK.range_any(jnp.asarray(cnt), jnp.asarray(live))
    got = TK.range_any(torch.from_numpy(cnt), torch.from_numpy(live))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == "all_dead":
        assert not got.any()
    if case == "hot" and n:
        assert bool(got[n // 3])


def test_range_any_without_positions():
    # the JAX range_any cannot gather from an empty out_live: the port's
    # answer (nothing matched) is checked on its own terms
    got = TK.range_any(
        torch.tensor([0, 2, 1], dtype=torch.int64), torch.zeros(0, dtype=torch.bool)
    )
    np.testing.assert_array_equal(got.numpy(), np.zeros(3, dtype=bool))


def _scatter_any_case(case, m, capacity, seed):
    """(idx, flags): flagged indices into [0, capacity); unflagged
    positions carry clamped placeholders, as dead expansion rows do."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, max(capacity, 1), size=m).astype(np.int64)
    flags = rng.random(m) >= 0.5
    if case == "dead_tail":
        flags[m // 2:] = False
        idx[m // 2:] = 0  # K4's placeholder for dead positions
    if case == "all_dead":
        flags[:] = False
    if case == "hot":
        idx[: m // 2] = capacity // 2
    return idx, flags


SCATTER_ANY_CASES = [
    ("random", 1, 1), ("random", 4096, 1000), ("random", 4096, 9000),
    ("dead_tail", 4096, 700), ("all_dead", 4096, 700), ("hot", 4096, 700),
]


@pytest.mark.parametrize("case,m,capacity", SCATTER_ANY_CASES)
def test_scatter_any_matches_jax(case, m, capacity):
    idx, flags = _scatter_any_case(case, m, capacity, seed=m + capacity)
    want = JK.scatter_any(jnp.asarray(idx), jnp.asarray(flags), capacity)
    got = TK.scatter_any(torch.from_numpy(idx), torch.from_numpy(flags), capacity)
    assert got.dtype == torch.bool and got.shape == (capacity,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scatter_any_without_positions():
    # the JAX scatter_any cannot probe an empty index array: the port's
    # answer (no slot marked) is checked on its own terms
    got = TK.scatter_any(
        torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.bool), 5
    )
    np.testing.assert_array_equal(got.numpy(), np.zeros(5, dtype=bool))


def _hash_case(case, n, seed):
    """Key parts [(data, valid|None)] for K7: two int64 parts (a
    multi-key join), floats with NaN and +-0.0 beside a nullable int32,
    and the narrow types."""
    rng = np.random.default_rng(seed)
    if case == "two_int64":
        return [(rng.integers(0, 1 << 40, size=n).astype(np.int64), None),
                (rng.integers(-(1 << 62), 1 << 62, size=n).astype(np.int64), None)]
    if case == "float_nullable":
        f = rng.normal(size=n)
        if n:
            f[:: max(n // 4, 1)] = np.nan
            f[1:: max(n // 5, 1)] = -0.0
            f[2:: max(n // 6, 1)] = 0.0
        return [(rng.integers(0, 9, size=n).astype(np.int64), None), (f, None),
                (rng.integers(-5, 5, size=n).astype(np.int32), rng.random(n) >= 0.3)]
    if case == "narrow":
        g = rng.normal(size=n).astype(np.float32)
        if n:
            g[:: max(n // 3, 1)] = np.float32("nan")
            g[1:: max(n // 3, 1)] = -0.0
        return [(rng.integers(-100, 100, size=n).astype(np.int8), None),
                (rng.integers(-999, 999, size=n).astype(np.int16), rng.random(n) >= 0.5),
                (rng.random(n) >= 0.5, None), (g, None)]
    raise AssertionError(case)


@pytest.mark.parametrize("n", [0, 1, 4096])
@pytest.mark.parametrize("case", ["two_int64", "float_nullable", "narrow"])
def test_hash_keys_matches_jax(case, n):
    parts = _hash_case(case, n, seed=n + len(case))
    want = JK.hash_columns(
        [(jnp.asarray(d), None if v is None else jnp.asarray(v)) for d, v in parts]
    )
    got = TK.hash_keys(
        [(torch.from_numpy(d), None if v is None else torch.from_numpy(v))
         for d, v in parts]
    )
    assert got.dtype == torch.int64 and got.shape == (n,)
    np.testing.assert_array_equal(_np(got), _np(want))


def _pack_case(case, n, seed):
    """(cols [(data, valid|None)], live, widths) for K8."""
    rng = np.random.default_rng(seed)
    live = rng.random(n) >= 0.2
    if case == "folded":
        return [(rng.integers(0, 1 << 26, size=n).astype(np.int64), None)], live, (26,)
    if case == "three_nullable":
        return [
            (rng.integers(0, 1 << 10, size=n).astype(np.int32), rng.random(n) >= 0.2),
            (rng.integers(0, 25, size=n).astype(np.int64), rng.random(n) >= 0.2),
            (rng.integers(0, 1 << 20, size=n).astype(np.int64), rng.random(n) >= 0.2),
        ], live, (10, 5, 20)
    if case == "packed63":
        k = rng.integers(0, 40, size=n).astype(np.int64) | np.int64(1 << 61)
        return [(k, rng.random(n) >= 0.2)], live, (62,)
    if case == "multiword":
        f = rng.normal(size=n)
        if n:
            f[:: max(n // 7, 1)] = np.nan
            f[1:: max(n // 7, 1)] = -0.0
        return [
            (rng.integers(-(1 << 62), 1 << 62, size=n).astype(np.int64), None),
            (f, None),
            (rng.integers(0, 9, size=n).astype(np.int16), rng.random(n) >= 0.5),
            (rng.random(n) >= 0.5, None),
        ], live, (64, 64, 4, 1)
    raise AssertionError(case)


@pytest.mark.parametrize("n", [0, 1, 4096])
@pytest.mark.parametrize("case", ["folded", "three_nullable", "packed63", "multiword"])
def test_pack_keys_matches_jax(case, n):
    cols, live, widths = _pack_case(case, n, seed=n + len(case))
    jn = [JK.normalize_key(jnp.asarray(d), None if v is None else jnp.asarray(v))
          for d, v in cols]
    jw, jfold, jbits = JK._pack_words(
        tuple(b for b, _ in jn),
        tuple(None if v is None else f for (_, f), (_, v) in zip(jn, cols)),
        jnp.asarray(live), widths,
    )
    tw, tfold, tbits = TK.pack_keys(
        [(torch.from_numpy(d), None if v is None else torch.from_numpy(v))
         for d, v in cols],
        torch.from_numpy(live), widths,
    )
    assert (tfold, tbits, len(tw)) == (jfold, jbits, len(jw))
    for a, b in zip(tw, jw):
        assert a.shape == (n,)
        np.testing.assert_array_equal(_np(a), _np(b))


def _minmax_case(dtype, n, seed):
    rng = np.random.default_rng(seed)
    if dtype == "float64":
        v = rng.normal(size=n).round(1)
        if n > 7:
            v[rng.random(n) < 0.01] = np.nan  # some groups hold a NaN
            v[rng.random(n) < 0.1] = -0.0
            v[rng.random(n) < 0.1] = 0.0
        return v, (np.inf, -np.inf)
    info = np.iinfo(dtype)
    v = rng.integers(info.min, info.max, size=n, endpoint=True).astype(dtype)
    return v, (info.max, info.min)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", ["int64", "float64", "int8", "int32"])
def test_seg_minmax_matches_jax(dtype, n):
    cols, live, capacity, _w = _key_case("dups" if n < 4096 else "overflow", n, 5)
    capacity = 4 * max(n, 1) if n > 7 else capacity
    jn, tn = _norm_both(cols)
    tinfo = TK.group_by(
        [(b, None) for b, _ in tn], torch.from_numpy(live), capacity,
    )
    vals, fills = _minmax_case(dtype, n, seed=n + 2)
    contrib = np.random.default_rng(n).random(n) >= 0.3
    perm = _np(tinfo.perm)
    for is_min, fill in zip((True, False), fills):
        vs = np.where(contrib[perm] & live[perm], vals[perm], fill).astype(vals.dtype)
        got = TK.seg_minmax(
            torch.from_numpy(vs), tinfo.starts, tinfo.ends, fill, is_min,
        )
        assert got.dtype == torch.from_numpy(vs).dtype
        if n == 0:
            # the JAX sort_group cannot trace an empty page: every group
            # of the port's empty result is the fill
            np.testing.assert_array_equal(got.numpy(), np.full(capacity, fill, vs.dtype))
            continue
        jinfo = JK.sort_group(
            tuple(b for b, _ in jn), (None,) * len(jn), jnp.asarray(live), capacity,
        )
        want = JK.seg_minmax_scan(jnp.asarray(vs), jinfo, fill, is_min)
        # exact, NaN equal to NaN; -0.0 equals 0.0 (the JAX package on
        # XLA:CPU gives +0.0 for a group holding only -0.0, the port -0.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_order_words_float_encoding_matches_jax(dtype):
    """K10's float words are the JAX ``_float_sort_bits`` (complemented
    for DESC) with the top bit flipped to signed order."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=999).astype(dtype)
    x[::5] = np.nan
    x[1::7] = -0.0
    x[2::11] = np.inf
    x[3::13] = -np.inf
    bits = np.asarray(JK._float_sort_bits(jnp.asarray(x))).astype(np.uint64)
    width = 64 if dtype == "float64" else 32
    full = (1 << width) - 1
    for asc in (True, False):
        (word,), (flag,), dead = TK.order_words(
            [(torch.from_numpy(x), None, asc, False)],
            torch.ones(999, dtype=torch.bool),
        )
        assert flag is None and not dead.any()
        want = [int(b) if asc else full - int(b) for b in bits]
        got = [int(w) + (1 << (width - 1)) for w in word.numpy()]
        assert got == want


@pytest.mark.parametrize("case", ["keys_nulls", "global", "hash_lane", "empty"])
def test_dedupe_matches_jax(case):
    from trino_tpu.exec import stage as JS
    from trino_tpu_torch.exec import stage as TS

    rng = np.random.default_rng(len(case))
    n = 0 if case == "empty" else 4096
    live = rng.random(n) >= 0.2
    value = rng.integers(0, 40, size=n).astype(np.int64)
    value_valid = rng.random(n) >= 0.1
    keys = []
    widths = (6,)
    if case in ("keys_nulls", "empty"):
        keys = [(rng.integers(0, 7, size=n).astype(np.int64), rng.random(n) >= 0.2),
                (rng.integers(0, 3, size=n).astype(np.int32), None)]
        widths = (3, 2, 6)
    if case == "hash_lane":
        lanes = rng.integers(-(1 << 62), 1 << 62, size=(9, 2))[rng.integers(0, 9, size=n)]
        value, widths = lanes, (64,)
    def jx(a):
        return None if a is None else jnp.asarray(a)

    def tx(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a))

    v_j = jx(value)[:, 0] if value.ndim == 2 else jx(value)
    v_t = torch.from_numpy(value)[:, 0] if value.ndim == 2 else tx(value)
    got = TS._dedupe(
        [(tx(d), tx(v)) for d, v in keys], (v_t, tx(value_valid)),
        torch.from_numpy(live), n, widths,
    )
    assert got.dtype == torch.bool and got.shape == (n,)
    if n == 0:
        return  # the JAX sort_group cannot trace an empty page
    want = JS._dedupe(
        [(jx(d), jx(v)) for d, v in keys], (v_j, jx(value_valid)),
        jnp.asarray(live), n, widths,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
