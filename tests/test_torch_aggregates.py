"""The port's aggregate functions (``trino_tpu_torch``, on the CPU) against
the JAX package: approx_distinct, approx_percentile, max_by / min_by,
arbitrary / any_value, bool_and / bool_or and the variance family.

- Each plain function against its JAX function on the same inputs, made
  with numpy from fixed seeds: ``content_hash64``, ``order_bits``,
  ``clz64`` / ``dev_hash64``, the HLL registers (A1's plain version) and
  estimate (A2's), ``seg_arg_extreme`` (A3's) and ``seg_first_index``.
  Integers, hashes and registers must be equal. ``seg_arg_extreme`` is
  compared on the groups that have a contributing row: for the others
  both packages return a row that callers mask with count > 0 (the JAX
  package's scan gives the best non-contributing row, the port the
  group's first row).
- ``statements.AGGREGATE_STATEMENTS`` (the single-runner statements of
  ``tests/test_functions.py`` and ``tests/test_sketches.py``, written
  over TPC-H ``tiny`` and VALUES) through both runners: equal rows,
  DOUBLEs of integer arguments exactly, of double and decimal arguments
  to relative 1e-9 with absolute 1e-9 (the DECIMAL -> DOUBLE cast and
  the float64 sums' order). Where sqlite can compute the same answer
  (``AGGREGATE_SQLITE``) the rows also match sqlite; HLL estimates are
  held to the exact distinct count within the sketch's error, and
  percentiles to numpy's sorted rank.
"""

import math
from decimal import Decimal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trino_tpu import page as JP
from trino_tpu.engine import QueryRunner as JaxRunner
from trino_tpu.exec import aggregates as JA
from trino_tpu.exec import kernels as JK
from trino_tpu.testing.golden import assert_rows_match, load_tpch_sqlite, to_sqlite
from trino_tpu_torch import page as TP
from trino_tpu_torch.engine import QueryRunner as TorchRunner
from trino_tpu_torch.exec import aggregates as TA
from trino_tpu_torch.exec import kernels as TK
from trino_tpu_torch.testing.statements import AGGREGATE_SQLITE, AGGREGATE_STATEMENTS

from test_torch_tile_cases import ARG_CASES, arg_case

SIGN = -(1 << 63)


def _i64(x):
    """A JAX (uint64 or any integer) or torch array as int64 numpy."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.dtype == np.uint64:
        return a.view(np.int64)
    return a.astype(np.int64)


# ---- plain functions against the JAX package ---------------------------------


@pytest.mark.parametrize("case", ["ascii", "mixed_width", "unicode", "empty"])
def test_content_hash64_matches_jax(case):
    rng = np.random.default_rng(3)
    if case == "ascii":
        vals = np.asarray([f"brand#{i}" for i in rng.integers(0, 999, 200)])
    elif case == "mixed_width":
        vals = np.asarray(["", "a", "ab", "x" * 40, "abc", "a"], dtype=object)
    elif case == "unicode":
        vals = np.asarray(["café", "über", "日本", "cafe"])
    else:
        vals = np.asarray([], dtype=str)
    got = TP.content_hash64(vals)
    want = JP.content_hash64(vals)
    assert got.dtype == np.uint64
    assert np.array_equal(got, want)


def _typed_values(dtype, n, seed):
    rng = np.random.default_rng(seed)
    if dtype == "float64":
        v = rng.normal(size=n) * 1e3
        v[::7] = np.nan
        v[1::11] = -0.0
        v[2::11] = 0.0
        v[3::13] = np.inf
        v[4::13] = -np.inf
        return v
    if dtype == "float32":
        v = (rng.normal(size=n) * 1e3).astype(np.float32)
        v[::9] = np.nan
        v[1::9] = -0.0
        return v
    if dtype == "bool":
        return rng.random(n) < 0.5
    if dtype == "int64":
        v = rng.integers(-50, 50, size=n).astype(np.int64)
        v[::17] = np.iinfo(np.int64).max
        v[1::17] = np.iinfo(np.int64).min
        return v
    return rng.integers(-1000, 1000, size=n).astype(np.dtype(dtype))


@pytest.mark.parametrize("dtype", ["int64", "int32", "int16", "bool", "float64", "float32"])
def test_order_bits_matches_jax(dtype):
    """The port's signed form is the JAX package's u64 bits ^ bit 63."""
    v = _typed_values(dtype, 500, 11)
    got = _i64(TK.order_bits(torch.from_numpy(v)))
    want = _i64(JK.order_bits(jnp.asarray(v)))
    assert np.array_equal(got ^ SIGN, want)


def test_clz64_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.integers(-(1 << 63), (1 << 63) - 1, size=2000, dtype=np.int64)
    x[:64] = np.asarray([1 << k for k in range(63)] + [0], dtype=np.int64)
    x[64:128] = x[64:128] >> rng.integers(0, 64, size=64)
    got = _i64(TK.clz64(torch.from_numpy(x)))
    want = _i64(JA._clz64(jnp.asarray(x.view(np.uint64))))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", ["int64", "int32", "bool", "float64_nan_zero", "float32", "limbs"])
def test_dev_hash64_matches_jax(case):
    rng = np.random.default_rng(9)
    if case == "float64_nan_zero":
        v = _typed_values("float64", 400, 1)
        # NaN payloads hash as they are: two distinct NaNs
        bits = v.view(np.int64)
        bits[5] = np.int64(0x7FF8000000000123)
        bits[6] = np.int64(-0x0008000000000000)  # a negative quiet NaN
        v = bits.view(np.float64)
    elif case == "limbs":
        hi = rng.integers(-(1 << 31), 1 << 31, size=400).astype(np.int64)
        lo = rng.integers(0, 1 << 32, size=400).astype(np.int64)
        v = np.stack([hi, lo], axis=1)
    else:
        v = _typed_values(case, 400, 2)
    got = _i64(TK.dev_hash64(torch.from_numpy(v)))
    want = _i64(JA.dev_hash64(jnp.asarray(v)))
    assert np.array_equal(got, want)
    if case == "float64_nan_zero":
        zero = np.flatnonzero(v == 0.0)
        assert len(set(got[zero].tolist())) == 1  # -0.0 hashes as +0.0
        assert got[5] != got[6]


class _Groups:
    """The one field of GroupInfo that ``_hll_registers`` reads."""

    def __init__(self, group):
        self.group = group


def _hll_case(n, m, grouped, seed):
    rng = np.random.default_rng(seed)
    b = m.bit_length() - 1
    h = rng.integers(-(1 << 63), (1 << 63) - 1, size=n, dtype=np.int64)
    if n >= 60:
        # lanes whose low 64 - b bits are zero: rho clamps at 64 - b + 1
        h[:5] = np.arange(5, dtype=np.int64) << (64 - b)
        h[5] = 0
        # a hot value and low-entropy hashes (large rho)
        h[6:40] = h[6]
        h[40:60] = rng.integers(0, 1 << 20, size=20)
    contrib = rng.random(n) >= 0.2
    caps = 1
    group = None
    if grouped:
        caps = 37
        group = rng.integers(0, caps + 3, size=n).astype(np.int64)  # some overflow
    return h, contrib, group, caps


@pytest.mark.parametrize("m,grouped", [(512, True), (4096, False), (512, False), (4096, True)])
@pytest.mark.parametrize("n", [0, 1, 3000])
def test_hll_registers_match_jax(m, grouped, n):
    h, contrib, group, caps = _hll_case(n, m, grouped, seed=n + m)
    got = TK.hll_registers_plain(
        torch.from_numpy(h), torch.from_numpy(contrib),
        None if group is None else torch.from_numpy(group), m, caps, True,
    )
    if n == 0:
        # the JAX function cannot gather from an empty sort; no rows give
        # empty registers
        assert got.shape == (caps, m) and not got.any()
        return
    info = None if group is None else _Groups(jnp.asarray(group.astype(np.int32)))
    want = JA._hll_registers(
        jnp.asarray(h.view(np.uint64)), jnp.asarray(contrib), m, info, caps,
    )
    assert got.dtype == torch.int8 and got.shape == (caps, m)
    assert np.array_equal(got.numpy(), np.asarray(want))
    if n > 5:
        b = m.bit_length() - 1
        assert int(got.max()) <= 64 - b + 1


def test_hll_registers_hash_values_like_jax():
    """Unhashed lanes (hashed=False) are hashed with dev_hash64 first."""
    v = _typed_values("float64", 2000, 4)
    contrib = np.ones(2000, dtype=bool)
    got = TK.hll_registers_plain(
        torch.from_numpy(v), torch.from_numpy(contrib), None, 4096, 1, False,
    )
    want = JA._hll_registers(
        JA.dev_hash64(jnp.asarray(v)), jnp.asarray(contrib), 4096, None, 1,
    )
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["random", "linear_counting", "all_zero", "high", "one_row"])
@pytest.mark.parametrize("m", [512, 4096])
def test_hll_estimate_matches_jax(case, m):
    rng = np.random.default_rng(m)
    c = 50
    if case == "random":
        reg = rng.integers(0, 30, size=(c, m))
    elif case == "linear_counting":
        reg = np.where(rng.random((c, m)) < 0.1, rng.integers(1, 6, size=(c, m)), 0)
    elif case == "all_zero":
        reg = np.zeros((c, m), dtype=np.int64)
    elif case == "high":
        reg = rng.integers(20, 41, size=(c, m))
    else:
        reg = np.zeros((1, m), dtype=np.int64)
        reg[0, 3] = 1
    reg = reg.astype(np.int8)
    got = TK.hll_estimate_plain(torch.from_numpy(reg))
    want = JA._hll_estimate(jnp.asarray(reg))
    assert np.array_equal(got.numpy(), _i64(want))
    if case == "all_zero":
        assert not got.any()


@pytest.mark.parametrize("m", [512, 4096])
def test_hll_linear_counting_estimates_are_not_near_a_tie(m):
    """The linear-counting estimate m * log(m / v) takes one of m values.
    None lies within 1e-6 of a rounding tie, so a last-ulp difference
    between two log() implementations (numpy, XLA, CUDA) cannot change
    the rounded estimate: the kernel, the plain version, the JAX package
    and the numpy references agree exactly."""
    v = np.arange(1, m + 1, dtype=np.float64)
    est = m * np.log(m / v)
    frac = est - np.floor(est)
    assert np.min(np.abs(frac - 0.5)) > 1e-6


def _arg_case(dtype, n, seed):
    rng = np.random.default_rng(seed)
    n_keys = max(n // 6, 1)
    gkey = rng.integers(0, n_keys, size=n).astype(np.int64)
    live = rng.random(n) >= 0.15
    contrib = live & (rng.random(n) >= 0.3)
    # groups with no contributing row at all
    contrib &= gkey % 5 != 0
    if dtype == "float64":
        keys = rng.integers(-4, 4, size=n).astype(np.float64)  # ties
        keys[::7] = np.nan
        keys[1::9] = -0.0
        keys[2::9] = 0.0
        keys[3::19] = np.inf
    elif dtype == "int64":
        keys = rng.integers(-3, 3, size=n).astype(np.int64)
        # the would-be sentinels as real keys
        keys[::13] = np.iinfo(np.int64).max
        keys[1::13] = np.iinfo(np.int64).min
    else:
        keys = _typed_values(dtype, n, seed + 1)
    return gkey, live, contrib, keys


def _assert_arg_extreme_matches_jax(gkey, live, contrib, keys, is_min, capacity):
    tinfo = TK.group_by([(torch.from_numpy(gkey), None)], torch.from_numpy(live), capacity)
    jinfo = JK.sort_group(
        (jnp.asarray(gkey.view(np.uint64)),), (None,), jnp.asarray(live), capacity,
    )
    got = TK.seg_arg_extreme_plain(
        torch.from_numpy(keys), torch.from_numpy(contrib), tinfo.perm,
        tinfo.starts, tinfo.ends, is_min,
    ).numpy()
    perm = np.asarray(jinfo.perm)
    want = np.asarray(JK.seg_arg_extreme(
        JK.order_bits(jnp.asarray(keys))[perm], jnp.asarray(contrib)[perm],
        jinfo, is_min,
    ))
    has = np.zeros(capacity, dtype=bool)
    groups = tinfo.group.numpy()
    has[np.unique(groups[contrib & live & (groups < capacity)])] = True
    assert np.array_equal(got[has], want[has])
    # the chosen row contributes, is in its group and is extremal
    for g in np.flatnonzero(has)[:50]:
        rows = np.flatnonzero(live & contrib & (groups == g))
        bits = _i64(JK.order_bits(jnp.asarray(keys[rows]))) ^ SIGN
        best = bits.min() if is_min else bits.max()
        assert got[g] == rows[np.flatnonzero(bits == best)[0]]
    # a group without one gives its first sorted row (the port's contract)
    used = np.arange(capacity) < int(tinfo.num_groups)
    firsts = tinfo.perm.numpy()[tinfo.starts.numpy()[used & ~has]]
    assert np.array_equal(got[used & ~has], firsts)


@pytest.mark.parametrize("is_min", [True, False])
@pytest.mark.parametrize("dtype", ["int64", "float64", "int32", "bool"])
@pytest.mark.parametrize("n", [1, 7, 3000])
def test_seg_arg_extreme_matches_jax(dtype, n, is_min):
    gkey, live, contrib, keys = _arg_case(dtype, n, seed=n + len(dtype))
    _assert_arg_extreme_matches_jax(gkey, live, contrib, keys, is_min, 1024)


@pytest.mark.parametrize("is_min", [True, False])
@pytest.mark.parametrize("name,live_rows", [
    ("edge", 2047), ("edge", 2048), ("edge", 2049), ("singletons", 1000),
] + [(c, None) for c in ARG_CASES if c not in ("edge", "singletons")])
def test_seg_arg_extreme_tile_cases_match_jax(name, live_rows, is_min):
    """A3's tile shapes (``test_torch_tile_cases.py``) at one tile's size:
    3000 rows, as ``test_seg_arg_extreme_matches_jax``'s largest case, so
    that the JAX function compiled for it serves these too."""
    gkey, live, contrib, keys = arg_case(name, 3000, seed=len(name), live_rows=live_rows)
    _assert_arg_extreme_matches_jax(gkey, live, contrib, keys, is_min, 1024)


@pytest.mark.parametrize("n", [1, 7, 3000])
def test_seg_first_index_matches_jax(n):
    gkey, live, contrib, _ = _arg_case("int64", n, seed=n)
    capacity = 1024
    tinfo = TK.group_by([(torch.from_numpy(gkey), None)], torch.from_numpy(live), capacity)
    jinfo = JK.sort_group(
        (jnp.asarray(gkey.view(np.uint64)),), (None,), jnp.asarray(live), capacity,
    )
    rows, has = TK.seg_first_index(torch.from_numpy(contrib)[tinfo.perm], tinfo)
    jrows, jhas = JK.seg_first_index(jnp.asarray(contrib)[jinfo.perm], jinfo)
    assert np.array_equal(has.numpy(), np.asarray(jhas))
    assert np.array_equal(rows.numpy(), _i64(jrows))


def test_variance_formula_is_the_jax_packages():
    """``_variance`` on integer values gives the same float64 as the JAX
    package's ``VARIANCE_FNS`` branch: s2 - s1^2/n clamped at 0."""
    assert TA.VARIANCE_FNS == JA.VARIANCE_FNS
    assert (TA.HLL_GLOBAL_BUCKETS, TA.HLL_GROUPED_BUCKETS) == (
        JA.HLL_GLOBAL_BUCKETS, JA.HLL_GROUPED_BUCKETS)
    rng = np.random.default_rng(1)
    x = rng.integers(0, 100, size=1000)
    contrib = rng.random(1000) >= 0.1
    for name in sorted(TA.VARIANCE_FNS):
        got, ok = TA.compute_aggregate(
            name, None, (torch.from_numpy(x), None), None, 1, torch.from_numpy(contrib),
        )
        want, wok = JA.compute_aggregate(
            name, None, (jnp.asarray(x), None), None, 1, jnp.asarray(contrib),
        )
        assert got.tolist() == np.asarray(want).tolist(), name
        assert ok.tolist() == np.asarray(wok).tolist(), name


# ---- statements through both runners ------------------------------------------


@pytest.fixture(scope="module")
def torch_h():
    return TorchRunner.tpch("tiny", device="cpu")


@pytest.fixture(scope="module")
def jax_h():
    return JaxRunner.tpch("tiny")


@pytest.fixture(scope="module")
def oracle(jax_h):
    return load_tpch_sqlite(jax_h.metadata.connector("tpch").data("tiny"))


@pytest.fixture(scope="module")
def tpch_data(torch_h):
    return torch_h.metadata.connector("tpch").data("tiny")


#: statements whose DOUBLEs come from double or decimal arguments
APPROX_DOUBLES = {"variance_double", "variance_decimal"}


def _assert_same_rows(name, got, want):
    assert len(got) == len(want), name
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(b, float) and name in APPROX_DOUBLES:
                assert math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-9), (name, g, w)
            else:
                assert type(a) is type(b) and a == b, (name, g, w)


@pytest.mark.parametrize("name", list(AGGREGATE_STATEMENTS))
def test_statement_matches_jax_and_sqlite(torch_h, jax_h, oracle, name):
    sql = AGGREGATE_STATEMENTS[name]
    got = torch_h.execute(sql)
    want = jax_h.execute(sql)
    rows, wrows = got.rows, want.rows
    if not got.ordered:
        rows, wrows = sorted(rows, key=str), sorted(wrows, key=str)
    _assert_same_rows(name, rows, wrows)
    if name in AGGREGATE_SQLITE:
        expected = oracle.execute(to_sqlite(AGGREGATE_SQLITE[name])).fetchall()
        assert_rows_match(got.rows, expected, ordered=got.ordered, abs_tol=1e-9)


@pytest.mark.parametrize("col,table,rel,grouped", [
    ("o_custkey", "orders", 0.05, False),
    ("c_name", "customer", 0.05, False),
    ("l_comment", "lineitem", 0.02, False),
    ("o_comment", "orders", 0.02, False),
    ("o_custkey", "orders", 0.15, True),
])
def test_approx_distinct_within_the_sketch_error(torch_h, col, table, rel, grouped):
    """HLL with 4096 registers (rse ~1.6%) globally, 512 (~4.6%) grouped,
    against the exact count (the JAX package's bounds)."""
    if grouped:
        sql = f"select o_orderstatus, {{}}({col}) from {table} group by 1"
        est = dict(torch_h.execute(sql.format("approx_distinct")).rows)
        exact = dict(torch_h.execute(
            f"select o_orderstatus, count(distinct {col}) from {table} group by 1"
        ).rows)
        for k, e in exact.items():
            assert abs(est[k] - e) <= max(rel * e, 3), (k, est[k], e)
        return
    (a,), = torch_h.execute(f"select approx_distinct({col}) from {table}").rows
    (b,), = torch_h.execute(f"select count(distinct {col}) from {table}").rows
    assert abs(a - b) <= max(rel * b, 2), (a, b)


def test_approx_percentile_is_the_sorted_rank(torch_h, tpch_data):
    qty = np.asarray(tpch_data.column("lineitem", "l_quantity"))
    ln = np.asarray(tpch_data.column("lineitem", "l_linenumber"))
    (got,), = torch_h.execute(
        "select approx_percentile(l_quantity, 0.5) from lineitem"
    ).rows
    s = np.sort(qty)
    assert got == Decimal(int(s[round(0.5 * (len(s) - 1))])).scaleb(-2)
    rows = torch_h.execute(
        "select l_linenumber, approx_percentile(l_quantity, 0.9) "
        "from lineitem group by l_linenumber order by 1"
    ).rows
    for lnum, value in rows:
        s = np.sort(qty[ln == lnum])
        assert value == Decimal(int(s[round(0.9 * (len(s) - 1))])).scaleb(-2)
