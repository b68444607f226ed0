"""The port's PARTIAL/FINAL split and the spill tier's host helpers
against the JAX package, function by function, on inputs made with numpy
from fixed seeds (on the CPU).

- ``_hll_merge`` (A4's plain version): grouped, global, with
  non-contributing rows and rows of an overflow group; exact registers.
- ``_quant_summary`` (A5's plain version, after ``_quant_sorted_perm``):
  groups of 0, 1, k - 1, k and 10k contributing rows, ties, -0.0 and
  NaN, int64 and float64 values, grouped (k = 256) and global
  (k = 1024); exact summaries, bit for bit.
- ``_quant_merge`` (A6's plain version): summaries of chunks of uneven
  counts, q = 0, 0.5, 1, DOUBLE, BIGINT and long-decimal outputs, and a
  group whose pick lands exactly on q * total; exact picks.
- ``var_final:`` (``_var_final``) to relative 1e-12 (float64 state sums
  in another order), and ``sum_hi32``/``sum_lo32``
  (``_limb_partial_sum``) exactly, through both packages'
  ``compute_aggregate``.
- ``_split_aggregate``: the PARTIAL and FINAL nodes' output types and
  aggregate names, arguments and types equal the JAX package's for the
  aggregates the chunked tier splits.
- ``merge_sorted_runs`` and ``_host_partition_ids``: equal runs and
  partitions, also when the port's run keeps VARCHAR as dictionary codes.
- Sketch columns (int8 [n, 512], float64 [n, 257]) through
  ``Column.from_numpy``, compaction and a host round trip.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_skew_cases import QUANT_CASES, quant_case
from trino_tpu import types as JT
from trino_tpu.engine import QueryRunner as JaxRunner
from trino_tpu.exec import aggregates as JA
from trino_tpu.exec import kernels as JK
from trino_tpu.exec import spill as JS
from trino_tpu.plan import distribute as JD
from trino_tpu.plan import nodes as JP
from trino_tpu_torch import types as TT
from trino_tpu_torch.engine import QueryRunner as TorchRunner
from trino_tpu_torch.exec import aggregates as TA
from trino_tpu_torch.exec import kernels as TK
from trino_tpu_torch.exec import spill as TS
from trino_tpu_torch.page import StringDictionary
from trino_tpu_torch.plan import distribute as TD
from trino_tpu_torch.plan import nodes as TP


class _Groups:
    """The one field of GroupInfo that the merges read."""

    def __init__(self, group):
        self.group = group


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int64) if a.dtype == np.float64 else a


# ---- _hll_merge -----------------------------------------------------------------


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("n,m", [(1, 512), (40, 512), (3000, 512), (5, 4096), (700, 4096)])
def test_hll_merge_matches_jax(grouped, n, m):
    rng = np.random.default_rng(n + m + grouped)
    states = rng.integers(0, 40, size=(n, m)).astype(np.int8)
    states[rng.random((n, m)) < 0.6] = 0  # sparse registers
    contrib = rng.random(n) >= 0.25
    caps = 1
    group = None
    if grouped:
        caps = 37
        # ids past the table: the overflow rows both packages clip
        group = rng.integers(0, caps + 3, size=n).astype(np.int64)
    got = TK.hll_merge_plain(
        torch.from_numpy(states), torch.from_numpy(contrib),
        None if group is None else torch.from_numpy(group), caps,
    )
    info = None if group is None else _Groups(jnp.asarray(group.astype(np.int32)))
    want = JA._hll_merge(jnp.asarray(states), jnp.asarray(contrib), info, caps)
    assert got.dtype == torch.int8 and got.shape == (caps, m)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # the FINAL's estimate over the merged registers
    assert np.array_equal(
        TK.hll_estimate_plain(got).numpy(), np.asarray(JA._hll_estimate(want))
    )


def test_hll_merge_of_partials_is_the_resident_registers():
    """Register max is associative: the merge of per-chunk registers is
    the registers of all rows at once."""
    rng = np.random.default_rng(9)
    n, caps, m = 5000, 50, 512
    h = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, size=n))
    group = torch.from_numpy(rng.integers(0, caps, size=n))
    contrib = torch.from_numpy(rng.random(n) >= 0.1)
    whole = TK.hll_registers_plain(h, contrib, group, m, caps, True)
    parts, gids = [], []
    for lo in range(0, n, 1300):
        sl = slice(lo, lo + 1300)
        parts.append(TK.hll_registers_plain(h[sl], contrib[sl], group[sl], m, caps, True))
        gids.append(torch.arange(caps))
    merged = TK.hll_merge_plain(
        torch.cat(parts), torch.ones(len(parts) * caps, dtype=torch.bool),
        torch.cat(gids), caps,
    )
    assert torch.equal(merged, whole)


# ---- _quant_summary ---------------------------------------------------------------


def _summary_case(dtype, k, seed):
    """Group keys and values: groups with 0, 1, k-1, k and 10k
    contributing rows (plus non-contributing and dead rows), ties, -0.0,
    NaN."""
    rng = np.random.default_rng(seed)
    sizes = [3, 1, k - 1, k, 10 * k, 57]
    gkey = np.concatenate([np.full(s, g, dtype=np.int64) for g, s in enumerate(sizes)])
    n = len(gkey)
    contrib = rng.random(n) >= 0.1
    contrib[gkey == 0] = False  # a group of 0 contributing rows
    contrib[np.flatnonzero(gkey == 1)] = True
    contrib[np.flatnonzero(gkey == 2)] = True
    contrib[np.flatnonzero(gkey == 3)] = True
    live = np.ones(n, dtype=bool)
    live[-5:] = False
    perm = rng.permutation(n)
    gkey, contrib, live = gkey[perm], contrib[perm], live[perm]
    if dtype == "float64":
        v = rng.integers(-50, 50, size=n) / 4.0  # ties
        v[rng.random(n) < 0.05] = -0.0
        v[rng.random(n) < 0.05] = 0.0
        v[rng.random(n) < 0.01] = np.nan
    else:
        v = rng.integers(-(1 << 40), 1 << 40, size=n).astype(np.int64)
        v[::11] = 7  # ties
    return gkey, live, contrib & live, v


@pytest.mark.parametrize("dtype", ["float64", "int64"])
@pytest.mark.parametrize("grouped", [True, False])
def test_quant_summary_matches_jax(dtype, grouped):
    k = JA.QUANT_GROUPED_POINTS if grouped else JA.QUANT_GLOBAL_POINTS
    assert (TA.QUANT_GROUPED_POINTS, TA.QUANT_GLOBAL_POINTS) == (
        JA.QUANT_GROUPED_POINTS, JA.QUANT_GLOBAL_POINTS)
    gkey, live, eff, v = _summary_case(dtype, k, seed=k + len(dtype))
    capacity = 1024 if grouped else 1
    tinfo = jinfo = None
    if grouped:
        tinfo = TK.group_by(
            [(torch.from_numpy(gkey), None)], torch.from_numpy(live), capacity
        )
        jinfo = JK.sort_group(
            (jnp.asarray(gkey.view(np.uint64)),), (None,), jnp.asarray(live),
            capacity,
        )
    te = torch.from_numpy(eff)
    got = TA._quant_summary(
        torch.from_numpy(v), te, tinfo, capacity, k,
        TA._Reducer(tinfo, capacity, te, {}),
    )
    je = jnp.asarray(eff)
    want, _ = JA._quant_summary(
        jnp.asarray(v), je, jinfo, capacity, k,
        JA._Reducer(jinfo, capacity, je, {}),
    )
    assert got.dtype == torch.float64 and got.shape == (capacity, k + 1)
    assert np.array_equal(_bits(got.numpy()), _bits(want))


def test_quant_summary_offsets_round_half_to_even():
    """(i + 0.5) / k * cnt - 0.5 lands on x.5 for many counts: the
    offsets round half to even, as numpy's."""
    k = 256
    cnt = torch.arange(0, 3000, dtype=torch.int64)
    vd = torch.arange(int(cnt.sum()), dtype=torch.int64)
    starts = torch.cumsum(cnt, 0) - cnt
    out = TK.quant_summary_plain(vd, vd.clone(), starts, cnt, k)
    i = np.arange(k, dtype=np.float64)
    c = cnt.numpy().astype(np.float64)
    offs = np.clip(np.round((i[None, :] + 0.5) / k * c[:, None] - 0.5), 0,
                   np.maximum(c - 1, 0)[:, None]).astype(np.int64)
    want = np.clip(starts.numpy()[:, None] + offs, 0, len(vd) - 1)
    assert np.array_equal(out[:, :k].numpy(), want.astype(np.float64))
    assert np.array_equal(out[:, k].numpy(), c)


# ---- _quant_merge -----------------------------------------------------------------


def _chunk_summaries(k, n_groups, chunks, seed):
    """Summaries of ``chunks`` uneven chunks of a value column, each chunk
    a PARTIAL over its rows: [chunks * n_groups, k + 1] states and the
    group id of each partial row."""
    rng = np.random.default_rng(seed)
    n = 4000
    gkey = rng.integers(0, n_groups, size=n).astype(np.int64)
    v = np.round(rng.normal(size=n) * 1000.0, 2)
    v[rng.random(n) < 0.02] = -0.0
    bounds = np.sort(rng.choice(np.arange(1, n), size=chunks - 1, replace=False))
    states, groups = [], []
    cap = 64
    for lo, hi in zip(np.concatenate([[0], bounds]), np.concatenate([bounds, [n]])):
        g, x = gkey[lo:hi], v[lo:hi]
        live = torch.ones(len(g), dtype=torch.bool)
        info = TK.group_by([(torch.from_numpy(g), None)], live, cap)
        st = TA._quant_summary(
            torch.from_numpy(x), live, info, cap, k,
            TA._Reducer(info, cap, live, {}),
        )
        used = int(info.num_groups)
        states.append(st[:used].numpy())
        groups.append(g[info.owner[:used].numpy()])
    return np.concatenate(states), np.concatenate(groups)


@pytest.mark.parametrize("q", [0.0, 0.5, 1.0, 0.37])
@pytest.mark.parametrize("out", ["double", "bigint", "long_decimal"])
def test_quant_merge_matches_jax(q, out):
    k = 256
    states, groups = _chunk_summaries(k, 9, 5, seed=int(q * 100))
    rng = np.random.default_rng(4)
    contrib = rng.random(len(groups)) >= 0.1
    valid = rng.random(len(groups)) >= 0.05
    caps = 16
    jt, tt = {
        "double": (JT.DOUBLE, TT.DOUBLE),
        "bigint": (JT.BIGINT, TT.BIGINT),
        "long_decimal": (JT.DecimalType(38, 2), TT.DecimalType(38, 2)),
    }[out]
    qa = np.full(8, q)
    got, ghas = TA._quant_merge(
        torch.from_numpy(states), torch.from_numpy(qa), torch.from_numpy(contrib),
        torch.from_numpy(valid), _Groups(torch.from_numpy(groups)), caps, tt,
    )
    want, whas = JA._quant_merge(
        jnp.asarray(states), jnp.asarray(qa), jnp.asarray(contrib),
        jnp.asarray(valid), _Groups(jnp.asarray(groups.astype(np.int32))), caps, jt,
    )
    assert np.array_equal(ghas.numpy(), np.asarray(whas))
    h = ghas.numpy()
    assert np.array_equal(_bits(got.numpy()[h]), _bits(np.asarray(want)[h]))


def test_quant_merge_global_and_exact_target():
    """One group of two partial rows of equal counts: at q = 0.5 the
    running weight equals q * total exactly at the first row's last
    point, which is the pick (the 1e-9 slack admits equality)."""
    k = 4
    states = np.array([
        [1.0, 2.0, 3.0, 4.0, 8.0],
        [5.0, 6.0, 7.0, 8.0, 8.0],
    ])
    for q, pick in ((0.5, 4.0), (0.0, 1.0), (1.0, 8.0), (0.51, 5.0)):
        got, has = TA._quant_merge(
            torch.from_numpy(states), torch.tensor([q], dtype=torch.float64),
            torch.ones(2, dtype=torch.bool), None, None, 1, TT.DOUBLE,
        )
        want, whas = JA._quant_merge(
            jnp.asarray(states), jnp.asarray([q]), jnp.ones(2, dtype=bool),
            None, None, 1, JT.DOUBLE,
        )
        assert got.tolist() == np.asarray(want).tolist() == [pick], q
        assert has.tolist() == np.asarray(whas).tolist() == [True]


@pytest.mark.parametrize("name", QUANT_CASES)
def test_quant_cases_match_jax(name):
    """A6's plain version against the JAX package's ``_quant_merge`` on
    A6's adversarial cases (``test_torch_skew_cases.py``), the contract
    the card holds the kernel to: every value, bit for bit, and every
    flag, at q = 0, 0.5, 0.9 and 1."""
    states, eff, group, caps = quant_case(name, seed=5)
    info = None if group is None else _Groups(jnp.asarray(group.astype(np.int32)))
    tinfo = None if group is None else torch.from_numpy(group)
    for q in (0.0, 0.5, 0.9, 1.0):
        got, ghas = TK.quant_merge_plain(
            torch.from_numpy(states), torch.from_numpy(eff), tinfo, caps,
            torch.tensor([q], dtype=torch.float64))
        want, whas = JA._quant_merge(
            jnp.asarray(states), jnp.asarray([q]), jnp.asarray(eff), None,
            info, caps, JT.DOUBLE)
        assert np.array_equal(ghas.numpy(), np.asarray(whas)), q
        assert np.array_equal(_bits(got.numpy()), _bits(want)), q


def test_quant_merge_of_chunks_is_within_the_rank_bound():
    """Summaries of uneven chunks merge to a value within the summary's
    rank error of the exact percentile (as tests/test_sketches.py bounds
    the JAX package's)."""
    k = 256
    rng = np.random.default_rng(12)
    v = rng.normal(size=20_000)
    parts = []
    for lo, hi in ((0, 1000), (1000, 9000), (9000, 9100), (9100, 20_000)):
        x = torch.from_numpy(v[lo:hi])
        live = torch.ones(hi - lo, dtype=torch.bool)
        parts.append(TA._quant_summary(x, live, None, 1, k, TA._Reducer(None, 1, live, {})))
    states = torch.cat(parts)
    s = np.sort(v)
    for q in (0.1, 0.5, 0.9):
        (got,), _ = TA._quant_merge(
            states, torch.tensor([q], dtype=torch.float64),
            torch.ones(4, dtype=torch.bool), None, None, 1, TT.DOUBLE,
        )
        r = round(q * (len(s) - 1))
        eps = 4 * len(s) // k + 1
        assert s[max(r - eps, 0)] <= got <= s[min(r + eps, len(s) - 1)]


# ---- var_final and the limb partial sums -------------------------------------------


def _infos(gkey, live, capacity):
    tinfo = TK.group_by([(torch.from_numpy(gkey), None)], torch.from_numpy(live), capacity)
    jinfo = JK.sort_group(
        (jnp.asarray(gkey.view(np.uint64)),), (None,), jnp.asarray(live), capacity,
    )
    return tinfo, jinfo


@pytest.mark.parametrize("grouped", [True, False])
def test_var_final_matches_jax(grouped):
    """The FINAL of the variance family over (n, s1, s2) partial states;
    float64 sums in another order: relative 1e-12."""
    rng = np.random.default_rng(21)
    rows = 900
    gkey = rng.integers(0, 40, size=rows).astype(np.int64)
    live = rng.random(rows) >= 0.05
    cnt = rng.integers(0, 30, size=rows).astype(np.int64)
    x = rng.normal(size=(rows, 30)) * 100.0
    s1 = np.where(np.arange(30)[None, :] < cnt[:, None], x, 0.0).sum(1)
    s2 = np.where(np.arange(30)[None, :] < cnt[:, None], x * x, 0.0).sum(1)
    s1_valid = cnt > 0
    capacity = 64 if grouped else 1
    tinfo, jinfo = _infos(gkey, live, capacity) if grouped else (None, None)
    for kind in sorted(TA.VARIANCE_FNS):
        name = f"var_final:{kind}"
        got, ok = TA.compute_aggregate(
            name, TT.DOUBLE,
            [(torch.from_numpy(cnt), None), (torch.from_numpy(s1), torch.from_numpy(s1_valid)),
             (torch.from_numpy(s2), torch.from_numpy(s1_valid))],
            tinfo, capacity, torch.from_numpy(live),
        )
        want, wok = JA.compute_aggregate(
            name, JT.DOUBLE,
            [(jnp.asarray(cnt), None), (jnp.asarray(s1), jnp.asarray(s1_valid)),
             (jnp.asarray(s2), jnp.asarray(s1_valid))],
            jinfo, capacity, jnp.asarray(live),
        )
        ok, wok = ok.numpy(), np.asarray(wok)
        assert np.array_equal(ok, wok), kind
        for a, b in zip(got.numpy()[ok], np.asarray(want)[wok]):
            assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0), (kind, a, b)


@pytest.mark.parametrize("two_limb", [False, True])
@pytest.mark.parametrize("grouped", [True, False])
def test_limb_partial_sums_match_jax(two_limb, grouped):
    rng = np.random.default_rng(33)
    rows = 2000
    gkey = rng.integers(0, 25, size=rows).astype(np.int64)
    live = rng.random(rows) >= 0.1
    if two_limb:
        wide = rng.integers(-(1 << 60), 1 << 60, size=rows)
        data = np.stack([wide >> 32, wide & 0xFFFFFFFF], axis=-1).astype(np.int64)
    else:
        data = rng.integers(-(1 << 62), 1 << 62, size=rows).astype(np.int64)
    valid = rng.random(rows) >= 0.2
    valid[gkey == 3] = False  # a group with no contributing row: NULL
    capacity = 32 if grouped else 1
    tinfo, jinfo = _infos(gkey, live, capacity) if grouped else (None, None)
    for name in ("sum_hi32", "sum_lo32"):
        got, gv = TA.compute_aggregate(
            name, TT.BIGINT, (torch.from_numpy(data), torch.from_numpy(valid)),
            tinfo, capacity, torch.from_numpy(live),
        )
        want, wv = JA.compute_aggregate(
            name, JT.BIGINT, (jnp.asarray(data), jnp.asarray(valid)),
            jinfo, capacity, jnp.asarray(live),
        )
        assert np.array_equal(gv.numpy(), np.asarray(wv)), name
        assert np.array_equal(got.numpy(), np.asarray(want)), name


# ---- _split_aggregate ----------------------------------------------------------------

SPLIT_SQL = {
    "tpch_q01": None,
    "sketches": (
        "select l_returnflag, approx_distinct(l_partkey), "
        "approx_percentile(l_quantity, 0.5), max_by(l_orderkey, l_tax), "
        "min_by(l_orderkey, l_tax), arbitrary(l_linestatus), bool_or(l_quantity > 3), "
        "stddev_samp(l_quantity), var_pop(l_linenumber), count_if(l_tax > 0.02), "
        "min(l_shipdate), sum(l_quantity * l_tax) from lineitem group by 1"
    ),
    "global": (
        "select approx_distinct(l_comment), approx_percentile(l_extendedprice, 0.9), "
        "avg(l_discount), avg(l_linenumber), count(*), sum(l_suppkey) from lineitem"
    ),
}


def _first_aggregate(plan, cls):
    stack = [plan]
    while stack:
        n = stack.pop()
        if isinstance(n, cls):
            return n
        stack.extend(n.sources)
    raise AssertionError("no Aggregate")


def _desc(node):
    return (
        node.step, list(node.group_keys),
        {s: str(t) for s, t in node.outputs.items()},
        {
            s: (a.name, repr(a.args), str(a.type), repr(a.filter), a.distinct)
            for s, a in node.aggregates.items()
        },
    )


@pytest.mark.parametrize("name", list(SPLIT_SQL))
def test_split_aggregate_matches_jax(name):
    from trino_tpu.connectors.tpch.queries import QUERIES

    sql = SPLIT_SQL[name] or QUERIES["q01"]
    tplan = TorchRunner.tpch("tiny", device="cpu").plan_sql(sql)
    jplan = JaxRunner.tpch("tiny").plan_sql(sql)
    tagg = _first_aggregate(tplan, TP.Aggregate)
    jagg = _first_aggregate(jplan, JP.Aggregate)
    assert TD._SELF_COMBINING == JD._SELF_COMBINING
    tp, tf = TD._split_aggregate(tagg)
    jp, jf = JD._split_aggregate(jagg)
    assert _desc(tp) == _desc(jp)
    assert _desc(tf) == _desc(jf)


def test_split_aggregate_refuses_what_the_jax_package_refuses():
    """An aggregate without a split (approx_percentile of a decimal(38)
    expression) raises NotImplementedError in both packages; the chunked
    tier then runs it resident."""
    sql = (
        "select approx_percentile(cast(l_quantity as decimal(38, 2)), 0.5) "
        "from lineitem"
    )
    for runner, mod, cls in (
        (TorchRunner.tpch("tiny", device="cpu"), TD, TP.Aggregate),
        (JaxRunner.tpch("tiny"), JD, JP.Aggregate),
    ):
        agg = _first_aggregate(runner.plan_sql(sql), cls)
        with pytest.raises(NotImplementedError):
            mod._split_aggregate(agg)


# ---- merge_sorted_runs and _host_partition_ids -------------------------------------------


def _runs(seed, n_runs=4):
    """Sorted host runs of (int64 k, float64 f, nullable int32 x, varchar s,
    two-limb d) in both packages' HostRun, and the port's twin with the
    varchar column as codes of one shared dictionary."""
    rng = np.random.default_rng(seed)
    words = np.asarray(["apple", "pear", "fig", "kiwi", "", "plum"], dtype=object)
    dictionary = StringDictionary(np.unique(words.astype(str)).astype(object))
    out = []
    for r in range(n_runs):
        n = int(rng.integers(0, 300)) if r else 250
        k = np.sort(rng.integers(-20, 20, size=n)).astype(np.int64)
        f = rng.integers(-5, 5, size=n) / 2.0
        f[rng.random(n) < 0.1] = -0.0
        x = rng.integers(0, 9, size=n).astype(np.int32)
        xv = rng.random(n) >= 0.2
        codes = rng.integers(0, len(dictionary), size=n).astype(np.int32)
        s = dictionary.values[codes].astype(object)
        wide = rng.integers(-(1 << 40), 1 << 40, size=n)
        d = np.stack([wide >> 32, wide & 0xFFFFFFFF], axis=-1).astype(np.int64)
        out.append((n, k, f, x, xv, s, codes, d))
    names = ["k", "f", "x", "s", "d"]
    jt = [JT.BIGINT, JT.DOUBLE, JT.INTEGER, JT.VARCHAR, JT.DecimalType(38, 2)]
    tt = [TT.BIGINT, TT.DOUBLE, TT.INTEGER, TT.VARCHAR, TT.DecimalType(38, 2)]
    jruns, truns, coded = [], [], []
    for n, k, f, x, xv, s, codes, d in out:
        cols = [(k, None), (f, None), (x, xv), (s, None), (d, None)]
        jruns.append(JS.HostRun(names, jt, cols, n))
        truns.append(TS.HostRun(names, tt, cols, n))
        coded.append(TS.HostRun(
            names, tt, [(k, None), (f, None), (x, xv), (codes, None), (d, None)],
            n, [None, None, None, dictionary, None],
        ))
    return jruns, truns, coded


def _same_run(a, b):
    assert a.n_rows == b.n_rows and list(a.names) == list(b.names)
    for (va, xa), (vb, xb) in zip(a.columns, b.columns):
        if va.dtype == object or vb.dtype == object:
            assert np.array_equal(va.astype(str), vb.astype(str))
        else:
            assert np.array_equal(_bits(va), _bits(vb))
        assert (xa is None) == (xb is None)
        assert xa is None or np.array_equal(xa, xb)


def _sort_order(run, keys):
    """The row order sorting one run by ``keys``: the JAX package's
    general merge path over the run's row positions."""
    pos = np.arange(run.n_rows)
    tagged = JS.HostRun(
        run.names + ["#pos"], run.types + [JT.BIGINT],
        run.columns + [(pos, None)], run.n_rows,
    )
    half = run.n_rows // 2
    halves = [_take(tagged, pos[:half], JS), _take(tagged, pos[half:], JS)]
    merged = JS.merge_sorted_runs(halves, list(keys) * 2)
    return merged.columns[-1][0]


def _take(run, order, mod):
    cols = [(v[order], None if x is None else x[order]) for v, x in run.columns]
    if mod is TS:
        return TS.HostRun(run.names, run.types, cols, len(order), run.encodings)
    return JS.HostRun(run.names, run.types, cols, len(order))


@pytest.mark.parametrize("keys", [
    [("k", True, None)],
    [("k", False, None)],
    [("f", True, None)],
    [("x", True, None), ("k", False, None)],
    [("x", False, True), ("f", True, None)],
    [("s", True, None), ("k", True, None)],
    [("s", False, None), ("d", True, None)],
    [("d", False, None)],
])
def test_merge_sorted_runs_matches_jax(keys):
    jruns, truns, coded = _runs(seed=len(keys) + len(keys[0][0]))
    jk = [JP.SortKey(s, a, nf) for s, a, nf in keys]
    tk = [TP.SortKey(s, a, nf) for s, a, nf in keys]
    # each run arrives sorted by the keys (its chunk's device sort): the
    # reference's general path sorts one run's two halves by them
    order = [_sort_order(r, jk) for r in jruns]
    jruns, truns, coded = (
        [_take(r, o, mod) for r, o in zip(runs, order)]
        for runs, mod in ((jruns, JS), (truns, TS), (coded, TS))
    )
    want = JS.merge_sorted_runs(jruns, jk)
    _same_run(TS.merge_sorted_runs(truns, tk), want)
    merged = TS.merge_sorted_runs(coded, tk)
    _same_run(TS._decoded(merged), want)


@pytest.mark.parametrize("key_syms", [["k"], ["f"], ["x"], ["s"], ["k", "s"], ["x", "f"]])
@pytest.mark.parametrize("salt", [0, 3])
@pytest.mark.parametrize("parts", [2, 7])
def test_host_partition_ids_match_jax(key_syms, salt, parts):
    jruns, truns, coded = _runs(seed=parts + salt)
    for jr, tr, cr in zip(jruns, truns, coded):
        want = JS._host_partition_ids(jr, key_syms, parts, salt=salt)
        assert np.array_equal(TS._host_partition_ids(tr, key_syms, parts, salt=salt), want)
        assert np.array_equal(TS._host_partition_ids(cr, key_syms, parts, salt=salt), want)


@pytest.mark.parametrize("kind,lanes", [("hll", 512), ("quant", 257)])
def test_sketch_columns_survive_compaction_and_a_host_round_trip(kind, lanes):
    """A PARTIAL's sketch states ride pages as [capacity, lanes] columns
    (int8 registers, float64 summaries): ``Column.from_numpy``, the
    executor's compaction and the spill tier's host round trip keep them
    row for row."""
    from trino_tpu_torch.page import Column, Page

    rng = np.random.default_rng(lanes)
    t = TT.SketchType(kind, lanes)
    n = 300
    if kind == "hll":
        vals = rng.integers(0, 50, size=(n, lanes)).astype(np.int8)
    else:
        vals = rng.normal(size=(n, lanes))
    col = Column.from_numpy(t, vals, capacity=512)
    assert col.data.shape == (512, lanes) and col.data.dtype == (
        torch.int8 if kind == "hll" else torch.float64)
    keys = Column.from_numpy(TT.BIGINT, np.arange(n, dtype=np.int64), capacity=512)
    live = np.zeros(512, dtype=bool)
    live[:n] = rng.random(n) >= 0.3
    page = Page(["k", "s"], [keys, col], torch.from_numpy(live))
    ex = TorchRunner.tpch("tiny", device="cpu").executor
    packed = ex._compact(page)
    sel = np.flatnonzero(live)
    assert packed.known_rows == len(sel)
    assert np.array_equal(packed.column("s").data[: len(sel)].numpy(), vals[sel])
    run = TS.page_to_host(packed)
    back = TS.host_concat_to_page(ex, [run, TS.page_to_host(packed)])
    assert np.array_equal(back.column("s").data[: 2 * len(sel)].numpy(),
                          np.concatenate([vals[sel], vals[sel]]))
    assert np.array_equal(back.column("k").data[: 2 * len(sel)].numpy(),
                          np.concatenate([sel, sel]))
