"""The port's memory-bounded tier (``trino_tpu_torch/exec/spill.py``, the
executor's budget, revocation and ``max_chunk_rows`` paths) on the CPU,
against the JAX package and the sqlite oracle, at TPC-H ``tiny``.

Twins of the reference's tier tests: ``tests/test_spill.py`` (all 16,
with the port's own ``spill.MIN_CHUNK_ROWS`` cut to 8192 as the
reference cuts its own), ``tests/test_chunked_agg.py``, the chunked
cases of ``tests/test_sketches.py`` and the cap and revocation cases of
``tests/test_memory_governance.py``; then the budgeted semi join (which
raised before this tier) and the chunked cross join. Each budgeted
statement's rows must equal the JAX package's resident rows (exactly:
decimals, integers, strings; the statements hold no DOUBLE) and sqlite's
within the oracle's tolerance, where the reference test checks sqlite.
The tables of the two grace-join edge cases live in a small array
connector here (the port has no memory connector yet); the JAX package
runs them over its own memory connector.
"""

import numpy as np
import pytest

from trino_tpu.connectors.tpch.queries import QUERIES
from trino_tpu.engine import QueryRunner as JaxRunner
from trino_tpu.testing.golden import assert_rows_match, load_tpch_sqlite, to_sqlite
from trino_tpu_torch import types as TT
from trino_tpu_torch.connectors.base import Connector, TableSchema
from trino_tpu_torch.engine import QueryRunner
from trino_tpu_torch.exec import spill
from trino_tpu_torch.memory import ExceededMemoryLimitError
from trino_tpu_torch.metadata import Metadata, Session
from trino_tpu_torch.testing.statements import BUDGETED_STATEMENTS

#: tight enough that tiny's lineitem (60k rows) streams in several chunks,
#: loose enough that per-chunk working sets and final results fit
BUDGET = 2 << 20


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    monkeypatch.setattr(spill, "MIN_CHUNK_ROWS", 8192)
    spill.reset_entries()


@pytest.fixture()
def runner():
    r = QueryRunner.tpch("tiny", device="cpu")
    r.session.properties["hbm_budget_bytes"] = BUDGET
    return r


@pytest.fixture(scope="module")
def jax_r():
    return JaxRunner.tpch("tiny")


@pytest.fixture(scope="module")
def oracle(jax_r):
    return load_tpch_sqlite(jax_r.metadata.connector("tpch").data("tiny"))


def check(runner, jax_r, oracle, sql, abs_tol=1e-9):
    """The port's rows equal the JAX package's exactly and sqlite's
    within ``abs_tol``."""
    result = runner.execute(sql)
    want = jax_r.execute(sql)
    rows, wrows = result.rows, want.rows
    if not result.ordered:
        rows, wrows = sorted(rows, key=str), sorted(wrows, key=str)
    assert rows == wrows
    if oracle is not None:
        expected = oracle.execute(to_sqlite(sql)).fetchall()
        assert_rows_match(
            result.rows, expected, ordered=result.ordered, abs_tol=abs_tol
        )
    return result


# ---- twins of tests/test_spill.py ----------------------------------------------


def test_streamed_aggregation(runner, jax_r, oracle):
    check(
        runner, jax_r, oracle,
        "select l_returnflag, l_linestatus, sum(l_quantity), "
        "avg(l_extendedprice), count(*) from lineitem "
        "where l_shipdate <= date '1998-09-02' "
        "group by l_returnflag, l_linestatus order by 1, 2",
    )
    assert runner.executor.tracked_bytes_hwm > 0  # streaming engaged
    assert runner.executor.tracked_bytes_hwm <= BUDGET
    assert spill.ENTRIES["run_chain_streamed"] >= 1


def test_streamed_high_cardinality_aggregation(runner, jax_r, oracle):
    check(
        runner, jax_r, oracle,
        "select l_orderkey, sum(l_quantity) from lineitem "
        "group by l_orderkey order by 2 desc, 1 limit 20",
    )


def test_streamed_filter_only(runner, jax_r, oracle):
    check(
        runner, jax_r, oracle,
        "select l_orderkey, l_quantity from lineitem "
        "where l_quantity > 49 and l_discount < 0.02",
    )


def test_streamed_topn(runner, jax_r, oracle):
    check(
        runner, jax_r, oracle,
        "select l_orderkey, l_extendedprice from lineitem "
        "order by l_extendedprice desc, l_orderkey limit 7",
    )


def test_streamed_limit_early_exit(runner):
    res = runner.execute("select l_orderkey from lineitem limit 5")
    assert len(res.rows) == 5
    # three columns of lineitem exceed a quarter of the budget: the scan
    # streams, and stops after the first chunk
    res = runner.execute(
        "select l_orderkey, l_partkey, l_suppkey from lineitem limit 5"
    )
    assert len(res.rows) == 5
    assert spill.ENTRIES["run_chain_streamed"] == 1


def test_streamed_probe_join(runner, jax_r, oracle):
    check(
        runner, jax_r, oracle,
        "select n_name, count(*) from lineitem, supplier, nation "
        "where l_suppkey = s_suppkey and s_nationkey = n_nationkey "
        "group by n_name order by 1",
    )


def test_grace_join(runner, jax_r, oracle):
    """A full-width self-join: BOTH sides exceed the budget slab, forcing
    the grace-hash partitioned path."""
    check(
        runner, jax_r, oracle,
        "select count(*) from lineitem l1, lineitem l2 "
        "where l1.l_orderkey = l2.l_orderkey "
        "and l1.l_linenumber = l2.l_linenumber",
    )
    assert runner.executor.tracked_bytes_hwm <= BUDGET
    assert spill.ENTRIES["grace_join"] == 1


def test_grace_left_join(runner, jax_r, oracle):
    check(
        runner, jax_r, oracle,
        "select count(*), count(o_orderkey) from orders "
        "left join lineitem on o_orderkey = l_orderkey "
        "and l_quantity > 49",
    )


def test_streamed_semi_join(runner, jax_r, oracle):
    check(
        runner, jax_r, oracle,
        "select count(*) from lineitem where l_orderkey in "
        "(select o_orderkey from orders where o_orderpriority = '1-URGENT')",
    )


def test_budgeted_q18(runner, jax_r, oracle):
    """Q18 under a device budget (at tiny with its 300-unit threshold it
    returns no rows, as in the reference's test)."""
    check(runner, jax_r, oracle, QUERIES["q18"], abs_tol=1e-6)
    assert runner.executor.tracked_bytes_hwm <= BUDGET


def test_budgeted_empty_result(runner, jax_r, oracle):
    check(
        runner, jax_r, oracle,
        "select l_orderkey from lineitem where l_quantity > 1000",
    )


def test_results_identical_to_resident(jax_r):
    """The budget changes HOW, never WHAT: streamed and resident runs
    agree exactly (and with the JAX package)."""
    sql = (
        "select l_returnflag, count(*), sum(l_extendedprice) "
        "from lineitem, orders where l_orderkey = o_orderkey "
        "and o_orderdate < date '1995-01-01' "
        "group by l_returnflag order by 1"
    )
    resident = QueryRunner.tpch("tiny", device="cpu").execute(sql)
    budgeted = QueryRunner.tpch("tiny", device="cpu")
    budgeted.session.properties["hbm_budget_bytes"] = BUDGET
    assert budgeted.execute(sql).rows == resident.rows == jax_r.execute(sql).rows


def test_grace_join_varchar_keys(runner, jax_r, oracle):
    """VARCHAR grace keys hash the string VALUE, not chunk-local codes."""
    check(
        runner, jax_r, oracle,
        "select count(*) from lineitem l1, lineitem l2 "
        "where l1.l_shipmode = l2.l_shipmode "
        "and l1.l_orderkey = l2.l_orderkey "
        "and l1.l_linenumber = l2.l_linenumber",
    )


def test_streamed_join_respects_inner_limit(runner, jax_r):
    """A Limit below a join must not stream per chunk."""
    sql = (
        "select count(*) from (select l_orderkey from lineitem limit 50) s, "
        "orders where s.l_orderkey = o_orderkey"
    )
    resident = QueryRunner.tpch("tiny", device="cpu").execute(sql)
    assert runner.execute(sql).rows == resident.rows == jax_r.execute(sql).rows


class _ArrayConnector(Connector):
    """Tables of host arrays (schema ``default``)."""

    def __init__(self, tables):
        self._tables = tables  # name -> (TableSchema, {column: array})

    def list_schemas(self):
        return ["default"]

    def list_tables(self, schema):
        return sorted(self._tables)

    def table_schema(self, schema, table):
        return self._tables[table][0]

    def row_count(self, schema, table):
        cols = self._tables[table][1]
        return len(next(iter(cols.values())))

    def scan(self, schema, table, columns, split=None):
        cols = self._tables[table][1]
        out = {}
        for c in columns:
            arr = cols[c]
            if split is not None:
                arr = arr[split.start: split.start + split.count]
            out[c] = arr
        return out


def _two_tables(lk, v, rk, w):
    """(port runner over an array connector, JAX runner over its memory
    connector) holding l(k, v) and r(k, w)."""
    from trino_tpu.connectors.memory import MemoryConnector
    from trino_tpu.metadata import Metadata as JaxMetadata
    from trino_tpu.metadata import Session as JaxSession

    def schema(name, a, b):
        return TableSchema(name, [(a, TT.BIGINT), (b, TT.BIGINT)])

    md = Metadata()
    md.register_catalog("memory", _ArrayConnector({
        "l": (schema("l", "k", "v"), {"k": lk, "v": v}),
        "r": (schema("r", "k", "w"), {"k": rk, "w": w}),
    }))
    jmd = JaxMetadata()
    jmd.register_catalog("memory", MemoryConnector())
    j = JaxRunner(jmd, JaxSession(catalog="memory", schema="default"))
    j.execute("create table l (k bigint, v bigint)")
    j.execute("create table r (k bigint, w bigint)")
    conn = jmd.connector("memory")
    conn.insert("default", "l", {"k": (lk, None), "v": (v, None)})
    conn.insert("default", "r", {"k": (rk, None), "w": (w, None)})

    def port(budget=0, **props):
        r = QueryRunner(
            md, Session(catalog="memory", schema="default"), device="cpu"
        )
        if budget:
            r.session.properties["hbm_budget_bytes"] = budget
        r.session.properties.update(props)
        return r

    return port, j


def test_grace_join_recursion_on_underestimated_partitions():
    """A pair whose MEASURED bytes exceed the pair budget re-partitions
    with a salted hash until it fits: two forced first-pass partitions
    for ~4 MB of inputs against a 256 KB pair budget."""
    rng = np.random.default_rng(3)
    n = 120_000
    keys = rng.permutation(n).astype(np.int64)
    port, jax_runner = _two_tables(
        keys, rng.integers(0, 10, n).astype(np.int64),
        keys.copy(), rng.integers(0, 10, n).astype(np.int64),
    )
    sql = "select count(*), sum(v + w) from l, r where l.k = r.k"
    resident = port().execute(sql).rows
    b = port(1 << 20, grace_partitions=2)
    assert b.execute(sql).rows == resident == jax_runner.execute(sql).rows
    assert b.executor.grace_recursion_hwm > 1


def test_grace_join_single_hot_key_chunk_pairs():
    """A single hot probe key defeats re-partitioning: the hot-pair
    fallback streams (probe chunk x build chunk) pairs under the budget
    and the result stays exact."""
    rng = np.random.default_rng(5)
    n = 120_000
    lk = np.where(
        rng.random(n) < 0.5, 7, rng.integers(10, 1 << 40, n)
    ).astype(np.int64)
    rk = np.concatenate([
        np.asarray([7], dtype=np.int64),
        rng.integers(10, 1 << 40, n - 1).astype(np.int64),
    ])
    port, jax_runner = _two_tables(
        lk, rng.integers(0, 10, n).astype(np.int64),
        rk, rng.integers(0, 10, n).astype(np.int64),
    )
    sql = "select count(*), sum(v + w) from l, r where l.k = r.k"
    resident = port().execute(sql).rows
    b = port(1 << 20)
    assert b.execute(sql).rows == resident == jax_runner.execute(sql).rows
    assert b.executor.grace_hot_pairs > 0


# ---- twins of tests/test_chunked_agg.py ------------------------------------------


def _chunked(chunk):
    r = QueryRunner.tpch("tiny", device="cpu")
    r.session.properties["max_chunk_rows"] = chunk
    return r


@pytest.mark.parametrize("chunk", [3000, 4096])
def test_chunked_matches_oracle(jax_r, oracle, chunk):
    r = _chunked(chunk)
    # orders has 15000 rows at tiny: several chunks, each holding only a
    # fraction of the ~1000 custkeys
    check(
        r, jax_r, oracle,
        "select o_custkey, count(*), sum(o_totalprice), min(o_orderdate), "
        "avg(o_shippriority) from orders group by o_custkey",
        abs_tol=0.01,
    )
    check(
        r, jax_r, oracle,
        "select l_returnflag, l_linestatus, sum(l_quantity), count(*) "
        "from lineitem group by l_returnflag, l_linestatus",
        abs_tol=0.01,
    )


def test_keys_exceed_chunk(jax_r, oracle):
    """More distinct keys than one chunk holds rows."""
    check(
        _chunked(1024), jax_r, oracle,
        "select count(*) from ("
        "  select l_orderkey, sum(l_extendedprice) s from lineitem"
        "  group by l_orderkey) where s > 0",
    )


def test_chunked_same_as_unchunked(jax_r):
    sql = (
        "select o_orderpriority, count(*), avg(o_totalprice) "
        "from orders group by o_orderpriority order by 1"
    )
    plain = QueryRunner.tpch("tiny", device="cpu").execute(sql)
    assert _chunked(2048).execute(sql).rows == plain.rows == jax_r.execute(sql).rows


# ---- twins of the chunked cases of tests/test_sketches.py --------------------------


#: the reference's 4 MiB (lineitem's pruned scan of 481 KB stays
#: resident under it) and a budget under which it streams in 8 chunks
SKETCH_BUDGETS = [4 << 20, 256 << 10]


@pytest.mark.parametrize("budget", SKETCH_BUDGETS)
def test_approx_distinct_chunked(jax_r, budget):
    """Streamed under a budget, the estimate goes through the PARTIAL
    registers and their FINAL merge; it equals the resident estimate
    (register max is associative) and the JAX package's."""
    sql = "select approx_distinct(l_partkey) from lineitem"
    resident = QueryRunner.tpch("tiny", device="cpu").execute(sql).rows
    r = QueryRunner.tpch("tiny", device="cpu")
    r.session.properties["hbm_budget_bytes"] = budget
    assert r.execute(sql).rows == resident == jax_r.execute(sql).rows
    assert spill.ENTRIES["run_chain_streamed"] == int(budget < (1 << 20))


@pytest.mark.parametrize("budget", SKETCH_BUDGETS)
def test_approx_percentile_chunked(jax_r, budget):
    """Chunked, approx_percentile keeps per-chunk summaries: the answer
    lies within the summaries' rank bound of the exact percentile and
    equals the JAX package's answer under the same budget and chunk
    floor."""
    from decimal import Decimal

    from trino_tpu.exec import spill as jax_spill

    sql = "select approx_percentile(l_extendedprice, 0.5) from lineitem"
    data = jax_r.metadata.connector("tpch").data("tiny")
    vals = np.sort(np.asarray(data.column("lineitem", "l_extendedprice")))
    r = QueryRunner.tpch("tiny", device="cpu")
    r.session.properties["hbm_budget_bytes"] = budget
    (got,), = r.execute(sql).rows
    assert spill.ENTRIES["run_chain_streamed"] == int(budget < (1 << 20))
    rank = round(0.5 * (len(vals) - 1))
    eps = 64 * len(vals) // 1024 + 1  # many chunks x per-chunk error
    lo = Decimal(int(vals[max(rank - eps, 0)])).scaleb(-2)
    hi = Decimal(int(vals[min(rank + eps, len(vals) - 1)])).scaleb(-2)
    assert lo <= got <= hi, (got, lo, hi)
    jb = JaxRunner.tpch("tiny")
    jb.session.properties["hbm_budget_bytes"] = budget
    saved = jax_spill.MIN_CHUNK_ROWS
    jax_spill.MIN_CHUNK_ROWS = spill.MIN_CHUNK_ROWS
    try:
        assert jb.execute(sql).rows == [(got,)]
    finally:
        jax_spill.MIN_CHUNK_ROWS = saved


# ---- twins of tests/test_memory_governance.py ---------------------------------------

JOIN_SQL = (
    "select l_returnflag, count(*), sum(l_extendedprice) "
    "from lineitem, orders where l_orderkey = o_orderkey "
    "group by l_returnflag order by 1"
)


def test_per_node_cap_exceeded_raises():
    """A join whose working set can never fit under a tiny per-node cap
    fails with the typed error, not a generic one."""
    r = QueryRunner.tpch("tiny", device="cpu")
    r.session.properties["query_max_memory_per_node"] = "64kB"
    with pytest.raises(ExceededMemoryLimitError, match="per-node"):
        r.execute(JOIN_SQL)
    # nothing stays reserved after the failure
    assert r.executor.memory_pool.reserved_bytes == 0


def test_revocation_degrades_into_spill_tier(jax_r):
    """An over-cap hash join is revoked into the spill tier (the cap
    standing in as the budget) instead of failing: rows equal the
    resident run's and the JAX package's, and the tracked working set
    respects the cap."""
    cap = 2 << 20
    sql = (
        "select count(*) from lineitem l1, lineitem l2 "
        "where l1.l_orderkey = l2.l_orderkey "
        "and l1.l_linenumber = l2.l_linenumber"
    )
    resident = QueryRunner.tpch("tiny", device="cpu").execute(sql)
    r = QueryRunner.tpch("tiny", device="cpu")
    r.session.properties["query_max_memory_per_node"] = str(cap)
    res = r.execute(sql)
    assert res.rows == resident.rows == jax_r.execute(sql).rows
    assert r.executor.memory_revocations >= 1
    assert spill.ENTRIES["revocations"] >= 1
    assert 0 < r.executor.memory_ctx.peak_bytes <= cap
    assert r.executor.tracked_bytes_hwm <= cap
    # the revocation budget never leaks past the revoked subtree
    assert r.executor.hbm_budget() == 0


# ---- the budgeted semi join and the chunked cross join --------------------------------


@pytest.mark.parametrize("name", list(BUDGETED_STATEMENTS))
def test_budgeted_statement_matches_jax_and_sqlite(runner, jax_r, oracle, name):
    """Semi joins (IN, NOT IN, EXISTS; they raised under a budget before
    the tier), a streamed probe join, a chunked cross join, Q1 and the
    sketches' PARTIAL/FINAL under the budget, against the JAX package's
    resident rows and sqlite."""
    sql, entry, tol = BUDGETED_STATEMENTS[name]
    check(runner, jax_r, None if tol is None else oracle, sql,
          abs_tol=tol or 0.0)
    assert spill.ENTRIES[entry] >= 1, spill.ENTRIES


def test_cross_join_chunks_beyond_its_row_limit(jax_r, oracle):
    """Without a budget, ``cross_join_chunk_rows`` alone chunks a cross
    join (it raised before the tier)."""
    r = QueryRunner.tpch("tiny", device="cpu")
    r.session.properties["cross_join_chunk_rows"] = 100
    sql = (
        "select n1.n_regionkey, count(*), sum(n2.n_nationkey) "
        "from nation n1, nation n2 group by 1 order by 1"
    )
    check(r, jax_r, oracle, sql)
    assert spill.ENTRIES["chunked_cross_join"] == 1
