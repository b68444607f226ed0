"""SQL through the port (``trino_tpu_torch``, on the CPU) against the JAX
package and the sqlite oracle, at TPC-H ``tiny``.

Each statement runs through ``trino_tpu.engine.QueryRunner.tpch("tiny")``,
the port's ``QueryRunner.tpch("tiny", device="cpu")`` and sqlite. The
port's rows must equal the JAX package's exactly (decimals, integers,
strings and dates; a DOUBLE to relative 1e-9) and match sqlite within
the oracle's tolerance (sqlite computes decimals in binary floats). The
port's optimized plans for Q1 and Q3 must serialize to the same JSON as
the reference's.

Q18 returns no rows at ``tiny`` (no order there has more than 300
units), so ``q18_250`` runs it with ``having sum(l_quantity) > 250``,
which returns 72 rows. Statements over ``values`` lists have a
hand-written sqlite form (sqlite names ``values`` columns ``column1``,
the engines ``_col0``); statements with FULL or RIGHT joins skip the
sqlite comparison when the oracle's sqlite lacks them.
"""

import json
import math

import pytest

from trino_tpu.connectors.tpch.queries import QUERIES
from trino_tpu.engine import QueryRunner as JaxRunner
from trino_tpu.plan import serde as jax_serde
from trino_tpu.testing.golden import (
    assert_rows_match, load_tpch_sqlite, sqlite_supports, to_sqlite,
)
from trino_tpu_torch.engine import QueryRunner as TorchRunner
from trino_tpu_torch.plan import nodes as torch_nodes
from trino_tpu_torch.plan import serde as torch_serde
from trino_tpu_torch.testing import numpy_reference
from trino_tpu_torch.testing.statements import (
    JOIN_STATEMENTS, SQLITE_FORMS, STRING_STATEMENTS,
)

STATEMENTS = {
    "q01": QUERIES["q01"],
    "q03": QUERIES["q03"],
    "filter_project": (
        "select l_orderkey, l_linenumber, l_extendedprice * (1 - l_discount) "
        "as v from lineitem where l_quantity < 2 "
        "and l_shipdate < date '1992-06-01'"
    ),
    "group_by_nullable": (
        "select case when o_custkey % 3 = 0 then null else o_custkey % 5 end "
        "as k, count(*) as c, sum(o_totalprice) as s from orders group by 1"
    ),
    "decimal_avg": (
        "select o_orderstatus, avg(o_totalprice), min(o_totalprice), "
        "max(o_totalprice), count(*) from orders group by o_orderstatus"
    ),
    "count_star": "select count(*) from lineitem where l_discount > 0.05",
    "order_by_limit": (
        "select c_custkey, c_acctbal from customer "
        "order by c_acctbal desc, c_custkey limit 7"
    ),
    "two_table_join": (
        "select n_name, count(*) as c from customer, nation "
        "where c_nationkey = n_nationkey group by n_name"
    ),
    "empty_result": "select l_orderkey from lineitem where l_quantity > 1000",
    "date_predicate": (
        "select count(*), sum(l_quantity) from lineitem "
        "where l_shipdate between date '1994-01-01' and date '1994-12-31'"
    ),
    "values": "values (1, 'a', 1.5), (2, 'b', 2.5), (3, null, 3.5)",
    "extract_year": (
        "select extract(year from o_orderdate) as y, count(*) as c "
        "from orders group by 1 order by 1"
    ),
    **JOIN_STATEMENTS,
    **STRING_STATEMENTS,
}

#: statements whose sqlite comparison needs FULL/RIGHT OUTER JOIN
NEEDS_FULL_JOIN = {"fj", "right_join"}


@pytest.fixture(scope="module")
def jax_runner():
    return JaxRunner.tpch("tiny")


@pytest.fixture(scope="module")
def torch_runner():
    return TorchRunner.tpch("tiny", device="cpu")


@pytest.fixture(scope="module")
def oracle(jax_runner):
    conn = load_tpch_sqlite(jax_runner.metadata.connector("tpch").data("tiny"))
    # sqlite runs correlated EXISTS as a nested loop: without these
    # indexes Q21 alone takes minutes (answers are unchanged)
    conn.execute("create index lineitem_orderkey on lineitem(l_orderkey)")
    conn.execute("create index lineitem_part_supp on lineitem(l_partkey, l_suppkey)")
    # SQL's LIKE is case-sensitive; sqlite's is not unless asked
    conn.execute("pragma case_sensitive_like = on")
    return conn


def _row_key(row):
    return tuple((v is None, str(v)) for v in row)


def _assert_equal_rows(got, want, ordered):
    if not ordered:
        got, want = sorted(got, key=_row_key), sorted(want, key=_row_key)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert isinstance(a, float) and math.isclose(a, b, rel_tol=1e-9), (g, w)
            else:
                assert type(a) is type(b) and a == b, (g, w)


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_statement_matches_jax_and_sqlite(name, jax_runner, torch_runner, oracle):
    sql = STATEMENTS[name]
    want = jax_runner.execute(sql)
    got = torch_runner.execute(sql)
    assert got.names == want.names
    assert got.ordered == want.ordered
    _assert_equal_rows(got.rows, want.rows, want.ordered)
    if name in NEEDS_FULL_JOIN and not sqlite_supports("full_join"):
        pytest.skip("the oracle's sqlite has no FULL/RIGHT OUTER JOIN")
    expected = oracle.execute(SQLITE_FORMS.get(name) or to_sqlite(sql)).fetchall()
    assert_rows_match(got.rows, expected, ordered=got.ordered, abs_tol=0.006)


def test_q1_q3_row_counts(torch_runner):
    assert len(torch_runner.execute(QUERIES["q01"]).rows) == 4
    assert len(torch_runner.execute(QUERIES["q03"]).rows) == 10


@pytest.mark.parametrize("name", ["q01", "q03"])
def test_optimized_plan_serializes_like_reference(name, jax_runner, torch_runner):
    want = jax_serde.plan_to_json(jax_runner.plan_sql(QUERIES[name]))
    got = torch_serde.plan_to_json(torch_runner.plan_sql(QUERIES[name]))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


#: the TPC-H queries this slice of the port added (string predicates,
#: DISTINCT aggregates, cross joins): also held to the JAX package
NEW_TPCH = ("q02", "q09", "q11", "q13", "q14", "q16", "q20", "q22")

#: row counts of the TPC-H twin at tiny, as tests/test_tpch_queries.py
EXPECTED_ROWS = {"q01": 4, "q06": 1, "q14": 1, "q17": 1}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_tpch_query_on_port(name, jax_runner, torch_runner, oracle):
    """The port's twin of tests/test_tpch_queries.py: all 22 TPC-H
    queries at tiny against sqlite; the queries this slice added also
    against the JAX package."""
    sql = QUERIES[name]
    got = torch_runner.execute(sql)
    expected = oracle.execute(to_sqlite(sql)).fetchall()
    assert_rows_match(got.rows, expected, ordered=got.ordered, abs_tol=0.006)
    if name in EXPECTED_ROWS:
        assert len(got.rows) == EXPECTED_ROWS[name]
    if name in NEW_TPCH:
        want = jax_runner.execute(sql)
        assert got.names == want.names and got.ordered == want.ordered
        _assert_equal_rows(got.rows, want.rows, want.ordered)


REFERENCES = {
    "q01": (QUERIES["q01"], numpy_reference.q01),
    "q02": (QUERIES["q02"], numpy_reference.q02),
    "q03": (QUERIES["q03"], numpy_reference.q03),
    "q04": (QUERIES["q04"], numpy_reference.q04),
    "q09": (QUERIES["q09"], numpy_reference.q09),
    "q11": (QUERIES["q11"], numpy_reference.q11),
    # a FRACTION that keeps a quarter of tiny's parts (TPC-H scales it
    # as 0.0001 / SF; the card runs SF10's)
    "q11_0.005": (
        numpy_reference.q11_sql("0.0050000000"),
        lambda d: numpy_reference.q11(d, "0.0050000000"),
    ),
    "q13": (QUERIES["q13"], numpy_reference.q13),
    "q14": (QUERIES["q14"], numpy_reference.q14),
    "q16": (QUERIES["q16"], numpy_reference.q16),
    "q17": (QUERIES["q17"], numpy_reference.q17),
    "q20": (QUERIES["q20"], numpy_reference.q20),
    "q22": (QUERIES["q22"], numpy_reference.q22),
    "q18_250": (
        numpy_reference.q18_sql(250), lambda d: numpy_reference.q18(d, 250)
    ),
    "q21": (QUERIES["q21"], numpy_reference.q21),
    "fj": (numpy_reference.FJ_SQL, numpy_reference.fj),
}


@pytest.mark.parametrize("name", sorted(REFERENCES))
def test_numpy_reference_matches_sqlite(name, torch_runner, oracle):
    sql, fn = REFERENCES[name]
    data = torch_runner.metadata.connector("tpch").data("tiny")
    rows = fn(data)
    assert rows
    got = torch_runner.execute(sql).rows
    # exact; Q14's and Q17's one DOUBLE (exact decimal sums converted to
    # doubles on both sides) to relative 1e-12; Q11's ties in any order
    # (a variant is compared as its base query)
    assert numpy_reference.rows_match(name.split("_")[0], got, rows)
    if name == "fj" and not sqlite_supports("full_join"):
        pytest.skip("the oracle's sqlite has no FULL OUTER JOIN")
    expected = oracle.execute(to_sqlite(sql)).fetchall()
    assert_rows_match(rows, expected, ordered=True, abs_tol=0.006)


@pytest.mark.parametrize("got,want,match", [
    (1.0, 1.0, True),
    (1.0 + 1e-15, 1.0, True),
    (1.0 + 1e-9, 1.0, False),
    (float("nan"), 1.0, False),
    (1.0, float("nan"), False),
    (float("nan"), float("nan"), False),
    (float("inf"), float("inf"), True),
    (None, 1.0, False),
    (None, None, True),
])
def test_rows_match_doubles(got, want, match):
    """``rows_match`` holds a DOUBLE to relative 1e-12 and matches a NaN
    on neither side."""
    assert numpy_reference.rows_match("q17", [(got,)], [(want,)]) is match


#: tiny's high-NDV strings (names, comments) hash-code above this
HASH_NDV = 1000

HASH_VARCHAR_STATEMENTS = {
    "q18_250": numpy_reference.q18_sql(250),
    "group_count": (
        "select count(*) from (select l_comment, count(*) c "
        "from lineitem group by l_comment) t where c > 1"
    ),
    "group_decode": "select c_comment, count(*) from customer group by c_comment",
    "self_join": (
        "select count(*) from customer c1, customer c2 "
        "where c1.c_comment = c2.c_comment"
    ),
    "semi_join": (
        "select count(*) from customer where c_name in "
        "(select c_name from customer where c_acctbal > 0)"
    ),
    "count_distinct": (
        "select c_mktsegment, count(distinct c_comment), count(*) "
        "from customer group by c_mktsegment"
    ),
    "count_distinct_global": (
        "select count(distinct c_name), count(distinct c_comment) from customer"
    ),
    "left_join": (
        "select count(*), count(c2.c_name) from customer c1 left join "
        "(select c_name from customer where c_acctbal > 5000) c2 "
        "on c1.c_name = c2.c_name"
    ),
    "full_join": (
        "select count(*), count(o_comment), count(c_comment) from "
        "(select o_comment from orders where o_orderkey < 100) o "
        "full join customer on o_comment = c_comment"
    ),
}


@pytest.fixture(scope="module")
def hashed_runners():
    jax_r = JaxRunner.tpch("tiny")
    torch_r = TorchRunner.tpch("tiny", device="cpu")
    for r in (jax_r, torch_r):
        r.session.properties["varchar_hash_ndv"] = HASH_NDV
    return jax_r, torch_r


def _hashed_scan_symbols(plan):
    out, stack = [], [plan]
    while stack:
        n = stack.pop()
        if isinstance(n, torch_nodes.TableScan) and n.hash_varchar:
            out.extend(n.hash_varchar)
        stack.extend(n.sources)
    return out


@pytest.mark.parametrize("name", sorted(HASH_VARCHAR_STATEMENTS))
def test_hash_varchar_matches_jax(name, hashed_runners, oracle):
    """High-NDV VARCHAR columns scan as [hash64, row id] lanes with a
    host string pool (as TPC-H SF10's c_name does in Q18): grouping,
    joins, semi joins and DISTINCT run on the hash lane, output decodes
    through the pool. Held to sqlite too where its sqlite has the join."""
    jax_r, torch_r = hashed_runners
    sql = HASH_VARCHAR_STATEMENTS[name]
    assert _hashed_scan_symbols(torch_r.plan_sql(sql))
    want = jax_r.execute(sql)
    got = torch_r.execute(sql)
    assert got.names == want.names
    _assert_equal_rows(got.rows, want.rows, want.ordered)
    if name != "full_join" or sqlite_supports("full_join"):
        expected = oracle.execute(to_sqlite(sql)).fetchall()
        assert_rows_match(got.rows, expected, ordered=got.ordered, abs_tol=0.006)


def test_chunked_cross_join_raises():
    """A cross join beyond ``cross_join_chunk_rows`` no longer raises (the
    name is this test's history): it chunks the larger side through the
    host spill tier and gives the unchunked answer."""
    from trino_tpu_torch.exec import spill

    runner = TorchRunner.tpch("tiny", device="cpu")
    runner.session.properties["cross_join_chunk_rows"] = 100
    sql = "select count(*) from nation cross join region"  # 125 pairs
    assert runner.execute(sql.replace("nation", "region")).rows == [(25,)]
    spill.reset_entries()
    assert runner.execute(sql).rows == [(125,)]
    assert spill.ENTRIES["chunked_cross_join"] == 1


def test_like_tables_per_dictionary_are_bounded(oracle):
    """LIKE's host tables stay with the scan's dictionary for the
    ``DERIVED_PER_DICTIONARY`` most recent patterns: ad-hoc patterns
    evict the oldest, a repeated one is a hit, and an evicted one is
    built again with the same answer."""
    from trino_tpu_torch.expr import compiler

    patterns = ["%BRASS", "PROMO%", "%TIN", "MEDIUM%", "%STEEL", "LARGE%"]
    sql = "select count(*) from part where p_type like '{}'"
    runner = TorchRunner.tpch("tiny", device="cpu")
    for pat in patterns:
        q = sql.format(pat)
        assert runner.execute(q).rows == oracle.execute(q).fetchall()
    (part,) = [
        cols for key, cols in runner.executor._scan_cache.items()
        if "part" in key
    ]
    derived = part["p_type"].dictionary.derived
    assert [k[1] for k in derived] == patterns[-compiler.DERIVED_PER_DICTIONARY:]
    last = derived[next(reversed(derived))]
    q = sql.format(patterns[-1])
    assert runner.execute(q).rows == oracle.execute(q).fetchall()
    assert derived[next(reversed(derived))] is last
    q = sql.format(patterns[0])
    assert runner.execute(q).rows == oracle.execute(q).fetchall()
    assert len(derived) == compiler.DERIVED_PER_DICTIONARY
    assert next(reversed(derived))[1] == patterns[0]
