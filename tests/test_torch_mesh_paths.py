"""The port's mesh paths beyond plain TPC-H — twins of the JAX package's
mesh tests, on an 8-shard mesh of the CPU, against sqlite or an exact
host oracle and against the JAX package's mesh runner on the same
statements (rows, exchange counts and escalations):

- ``test_distributed_sort.py``: ORDER BY through a range exchange, with
  NULLs, VARCHAR and a skewed first key;
- ``test_dynamic_filter.py``: exact-membership dynamic filtering before
  the exchange, and an empty build side;
- ``test_grouping_sets.py``: ROLLUP on the mesh (GroupId per shard);
- ``test_failure_injection.py``: chain, exchange and join stage retries,
  exhausted retries;
- ``test_parallel.py::test_skew_join_hot_key`` and ``test_skew.py``: a
  90%-one-key probe takes the skew split, skewed DISTINCT, max_by and
  semi joins never escalate. Their tables are made through the memory
  connector's API (the port has no DDL yet) from the same numpy arrays
  in both packages;
- the distributed TPC-DS smoke set of ``test_tpcds_queries.py``.
"""

import collections
import gc

import numpy as np
import pytest

from trino_tpu.connectors.memory import MemoryConnector as JaxMemory
from trino_tpu.engine import QueryRunner as JaxRunner
from trino_tpu.metadata import Metadata as JaxMetadata, Session as JaxSession
from trino_tpu.parallel.core import make_mesh as jax_make_mesh
from trino_tpu.testing.golden import (
    assert_rows_match, load_tpcds_sqlite, load_tpch_sqlite, to_sqlite,
)
from trino_tpu import types as JT
from trino_tpu.connectors.base import TableSchema as JaxTableSchema
from trino_tpu_torch import types as T
from trino_tpu_torch.connectors.base import TableSchema
from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.connectors.tpcds.queries import QUERIES as DS_QUERIES, SQLITE_ORACLE
from trino_tpu_torch.engine import QueryRunner
from trino_tpu_torch.exec.failure import InjectedFailure
from trino_tpu_torch.exec.local import LocalExecutor
from trino_tpu_torch.metadata import Metadata, Session
from trino_tpu_torch.parallel import make_mesh
from trino_tpu_torch.plan import nodes as P


@pytest.fixture(scope="module", autouse=True)
def _collect_at_module_end():
    """Collect this module's runners (their tables, programs and
    connectors, held in reference cycles) when the module ends, so their
    finalizers run here and not inside a later module's allocations."""
    yield
    gc.collect()


def _mesh():
    return make_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def runner():
    return QueryRunner.tpch("tiny", mesh=_mesh())


@pytest.fixture(scope="module")
def jax_runner():
    return JaxRunner.tpch("tiny", mesh=jax_make_mesh(8))


@pytest.fixture(scope="module")
def oracle(runner):
    return load_tpch_sqlite(runner.metadata.connector("tpch").data("tiny"))


def check(r, oracle, sql, oracle_sql=None, abs_tol=1e-9, ordered=None):
    result = r.execute(sql)
    expected = oracle.execute(to_sqlite(oracle_sql or sql)).fetchall()
    assert_rows_match(
        result.rows, expected,
        ordered=result.ordered if ordered is None else ordered, abs_tol=abs_tol,
    )
    return result


def same_as_jax(r, jr, sql):
    """Rows, exchange count and escalations equal to the JAX mesh's."""
    before = (r.executor.exchange_stats["exchanges"], r.executor.exchange_escalations)
    jbefore = (jr.executor.exchange_stats["exchanges"], jr.executor.exchange_escalations)
    got, want = r.execute(sql).rows, jr.execute(sql).rows
    assert sorted(map(repr, got)) == sorted(map(repr, want))
    after = (r.executor.exchange_stats["exchanges"], r.executor.exchange_escalations)
    jafter = (jr.executor.exchange_stats["exchanges"], jr.executor.exchange_escalations)
    assert [a - b for a, b in zip(after, before)] == [
        a - b for a, b in zip(jafter, jbefore)]
    return got


def _exchanges(plan):
    out, stack = [], [plan]
    while stack:
        n = stack.pop()
        if isinstance(n, P.Exchange):
            out.append(n)
        stack.extend(n.sources)
    return out


# ---- distributed ORDER BY (test_distributed_sort.py:59-106) ---------------

SORT_SQL = {
    "full_table": (
        "select l_orderkey, l_linenumber, l_extendedprice from lineitem "
        "order by l_extendedprice desc, l_orderkey, l_linenumber"
    ),
    "varchar_desc": "select c_name, c_acctbal from customer order by c_name desc",
    "nulls_first": (
        "select o_orderkey, o_comment from orders "
        "order by o_comment asc nulls first, o_orderkey limit 500"
    ),
    "skewed_key": (
        "select l_linenumber, l_orderkey from lineitem "
        "order by case when l_linenumber > 1 then 0 else l_linenumber end, "
        "l_orderkey limit 2000"
    ),
}


def test_order_by_plans_range_exchange(runner):
    plan = runner.plan_sql(
        "select l_orderkey, l_extendedprice from lineitem "
        "order by l_extendedprice desc")
    kinds = [e.partitioning for e in _exchanges(plan)]
    assert "range" in kinds, kinds
    assert any(e.ordered for e in _exchanges(plan) if e.partitioning == "single")


@pytest.mark.parametrize("name", sorted(SORT_SQL))
def test_distributed_order_by(name, runner, jax_runner, oracle):
    sql = SORT_SQL[name]
    check(runner, oracle, sql, ordered=True)
    same_as_jax(runner, jax_runner, sql)


# ---- dynamic filtering (test_dynamic_filter.py:69, :85) -------------------

@pytest.fixture()
def df_runner(monkeypatch):
    monkeypatch.setattr(LocalExecutor, "DF_MIN_PROBE", 1024)
    return QueryRunner.tpch("tiny", mesh=_mesh())


def test_mesh_membership_prunes_before_exchange(df_runner, oracle):
    sql = (
        "select o_orderpriority, count(*) from lineitem, orders "
        "where l_orderkey = o_orderkey and o_orderdate >= date '1997-01-01' "
        "group by o_orderpriority"
    )
    check(df_runner, oracle, sql)
    log = df_runner.executor.df_log
    assert log, "mesh dynamic filter did not run"
    # ~2/7 of orders fall in 1997+; membership must reflect that drop
    assert log[-1]["rows_kept"] < 0.6 * log[-1]["rows_in"]


def test_mesh_df_correct_when_filter_empty(df_runner, oracle):
    check(df_runner, oracle,
          "select count(*) from lineitem, orders "
          "where l_orderkey = o_orderkey and o_totalprice < 0")


# ---- grouping sets (test_grouping_sets.py) ---------------------------------

ROLLUP_SQL = (
    "select l_returnflag, l_linestatus, sum(l_quantity), count(*) "
    "from lineitem group by rollup(l_returnflag, l_linestatus)"
)
ROLLUP_ORACLE = (
    "select l_returnflag, l_linestatus, sum(l_quantity), count(*) "
    "from lineitem group by l_returnflag, l_linestatus "
    "union all "
    "select l_returnflag, null, sum(l_quantity), count(*) "
    "from lineitem group by l_returnflag "
    "union all "
    "select null, null, sum(l_quantity), count(*) from lineitem"
)


def test_rollup_distributed(runner, jax_runner, oracle):
    check(runner, oracle, ROLLUP_SQL, ROLLUP_ORACLE, abs_tol=0.006)
    same_as_jax(runner, jax_runner, ROLLUP_SQL)


# ---- failure injection (test_failure_injection.py) -------------------------

AGG_SQL = (
    "select l_returnflag, count(*), sum(l_quantity) from lineitem "
    "group by l_returnflag"
)
JOIN_SQL = (
    "select c_mktsegment, count(*) from orders o, customer c "
    "where o.o_custkey = c.c_custkey group by c_mktsegment"
)


@pytest.fixture()
def injector(runner):
    inj = runner.executor.failure_injector
    yield inj
    inj.reset()


def test_chain_stage_retry(runner, oracle, injector):
    injector.fail_stage("chain", times=1)
    check(runner, oracle, AGG_SQL, ordered=False)
    assert any(tag.startswith("chain") for tag, _ in injector.injected)
    assert any(a == 1 for _tag, a in injector.attempts)


def test_exchange_stage_retry(runner, oracle, injector):
    injector.fail_stage("exchange", times=2)
    check(runner, oracle, AGG_SQL, ordered=False)
    assert ("exchange", 0) in injector.injected
    assert ("exchange", 1) in injector.injected


def test_join_stage_retry(runner, oracle, injector):
    injector.fail_stage("join-count", times=1)
    injector.fail_stage("join-expand", times=1)
    check(runner, oracle, JOIN_SQL, ordered=False)
    assert any(t.startswith("join-") for t, _ in injector.injected)


def test_exhausted_retries_fail_query(runner, injector):
    injector.fail_stage("chain", times=injector.max_attempts)
    with pytest.raises(InjectedFailure):
        runner.execute(AGG_SQL)
    injector.reset()
    assert runner.execute("select count(*) from nation").rows == [(25,)]


# ---- skew (test_parallel.py:105, test_skew.py) -----------------------------

def _memory_pair(tables):
    """A port mesh runner and a JAX mesh runner over memory catalogs that
    hold the same tables: name -> ([(column, type name)], {column: array})."""
    md, jmd = Metadata(), JaxMetadata()
    md.register_catalog("memory", MemoryConnector())
    jmd.register_catalog("memory", JaxMemory())
    for name, (cols, data) in tables.items():
        md.connector("memory").create_table("default", name, TableSchema(
            name, [(c, getattr(T, t)) for c, t in cols]))
        md.connector("memory").insert("default", name, data)
        jmd.connector("memory").create_table("default", name, JaxTableSchema(
            name, [(c, getattr(JT, t)) for c, t in cols]))
        jmd.connector("memory").insert("default", name, data)
    r = QueryRunner(md, Session(catalog="memory", schema="default"), mesh=_mesh())
    jr = JaxRunner(jmd, JaxSession(catalog="memory", schema="default"),
                   mesh=jax_make_mesh(8))
    return r, jr


def test_skew_join_hot_key():
    """A 90%-one-key probe side joins exactly on the mesh through the skew
    split: the hot destination's build rows broadcast and its probe rows
    salt round-robin, instead of escalating one bucket to shard capacity."""
    n = 100_000
    rng = np.random.default_rng(5)
    keys = np.where(rng.random(n) < 0.9, 7, rng.integers(0, 1000, n))
    r, jr = _memory_pair({
        "probe": ([("k", "BIGINT"), ("v", "BIGINT")],
                  {"k": keys.astype(np.int64), "v": np.arange(n, dtype=np.int64)}),
        "build": ([("k", "BIGINT"), ("w", "BIGINT")],
                  {"k": np.arange(1000, dtype=np.int64),
                   "w": np.arange(1000, dtype=np.int64) * 10}),
    })
    for x in (r, jr):
        x.session.properties["join_distribution_type"] = "PARTITIONED"
    sql = "select count(*), sum(w) from probe, build where probe.k = build.k"
    assert same_as_jax(r, jr, sql) == [(n, int(np.sum(keys * 10)))]
    assert r.executor.skew_joins >= 1
    assert r.executor.skew_joins == jr.executor.skew_joins


@pytest.fixture(scope="module")
def skewed():
    rng = np.random.default_rng(11)
    n = 40_000
    g = np.where(rng.random(n) < 0.9, 7, rng.integers(0, 50, n))
    v = rng.integers(0, 5_000, n)
    w = np.array(["w%03d" % x for x in rng.integers(0, 300, n)], dtype=object)
    r, jr = _memory_pair({"skewed": (
        [("g", "BIGINT"), ("v", "BIGINT"), ("w", "VARCHAR")],
        {"g": g.astype(np.int64), "v": v.astype(np.int64), "w": w},
    )})
    return r, jr, g, v, w


def test_skewed_distinct_group_by(skewed):
    r, jr, g, v, _ = skewed
    r.executor.exchange_escalations = 0
    rows = dict(same_as_jax(r, jr, "select g, count(distinct v) from skewed group by g"))
    exact = collections.defaultdict(set)
    for gi, vi in zip(g, v):
        exact[int(gi)].add(int(vi))
    assert rows == {k: len(s) for k, s in exact.items()}
    assert r.executor.exchange_escalations == 0


def test_skewed_distinct_varchar(skewed):
    r, jr, g, _, w = skewed
    r.executor.exchange_escalations = 0
    rows = dict(same_as_jax(r, jr, "select g, count(distinct w) from skewed group by g"))
    exact = collections.defaultdict(set)
    for gi, wi in zip(g, w):
        exact[int(gi)].add(str(wi))
    assert rows == {k: len(s) for k, s in exact.items()}
    assert r.executor.exchange_escalations == 0


def test_skewed_max_by_group_by(skewed):
    r, jr, g, v, w = skewed
    r.executor.exchange_escalations = 0
    rows = dict(r.execute("select g, max_by(w, v) from skewed group by g").rows)
    for k, got in rows.items():
        sel = g == k
        vmax = v[sel].max()
        assert got in {str(x) for x in w[sel & (v == vmax)]}, (k, got)
    assert r.executor.exchange_escalations == 0


def test_skewed_semi_join(skewed):
    r, jr, g, v, _ = skewed
    r.executor.exchange_escalations = 0
    ((cnt,),) = same_as_jax(
        r, jr, "select count(*) from skewed where v in "
               "(select v from skewed where g = 7 and v < 100)")
    member = {int(vi) for gi, vi in zip(g, v) if gi == 7 and vi < 100}
    assert cnt == sum(1 for vi in v if int(vi) in member)
    assert r.executor.exchange_escalations == 0


def test_two_level_distinct_plan_shape(skewed):
    r = skewed[0]
    plan = r.plan_sql("select g, count(distinct v) from skewed group by g")
    hashed = [tuple(e.hash_symbols) for e in _exchanges(plan)
              if e.partitioning == "hash"]
    assert len(hashed) == 2, hashed
    assert sorted(len(h) for h in hashed) == [1, 2]


# ---- TPC-DS on the mesh (test_tpcds_queries.py:35) -------------------------

SMOKE_DISTRIBUTED = ("q3", "q25", "q42", "q52", "q55", "q68", "q95")


@pytest.fixture(scope="module")
def ds_runner():
    return QueryRunner.tpcds("tiny", mesh=_mesh())


@pytest.fixture(scope="module")
def ds_oracle(ds_runner):
    return load_tpcds_sqlite(ds_runner.metadata.connector("tpcds").data("tiny"))


@pytest.mark.parametrize("qid", SMOKE_DISTRIBUTED)
def test_tpcds_distributed(qid, ds_runner, ds_oracle):
    result = ds_runner.execute(DS_QUERIES[qid])
    expected = ds_oracle.execute(
        to_sqlite(SQLITE_ORACLE.get(qid, DS_QUERIES[qid]))).fetchall()
    # abs 0.02, as tests/test_tpcds_queries.py: decimal avg/div round to
    # the type's scale; sqlite keeps float precision
    assert_rows_match(result.rows, expected, ordered=result.ordered, abs_tol=0.02)
