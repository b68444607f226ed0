"""TPC-H through the port's device mesh (``trino_tpu_torch``, an 8-shard
mesh of the CPU) against sqlite, the port's single-device runner and the
JAX package's mesh runner (its 8-device virtual CPU mesh).

Every statement is distribution-planned (``plan.distribute.add_exchanges``)
and runs on ``exec.mesh.MeshExecutor``: hash and range exchanges through
M1, partial/final aggregation, partitioned and broadcast joins, semi and
cross joins. Rows must match sqlite within its tolerance (0.006: sqlite
computes decimals in binary floats) and equal the single-device runner's.
Q1, Q3, ``q18_250`` and the ``dist_*`` statements of
``tests/test_distributed_queries.py`` must also equal the JAX package's
mesh rows (decimals, integers, strings and dates exactly; a DOUBLE to
relative 1e-9) with the same number of exchanges, the same exchanged
bytes and the same escalations.
"""

import gc
import math

import pytest
import torch

from trino_tpu.connectors.tpch.queries import QUERIES
from trino_tpu.engine import QueryRunner as JaxRunner
from trino_tpu.parallel.core import make_mesh as jax_make_mesh
from trino_tpu.testing.golden import assert_rows_match, load_tpch_sqlite, to_sqlite
from trino_tpu_torch.engine import QueryRunner as TorchRunner
from trino_tpu_torch.parallel import make_mesh
from trino_tpu_torch.testing import numpy_reference

DIST_STATEMENTS = {
    "dist_global_aggregate": (
        "select count(*), sum(l_quantity), min(l_tax), max(l_discount) "
        "from lineitem"
    ),
    "dist_group_by_varchar": (
        "select l_shipmode, count(*), avg(l_extendedprice) from lineitem "
        "group by l_shipmode order by l_shipmode"
    ),
    "dist_distinct_aggregate": (
        "select l_linestatus, count(distinct l_suppkey) from lineitem "
        "group by l_linestatus order by l_linestatus"
    ),
    "dist_variance": (
        "select l_returnflag, stddev(l_quantity), variance(l_discount) "
        "from lineitem group by l_returnflag order by l_returnflag"
    ),
    "dist_partitioned_join": (
        "select count(*), sum(l_extendedprice) from lineitem, orders "
        "where l_orderkey = o_orderkey and o_orderdate < date '1995-01-01'"
    ),
    "dist_broadcast_join": (
        "select n_name, count(*) from customer, nation "
        "where c_nationkey = n_nationkey group by n_name order by n_name"
    ),
    "dist_left_join": (
        "select c_custkey, o_orderkey from customer "
        "left join orders on c_custkey = o_custkey and o_totalprice > 200000 "
        "order by c_custkey, o_orderkey limit 50"
    ),
    "dist_semi_join": (
        "select count(*) from customer where c_custkey in "
        "(select o_custkey from orders where o_totalprice > 100000)"
    ),
    "dist_anti_join": (
        "select count(*) from customer where c_custkey not in "
        "(select o_custkey from orders)"
    ),
    "dist_cross_join_scalar_subquery": (
        "select count(*) from lineitem "
        "where l_quantity > (select avg(l_quantity) from lineitem)"
    ),
    "dist_topn_and_limit": (
        "select o_orderkey, o_totalprice from orders "
        "order by o_totalprice desc limit 10"
    ),
}

JAX_STATEMENTS = {
    "q01": QUERIES["q01"],
    "q03": QUERIES["q03"],
    "q18_250": numpy_reference.q18_sql(250),
    **DIST_STATEMENTS,
}


@pytest.fixture(scope="module", autouse=True)
def _collect_at_module_end():
    """Collect this module's runners (their tables, programs and
    connectors, held in reference cycles) when the module ends, so their
    finalizers run here and not inside a later module's allocations."""
    yield
    gc.collect()


@pytest.fixture(scope="module")
def mesh_runner():
    return TorchRunner.tpch("tiny", mesh=make_mesh(8, device="cpu"))


@pytest.fixture(scope="module")
def local_runner():
    return TorchRunner.tpch("tiny", device="cpu")


@pytest.fixture(scope="module")
def jax_mesh_runner():
    return JaxRunner.tpch("tiny", mesh=jax_make_mesh(8))


@pytest.fixture(scope="module")
def oracle(local_runner):
    conn = load_tpch_sqlite(local_runner.metadata.connector("tpch").data("tiny"))
    # sqlite runs correlated EXISTS as a nested loop: without these
    # indexes Q21 alone takes minutes (answers are unchanged)
    conn.execute("create index lineitem_orderkey on lineitem(l_orderkey)")
    conn.execute("create index lineitem_part_supp on lineitem(l_partkey, l_suppkey)")
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


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_tpch_query_on_mesh(name, mesh_runner, local_runner, oracle):
    sql = QUERIES[name]
    got = mesh_runner.execute(sql)
    want = local_runner.execute(sql)
    assert got.names == want.names
    # in the local runner's order where it has one: a mesh ORDER BY
    # (range exchange, shard sorts, ordered gather) or TopN is ordered
    # too, though the result (as in the JAX package) does not say so
    _assert_equal_rows(got.rows, want.rows, want.ordered)
    expected = oracle.execute(to_sqlite(sql)).fetchall()
    assert_rows_match(got.rows, expected, ordered=want.ordered, abs_tol=0.006)


@pytest.mark.parametrize("name", sorted(JAX_STATEMENTS))
def test_statement_matches_jax_mesh(name, mesh_runner, jax_mesh_runner, oracle):
    sql = JAX_STATEMENTS[name]
    tex, jex = mesh_runner.executor, jax_mesh_runner.executor
    t0 = (dict(tex.exchange_stats), tex.exchange_escalations)
    j0 = (dict(jex.exchange_stats), jex.exchange_escalations)
    want = jax_mesh_runner.execute(sql)
    got = mesh_runner.execute(sql)
    assert got.names == want.names and got.ordered == want.ordered
    _assert_equal_rows(got.rows, want.rows, want.ordered)
    for key in ("exchanges", "bytes"):
        assert (tex.exchange_stats[key] - t0[0][key]
                == jex.exchange_stats[key] - j0[0][key]), key
    assert (tex.exchange_escalations - t0[1]
            == jex.exchange_escalations - j0[1])
    if name != "dist_variance":  # sqlite has no stddev
        expected = oracle.execute(to_sqlite(sql)).fetchall()
        assert_rows_match(got.rows, expected, ordered=got.ordered, abs_tol=0.006)


def test_mesh_plans_exchanges(mesh_runner):
    """The mesh runner distribution-plans: Q3 hash-exchanges its
    aggregation and gathers below the TopN."""
    from trino_tpu_torch.plan import nodes as P

    kinds, stack = [], [mesh_runner.plan_sql(QUERIES["q03"])]
    while stack:
        n = stack.pop()
        if isinstance(n, P.Exchange):
            kinds.append(n.partitioning)
        stack.extend(n.sources)
    assert "hash" in kinds and "single" in kinds


def test_make_mesh_without_device_needs_cuda():
    """``make_mesh(8)`` with no device puts its shards on ``cuda``; with
    CUDA absent it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        mesh = make_mesh(8)
        assert [d.type for d in mesh.devices] == ["cuda"] * 8
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchRunner.tpch("tiny", mesh=make_mesh(8))


def test_mesh_may_repeat_and_list_devices():
    mesh = make_mesh(devices=["cpu", "cpu", "cpu"])
    assert mesh.devices.size == 3 and mesh.shape == {"workers": 3}
    runner = TorchRunner.tpch("tiny", mesh=mesh)
    assert runner.device == torch.device("cpu")
    assert runner.execute("select count(*) from orders").rows == [(15000,)]


SALT_STATEMENTS = {
    "q03": QUERIES["q03"],
    "q01": QUERIES["q01"],
    "partitioned_join": DIST_STATEMENTS["dist_partitioned_join"],
    "semi_join": DIST_STATEMENTS["dist_semi_join"],
    "left_join": DIST_STATEMENTS["dist_left_join"],
}


@pytest.mark.parametrize("name", sorted(SALT_STATEMENTS))
def test_fragment_saltable_matches_jax(name, mesh_runner, jax_mesh_runner):
    """``fragment_saltable`` gives the JAX package's verdict and reason on
    the fragment below each gather of the same distributed plan."""
    from trino_tpu.plan import nodes as JP
    from trino_tpu.plan.distribute import fragment_saltable as jax_saltable
    from trino_tpu_torch.plan import nodes as P
    from trino_tpu_torch.plan.distribute import fragment_saltable

    def fragments(plan, exchange):
        out, stack = [], [plan]
        while stack:
            n = stack.pop()
            if isinstance(n, exchange) and n.partitioning == "single":
                out.append(n.source)
            stack.extend(n.sources)
        return out

    sql = SALT_STATEMENTS[name]
    got = [fragment_saltable(f)
           for f in fragments(mesh_runner.plan_sql(sql), P.Exchange)]
    want = [jax_saltable(f)
            for f in fragments(jax_mesh_runner.plan_sql(sql), JP.Exchange)]
    assert got and got == want
