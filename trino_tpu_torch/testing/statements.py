"""SQL statements over TPC-H ``tiny`` that exercise the port's semi joins
and outer joins: TPC-H Q4, Q17, Q18 (also with a threshold of 250, since
no ``tiny`` order has more than 300 units), Q21, a full outer join,
LEFT and RIGHT joins with residual conditions, IN / NOT IN with NULLs on
either side and against an empty set, correlated EXISTS / NOT EXISTS
with a non-equi residual and a two-key semi join.

The differential tests (port against the JAX package and sqlite) and
the card tests (cuda against cpu) share them.
"""

from __future__ import annotations

from trino_tpu_torch.connectors.tpch.queries import QUERIES
from trino_tpu_torch.testing.numpy_reference import FJ_SQL, q18_sql

__all__ = ["JOIN_STATEMENTS", "SQLITE_FORMS"]

_IN_PROBE = "select _col0 from (values 1, 3, null) a where _col0 "
_IN_PROBE_SQLITE = (
    "select column1 from (values (1), (3), (null)) a where column1 "
)

JOIN_STATEMENTS = {
    "q04": QUERIES["q04"],
    "q17": QUERIES["q17"],
    "q18": QUERIES["q18"],
    "q18_250": q18_sql(250),
    "q21": QUERIES["q21"],
    "fj": FJ_SQL,
    "left_join_residual": (
        "select c_nationkey, count(*), count(o_orderkey), sum(o_totalprice) "
        "from customer left join orders on c_custkey = o_custkey "
        "and o_totalprice > 100 * c_acctbal group by c_nationkey"
    ),
    "right_join": (
        "select n_name, count(c_custkey), sum(c_acctbal) from customer "
        "right join nation on c_nationkey = n_nationkey "
        "and c_acctbal > 9900 group by n_name"
    ),
    "in_values_build_null": (
        _IN_PROBE + "in (select _col0 from (values 1, 2, null) b)"
    ),
    "not_in_values_build_null": (
        _IN_PROBE + "not in (select _col0 from (values 1, 2, null) b)"
    ),
    "not_in_values_probe_null": (
        _IN_PROBE + "not in (select _col0 from (values 1, 2) b)"
    ),
    "not_in_empty": (
        _IN_PROBE + "not in (select _col0 from (values 1, 2) b where _col0 > 5)"
    ),
    "exists_residual": (
        "select o_orderpriority, count(*) from orders where exists "
        "(select * from lineitem where l_orderkey = o_orderkey "
        "and l_extendedprice > o_totalprice * 0.3) group by o_orderpriority"
    ),
    "not_exists_residual": (
        "select count(*) from orders where not exists "
        "(select * from lineitem where l_orderkey = o_orderkey "
        "and l_extendedprice > o_totalprice * 0.3)"
    ),
    "two_key_semi": (
        "select count(*), sum(ps_availqty) from partsupp where exists "
        "(select * from lineitem where l_partkey = ps_partkey "
        "and l_suppkey = ps_suppkey and l_quantity > 45)"
    ),
}

#: sqlite forms of the statements over ``values`` lists: sqlite names
#: their columns ``column1``, the engines ``_col0``
SQLITE_FORMS = {
    "in_values_build_null": (
        _IN_PROBE_SQLITE + "in (select column1 from (values (1), (2), (null)))"
    ),
    "not_in_values_build_null": (
        _IN_PROBE_SQLITE + "not in (select column1 from (values (1), (2), (null)))"
    ),
    "not_in_values_probe_null": (
        _IN_PROBE_SQLITE + "not in (select column1 from (values (1), (2)))"
    ),
    "not_in_empty": (
        _IN_PROBE_SQLITE
        + "not in (select column1 from (values (1), (2)) where column1 > 5)"
    ),
}
