"""SQL statements over TPC-H ``tiny`` that exercise the port's semi joins
and outer joins (``JOIN_STATEMENTS``): TPC-H Q4, Q17, Q18 (also with a
threshold of 250, since no ``tiny`` order has more than 300 units), Q21,
a full outer join, LEFT and RIGHT joins with residual conditions, IN /
NOT IN with NULLs on either side and against an empty set, correlated
EXISTS / NOT EXISTS with a non-equi residual and a two-key semi join.

``STRING_STATEMENTS`` exercise string predicates and transforms (LIKE,
NOT LIKE with ``_`` and ``%``, ``regexp_like``, ``substr``, ``lower``,
``upper``, ``trim``, ``replace``, ``||`` with a literal,
``regexp_replace``, ``regexp_extract``), ``count(DISTINCT)`` grouped,
global, over NULLs and under a NULL-literal GROUP BY key, and cross
joins against a scalar subquery.

The differential tests (port against the JAX package and sqlite) and
the card tests (cuda against cpu) share them.
"""

from __future__ import annotations

from trino_tpu_torch.connectors.tpch.queries import QUERIES
from trino_tpu_torch.testing.numpy_reference import FJ_SQL, q18_sql

__all__ = ["JOIN_STATEMENTS", "STRING_STATEMENTS", "SQLITE_FORMS"]

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

STRING_STATEMENTS = {
    "like_contains": (
        "select count(*), sum(p_retailprice) from part where p_name like '%green%'"
    ),
    "like_underscore": (
        "select count(*) from customer where c_phone like '1_-1%'"
    ),
    "not_like_group": (
        "select p_type, count(*) from part "
        "where p_type not like 'MEDIUM POLISHED%' and p_size < 4 group by p_type"
    ),
    "like_in_case": (
        "select sum(case when p_type like 'PROMO%' then p_size else 0 end), "
        "count(*) from part"
    ),
    "regexp_like": (
        "select count(*) from part where regexp_like(p_name, '^(green|red) ')"
    ),
    "substr_group": (
        "select substr(c_phone, 1, 2) as cc, count(*) as n, sum(c_acctbal) "
        "from customer group by substr(c_phone, 1, 2)"
    ),
    "transforms": (
        "select lower(n_name), upper(r_name), trim(' ' || n_name || ' '), "
        "replace(n_name, 'A', 'a'), n_name || '!', substr(n_comment, 3, 5) "
        "from nation, region where n_regionkey = r_regionkey"
    ),
    "regexp_transforms": (
        "select regexp_replace(n_name, 'A', 'a'), "
        "regexp_extract(n_name, '^[A-Z]+') from nation"
    ),
    "count_distinct_grouped": (
        "select o_orderstatus, count(distinct o_custkey), count(*) "
        "from orders group by o_orderstatus"
    ),
    "count_distinct_global": (
        "select count(distinct l_suppkey), count(distinct l_partkey), "
        "sum(l_quantity) from lineitem"
    ),
    "count_distinct_nulls": (
        "select o_orderpriority, count(distinct case when o_custkey % 3 = 0 "
        "then null else o_custkey % 7 end) from orders group by o_orderpriority"
    ),
    "count_distinct_string": (
        "select p_size, count(distinct p_brand), count(distinct p_container) "
        "from part where p_size < 6 group by p_size"
    ),
    "group_null_literal": (
        "select k, count(*), count(distinct n_regionkey) from "
        "(select cast(null as bigint) as k, n_regionkey from nation) t "
        "group by k"
    ),
    "cross_scalar": (
        "select count(*), sum(c_acctbal) from customer "
        "where c_acctbal > (select avg(c_acctbal) from customer where c_acctbal > 0)"
    ),
    "cross_scalar_grouped": (
        "select n_name, count(*) from supplier, nation "
        "where s_nationkey = n_nationkey and s_acctbal > "
        "(select avg(s_acctbal) + 1000 from supplier) group by n_name"
    ),
}

#: sqlite forms of the statements over ``values`` lists (sqlite names
#: their columns ``column1``, the engines ``_col0``) and of the string
#: functions sqlite lacks
SQLITE_FORMS = {
    "regexp_like": (
        "select count(*) from part where p_name like 'green %' "
        "or p_name like 'red %'"
    ),
    "regexp_transforms": (
        "select replace(n_name, 'A', 'a'), "
        "case when instr(n_name, ' ') > 0 "
        "then substr(n_name, 1, instr(n_name, ' ') - 1) else n_name end "
        "from nation"
    ),
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
