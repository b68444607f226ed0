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

``WINDOW_STATEMENTS`` exercise set operations (UNION ALL, UNION,
INTERSECT, EXCEPT, chained and nested) and window functions (ranks,
running and partition sums, ROWS frames, lead/lag, first/last/nth
value, running min/max, windows over aggregates, ntile, percent_rank,
cume_dist and RANGE offset frames over integer, decimal and nullable
keys, ascending and descending), and a float window sum whose small
partition sits beside a huge one.

``AGGREGATE_STATEMENTS`` exercise approx_distinct (numeric, dictionary
VARCHAR, grouped, over NULLs and under a FILTER), approx_percentile
(global, grouped, over NULLs, over decimal(38) sums), max_by / min_by
(grouped, global, VARCHAR values), arbitrary / any_value, bool_and /
bool_or and the variance family over integer, double and decimal
arguments; ``AGGREGATE_SQLITE`` holds sqlite forms where sqlite can
compute the same answer.

``SKETCH_CARD`` holds the TPC-DS statements of these functions that the
card runs at SF1 and SF10 (``ds_q39_inv`` at SF1 only), with exact
references in ``numpy_reference``.

``BUDGETED_STATEMENTS`` run under an ``hbm_budget_bytes`` that makes
lineitem stream: semi joins (IN, NOT IN, EXISTS), a chunked cross join,
TPC-H Q1's limb-sum PARTIAL and the sketches' and ``*_by``/variance
PARTIAL/FINAL split (integer variance arguments, whose moments are exact
in float64, so the rows equal the resident ones). Each names the spill
path it must enter and the tolerance of sqlite's answer (None: sqlite
has no such function).

The differential tests (port against the JAX package and sqlite) and
the card tests (cuda against cpu) share them.
"""

from __future__ import annotations

from trino_tpu_torch.connectors.tpch.queries import QUERIES
from trino_tpu_torch.testing.numpy_reference import FJ_SQL, q18_sql

__all__ = [
    "JOIN_STATEMENTS", "STRING_STATEMENTS", "WINDOW_STATEMENTS", "SQLITE_FORMS",
    "AGGREGATE_STATEMENTS", "AGGREGATE_SQLITE", "SKETCH_CARD",
    "BUDGETED_STATEMENTS",
]

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

_FLOAT_ROWS = (
    "(1, 1, 1e18), (1, 2, 1e18), (1, 3, 1e18), "
    "(2, 1, 1.0), (2, 2, 2.0), (2, 3, 3.0)"
)

WINDOW_STATEMENTS = {
    "union_all": (
        "select n_regionkey from nation union all "
        "select r_regionkey from region"
    ),
    "union_distinct": (
        "select n_regionkey from nation union "
        "select r_regionkey + 2 from region order by 1"
    ),
    "union_multi_column_types": (
        "select n_name, n_regionkey from nation union "
        "select r_name, r_regionkey * 1.5 from region"
    ),
    "intersect": (
        "select l_linestatus from lineitem intersect "
        "select o_orderstatus from orders"
    ),
    "except": (
        "select o_orderstatus from orders except "
        "select l_linestatus from lineitem"
    ),
    "chained_setops": (
        "select n_regionkey from nation "
        "union select r_regionkey from region except select 1"
    ),
    "union_in_subquery": (
        "select count(*) from (select n_nationkey k from nation "
        "union all select r_regionkey from region)"
    ),
    "union_with_aggregation_above": (
        "select k, count(*) from (select n_regionkey k from nation "
        "union all select r_regionkey from region) group by k order by k"
    ),
    "row_number": (
        "select o_orderkey, row_number() over "
        "(partition by o_custkey order by o_orderkey) "
        "from orders where o_custkey < 20"
    ),
    "rank_dense_rank": (
        "select c_custkey, rank() over (order by c_nationkey), "
        "dense_rank() over (order by c_nationkey) "
        "from customer where c_custkey <= 50"
    ),
    "running_sum": (
        "select o_orderkey, sum(o_totalprice) over "
        "(partition by o_custkey order by o_orderkey) "
        "from orders where o_custkey < 10"
    ),
    "partition_total": (
        "select o_orderkey, count(*) over (partition by o_custkey), "
        "avg(o_totalprice) over (partition by o_custkey) "
        "from orders where o_custkey < 10"
    ),
    "global_window": "select n_name, sum(n_regionkey) over () from nation",
    "rows_frame": (
        "select o_orderkey, sum(o_shippriority + 1) over "
        "(order by o_orderkey rows between 2 preceding and 1 following) "
        "from orders where o_orderkey < 200"
    ),
    "lead_lag": (
        "select o_orderkey, lag(o_orderkey) over (order by o_orderkey), "
        "lead(o_orderkey, 2) over (order by o_orderkey) "
        "from orders where o_orderkey < 100"
    ),
    "first_last_value": (
        "select o_orderkey, first_value(o_orderkey) over "
        "(partition by o_custkey order by o_orderkey), "
        "last_value(o_orderkey) over (partition by o_custkey "
        "order by o_orderkey "
        "rows between unbounded preceding and unbounded following) "
        "from orders where o_custkey < 10"
    ),
    "min_max_running": (
        "select o_orderkey, "
        "min(o_totalprice) over (partition by o_custkey order by o_orderkey), "
        "max(o_totalprice) over (partition by o_custkey order by o_orderkey) "
        "from orders where o_custkey < 10"
    ),
    "window_over_aggregate": (
        "select o_custkey, count(*) cnt, "
        "rank() over (order by count(*) desc, o_custkey) "
        "from orders where o_custkey < 30 group by o_custkey"
    ),
    "window_in_expression": (
        "select o_orderkey, "
        "o_totalprice - avg(o_totalprice) over (partition by o_custkey) "
        "from orders where o_custkey < 10"
    ),
    "window_varchar_order": (
        "select n_name, row_number() over (order by n_name desc) from nation"
    ),
    "ntile": (
        "select c_custkey, ntile(4) over (order by c_custkey) "
        "from customer where c_custkey <= 20"
    ),
    "percent_rank_cume_dist": (
        "select o_custkey, o_orderkey, "
        "percent_rank() over (partition by o_custkey order by o_totalprice), "
        "cume_dist() over (partition by o_custkey order by o_totalprice) "
        "from orders order by o_orderkey"
    ),
    "percent_rank_single_row_partitions": (
        "select o_orderkey, "
        "percent_rank() over (partition by o_orderkey order by o_totalprice), "
        "cume_dist() over (partition by o_orderkey order by o_totalprice) "
        "from orders order by o_orderkey limit 50"
    ),
    "nth_value": (
        "select o_orderkey, nth_value(o_totalprice, 2) over ("
        "partition by o_custkey order by o_orderdate "
        "rows between unbounded preceding and unbounded following) "
        "from orders order by o_orderkey"
    ),
    "nth_value_default_frame": (
        "select o_orderkey, nth_value(o_orderkey, 3) over ("
        "partition by o_custkey order by o_orderkey) "
        "from orders order by o_orderkey"
    ),
    "range_offset_frame_sum": (
        "select o_orderkey, sum(o_shippriority + 1) over ("
        "partition by o_custkey order by o_orderkey "
        "range between 5 preceding and 5 following), "
        "count(*) over (partition by o_custkey order by o_orderkey "
        "range between 10 preceding and current row) "
        "from orders order by o_orderkey"
    ),
    "range_offset_frame_desc": (
        "select o_orderkey, count(*) over ("
        "partition by o_custkey order by o_orderkey desc "
        "range between 8 preceding and 4 following) "
        "from orders order by o_orderkey"
    ),
    "range_offset_following_only": (
        "select o_orderkey, sum(o_shippriority + 1) over ("
        "partition by o_custkey order by o_orderkey "
        "range between 3 following and 9 following) "
        "from orders order by o_orderkey"
    ),
    "range_offset_decimal_key": (
        "select o_orderkey, count(*) over ("
        "partition by o_custkey order by o_totalprice "
        "range between 10000 preceding and 10000 following) "
        "from orders order by o_orderkey"
    ),
    "range_offset_null_keys": (
        "select o_orderkey, count(*) over (partition by o_custkey "
        "order by nullif(o_shippriority, 0) "
        "range between 1 preceding and 1 following) "
        "from orders order by o_orderkey limit 500"
    ),
    "float_sum_cross_partition": (
        "select _col0, _col1, sum(_col2) over "
        "(partition by _col0 order by _col1) "
        f"from (values {_FLOAT_ROWS}) order by 1, 2"
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
    "float_sum_cross_partition": (
        "select column1, column2, sum(column3) over "
        "(partition by column1 order by column2) "
        f"from (values {_FLOAT_ROWS}) order by 1, 2"
    ),
}


_GV = (
    "(select _col0 g, _col1 v from (values (1, 10), (1, 20), (1, 30), "
    "(1, null), (2, 5), (2, null), (2, 7), (3, null)) t0) t"
)


def _var_sqlite(x: str, pop: bool, root: bool) -> str:
    """A sqlite form of the variance family (sqlite has none)."""
    n = f"count({x})"
    m2 = f"(sum({x} * {x}) - sum({x}) * sum({x}) / {n})"
    v = f"({m2} / ({n}{'' if pop else ' - 1'}))"
    return f"sqrt({v})" if root else v


AGGREGATE_STATEMENTS = {
    "approx_distinct_global": "select approx_distinct(o_custkey) from orders",
    "approx_distinct_varchar": "select approx_distinct(c_name) from customer",
    "approx_distinct_comment": "select approx_distinct(l_comment) from lineitem",
    "approx_distinct_grouped": (
        "select o_orderstatus, approx_distinct(o_custkey) from orders "
        "group by o_orderstatus"
    ),
    "approx_distinct_nulls": f"select g, approx_distinct(v) from {_GV} group by g",
    "approx_distinct_filter": (
        "select approx_distinct(case when o_orderstatus = 'P' then o_custkey end), "
        "approx_distinct(o_clerk) from orders"
    ),
    "approx_distinct_empty": (
        "select approx_distinct(o_custkey) from orders where o_custkey < 0"
    ),
    "max_by_min_by": (
        "select o_custkey, max_by(o_orderkey, o_totalprice), "
        "min_by(o_orderkey, o_totalprice) "
        "from orders where o_custkey < 20 group by o_custkey order by 1"
    ),
    "max_by_varchar_global": (
        "select max_by(n_name, n_nationkey), min_by(n_name, n_nationkey) "
        "from nation"
    ),
    "max_by_ties_and_nulls": (
        "select l_returnflag, max_by(l_orderkey, l_quantity), "
        "min_by(l_orderkey, l_quantity), max_by(l_comment, l_discount), "
        "min_by(nullif(l_linenumber, 1), l_tax) from lineitem "
        "group by l_returnflag order by 1"
    ),
    "max_by_double_key": (
        "select o_orderpriority, max_by(o_orderkey, o_totalprice * 1e0), "
        "min_by(o_orderkey, o_totalprice * -1e0) from orders "
        "group by o_orderpriority order by 1"
    ),
    "approx_percentile_global": (
        "select approx_percentile(l_quantity, 0.5) from lineitem"
    ),
    "approx_percentile_grouped": (
        "select l_linenumber, approx_percentile(l_quantity, 0.9) "
        "from lineitem group by l_linenumber order by 1"
    ),
    "approx_percentile_nulls": (
        f"select g, approx_percentile(v, 0.5) from {_GV} group by g order by 1"
    ),
    "approx_percentile_wide_decimal": (
        "select approx_percentile(s, 0.5) from "
        "(select o_custkey, sum(o_totalprice) s from orders group by o_custkey)"
    ),
    "approx_percentile_double": (
        "select o_orderstatus, approx_percentile(o_totalprice * 1e0, 0.25), "
        "approx_percentile(o_totalprice * 1e0, 1.0) from orders "
        "group by o_orderstatus order by 1"
    ),
    "arbitrary_any_value": (
        "select o_orderstatus, arbitrary(o_orderkey), any_value(o_clerk), "
        "count(*) from orders group by o_orderstatus order by 1"
    ),
    "arbitrary_nulls": f"select g, arbitrary(v) from {_GV} group by g order by 1",
    "bool_and_or": (
        "select o_orderstatus, bool_and(o_totalprice > 1000), "
        "bool_or(o_totalprice > 400000) from orders "
        "group by o_orderstatus order by 1"
    ),
    "bool_and_or_global": (
        "select bool_and(l_quantity > 0), bool_or(l_quantity > 50), "
        "bool_and(l_quantity > 1) from lineitem"
    ),
    "variance_int": (
        "select o_orderstatus, stddev(o_custkey), stddev_samp(o_custkey), "
        "stddev_pop(o_custkey), variance(o_custkey), var_samp(o_custkey), "
        "var_pop(o_custkey) from orders group by o_orderstatus order by 1"
    ),
    "variance_double": (
        "select l_returnflag, stddev_samp(l_extendedprice * 1e0), "
        "var_pop(l_extendedprice * 1e0) from lineitem "
        "group by l_returnflag order by 1"
    ),
    "variance_decimal": (
        "select l_linestatus, stddev_samp(l_extendedprice), "
        "var_samp(l_discount), stddev_pop(l_tax) from lineitem "
        "group by l_linestatus order by 1"
    ),
    "variance_global_and_small": (
        "select var_samp(v), stddev_pop(v), var_pop(v), stddev_samp(g) "
        f"from {_GV} where g = 2"
    ),
    "variance_single_row_groups": (
        f"select g, var_samp(v), var_pop(v), stddev(v) from {_GV} "
        "group by g order by 1"
    ),
}

#: sqlite forms of the statements that sqlite can answer (no HLL, no
#: percentiles: those are held to the JAX package's rows and exact counts)
AGGREGATE_SQLITE = {
    "max_by_min_by": (
        "select o_custkey, "
        "(select o2.o_orderkey from orders o2 where o2.o_custkey = o.o_custkey"
        "  order by o2.o_totalprice desc limit 1), "
        "(select o3.o_orderkey from orders o3 where o3.o_custkey = o.o_custkey"
        "  order by o3.o_totalprice asc limit 1) "
        "from orders o where o_custkey < 20 group by o_custkey order by 1"
    ),
    "max_by_varchar_global": (
        "select (select n_name from nation order by n_nationkey desc limit 1), "
        "(select n_name from nation order by n_nationkey limit 1)"
    ),
    "bool_and_or": (
        "select o_orderstatus, min(o_totalprice > 1000), "
        "max(o_totalprice > 400000) from orders "
        "group by o_orderstatus order by 1"
    ),
    "bool_and_or_global": (
        "select min(l_quantity > 0), max(l_quantity > 50), "
        "min(l_quantity > 1) from lineitem"
    ),
    "variance_int": (
        "select o_orderstatus, "
        + ", ".join(
            _var_sqlite("(o_custkey * 1.0)", pop, root)
            for pop, root in ((False, True), (False, True), (True, True),
                              (False, False), (False, False), (True, False))
        )
        + " from orders group by o_orderstatus order by 1"
    ),
    "variance_double": (
        "select l_returnflag, "
        + _var_sqlite("l_extendedprice", False, True) + ", "
        + _var_sqlite("l_extendedprice", True, False)
        + " from lineitem group by l_returnflag order by 1"
    ),
    "variance_decimal": (
        "select l_linestatus, "
        + _var_sqlite("l_extendedprice", False, True) + ", "
        + _var_sqlite("l_discount", False, False) + ", "
        + _var_sqlite("l_tax", True, True)
        + " from lineitem group by l_linestatus order by 1"
    ),
    "approx_distinct_empty": "select 0",
    "arbitrary_nulls": (
        "select column1, (select t2.column2 from (values (1, 10), (1, 20), "
        "(1, 30), (1, null), (2, 5), (2, null), (2, 7), (3, null)) t2 "
        "where t2.column1 = t.column1 and t2.column2 is not null limit 1) "
        "from (values (1, 0), (2, 0), (3, 0)) t order by 1"
    ),
}

#: the card's statements of the aggregate functions over TPC-DS
SKETCH_CARD = {
    "ds_sketch_item": """select ss_item_sk, count(*), approx_distinct(ss_customer_sk),
       approx_percentile(ss_net_paid, 0.5),
       max_by(ss_ticket_number, ss_net_paid),
       min_by(ss_ticket_number, ss_net_paid),
       arbitrary(ss_store_sk), bool_or(ss_quantity > 95),
       stddev_samp(ss_quantity), var_pop(ss_quantity)
from store_sales group by ss_item_sk order by ss_item_sk""",
    "ds_sketch_global": """select approx_distinct(ss_customer_sk), approx_distinct(i_brand),
       approx_percentile(ss_sales_price, 0.9),
       max_by(i_item_id, ss_net_profit), min_by(i_item_id, ss_net_profit),
       stddev_pop(ss_quantity), bool_and(ss_quantity > 0)
from store_sales, item where ss_item_sk = i_item_sk""",
    "ds_q17_store": """select i_item_id, s_state,
       count(ss_quantity), avg(ss_quantity), stddev_samp(ss_quantity),
       count(sr_return_quantity), avg(sr_return_quantity),
       stddev_samp(sr_return_quantity)
from store_sales, store_returns, date_dim d1, date_dim d2, store, item
where d1.d_quarter_name = '2001Q1' and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk
  and d2.d_quarter_name in ('2001Q1', '2001Q2', '2001Q3')
group by i_item_id, s_state
order by i_item_id, s_state""",
    "ds_q39_inv": """select count(*), count(stdev), sum(stdev), sum(mean)
from (select w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy,
             stddev_samp(inv_quantity_on_hand) stdev,
             avg(inv_quantity_on_hand) mean
      from inventory, item, warehouse, date_dim
      where inv_item_sk = i_item_sk and inv_warehouse_sk = w_warehouse_sk
        and inv_date_sk = d_date_sk and d_year = 2001
      group by w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy) foo""",
}

#: name -> (sql, spill path entered, sqlite's tolerance or None)
BUDGETED_STATEMENTS = {
    "in_semi": (
        "select count(*), sum(l_quantity) from lineitem where l_orderkey in "
        "(select o_orderkey from orders where o_totalprice > 300000)",
        "streamed_semi_join", 1e-9,
    ),
    "not_in_semi": (
        "select count(*), sum(l_quantity) from lineitem where l_suppkey "
        "not in (select s_suppkey from supplier where s_acctbal > 5000)",
        "streamed_semi_join", 1e-9,
    ),
    "exists_semi": (
        "select count(*), sum(l_extendedprice) from lineitem where exists "
        "(select * from supplier where s_suppkey = l_suppkey "
        "and s_acctbal > 5000)",
        "streamed_semi_join", 1e-9,
    ),
    "probe_join": (
        "select o_orderpriority, count(*), sum(l_quantity) from lineitem, "
        "orders where l_orderkey = o_orderkey "
        "and o_orderdate < date '1993-01-01' group by 1 order by 1",
        "streamed_probe_join", 1e-9,
    ),
    "cross_budget": (
        "select count(*), sum(l_quantity * r_regionkey) from lineitem, region",
        "chunked_cross_join", 1e-9,
    ),
    # avg of a decimal rounds to its scale; sqlite's is a binary float
    "q01": (QUERIES["q01"], "run_chain_streamed", 0.01),
    "sketch_grouped": (
        "select l_returnflag, count(*), approx_distinct(l_partkey), "
        "approx_distinct(l_shipmode), max_by(l_orderkey, l_extendedprice), "
        "min_by(l_orderkey, l_extendedprice), arbitrary(l_linestatus), "
        "bool_or(l_quantity > 49), bool_and(l_quantity > 0), "
        "stddev_samp(l_linenumber), var_pop(l_suppkey) "
        "from lineitem group by l_returnflag order by 1",
        "run_chain_streamed", None,
    ),
    "sketch_global": (
        "select approx_distinct(l_comment), approx_distinct(l_orderkey), "
        "max_by(l_orderkey, l_extendedprice), variance(l_linenumber), "
        "count(*) from lineitem",
        "run_chain_streamed", None,
    ),
}
