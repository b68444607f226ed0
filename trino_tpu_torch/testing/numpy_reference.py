"""Exact numpy implementations of TPC-H Q1, Q3, Q4, Q17, Q18 and Q21,
and of one full outer join (``FJ_SQL``).

An independent check of the engine's answers: the same generated data
(``connectors.tpch.generator.TpchData``: dates as epoch days, decimals
as unscaled int64) computed with plain numpy, returning the result rows
in the form ``QueryRunner.execute`` gives them (strings, ``Decimal`` at
the SQL scale, ints, ISO dates). Decimal sums are exact: each int64
column is summed as two 32-bit limbs and recombined in Python integers;
averages round half away from zero, as the engine's decimal avg does.
Q17's one DOUBLE output is the exact decimal sum converted to a double
and divided by 7.0; the engine casts the two-limb sum the same way, so
the two agree to a few ulps (compare to relative 1e-12).
"""

from __future__ import annotations

from decimal import Decimal

import numpy as np

from trino_tpu_torch import types as T

__all__ = ["q01", "q03", "q04", "q17", "q18", "q21", "fj", "FJ_SQL", "q18_sql"]

#: a full outer join with unmatched rows on both sides (no TPC-H query
#: has one): 1992 orders against customers with a large balance
FJ_SQL = """select count(*), count(o_orderkey), count(c_custkey) from
  (select o_orderkey, o_custkey from orders where o_orderdate < date '1993-01-01') o
  full outer join (select c_custkey from customer where c_acctbal > 5000) c
  on o_custkey = c_custkey"""


def q18_sql(threshold: int = 300) -> str:
    """TPC-H Q18 with its HAVING threshold on sum(l_quantity)."""
    from trino_tpu_torch.connectors.tpch.queries import QUERIES

    sql = QUERIES["q18"]
    if "> 300" not in sql:
        raise ValueError("Q18 text has no '> 300' threshold")
    return sql.replace("> 300", f"> {int(threshold)}")


def _exact_sum(x: np.ndarray) -> int:
    """Exact sum of an int64 array (no wraparound)."""
    x = np.asarray(x, dtype=np.int64)
    hi = int(np.sum(x >> 32, dtype=np.int64))
    lo = int(np.sum(x & 0xFFFFFFFF, dtype=np.int64))
    return hi * (1 << 32) + lo


def _div_half_away(num: int, den: int) -> int:
    q, r = divmod(abs(num), den)
    if 2 * r >= den:
        q += 1
    return q if num >= 0 else -q


def _dec(unscaled: int, scale: int) -> Decimal:
    return Decimal(unscaled).scaleb(-scale)


def q01(data) -> list[tuple]:
    """TPC-H Q1 rows, ordered by (l_returnflag, l_linestatus)."""
    ship = data.column("lineitem", "l_shipdate")
    keep = ship <= T.parse_date("1998-09-02")
    rf = np.asarray(data.column("lineitem", "l_returnflag")[keep]).astype(str)
    ls = np.asarray(data.column("lineitem", "l_linestatus")[keep]).astype(str)
    qty = data.column("lineitem", "l_quantity")[keep]
    price = data.column("lineitem", "l_extendedprice")[keep]
    disc = data.column("lineitem", "l_discount")[keep]
    tax = data.column("lineitem", "l_tax")[keep]
    disc_price = price * (100 - disc)  # scale 4
    charge = disc_price * (100 + tax)  # scale 6
    rows = []
    for f in np.unique(rf):
        in_f = rf == f
        for s in np.unique(ls[in_f]):
            g = in_f & (ls == s)
            n = int(np.count_nonzero(g))
            s_qty = _exact_sum(qty[g])
            s_price = _exact_sum(price[g])
            rows.append((
                str(f), str(s),
                _dec(s_qty, 2),
                _dec(s_price, 2),
                _dec(_exact_sum(disc_price[g]), 4),
                _dec(_exact_sum(charge[g]), 6),
                _dec(_div_half_away(s_qty, n), 2),
                _dec(_div_half_away(s_price, n), 2),
                _dec(_div_half_away(_exact_sum(disc[g]), n), 2),
                n,
            ))
    return rows


def q03(data) -> list[tuple]:
    """TPC-H Q3 rows: the 10 largest revenues, ties by o_orderdate."""
    cutoff = T.parse_date("1995-03-15")
    seg = np.asarray(data.column("customer", "c_mktsegment")).astype(str)
    cust = data.column("customer", "c_custkey")[seg == "BUILDING"]
    o_key = data.column("orders", "o_orderkey")
    o_cust = data.column("orders", "o_custkey")
    o_date = data.column("orders", "o_orderdate")
    o_prio = data.column("orders", "o_shippriority")
    o_sel = (o_date < cutoff) & np.isin(o_cust, cust)
    okeys = o_key[o_sel]
    l_ok = data.column("lineitem", "l_orderkey")
    l_sel = (data.column("lineitem", "l_shipdate") > cutoff) & np.isin(l_ok, okeys)
    keys = l_ok[l_sel]
    rev = (
        data.column("lineitem", "l_extendedprice")[l_sel]
        * (100 - data.column("lineitem", "l_discount")[l_sel])
    )  # scale 4
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    if len(ks) == 0:
        return []
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    gkeys = ks[starts]
    sums = np.add.reduceat(rev[order], starts)  # per order: < 2^40, exact
    # o_orderdate / o_shippriority of each group's order
    o_sorter = np.argsort(o_key, kind="stable")
    at = o_sorter[np.searchsorted(o_key, gkeys, sorter=o_sorter)]
    gdate = o_date[at]
    gprio = o_prio[at]
    top = np.lexsort((gdate, -sums))[:10]
    return [
        (int(gkeys[i]), _dec(int(sums[i]), 4), T.format_date(int(gdate[i])),
         int(gprio[i]))
        for i in top
    ]


def _str(data, table: str, name: str) -> np.ndarray:
    return np.asarray(data.column(table, name)).astype(str)


def _lookup(keys: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Row positions of ``want`` in the unique key column ``keys``."""
    sorter = np.argsort(keys, kind="stable")
    return sorter[np.searchsorted(keys, want, sorter=sorter)]


def _group_sums(group: np.ndarray, vals: np.ndarray, n: int) -> np.ndarray:
    """Exact int64 per-group sums: each 32-bit limb summed through a
    float64 bincount, exact while a group's limb sum stays below 2^53
    (2^21 rows per group)."""
    vals = np.asarray(vals, dtype=np.int64)
    hi = np.bincount(group, weights=vals >> 32, minlength=n)
    lo = np.bincount(group, weights=vals & 0xFFFFFFFF, minlength=n)
    return hi.astype(np.int64) * (1 << 32) + lo.astype(np.int64)


def q04(data) -> list[tuple]:
    """TPC-H Q4 rows: late-line orders of 1993 Q3 per priority."""
    lo, hi = T.parse_date("1993-07-01"), T.parse_date("1993-10-01")
    o_date = data.column("orders", "o_orderdate")
    sel = (o_date >= lo) & (o_date < hi)
    late = (
        data.column("lineitem", "l_commitdate")
        < data.column("lineitem", "l_receiptdate")
    )
    late_orders = np.unique(data.column("lineitem", "l_orderkey")[late])
    sel &= np.isin(data.column("orders", "o_orderkey"), late_orders)
    prio = _str(data, "orders", "o_orderpriority")[sel]
    names, counts = np.unique(prio, return_counts=True)
    return [(str(p), int(c)) for p, c in zip(names, counts)]


def q17(data) -> list[tuple]:
    """TPC-H Q17's one row: sum(l_extendedprice) / 7.0 over the lines of
    Brand#23 MED BOX parts whose quantity is under 0.2 times the part's
    average quantity (the average a decimal(15,2), rounded half away
    from zero, as the engine's decimal avg)."""
    brand = _str(data, "part", "p_brand")
    container = _str(data, "part", "p_container")
    parts = data.column("part", "p_partkey")[
        (brand == "Brand#23") & (container == "MED BOX")
    ]
    l_part = data.column("lineitem", "l_partkey")
    qty = data.column("lineitem", "l_quantity")  # scale 2
    sel = np.isin(l_part, parts)
    if not sel.any():
        return [(None,)]
    keys, inv = np.unique(l_part[sel], return_inverse=True)
    # per-part sums and counts over ALL of lineitem
    every = np.isin(l_part, keys)
    at = np.searchsorted(keys, l_part[every])
    sums = _group_sums(at, qty[every], len(keys))
    counts = np.bincount(at, minlength=len(keys)).astype(np.int64)
    avg = np.array([
        _div_half_away(int(s_), int(c_)) for s_, c_ in zip(sums, counts)
    ], dtype=np.int64)  # scale 2
    # l_quantity (scale 2) < 0.2 * avg (scale 3): qty * 10 < 2 * avg
    keep = qty[sel] * 10 < 2 * avg[inv]
    total = _exact_sum(data.column("lineitem", "l_extendedprice")[sel][keep])
    if not keep.any():
        return [(None,)]
    return [(float(total) / 100.0 / 7.0,)]


def q18(data, threshold: int = 300) -> list[tuple]:
    """TPC-H Q18 rows: orders whose lines sum to more than ``threshold``
    units, largest o_totalprice first, ties by o_orderdate, at most 100."""
    l_ok = data.column("lineitem", "l_orderkey")
    qty = data.column("lineitem", "l_quantity")  # scale 2
    keys, inv = np.unique(l_ok, return_inverse=True)
    sums = _group_sums(inv, qty, len(keys))
    big = sums > int(threshold) * 100
    okeys, osums = keys[big], sums[big]
    o_at = _lookup(data.column("orders", "o_orderkey"), okeys)
    cust = data.column("orders", "o_custkey")[o_at]
    date = data.column("orders", "o_orderdate")[o_at]
    price = data.column("orders", "o_totalprice")[o_at]
    c_at = _lookup(data.column("customer", "c_custkey"), cust)
    c_name = _str(data, "customer", "c_name")[c_at]
    top = np.lexsort((date, -price))[:100]
    return [
        (str(c_name[i]), int(cust[i]), int(okeys[i]),
         T.format_date(int(date[i])), _dec(int(price[i]), 2),
         _dec(int(osums[i]), 2))
        for i in top
    ]


def q21(data) -> list[tuple]:
    """TPC-H Q21 rows: per Saudi supplier, its late lines of F orders in
    which another supplier had a line and no other supplier was late."""
    l_ok = data.column("lineitem", "l_orderkey")
    l_supp = data.column("lineitem", "l_suppkey")
    late = (
        data.column("lineitem", "l_receiptdate")
        > data.column("lineitem", "l_commitdate")
    )
    # per-order min/max supplier over all lines and over late lines
    order = np.argsort(l_ok, kind="stable")
    ks = l_ok[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    g = np.empty(len(l_ok), dtype=np.int64)
    g[order] = np.cumsum(np.r_[True, ks[1:] != ks[:-1]]) - 1
    ss = l_supp[order]
    late_s = late[order]
    lo_all = np.minimum.reduceat(ss, starts)
    hi_all = np.maximum.reduceat(ss, starts)
    lo_late = np.minimum.reduceat(
        np.where(late_s, ss, np.iinfo(np.int64).max), starts
    )
    hi_late = np.maximum.reduceat(np.where(late_s, ss, -1), starts)
    # exists: the order has a line of another supplier; not exists: every
    # late line of the order is this supplier's
    other = (lo_all[g] != l_supp) | (hi_all[g] != l_supp)
    alone = (lo_late[g] == l_supp) & (hi_late[g] == l_supp)
    sel = late & other & alone
    status = _str(data, "orders", "o_orderstatus")
    f_orders = data.column("orders", "o_orderkey")[status == "F"]
    sel &= np.isin(l_ok, f_orders)
    n_name = _str(data, "nation", "n_name")
    saudi = data.column("nation", "n_nationkey")[n_name == "SAUDI ARABIA"]
    s_key = data.column("supplier", "s_suppkey")
    s_ok = np.isin(data.column("supplier", "s_nationkey"), saudi)
    sel &= np.isin(l_supp, s_key[s_ok])
    s_at = _lookup(s_key, l_supp[sel])
    names, counts = np.unique(
        _str(data, "supplier", "s_name")[s_at], return_counts=True
    )
    top = np.lexsort((names, -counts))[:100]
    return [(str(names[i]), int(counts[i])) for i in top]


def fj(data) -> list[tuple]:
    """``FJ_SQL``'s one row: count(*), count(o_orderkey), count(c_custkey)
    of the full outer join."""
    o_cust = data.column("orders", "o_custkey")[
        data.column("orders", "o_orderdate") < T.parse_date("1993-01-01")
    ]
    c_key = data.column("customer", "c_custkey")[
        data.column("customer", "c_acctbal") > 500000  # scale 2
    ]
    matched_orders = int(np.count_nonzero(np.isin(o_cust, c_key)))
    lonely_customers = int(np.count_nonzero(~np.isin(c_key, o_cust)))
    return [(
        len(o_cust) + lonely_customers, len(o_cust),
        matched_orders + lonely_customers,
    )]
