"""Exact numpy implementations of TPC-H Q1, Q2, Q3, Q4, Q9, Q11, Q13,
Q14, Q16, Q17, Q18, Q20, Q21 and Q22, of one full outer join
(``FJ_SQL``), and of the TPC-DS statements the card runs: q3 (``ds_q03``),
q98 (``ds_q98``), q86 (``ds_q86``), q51 at a chosen month window
(``q51_sql``, ``ds_q51``) with the totals of its windowed relation
(``q51_totals_sql``, ``ds_q51_totals``) and a RANGE offset window
(``RANGE7_SQL``, ``ds_range7``). Ranks, running sums and RANGE frames are
computed with numpy alone. The aggregate functions' statements
(``statements.SKETCH_CARD``: ``ds_sketch_item``, ``ds_sketch_global``,
``ds_q17_store``, ``ds_q39_inv``) build their HLL registers with
``np.maximum.at``, their percentiles and ``*_by`` rows with stable
sorts, and their variances from exact integer sums with the engine's
float64 formula. ``chunked_percentile`` is the exact twin of the chunked
tier's approx_percentile (per-chunk quantile summaries and their
weighted merge) over the same contiguous chunk bounds.

An independent check of the engine's answers: the same generated data
(``connectors.tpch.generator.TpchData``: dates as epoch days, decimals
as unscaled int64) computed with plain numpy, returning the result rows
in the form ``QueryRunner.execute`` gives them (strings, ``Decimal`` at
the SQL scale, ints, ISO dates). Decimal sums are exact: each int64
column is summed as two 32-bit limbs and recombined in Python integers;
averages round half away from zero, as the engine's decimal avg does.
Q17's one DOUBLE output is the exact decimal sum converted to a double
and divided by 7.0, Q14's the ratio of two exact sums converted to
doubles; the engine casts the two-limb sums the same way, so the two
agree to a few ulps (``rows_match`` compares DOUBLEs to relative 1e-12).
String predicates are Python string methods (``in``, ``startswith``,
``find``), not the engine's LIKE-to-regex translation.
"""

from __future__ import annotations

import math
from decimal import Decimal
from fractions import Fraction

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.page import content_hash64

__all__ = [
    "q01", "q02", "q03", "q04", "q09", "q11", "q13", "q14", "q16", "q17",
    "q18", "q20", "q21", "q22", "fj", "FJ_SQL", "q11_sql", "q18_sql",
    "rows_match", "ds_q03", "ds_q98", "ds_q86", "ds_q51", "ds_q51_totals",
    "ds_range7", "q51_sql", "q51_totals_sql", "RANGE7_SQL",
    "ds_sketch_item", "ds_sketch_global", "ds_q17_store", "ds_q39_inv",
    "quantile_summary", "chunked_percentile", "percentile_rank_errors",
]

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


#: Q11's FRACTION as the query text writes it (TPC-H 2.4.11.3: 0.0001/SF)
Q11_FRACTION = "0.0001000000"


def q11_sql(fraction: str = Q11_FRACTION) -> str:
    """TPC-H Q11 with its FRACTION (a decimal literal), which the
    specification scales as 0.0001 / SF."""
    from trino_tpu_torch.connectors.tpch.queries import QUERIES

    sql = QUERIES["q11"]
    if f"* {Q11_FRACTION}" not in sql:
        raise ValueError(f"Q11 text has no '* {Q11_FRACTION}' fraction")
    Decimal(fraction)  # a decimal literal, nothing else
    return sql.replace(f"* {Q11_FRACTION}", f"* {fraction}")


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


#: DOUBLE tolerances by statement (1e-12 elsewhere): the variances and
#: averages of integer arguments are exact (the same float64 operations
#: on exact sums); ds_q39_inv sums a million doubles in another order
_REL_TOL = {
    "ds_sketch_item": 0.0, "ds_sketch_global": 0.0, "ds_q17_store": 0.0,
    "ds_q39_inv": 1e-9,
}


def rows_match(name: str, got, want) -> bool:
    """The engine's rows against a reference's: equal, with DOUBLEs to
    relative 1e-12 (Q14, Q17; a NaN matches nothing; ``_REL_TOL`` for
    the aggregate functions' statements) and, for Q11, whose
    ORDER BY value leaves ties in no defined order, the value column
    equal in order and the rows equal as a set."""
    if len(got) != len(want):
        return False
    if name == "q11":
        return (
            [r[1] for r in got] == [r[1] for r in want]
            and sorted(got) == sorted(want)
        )
    if name in _ORDER_KEYS:
        # ties in the ORDER BY keys leave the rows' order open: the keys
        # must agree in order, the rows as a multiset
        key = _ORDER_KEYS[name]
        if [key(r) for r in got] != [key(r) for r in want]:
            return False
        got, want = sorted(got, key=_row_key), sorted(want, key=_row_key)
    rel = _REL_TOL.get(name, 1e-12)
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for a, b in zip(g, w):
            if isinstance(b, float):
                if not isinstance(a, float) or not math.isclose(
                    a, b, rel_tol=rel, abs_tol=0.0
                ):
                    return False
            elif type(a) is not type(b) or a != b:
                return False
    return True


def _contains_in_order(values, first: str, second: str) -> np.ndarray:
    """``LIKE '%first%second%'`` of each string, by ``str.find``."""
    out = np.zeros(len(values), dtype=np.bool_)
    for i, v in enumerate(values):
        j = v.find(first)
        out[i] = j >= 0 and v.find(second, j + len(first)) >= 0
    return out


def _years(days: np.ndarray) -> np.ndarray:
    """Calendar years of epoch days."""
    return (
        np.asarray(days, dtype="datetime64[D]").astype("datetime64[Y]")
        .astype(np.int64) + 1970
    )


def _region_suppliers(data, region: str) -> np.ndarray:
    """Row mask over supplier: suppliers of the named region."""
    r_key = data.column("region", "r_regionkey")[_str(data, "region", "r_name") == region]
    nations = data.column("nation", "n_nationkey")[
        np.isin(data.column("nation", "n_regionkey"), r_key)
    ]
    return np.isin(data.column("supplier", "s_nationkey"), nations)


def q02(data) -> list[tuple]:
    """TPC-H Q2 rows: per size-15 BRASS part, the European suppliers at
    the part's lowest European supply cost; largest s_acctbal first,
    then n_name, s_name, p_partkey; at most 100."""
    s_key = data.column("supplier", "s_suppkey")
    eu_supp = s_key[_region_suppliers(data, "EUROPE")]
    ps_part = data.column("partsupp", "ps_partkey")
    ps_supp = data.column("partsupp", "ps_suppkey")
    ps_cost = data.column("partsupp", "ps_supplycost")  # scale 2
    in_eu = np.isin(ps_supp, eu_supp)
    order = np.argsort(ps_part[in_eu], kind="stable")
    ks = ps_part[in_eu][order]
    if len(ks) == 0:
        return []
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    parts = ks[starts]
    mins = np.minimum.reduceat(ps_cost[in_eu][order], starts)
    p_key = data.column("part", "p_partkey")
    p_type = data.column("part", "p_type")
    brass = np.fromiter((t.endswith("BRASS") for t in p_type), np.bool_, len(p_type))
    cand = p_key[(data.column("part", "p_size") == 15) & brass]
    sel = np.flatnonzero(in_eu & np.isin(ps_part, cand))
    at = np.searchsorted(parts, ps_part[sel])
    sel = sel[ps_cost[sel] == mins[at]]
    s_at = _lookup(s_key, ps_supp[sel])
    p_at = _lookup(p_key, ps_part[sel])
    n_at = _lookup(
        data.column("nation", "n_nationkey"),
        data.column("supplier", "s_nationkey")[s_at],
    )
    acct = data.column("supplier", "s_acctbal")[s_at]
    cols = {
        "s_name": _str(data, "supplier", "s_name")[s_at],
        "n_name": _str(data, "nation", "n_name")[n_at],
        "s_address": _str(data, "supplier", "s_address")[s_at],
        "s_phone": _str(data, "supplier", "s_phone")[s_at],
        "s_comment": _str(data, "supplier", "s_comment")[s_at],
        "p_mfgr": _str(data, "part", "p_mfgr")[p_at],
    }
    pk = ps_part[sel]
    top = sorted(
        range(len(sel)),
        key=lambda i: (-int(acct[i]), cols["n_name"][i], cols["s_name"][i], int(pk[i])),
    )[:100]
    return [
        (_dec(int(acct[i]), 2), str(cols["s_name"][i]), str(cols["n_name"][i]),
         int(pk[i]), str(cols["p_mfgr"][i]), str(cols["s_address"][i]),
         str(cols["s_phone"][i]), str(cols["s_comment"][i]))
        for i in top
    ]


def q09(data) -> list[tuple]:
    """TPC-H Q9 rows: profit of 'green' parts per supplier nation and
    order year; nation ascending, year descending."""
    p_key = data.column("part", "p_partkey")
    p_name = data.column("part", "p_name")
    green = p_key[np.fromiter(("green" in v for v in p_name), np.bool_, len(p_name))]
    l_part = data.column("lineitem", "l_partkey")
    sel = np.isin(l_part, green)
    part = l_part[sel]
    supp = data.column("lineitem", "l_suppkey")[sel]
    # ps_supplycost of each line's (part, supplier)
    width = int(data.column("supplier", "s_suppkey").max()) + 1
    ps_pair = data.column("partsupp", "ps_partkey") * width + data.column("partsupp", "ps_suppkey")
    cost = data.column("partsupp", "ps_supplycost")[_lookup(ps_pair, part * width + supp)]
    amount = (
        data.column("lineitem", "l_extendedprice")[sel]
        * (100 - data.column("lineitem", "l_discount")[sel])
        - cost * data.column("lineitem", "l_quantity")[sel]
    )  # scale 4
    nation = data.column("supplier", "s_nationkey")[
        _lookup(data.column("supplier", "s_suppkey"), supp)
    ]
    year = _years(data.column("orders", "o_orderdate")[
        _lookup(data.column("orders", "o_orderkey"),
                data.column("lineitem", "l_orderkey")[sel])
    ])
    keys, inv = np.unique(nation * 10_000 + year, return_inverse=True)
    sums = _group_sums(inv, amount, len(keys))
    n_name = _str(data, "nation", "n_name")[
        _lookup(data.column("nation", "n_nationkey"), keys // 10_000)
    ]
    rows = [
        (str(n_name[i]), int(keys[i] % 10_000), _dec(int(sums[i]), 4))
        for i in range(len(keys))
    ]
    return sorted(rows, key=lambda r: (r[0], -r[1]))


def q11(data, fraction: str = Q11_FRACTION) -> list[tuple]:
    """TPC-H Q11 rows: German stock value per part above ``fraction``
    of the German total, largest first (ties by p_partkey)."""
    s_key = data.column("supplier", "s_suppkey")
    germany = data.column("nation", "n_nationkey")[
        _str(data, "nation", "n_name") == "GERMANY"
    ]
    supp = s_key[np.isin(data.column("supplier", "s_nationkey"), germany)]
    sel = np.isin(data.column("partsupp", "ps_suppkey"), supp)
    value = (
        data.column("partsupp", "ps_supplycost")[sel]
        * data.column("partsupp", "ps_availqty")[sel]
    )  # scale 2
    total = _exact_sum(value)
    keys, inv = np.unique(data.column("partsupp", "ps_partkey")[sel], return_inverse=True)
    sums = _group_sums(inv, value, len(keys))
    # value > total * fraction, exactly: value * den > total * num
    frac = Fraction(fraction)
    rows = [
        (int(k), _dec(int(v), 2)) for k, v in zip(keys, sums)
        if int(v) * frac.denominator > total * frac.numerator
    ]
    return sorted(rows, key=lambda r: (-r[1], r[0]))


def q13(data) -> list[tuple]:
    """TPC-H Q13 rows: how many customers have each count of orders
    whose comment is not like '%special%requests%'; most customers
    first, then the larger count."""
    keep = ~_contains_in_order(data.column("orders", "o_comment"), "special", "requests")
    c_key = data.column("customer", "c_custkey")
    at = _lookup(c_key, data.column("orders", "o_custkey")[keep])
    per_cust = np.bincount(at, minlength=len(c_key))
    counts, custdist = np.unique(per_cust, return_counts=True)
    order = np.lexsort((-counts, -custdist))
    return [(int(counts[i]), int(custdist[i])) for i in order]


def q14(data) -> list[tuple]:
    """TPC-H Q14's one row: the promotion share of September 1995's
    revenue, 100.0 * promo / total over the exact sums as doubles."""
    ship = data.column("lineitem", "l_shipdate")
    sel = (ship >= T.parse_date("1995-09-01")) & (ship < T.parse_date("1995-10-01"))
    rev = (
        data.column("lineitem", "l_extendedprice")[sel]
        * (100 - data.column("lineitem", "l_discount")[sel])
    )  # scale 4
    p_type = data.column("part", "p_type")[
        _lookup(data.column("part", "p_partkey"), data.column("lineitem", "l_partkey")[sel])
    ]
    promo = np.fromiter((t.startswith("PROMO") for t in p_type), np.bool_, len(p_type))
    total = _exact_sum(rev)
    if not sel.any():
        return [(None,)]
    return [(100.0 * (_exact_sum(rev[promo]) / 1e4) / (total / 1e4),)]


def q16(data) -> list[tuple]:
    """TPC-H Q16 rows: distinct suppliers without complaints per
    (brand, type, size) of the selected parts; most suppliers first,
    then brand, type, size."""
    s_comment = data.column("supplier", "s_comment")
    bad = data.column("supplier", "s_suppkey")[
        _contains_in_order(s_comment, "Customer", "Complaints")
    ]
    brand = data.column("part", "p_brand")
    p_type = data.column("part", "p_type")
    size = data.column("part", "p_size")
    ok = (
        (np.asarray(brand) != "Brand#45")
        & ~np.fromiter((t.startswith("MEDIUM POLISHED") for t in p_type), np.bool_, len(p_type))
        & np.isin(size, [49, 14, 23, 45, 19, 3, 36, 9])
    )
    p_key = data.column("part", "p_partkey")
    ps_part = data.column("partsupp", "ps_partkey")
    ps_supp = data.column("partsupp", "ps_suppkey")
    sel = np.isin(ps_part, p_key[ok]) & ~np.isin(ps_supp, bad)
    p_at = _lookup(p_key, ps_part[sel])
    groups: dict[tuple, set] = {}
    for b, t, z, s_ in zip(brand[p_at], p_type[p_at], size[p_at], ps_supp[sel]):
        groups.setdefault((str(b), str(t), int(z)), set()).add(int(s_))
    rows = [(b, t, z, len(v)) for (b, t, z), v in groups.items()]
    return sorted(rows, key=lambda r: (-r[3], r[0], r[1], r[2]))


def q20(data) -> list[tuple]:
    """TPC-H Q20 rows: Canadian suppliers with more stock of a 'forest'
    part than half of what they shipped of it in 1994, by s_name."""
    p_name = data.column("part", "p_name")
    forest = data.column("part", "p_partkey")[
        np.fromiter((v.startswith("forest") for v in p_name), np.bool_, len(p_name))
    ]
    ship = data.column("lineitem", "l_shipdate")
    l_part = data.column("lineitem", "l_partkey")
    sel = (
        (ship >= T.parse_date("1994-01-01")) & (ship < T.parse_date("1995-01-01"))
        & np.isin(l_part, forest)
    )
    width = int(data.column("supplier", "s_suppkey").max()) + 1
    pairs, inv = np.unique(
        l_part[sel] * width + data.column("lineitem", "l_suppkey")[sel],
        return_inverse=True,
    )
    shipped = _group_sums(inv, data.column("lineitem", "l_quantity")[sel], len(pairs))
    ps_part = data.column("partsupp", "ps_partkey")
    ps_supp = data.column("partsupp", "ps_suppkey")
    cand = np.flatnonzero(np.isin(ps_part, forest))
    key = ps_part[cand] * width + ps_supp[cand]
    at = np.clip(np.searchsorted(pairs, key), 0, max(len(pairs) - 1, 0))
    has = (at < len(pairs)) & (pairs[at] == key) if len(pairs) else np.zeros(len(key), bool)
    avail = data.column("partsupp", "ps_availqty")[cand]
    # ps_availqty > 0.5 * sum(l_quantity) (scale 2): 200 * avail > sum
    keep = has & (200 * avail > np.where(has, shipped[at] if len(pairs) else 0, 0))
    supp = np.unique(ps_supp[cand][keep])
    canada = data.column("nation", "n_nationkey")[_str(data, "nation", "n_name") == "CANADA"]
    s_sel = (
        np.isin(data.column("supplier", "s_nationkey"), canada)
        & np.isin(data.column("supplier", "s_suppkey"), supp)
    )
    rows = list(zip(
        _str(data, "supplier", "s_name")[s_sel].tolist(),
        _str(data, "supplier", "s_address")[s_sel].tolist(),
    ))
    return sorted(rows)


Q22_CODES = ("13", "31", "23", "29", "30", "18", "17")


def q22(data) -> list[tuple]:
    """TPC-H Q22 rows: per country code, customers without orders whose
    balance is above the code set's average positive balance (a decimal
    avg rounded half away from zero); by code."""
    phone = data.column("customer", "c_phone")
    code = np.asarray([p[:2] for p in phone], dtype=object)
    inset = np.isin(code.astype(str), Q22_CODES)
    acct = data.column("customer", "c_acctbal")  # scale 2
    pos = inset & (acct > 0)
    if not pos.any():
        return []
    avg = _div_half_away(_exact_sum(acct[pos]), int(np.count_nonzero(pos)))
    sel = (
        inset & (acct > avg)
        & ~np.isin(data.column("customer", "c_custkey"), data.column("orders", "o_custkey"))
    )
    codes, inv = np.unique(code[sel].astype(str), return_inverse=True)
    sums = _group_sums(inv, acct[sel], len(codes))
    counts = np.bincount(inv, minlength=len(codes))
    return [
        (str(c), int(n), _dec(int(s_), 2)) for c, n, s_ in zip(codes, counts, sums)
    ]


# ---- TPC-DS ------------------------------------------------------------------

#: the ORDER BY keys of the TPC-DS statements whose keys do not fix every
#: row's position (q3's brand name, q98's price)
_ORDER_KEYS = {
    "ds_q03": lambda r: (r[0], r[3], r[1]),
    "ds_q98": lambda r: (r[2], r[3], r[0], r[1]),
}


def _row_key(row):
    return tuple((v is None, str(v)) for v in row)


#: a RANGE offset window over the whole of store_sales: per store, each
#: sale's 7-day trailing sum of net paid, summed again
RANGE7_SQL = """select ss_store_sk, count(*), sum(w)
from (select ss_store_sk,
             sum(ss_net_paid) over (partition by ss_store_sk order by ss_sold_date_sk
                                    range between 6 preceding and current row) w
      from store_sales)
group by ss_store_sk
order by 1"""

#: q51's month window as the TPC-DS text writes it (1200-1211, months
#: counted from 1900); this generator counts d_month_seq from 1990
_Q51_MONTHS = "1200 AND (1200 + 11)"


def q51_sql(month_lo: int = 108) -> str:
    """TPC-DS q51 over the twelve months from ``month_lo`` (108 = 1999
    in this generator's d_month_seq)."""
    from trino_tpu_torch.connectors.tpcds.queries import QUERIES

    sql = QUERIES["q51"]
    if sql.count(_Q51_MONTHS) != 2:
        raise ValueError("q51 text has no month window to replace")
    m = int(month_lo)
    return sql.replace(_Q51_MONTHS, f"{m} AND ({m} + 11)")


def q51_totals_sql(month_lo: int = 108) -> str:
    """count(*), the non-NULL counts and the sums of web_cumulative and
    store_cumulative over q51's windowed relation ``y`` (every row of it,
    not only the first 100 that pass its filter)."""
    sql = q51_sql(month_lo)
    head, sep, tail = sql.partition("SELECT *\nFROM\n  (")
    inner, sep2, _ = tail.rpartition(")  y")
    if not sep or not sep2:
        raise ValueError("q51 text does not have its outer SELECT over y")
    return (
        head + "SELECT count(*), count(web_cumulative), "
        "count(store_cumulative), sum(web_cumulative), "
        "sum(store_cumulative)\nFROM (" + inner + ") y"
    )


def _ds(data, table: str, name: str) -> np.ndarray:
    return np.asarray(data.column(table, name))


def _dim_rows(keys: np.ndarray, want: np.ndarray):
    """(row position in the dimension, found) of each fact key."""
    sorter = np.argsort(keys, kind="stable")
    at = np.searchsorted(keys, want, sorter=sorter).clip(0, len(keys) - 1)
    rows = sorter[at]
    return rows, keys[rows] == want


def _grouped(cols, vals: np.ndarray):
    """Exact per-group sums of int64 ``vals`` grouped by the key arrays
    ``cols``: (unique key arrays, sums)."""
    keys = np.rec.fromarrays(cols)
    uniq, inv = np.unique(keys, return_inverse=True)
    sums = _group_sums(inv.reshape(-1), vals, len(uniq))
    return [uniq[f] for f in uniq.dtype.names], sums


def ds_q03(data) -> list[tuple]:
    """TPC-DS q3: brand revenue of manufacturer 128 in November, by
    year."""
    d_sk = _ds(data, "date_dim", "d_date_sk")
    ss_date = _ds(data, "store_sales", "ss_sold_date_sk")
    ss_item = _ds(data, "store_sales", "ss_item_sk")
    i_sk = _ds(data, "item", "i_item_sk")
    drow, dok = _dim_rows(d_sk, ss_date)
    irow, iok = _dim_rows(i_sk, ss_item)
    sel = (
        dok & iok
        & (_ds(data, "date_dim", "d_moy")[drow] == 11)
        & (_ds(data, "item", "i_manufact_id")[irow] == 128)
    )
    year = _ds(data, "date_dim", "d_year")[drow[sel]].astype(np.int64)
    bid = _ds(data, "item", "i_brand_id")[irow[sel]].astype(np.int64)
    brand = _ds(data, "item", "i_brand").astype(str)[irow[sel]]
    (gy, gb, gn), sums = _grouped(
        [year, bid, brand], _ds(data, "store_sales", "ss_ext_sales_price")[sel]
    )
    order = np.lexsort((gn, gb, -sums, gy))[:100]
    return [
        (int(gy[i]), int(gb[i]), str(gn[i]), _dec(int(sums[i]), 2))
        for i in order
    ]


def ds_q98(data) -> list[tuple]:
    """TPC-DS q98: item revenue in three categories over 31 days, with
    its share of its class's revenue (the window sum over the groups)."""
    lo, hi = T.parse_date("1999-02-22"), T.parse_date("1999-03-24")
    d_sk = _ds(data, "date_dim", "d_date_sk")
    ss_date = _ds(data, "store_sales", "ss_sold_date_sk")
    ss_item = _ds(data, "store_sales", "ss_item_sk")
    drow, dok = _dim_rows(d_sk, ss_date)
    irow, iok = _dim_rows(_ds(data, "item", "i_item_sk"), ss_item)
    day = _ds(data, "date_dim", "d_date")[drow]
    cat_all = _ds(data, "item", "i_category").astype(str)
    sel = (
        dok & iok & (day >= lo) & (day <= hi)
        & np.isin(cat_all[irow], ["Sports", "Books", "Home"])
    )
    r = irow[sel]
    keys = [
        _ds(data, "item", "i_item_id").astype(str)[r],
        _ds(data, "item", "i_item_desc").astype(str)[r],
        cat_all[r],
        _ds(data, "item", "i_class").astype(str)[r],
        _ds(data, "item", "i_current_price")[r].astype(np.int64),
    ]
    (g_id, g_desc, g_cat, g_cls, g_price), rev = _grouped(
        keys, _ds(data, "store_sales", "ss_ext_sales_price")[sel]
    )
    cls_u, cls_inv = np.unique(g_cls, return_inverse=True)
    cls_total = _group_sums(cls_inv.reshape(-1), rev, len(cls_u))[cls_inv.reshape(-1)]
    ratio = np.asarray([
        float(_dec(int(a) * 100, 2)) / float(_dec(int(b), 2))
        for a, b in zip(rev, cls_total)
    ])
    order = np.lexsort((ratio, g_desc, g_id, g_cls, g_cat))[:100]
    return [
        (str(g_id[i]), str(g_desc[i]), str(g_cat[i]), str(g_cls[i]),
         _dec(int(g_price[i]), 2), _dec(int(rev[i]), 2), float(ratio[i]))
        for i in order
    ]


def _rank_desc(part: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """rank() over (partition by part order by vals desc), per row."""
    order = np.lexsort((-vals, part))
    ranks = np.empty(len(vals), dtype=np.int64)
    prev_p = prev_v = None
    for pos, i in enumerate(order):
        if part[i] != prev_p:
            start, prev_p, prev_v, r = pos, part[i], None, 0
        if vals[i] != prev_v:
            r, prev_v = pos - start + 1, vals[i]
        ranks[i] = r
    return ranks


def ds_q86(data) -> list[tuple]:
    """TPC-DS q86: web revenue of 1999 rolled up over (category, class),
    ranked within each parent (grouping sets, grouping(), rank())."""
    d_sk = _ds(data, "date_dim", "d_date_sk")
    ws_date = _ds(data, "web_sales", "ws_sold_date_sk")
    drow, dok = _dim_rows(d_sk, ws_date)
    irow, iok = _dim_rows(
        _ds(data, "item", "i_item_sk"), _ds(data, "web_sales", "ws_item_sk")
    )
    mseq = _ds(data, "date_dim", "d_month_seq")[drow]
    sel = dok & iok & (mseq >= 108) & (mseq <= 119)
    paid = _ds(data, "web_sales", "ws_net_paid")[sel]
    cat = _ds(data, "item", "i_category").astype(str)[irow[sel]]
    cls = _ds(data, "item", "i_class").astype(str)[irow[sel]]
    rows = []  # (total, category, class, lochierarchy)
    (gc, gk), sums = _grouped([cat, cls], paid)
    rows += [(int(v), str(a), str(b), 0) for a, b, v in zip(gc, gk, sums)]
    (gc,), sums = _grouped([cat], paid)
    rows += [(int(v), str(a), None, 1) for a, v in zip(gc, sums)]
    if len(paid):
        rows.append((_exact_sum(paid), None, None, 2))
    # rank within (lochierarchy, category of the class rows)
    parts = np.asarray([
        f"{r[3]}|{r[1] if r[3] == 0 else ''}" for r in rows
    ])
    totals = np.asarray([r[0] for r in rows], dtype=np.int64)
    ranks = _rank_desc(parts, totals)

    def sort_key(i):
        total, c, k, loch = rows[i]
        case = c if loch == 0 else None
        return (-loch, case is None, case or "", ranks[i], c is None, c or "",
                k is None, k or "")

    order = sorted(range(len(rows)), key=sort_key)[:100]
    return [
        (_dec(rows[i][0], 2), rows[i][1], rows[i][2], rows[i][3], int(ranks[i]))
        for i in order
    ]


def _segment_running(seg: np.ndarray, vals: np.ndarray, kind: str) -> np.ndarray:
    """Running sum or max of int64 ``vals`` within runs of equal ``seg``
    (rows already in (segment, order) order); max treats -1 as NULL and
    keeps -1 until a value is seen (``vals`` are non-negative)."""
    starts = np.r_[True, seg[1:] != seg[:-1]]
    if kind == "sum":
        cs = np.cumsum(vals)
        base = np.maximum.accumulate(np.where(starts, np.arange(len(vals)), 0))
        before = np.where(base > 0, cs[np.maximum(base - 1, 0)], 0)
        return cs - before
    sid = np.cumsum(starts) - 1
    big = int(vals.max(initial=0)) + 2
    if len(sid) and int(sid[-1]) * big > (1 << 62):
        raise OverflowError("segment offsets overflow int64")
    return np.maximum.accumulate(sid * big + vals + 1) - sid * big - 1


def _q51_side(data, fact: str, prefix: str, months):
    """(item, day, running sum) of web_v1 / store_v1: sales per (item,
    day) in the month window, summed running per item by day."""
    d_sk = _ds(data, "date_dim", "d_date_sk")
    drow, dok = _dim_rows(d_sk, _ds(data, fact, f"{prefix}_sold_date_sk"))
    mseq = _ds(data, "date_dim", "d_month_seq")[drow]
    sel = dok & (mseq >= months[0]) & (mseq <= months[1])
    item = _ds(data, fact, f"{prefix}_item_sk")[sel].astype(np.int64)
    day = _ds(data, "date_dim", "d_date")[drow[sel]].astype(np.int64)
    (gi, gd), sums = _grouped([item, day], _ds(data, fact, f"{prefix}_sales_price")[sel])
    order = np.lexsort((gd, gi))
    gi, gd, sums = gi[order], gd[order], sums[order]
    return gi, gd, _segment_running(gi, sums, "sum")


def _q51_y(data, month_lo: int):
    """q51's relation y in (item_sk, d_date) order: item, day, web and
    store running sums and their running maxima (-1 for NULL)."""
    months = (month_lo, month_lo + 11)
    wi, wd, wv = _q51_side(data, "web_sales", "ws", months)
    si, sd, sv = _q51_side(data, "store_sales", "ss", months)
    item = np.concatenate([wi, si])
    day = np.concatenate([wd, sd])
    keys = np.rec.fromarrays([item, day])
    uniq, inv = np.unique(keys, return_inverse=True)
    inv = inv.reshape(-1)
    web = np.full(len(uniq), -1, dtype=np.int64)
    store = np.full(len(uniq), -1, dtype=np.int64)
    web[inv[: len(wi)]] = wv
    store[inv[len(wi):]] = sv
    ui, ud = uniq["f0"], uniq["f1"]
    return (
        ui, ud, web, store,
        _segment_running(ui, web, "max"), _segment_running(ui, store, "max"),
    )


def _null_dec(v) -> Decimal | None:
    return None if v < 0 else _dec(int(v), 2)


def ds_q51(data, month_lo: int = 108) -> list[tuple]:
    """TPC-DS q51 (``q51_sql(month_lo)``): the first 100 (item, day) rows,
    in order, whose running web maximum exceeds the running store
    maximum."""
    ui, ud, web, store, wmax, smax = _q51_y(data, month_lo)
    keep = np.nonzero((wmax >= 0) & (smax >= 0) & (wmax > smax))[0][:100]
    return [
        (int(ui[i]), T.format_date(int(ud[i])), _null_dec(web[i]),
         _null_dec(store[i]), _null_dec(wmax[i]), _null_dec(smax[i]))
        for i in keep
    ]


def ds_q51_totals(data, month_lo: int = 108) -> list[tuple]:
    """``q51_totals_sql(month_lo)``: count(*), count(web_cumulative),
    count(store_cumulative), sum(web_cumulative), sum(store_cumulative)
    over y."""
    _, _, _, _, wmax, smax = _q51_y(data, month_lo)
    w, s = wmax[wmax >= 0], smax[smax >= 0]
    return [(
        len(wmax), len(w), len(s),
        _dec(_exact_sum(w), 2) if len(w) else None,
        _dec(_exact_sum(s), 2) if len(s) else None,
    )]


def ds_range7(data) -> list[tuple]:
    """``RANGE7_SQL``: per store, the count of sales and the sum over its
    sales of each one's trailing 7-day net paid (the sale's own day and
    the 6 before it, all of the store's sales on those days)."""
    store = _ds(data, "store_sales", "ss_store_sk").astype(np.int64)
    day = _ds(data, "store_sales", "ss_sold_date_sk").astype(np.int64)
    paid = _ds(data, "store_sales", "ss_net_paid").astype(np.int64)
    stores, sidx = np.unique(store, return_inverse=True)
    lo = int(day.min(initial=0))
    span = int(day.max(initial=0)) - lo + 1
    at = sidx.reshape(-1) * span + (day - lo)
    size = len(stores) * span
    cnt = np.bincount(at, minlength=size).astype(np.int64).reshape(-1, span)
    per_day = _group_sums(at, paid, size).reshape(-1, span)
    cs = np.cumsum(per_day, axis=1)
    shifted = np.zeros_like(cs)
    shifted[:, 7:] = cs[:, :-7]
    trailing = cs - shifted  # each day's own and the 6 before it
    totals = (cnt * trailing).sum(axis=1)
    return [
        (int(st), int(c), _dec(int(t), 2))
        for st, c, t in zip(stores, cnt.sum(axis=1), totals)
    ]


# ---- the aggregate functions' TPC-DS statements ---------------------------------

def _splitmix64(v: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer of int64 values, as uint64 (the HLL value
    hash of a numeric lane)."""
    v = np.asarray(v, dtype=np.int64).view(np.uint64).copy()
    with np.errstate(over="ignore"):
        v ^= v >> np.uint64(30)
        v *= np.uint64(0xBF58476D1CE4E5B9)
        v ^= v >> np.uint64(27)
        v *= np.uint64(0x94D049BB133111EB)
        v ^= v >> np.uint64(31)
    return v


def _leading_zeros(w: np.ndarray) -> np.ndarray:
    """Leading zero bits of each uint64 (64 for 0)."""
    out = np.full(len(w), 64, dtype=np.int64)
    nz = w != 0
    x = w[nz]
    n = np.zeros(len(x), dtype=np.int64)
    for s in (32, 16, 8, 4, 2, 1):
        top = (x >> np.uint64(64 - s)) == 0
        n += np.where(top, s, 0)
        x = np.where(top, x << np.uint64(s), x)
    out[nz] = n
    return out


def _hll_estimates(group: np.ndarray, n_groups: int, h: np.ndarray, m: int) -> list[int]:
    """HLL estimates of each group's uint64 hashes: registers by
    ``np.maximum.at`` (each register the largest rho = leading zeros of
    the hash's low bits + 1, clamped to 64 - b + 1), then the standard
    estimate with the linear-counting correction, rounded half to even."""
    b = m.bit_length() - 1
    bucket = (h >> np.uint64(64 - b)).astype(np.int64)
    with np.errstate(over="ignore"):
        rho = np.minimum(_leading_zeros(h << np.uint64(b)) + 1, 64 - b + 1)
    reg = np.zeros(n_groups * m, dtype=np.int64)
    np.maximum.at(reg, np.asarray(group, dtype=np.int64) * m + bucket, rho)
    reg = reg.reshape(n_groups, m)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    inv = np.ldexp(1.0, -reg).sum(axis=1)
    raw = alpha * m * m / inv
    zeros = (reg == 0).sum(axis=1).astype(np.float64)
    lin = m * np.log(np.where(zeros > 0, m / np.maximum(zeros, 1.0), 1.0))
    est = np.where((raw <= 2.5 * m) & (zeros > 0), lin, raw)
    return [int(e) for e in np.round(est)]


def _variance(s1: int, s2: int, n: int, pop: bool, root: bool):
    """The engine's variance over exact integer sums: float64 s1, s2 and
    m2 = s2 - s1^2 / n clamped at 0; NULL below 1 (pop) or 2 rows."""
    if n < (1 if pop else 2):
        return None
    f1, f2, fn = float(s1), float(s2), float(n)
    m2 = max(f2 - (f1 * f1) / max(fn, 1.0), 0.0)
    var = m2 / max(fn if pop else fn - 1.0, 1.0)
    return math.sqrt(var) if root else var


def _runs(keys_sorted: np.ndarray):
    """(starts, counts) of the runs of equal values of a sorted array."""
    if len(keys_sorted) == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    starts = np.flatnonzero(np.r_[True, keys_sorted[1:] != keys_sorted[:-1]])
    counts = np.diff(np.r_[starts, len(keys_sorted)])
    return starts, counts


def _percentile_at(starts, counts, q: float) -> np.ndarray:
    """Sorted position of each group's percentile q: its start plus
    round(q * (count - 1)), half to even."""
    offs = np.round(q * (counts.astype(np.float64) - 1.0)).astype(np.int64)
    return starts + np.clip(offs, 0, np.maximum(counts - 1, 0))


def ds_sketch_item(data, chunk_rows: int | None = None) -> list[tuple]:
    """``statements.SKETCH_CARD["ds_sketch_item"]``: per store_sales item,
    count(*), approx_distinct of the customer, the median net paid,
    max_by / min_by of the ticket by net paid (ties to the first row in
    scan order), arbitrary store (the first row in scan order), bool_or
    of quantity > 95, stddev_samp and var_pop of quantity.

    With ``chunk_rows``, the statement as the chunked tier runs it when
    store_sales streams in row ranges of that many rows: the median is
    the merge of the chunks' quantile summaries
    (``chunked_percentile``); every other column is the same (register
    max, the integer moments and the first rows do not depend on the
    chunks)."""
    item = _ds(data, "store_sales", "ss_item_sk").astype(np.int64)
    cust = _ds(data, "store_sales", "ss_customer_sk").astype(np.int64)
    paid = _ds(data, "store_sales", "ss_net_paid").astype(np.int64)
    ticket = _ds(data, "store_sales", "ss_ticket_number").astype(np.int64)
    store = _ds(data, "store_sales", "ss_store_sk").astype(np.int64)
    qty = _ds(data, "store_sales", "ss_quantity").astype(np.int64)
    scan = np.argsort(item, kind="stable")  # scan order within each item
    starts, counts = _runs(item[scan])
    gid = np.repeat(np.arange(len(starts)), counts)
    group = np.empty(len(item), dtype=np.int64)
    group[scan] = gid
    est = _hll_estimates(group, len(starts), _splitmix64(cust), 512)
    by_paid = np.lexsort((paid, item))  # stable: ties keep scan order
    by_paid_desc = np.lexsort((-paid, item))
    if chunk_rows is None:
        median = paid[by_paid[_percentile_at(starts, counts, 0.5)]]
    else:
        _items, picks = chunked_percentile(item, paid, chunk_rows, 0.5)
        median = np.round(picks).astype(np.int64)
    big = np.logical_or.reduceat((qty > 95)[scan], starts) if len(starts) else []
    s1 = _group_sums(group, qty, len(starts))
    s2 = _group_sums(group, qty * qty, len(starts))
    return [
        (int(item[scan[s]]), int(c), est[g], _dec(int(median[g]), 2),
         int(ticket[by_paid_desc[s]]), int(ticket[by_paid[s]]),
         int(store[scan[s]]), bool(big[g]),
         _variance(int(s1[g]), int(s2[g]), int(c), False, True),
         _variance(int(s1[g]), int(s2[g]), int(c), True, False))
        for g, (s, c) in enumerate(zip(starts, counts))
    ]


def quantile_summary(keys: np.ndarray, vals: np.ndarray, k: int):
    """The engine's PARTIAL quantile summary of one chunk, grouped by
    ``keys`` (every row contributing): (group keys ascending, float64
    points [groups, k], counts). Point i of a group of c rows is its
    sorted value at clip(round((i + 0.5) / k * c - 0.5), 0, c - 1),
    rounded half to even; equal values keep scan order."""
    order = np.lexsort((vals, keys))
    ks, vs = keys[order], vals[order]
    starts, counts = _runs(ks)
    i = np.arange(k, dtype=np.float64)
    c = counts.astype(np.float64)
    offs = np.clip(
        np.round((i[None, :] + 0.5) / k * c[:, None] - 0.5),
        0, np.maximum(c - 1, 0)[:, None],
    ).astype(np.int64)
    return ks[starts], vs[starts[:, None] + offs].astype(np.float64), counts


def chunked_percentile(keys: np.ndarray, vals: np.ndarray, chunk_rows: int,
                       q: float, k: int = 256):
    """The engine's FINAL merge of per-chunk quantile summaries over the
    contiguous row ranges [j * chunk_rows, (j + 1) * chunk_rows): each
    point weighs its chunk's group count / k; over a group's points in
    value order (equal values in chunk order, then point order) the pick
    is the first point whose running weight reaches q * total - 1e-9.
    Returns (group keys ascending, float64 picks)."""
    parts = [
        quantile_summary(keys[lo:lo + chunk_rows], vals[lo:lo + chunk_rows], k)
        for lo in range(0, len(keys), chunk_rows)
    ]
    groups = np.unique(np.concatenate([p[0] for p in parts]))
    n_chunks = len(parts)
    pts = np.full((len(groups), n_chunks * k), np.inf)
    wts = np.zeros((len(groups), n_chunks))
    for j, (gk, p, c) in enumerate(parts):
        at = np.searchsorted(groups, gk)
        pts[at, j * k:(j + 1) * k] = p
        wts[at, j] = c / k
    del parts
    order = np.argsort(pts, axis=1, kind="stable")
    ws = np.take_along_axis(wts, order // k, axis=1)
    vs = np.take_along_axis(pts, order, axis=1)
    del order, pts
    cum = np.cumsum(ws, axis=1)  # exact: dyadic weights
    target = q * cum[:, -1] - 1e-9
    first = np.argmax((cum >= target[:, None]) & (ws > 0), axis=1)
    return groups, vs[np.arange(len(groups)), first]


def percentile_rank_errors(keys: np.ndarray, vals: np.ndarray, picks,
                           q: float, n_chunks: int, k: int = 256) -> int:
    """How many groups' picks lie outside the summaries' rank bound of
    the exact percentile: sorted ranks round(q * (c - 1)) +- (n_chunks *
    c // k + 1), as tests/test_sketches.py bounds the JAX package's."""
    order = np.lexsort((vals, keys))
    starts, counts = _runs(keys[order])
    vs = vals[order]
    r = np.round(q * (counts - 1.0)).astype(np.int64)
    eps = n_chunks * counts // k + 1
    lo = vs[starts + np.maximum(r - eps, 0)]
    hi = vs[starts + np.minimum(r + eps, counts - 1)]
    picks = np.asarray(picks)
    return int(((picks < lo) | (picks > hi)).sum())


def ds_sketch_global(data) -> list[tuple]:
    """``statements.SKETCH_CARD["ds_sketch_global"]``: over store_sales
    joined to item, approx_distinct of the customer (a numeric lane) and
    of the brand (content hashes of the strings), the 0.9 percentile of
    the sales price, max_by / min_by of the item id by net profit (the
    first such sale in scan order), stddev_pop of quantity and bool_and
    of quantity > 0."""
    irow, iok = _dim_rows(
        _ds(data, "item", "i_item_sk"), _ds(data, "store_sales", "ss_item_sk")
    )
    r = irow[iok]
    cust = _ds(data, "store_sales", "ss_customer_sk")[iok].astype(np.int64)
    price = np.sort(_ds(data, "store_sales", "ss_sales_price")[iok].astype(np.int64))
    profit = _ds(data, "store_sales", "ss_net_profit")[iok].astype(np.int64)
    qty = _ds(data, "store_sales", "ss_quantity")[iok].astype(np.int64)
    item_id = _ds(data, "item", "i_item_id").astype(str)[r]
    brand_hash = content_hash64(_ds(data, "item", "i_brand").astype(str))[r]
    n = len(r)
    zeros = np.zeros(n, dtype=np.int64)
    if n == 0:
        return [(0, 0, None, None, None, None, None)]
    at = _percentile_at(np.zeros(1, np.int64), np.asarray([n]), 0.9)[0]
    return [(
        _hll_estimates(zeros, 1, _splitmix64(cust), 4096)[0],
        _hll_estimates(zeros, 1, brand_hash, 4096)[0],
        _dec(int(price[at]), 2),
        str(item_id[int(np.argmax(profit == profit.max()))]),
        str(item_id[int(np.argmax(profit == profit.min()))]),
        _variance(_exact_sum(qty), _exact_sum(qty * qty), n, True, True),
        bool(np.all(qty > 0)),
    )]


def _pairs(left: list, right: list):
    """(left rows, right rows) of the equi-join of two key tuples."""
    lk = np.rec.fromarrays([np.asarray(c, dtype=np.int64) for c in left])
    rk = np.rec.fromarrays([np.asarray(c, dtype=np.int64) for c in right])
    _, inv = np.unique(np.concatenate([lk, rk]), return_inverse=True)
    inv = inv.reshape(-1)
    li, ri = inv[: len(lk)], inv[len(lk):]
    order = np.argsort(ri, kind="stable")
    lo = np.searchsorted(ri[order], li, side="left")
    cnt = np.searchsorted(ri[order], li, side="right") - lo
    lrows = np.repeat(np.arange(len(li)), cnt)
    first = np.repeat(lo - np.r_[0, np.cumsum(cnt)[:-1]], cnt)
    rrows = order[np.arange(len(lrows)) + first]
    return lrows, rrows


def ds_q17_store(data) -> list[tuple]:
    """``statements.SKETCH_CARD["ds_q17_store"]``: TPC-DS q17 without its
    catalog_sales leg, every group: per (item id, store state), count,
    avg and stddev_samp of the sale's quantity and of the returned
    quantity."""
    d_sk = _ds(data, "date_dim", "d_date_sk")
    quarter = _ds(data, "date_dim", "d_quarter_name").astype(str)
    srow, sok = _dim_rows(d_sk, _ds(data, "store_sales", "ss_sold_date_sk"))
    ss_sel = np.flatnonzero(sok & (quarter[srow] == "2001Q1"))
    rrow, rok = _dim_rows(d_sk, _ds(data, "store_returns", "sr_returned_date_sk"))
    sr_sel = np.flatnonzero(
        rok & np.isin(quarter[rrow], ["2001Q1", "2001Q2", "2001Q3"])
    )
    keys = ("customer_sk", "item_sk", "ticket_number")
    li, ri = _pairs(
        [_ds(data, "store_sales", f"ss_{k}")[ss_sel] for k in keys],
        [_ds(data, "store_returns", f"sr_{k}")[sr_sel] for k in keys],
    )
    ss_rows, sr_rows = ss_sel[li], sr_sel[ri]
    irow, iok = _dim_rows(
        _ds(data, "item", "i_item_sk"), _ds(data, "store_sales", "ss_item_sk")[ss_rows]
    )
    strow, stok = _dim_rows(
        _ds(data, "store", "s_store_sk"), _ds(data, "store_sales", "ss_store_sk")[ss_rows]
    )
    ok = iok & stok
    item_id = _ds(data, "item", "i_item_id").astype(str)[irow[ok]]
    state = _ds(data, "store", "s_state").astype(str)[strow[ok]]
    q1 = _ds(data, "store_sales", "ss_quantity")[ss_rows[ok]].astype(np.int64)
    q2 = _ds(data, "store_returns", "sr_return_quantity")[sr_rows[ok]].astype(np.int64)
    uniq, inv = np.unique(np.rec.fromarrays([item_id, state]), return_inverse=True)
    inv = inv.reshape(-1)
    g = len(uniq)
    cnt = np.bincount(inv, minlength=g)
    out = []
    sums = [(_group_sums(inv, q, g), _group_sums(inv, q * q, g)) for q in (q1, q2)]
    for k in range(g):
        row = [str(uniq[k][0]), str(uniq[k][1])]
        for s1, s2 in sums:
            c = int(cnt[k])
            row += [c, float(s1[k]) / c,
                    _variance(int(s1[k]), int(s2[k]), c, False, True)]
        out.append(tuple(row))
    return out


def ds_q39_inv(data) -> list[tuple]:
    """``statements.SKETCH_CARD["ds_q39_inv"]``: count(*), count(stdev),
    sum(stdev) and sum(mean) over q39's inner ``inv`` aggregate
    (stddev_samp and avg of the quantity on hand per warehouse, item and
    month of 2001). The two sums add float64s in the order of the groups
    (the engine's order differs: ``rows_match`` allows relative 1e-9)."""
    drow, dok = _dim_rows(
        _ds(data, "date_dim", "d_date_sk"), _ds(data, "inventory", "inv_date_sk")
    )
    year = _ds(data, "date_dim", "d_year")[drow]
    wrow, wok = _dim_rows(
        _ds(data, "warehouse", "w_warehouse_sk"),
        _ds(data, "inventory", "inv_warehouse_sk"),
    )
    _, iok = _dim_rows(
        _ds(data, "item", "i_item_sk"), _ds(data, "inventory", "inv_item_sk")
    )
    sel = dok & wok & iok & (year == 2001)
    wh = _ds(data, "inventory", "inv_warehouse_sk")[sel].astype(np.int64)
    item = _ds(data, "inventory", "inv_item_sk")[sel].astype(np.int64)
    moy = _ds(data, "date_dim", "d_moy")[drow[sel]].astype(np.int64)
    qoh = _ds(data, "inventory", "inv_quantity_on_hand")[sel].astype(np.int64)
    _, inv = np.unique(np.rec.fromarrays([wh, item, moy]), return_inverse=True)
    inv = inv.reshape(-1)
    g = int(inv.max(initial=-1)) + 1
    cnt = np.bincount(inv, minlength=g)
    s1 = _group_sums(inv, qoh, g)
    s2 = _group_sums(inv, qoh * qoh, g)
    stdev = [_variance(int(a), int(b), int(c), False, True)
             for a, b, c in zip(s1, s2, cnt)]
    have = [s for s in stdev if s is not None]
    means = [float(a) / int(c) for a, c in zip(s1, cnt)]
    return [(g, len(have), math.fsum(have) if have else None,
             math.fsum(means) if means else None)]
