"""Deterministic, vectorized TPC-DS data generation.

The analog of the reference's TPC-DS generator connector
(plugin/trino-tpcds/, backed by the teradata tpcds library): the full
24-table TPC-DS schema (spec column names and types), generated as
numpy columns with the spec's structural rules — a real calendar
date_dim, surrogate-key dimensions, multi-line sales "documents"
(ticket/order numbers repeat across rows), returns drawn as subsets of
sales, weekly inventory snapshots, and internally consistent derived
pricing columns.

Not bit-identical to dsdgen's RNG streams (like tpch/generator.py is
not bit-identical to dbgen) — correctness tests load THIS data into
sqlite, so engine results are checked against golden results over
identical inputs. Columns generate on demand per (table, column) and
cache in memory; tiny scale is sized for tests.
"""

from __future__ import annotations

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.connectors.base import TableSchema
from trino_tpu_torch.types import parse_date

__all__ = ["TpcdsData", "SCHEMAS", "SCHEMA_SF"]

D52 = T.DecimalType(5, 2)
D72 = T.DecimalType(7, 2)
D152 = T.DecimalType(15, 2)
I = T.INTEGER
B = T.BIGINT
V = T.VARCHAR
DT = T.DATE

#: the calendar span covered by date_dim (and the fact sale dates fall
#: in the last five years of it, per the spec's 1998-2002 window)
DATE_LO = parse_date("1990-01-01")
DATE_HI = parse_date("2002-12-31")
SALES_LO = parse_date("1998-01-02")
SALES_HI = parse_date("2002-12-30")
#: spec surrogate key of 1998-01-01 (d_date_sk is a Julian day number)
SK_1998 = 2450815
_JD_OFFSET = SK_1998 - parse_date("1998-01-01")


def date_to_sk(days: np.ndarray | int):
    """DATE (days since epoch) -> d_date_sk (Julian day, spec-aligned)."""
    return days + _JD_OFFSET


#: named schema -> scale factor (mirrors the tpch connector)
SCHEMA_SF = {"tiny": 0.01, "sf1": 1.0, "sf10": 10.0, "sf100": 100.0}

# ---- schema (TPC-DS v2 spec, all 24 tables) --------------------------------

_ADDRESS = [
    ("street_number", V), ("street_name", V), ("street_type", V),
    ("suite_number", V), ("city", V), ("county", V), ("state", V),
    ("zip", V), ("country", V), ("gmt_offset", D52),
]

_SCHEMA_SPEC: dict[str, tuple[str, list[tuple[str, T.DataType]]]] = {
    "call_center": ("cc_", [
        ("call_center_sk", B), ("call_center_id", V),
        ("rec_start_date", DT), ("rec_end_date", DT),
        ("closed_date_sk", B), ("open_date_sk", B), ("name", V),
        ("class", V), ("employees", I), ("sq_ft", I), ("hours", V),
        ("manager", V), ("mkt_id", I), ("mkt_class", V), ("mkt_desc", V),
        ("market_manager", V), ("division", I), ("division_name", V),
        ("company", I), ("company_name", V), *_ADDRESS,
        ("tax_percentage", D52)]),
    "catalog_page": ("cp_", [
        ("catalog_page_sk", B), ("catalog_page_id", V),
        ("start_date_sk", B), ("end_date_sk", B), ("department", V),
        ("catalog_number", I), ("catalog_page_number", I),
        ("description", V), ("type", V)]),
    "catalog_returns": ("cr_", [
        ("returned_date_sk", B), ("returned_time_sk", B), ("item_sk", B),
        ("refunded_customer_sk", B), ("refunded_cdemo_sk", B),
        ("refunded_hdemo_sk", B), ("refunded_addr_sk", B),
        ("returning_customer_sk", B), ("returning_cdemo_sk", B),
        ("returning_hdemo_sk", B), ("returning_addr_sk", B),
        ("call_center_sk", B), ("catalog_page_sk", B), ("ship_mode_sk", B),
        ("warehouse_sk", B), ("reason_sk", B), ("order_number", B),
        ("return_quantity", I), ("return_amount", D72), ("return_tax", D72),
        ("return_amt_inc_tax", D72), ("fee", D72), ("return_ship_cost", D72),
        ("refunded_cash", D72), ("reversed_charge", D72),
        ("store_credit", D72), ("net_loss", D72)]),
    "catalog_sales": ("cs_", [
        ("sold_date_sk", B), ("sold_time_sk", B), ("ship_date_sk", B),
        ("bill_customer_sk", B), ("bill_cdemo_sk", B), ("bill_hdemo_sk", B),
        ("bill_addr_sk", B), ("ship_customer_sk", B), ("ship_cdemo_sk", B),
        ("ship_hdemo_sk", B), ("ship_addr_sk", B), ("call_center_sk", B),
        ("catalog_page_sk", B), ("ship_mode_sk", B), ("warehouse_sk", B),
        ("item_sk", B), ("promo_sk", B), ("order_number", B),
        ("quantity", I), ("wholesale_cost", D72), ("list_price", D72),
        ("sales_price", D72), ("ext_discount_amt", D72),
        ("ext_sales_price", D72), ("ext_wholesale_cost", D72),
        ("ext_list_price", D72), ("ext_tax", D72), ("coupon_amt", D72),
        ("ext_ship_cost", D72), ("net_paid", D72),
        ("net_paid_inc_tax", D72), ("net_paid_inc_ship", D72),
        ("net_paid_inc_ship_tax", D72), ("net_profit", D72)]),
    "customer": ("c_", [
        ("customer_sk", B), ("customer_id", V), ("current_cdemo_sk", B),
        ("current_hdemo_sk", B), ("current_addr_sk", B),
        ("first_shipto_date_sk", B), ("first_sales_date_sk", B),
        ("salutation", V), ("first_name", V), ("last_name", V),
        ("preferred_cust_flag", V), ("birth_day", I), ("birth_month", I),
        ("birth_year", I), ("birth_country", V), ("login", V),
        ("email_address", V), ("last_review_date_sk", B)]),
    "customer_address": ("ca_", [
        ("address_sk", B), ("address_id", V), *_ADDRESS,
        ("location_type", V)]),
    "customer_demographics": ("cd_", [
        ("demo_sk", B), ("gender", V), ("marital_status", V),
        ("education_status", V), ("purchase_estimate", I),
        ("credit_rating", V), ("dep_count", I),
        ("dep_employed_count", I), ("dep_college_count", I)]),
    "date_dim": ("d_", [
        ("date_sk", B), ("date_id", V), ("date", DT), ("month_seq", I),
        ("week_seq", I), ("quarter_seq", I), ("year", I), ("dow", I),
        ("moy", I), ("dom", I), ("qoy", I), ("fy_year", I),
        ("fy_quarter_seq", I), ("fy_week_seq", I), ("day_name", V),
        ("quarter_name", V), ("holiday", V), ("weekend", V),
        ("following_holiday", V), ("first_dom", I), ("last_dom", I),
        ("same_day_ly", I), ("same_day_lq", I), ("current_day", V),
        ("current_week", V), ("current_month", V), ("current_quarter", V),
        ("current_year", V)]),
    "household_demographics": ("hd_", [
        ("demo_sk", B), ("income_band_sk", B), ("buy_potential", V),
        ("dep_count", I), ("vehicle_count", I)]),
    "income_band": ("ib_", [
        ("income_band_sk", B), ("lower_bound", I), ("upper_bound", I)]),
    "inventory": ("inv_", [
        ("date_sk", B), ("item_sk", B), ("warehouse_sk", B),
        ("quantity_on_hand", I)]),
    "item": ("i_", [
        ("item_sk", B), ("item_id", V), ("rec_start_date", DT),
        ("rec_end_date", DT), ("item_desc", V), ("current_price", D72),
        ("wholesale_cost", D72), ("brand_id", I), ("brand", V),
        ("class_id", I), ("class", V), ("category_id", I), ("category", V),
        ("manufact_id", I), ("manufact", V), ("size", V),
        ("formulation", V), ("color", V), ("units", V), ("container", V),
        ("manager_id", I), ("product_name", V)]),
    "promotion": ("p_", [
        ("promo_sk", B), ("promo_id", V), ("start_date_sk", B),
        ("end_date_sk", B), ("item_sk", B), ("cost", D152),
        ("response_target", I), ("promo_name", V), ("channel_dmail", V),
        ("channel_email", V), ("channel_catalog", V), ("channel_tv", V),
        ("channel_radio", V), ("channel_press", V), ("channel_event", V),
        ("channel_demo", V), ("channel_details", V), ("purpose", V),
        ("discount_active", V)]),
    "reason": ("r_", [
        ("reason_sk", B), ("reason_id", V), ("reason_desc", V)]),
    "ship_mode": ("sm_", [
        ("ship_mode_sk", B), ("ship_mode_id", V), ("type", V),
        ("code", V), ("carrier", V), ("contract", V)]),
    "store": ("s_", [
        ("store_sk", B), ("store_id", V), ("rec_start_date", DT),
        ("rec_end_date", DT), ("closed_date_sk", B), ("store_name", V),
        ("number_employees", I), ("floor_space", I), ("hours", V),
        ("manager", V), ("market_id", I), ("geography_class", V),
        ("market_desc", V), ("market_manager", V), ("division_id", I),
        ("division_name", V), ("company_id", I), ("company_name", V),
        *_ADDRESS, ("tax_precentage", D52)]),  # spec's own spelling
    "store_returns": ("sr_", [
        ("returned_date_sk", B), ("return_time_sk", B), ("item_sk", B),
        ("customer_sk", B), ("cdemo_sk", B), ("hdemo_sk", B),
        ("addr_sk", B), ("store_sk", B), ("reason_sk", B),
        ("ticket_number", B), ("return_quantity", I), ("return_amt", D72),
        ("return_tax", D72), ("return_amt_inc_tax", D72), ("fee", D72),
        ("return_ship_cost", D72), ("refunded_cash", D72),
        ("reversed_charge", D72), ("store_credit", D72), ("net_loss", D72)]),
    "store_sales": ("ss_", [
        ("sold_date_sk", B), ("sold_time_sk", B), ("item_sk", B),
        ("customer_sk", B), ("cdemo_sk", B), ("hdemo_sk", B),
        ("addr_sk", B), ("store_sk", B), ("promo_sk", B),
        ("ticket_number", B), ("quantity", I), ("wholesale_cost", D72),
        ("list_price", D72), ("sales_price", D72),
        ("ext_discount_amt", D72), ("ext_sales_price", D72),
        ("ext_wholesale_cost", D72), ("ext_list_price", D72),
        ("ext_tax", D72), ("coupon_amt", D72), ("net_paid", D72),
        ("net_paid_inc_tax", D72), ("net_profit", D72)]),
    "time_dim": ("t_", [
        ("time_sk", B), ("time_id", V), ("time", I), ("hour", I),
        ("minute", I), ("second", I), ("am_pm", V), ("shift", V),
        ("sub_shift", V), ("meal_time", V)]),
    "warehouse": ("w_", [
        ("warehouse_sk", B), ("warehouse_id", V), ("warehouse_name", V),
        ("warehouse_sq_ft", I), *_ADDRESS]),
    "web_page": ("wp_", [
        ("web_page_sk", B), ("web_page_id", V), ("rec_start_date", DT),
        ("rec_end_date", DT), ("creation_date_sk", B),
        ("access_date_sk", B), ("autogen_flag", V), ("customer_sk", B),
        ("url", V), ("type", V), ("char_count", I), ("link_count", I),
        ("image_count", I), ("max_ad_count", I)]),
    "web_returns": ("wr_", [
        ("returned_date_sk", B), ("returned_time_sk", B), ("item_sk", B),
        ("refunded_customer_sk", B), ("refunded_cdemo_sk", B),
        ("refunded_hdemo_sk", B), ("refunded_addr_sk", B),
        ("returning_customer_sk", B), ("returning_cdemo_sk", B),
        ("returning_hdemo_sk", B), ("returning_addr_sk", B),
        ("web_page_sk", B), ("reason_sk", B), ("order_number", B),
        ("return_quantity", I), ("return_amt", D72), ("return_tax", D72),
        ("return_amt_inc_tax", D72), ("fee", D72),
        ("return_ship_cost", D72), ("refunded_cash", D72),
        ("reversed_charge", D72), ("account_credit", D72),
        ("net_loss", D72)]),
    "web_sales": ("ws_", [
        ("sold_date_sk", B), ("sold_time_sk", B), ("ship_date_sk", B),
        ("item_sk", B), ("bill_customer_sk", B), ("bill_cdemo_sk", B),
        ("bill_hdemo_sk", B), ("bill_addr_sk", B),
        ("ship_customer_sk", B), ("ship_cdemo_sk", B),
        ("ship_hdemo_sk", B), ("ship_addr_sk", B), ("web_page_sk", B),
        ("web_site_sk", B), ("ship_mode_sk", B), ("warehouse_sk", B),
        ("promo_sk", B), ("order_number", B), ("quantity", I),
        ("wholesale_cost", D72), ("list_price", D72), ("sales_price", D72),
        ("ext_discount_amt", D72), ("ext_sales_price", D72),
        ("ext_wholesale_cost", D72), ("ext_list_price", D72),
        ("ext_tax", D72), ("coupon_amt", D72), ("ext_ship_cost", D72),
        ("net_paid", D72), ("net_paid_inc_tax", D72),
        ("net_paid_inc_ship", D72), ("net_paid_inc_ship_tax", D72),
        ("net_profit", D72)]),
    "web_site": ("web_", [
        ("site_sk", B), ("site_id", V), ("rec_start_date", DT),
        ("rec_end_date", DT), ("name", V), ("open_date_sk", B),
        ("close_date_sk", B), ("class", V), ("manager", V), ("mkt_id", I),
        ("mkt_class", V), ("mkt_desc", V), ("market_manager", V),
        ("company_id", I), ("company_name", V), *_ADDRESS,
        ("tax_percentage", D52)]),
}

PREFIX = {t: p for t, (p, _) in _SCHEMA_SPEC.items()}

SCHEMAS: dict[str, TableSchema] = {
    t: TableSchema(t, [(p + c, ty) for c, ty in cols])
    for t, (p, cols) in _SCHEMA_SPEC.items()
}

# text pools (arbitrary deterministic vocabulary)
_CATEGORIES = (
    "Books", "Children", "Electronics", "Home", "Jewelry", "Men",
    "Music", "Shoes", "Sports", "Women",
)
_CLASSES = (
    "accessories", "athletic", "baseball", "classical", "computers",
    "dresses", "fiction", "kids", "pants", "romance", "scanners",
    "shirts",
)
_COLORS = (
    "aquamarine", "azure", "beige", "black", "blue", "chartreuse",
    "cream", "cyan", "forest", "gainsboro", "ghost", "green", "indian",
    "ivory", "khaki", "lavender", "magenta", "maroon", "navy", "olive",
    "orange", "orchid", "pale", "peach", "plum", "powder", "puff",
    "rose", "royal", "salmon", "seashell", "sienna", "sky", "slate",
    "smoke", "snow", "spring", "steel", "tan", "thistle", "tomato",
    "turquoise", "violet", "wheat", "white", "yellow",
)
_BUY_POTENTIAL = (
    "0-500", "501-1000", "1001-5000", "5001-10000", ">10000", "Unknown",
)
_EDUCATION = (
    "Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree",
    "Advanced Degree", "Unknown",
)
_CREDIT = ("Low Risk", "High Risk", "Good", "Unknown")
_CITIES = (
    "Fairview", "Midway", "Pleasant Hill", "Centerville", "Oak Grove",
    "Riverside", "Five Points", "Oakland", "Springdale", "Union",
    "Salem", "Georgetown", "Greenville", "Marion", "Glendale",
)
_COUNTIES = (
    "Williamson County", "Walker County", "Ziebach County",
    "Luce County", "Furnas County", "Richland County", "Gage County",
    "Daviess County", "Barrow County", "Franklin Parish",
)
_STATES = (
    "AL", "AR", "CA", "CO", "FL", "GA", "IA", "IL", "IN", "KS", "KY",
    "LA", "MI", "MN", "MO", "MS", "NC", "ND", "NE", "NY", "OH", "OK",
    "OR", "PA", "SC", "SD", "TN", "TX", "VA", "WA", "WI", "WV",
)
_STREETS = (
    "Main", "Oak", "Park", "Elm", "First", "Second", "Third", "Fourth",
    "Maple", "Pine", "Cedar", "Hill", "Lake", "Sunset", "Washington",
    "Jackson", "Lincoln", "Johnson", "Williams", "Davis",
)
_STREET_TYPES = (
    "Street", "Avenue", "Boulevard", "Circle", "Court", "Drive",
    "Lane", "Parkway", "Road", "Way",
)
_DESC_WORDS = (
    "able", "about", "account", "actual", "additional", "available",
    "basic", "careful", "certain", "clear", "common", "complete",
    "correct", "current", "different", "direct", "early", "easy",
    "entire", "exact", "final", "following", "free", "full", "general",
    "good", "great", "important", "large", "little", "local", "long",
    "major", "national", "natural", "necessary", "new", "normal",
    "old", "only", "open", "other", "particular", "political",
    "possible", "present", "private", "public", "real", "recent",
)


class TpcdsData:
    """All 24 TPC-DS tables at one scale factor, columns on demand."""

    def __init__(self, sf: float):
        self.sf = sf
        self._cache: dict[tuple[str, str], np.ndarray] = {}
        self._dates = np.arange(DATE_LO, DATE_HI + 1, dtype=np.int64)
        self._sale_days = np.arange(SALES_LO, SALES_HI + 1, dtype=np.int64)

    # ---- row counts ------------------------------------------------------

    def _n(self, base: int, minimum: int = 1) -> int:
        return max(minimum, round(base * self.sf))

    @property
    def n_item(self) -> int:
        return self._n(18_000, 200)

    @property
    def n_customer(self) -> int:
        return self._n(100_000, 1_000)

    @property
    def n_store(self) -> int:
        return self._n(12, 4)

    @property
    def n_warehouse(self) -> int:
        return self._n(5, 3)

    def row_count(self, table: str) -> int:
        fixed = {
            "date_dim": len(self._dates),
            "time_dim": 86_400,
            "income_band": 20,
            "ship_mode": 20,
            "household_demographics": 7_200,
        }
        if table in fixed:
            return fixed[table]
        if table == "inventory":
            weeks = len(self._sale_days[::7])
            return weeks * self.n_item * self.n_warehouse
        scaled = {
            "call_center": (6, 2),
            "catalog_page": (11_718, 200),
            "catalog_returns": (144_000, 1_500),
            "catalog_sales": (1_440_000, 15_000),
            "customer": (100_000, 1_000),
            "customer_address": (50_000, 500),
            "customer_demographics": (1_920_800, 19_208),
            "item": (18_000, 200),
            "promotion": (300, 10),
            "reason": (35, 5),
            "store": (12, 4),
            "store_returns": (288_000, 3_000),
            "store_sales": (2_880_000, 30_000),
            "warehouse": (5, 3),
            "web_page": (60, 10),
            "web_returns": (72_000, 750),
            "web_sales": (720_000, 7_500),
            "web_site": (30, 2),
        }
        base, minimum = scaled[table]
        return self._n(base, minimum)

    def _rng(self, table: str, stream: str) -> np.random.Generator:
        import zlib

        return np.random.default_rng([
            zlib.crc32(b"tpcds"), zlib.crc32(table.encode()),
            zlib.crc32(stream.encode()), int(self.sf * 1000),
        ])

    # ---- public API ------------------------------------------------------

    def column(self, table: str, name: str) -> np.ndarray:
        prefix = PREFIX[table]
        if name.startswith(prefix):
            name = name[len(prefix):]
        key = (table, name)
        if key not in self._cache:
            arr = self._generate(table, name)
            arr.setflags(write=False)
            self._cache[key] = arr
        return self._cache[key]

    def table(self, table: str) -> dict[str, np.ndarray]:
        return {c: self.column(table, c) for c in SCHEMAS[table].column_names}

    # ---- generic generators ----------------------------------------------

    def _generate(self, table: str, name: str) -> np.ndarray:
        special = getattr(self, f"_{table}__{name}", None)
        if special is not None:
            return special()
        n = self.row_count(table)
        rng = self._rng(table, name)
        prefix, cols = _SCHEMA_SPEC[table]
        typ = dict(cols).get(name)
        if typ is None:
            raise KeyError(f"no column {table}.{prefix}{name}")
        # structural defaults by column-name convention
        if name.endswith("_sk") and name == _sk_name(table):
            return np.arange(1, n + 1, dtype=np.int64)
        if name.endswith("_id") and isinstance(typ, T.VarcharType):
            # business-key strings only for VARCHAR ids; numeric *_id
            # columns (market_id, brand_id, manager_id...) fall through
            # to the integer generator
            return np.array(
                [f"{prefix.upper()}{i:012d}" for i in range(1, n + 1)],
                dtype=object,
            )
        if name.endswith("_sk"):
            dim = _FK_TARGET.get(name)
            if dim is not None:
                return self._fk_values(dim, rng, n)
            return rng.integers(1, n + 1, n).astype(np.int64)
        if isinstance(typ, T.DateType):
            return rng.choice(self._dates, n)
        if isinstance(typ, T.DecimalType):
            return rng.integers(0, 100_00, n).astype(np.int64)
        if isinstance(typ, T.IntegerKind):
            return rng.integers(0, 1000, n).astype(np.int64)
        # varchar: pooled words by convention
        pool = _TEXT_POOLS.get(name, _DESC_WORDS)
        return np.asarray(pool, dtype=object)[
            rng.integers(0, len(pool), n)
        ].astype(object)

    def _fk_values(self, dim: str, rng, n: int) -> np.ndarray:
        """Random foreign keys drawn from the dimension's ACTUAL key
        domain: date_dim keys are Julian-day numbers and time_dim keys
        are 0-based — a naive 1..row_count draw would never join."""
        if dim == "date_dim":
            return rng.choice(date_to_sk(self._dates), n)
        if dim == "time_dim":
            return rng.integers(0, 86_400, n).astype(np.int64)
        return rng.integers(1, self.row_count(dim) + 1, n).astype(np.int64)

    # ---- date_dim: a real calendar ---------------------------------------

    def _date_dim__date_sk(self):
        return date_to_sk(self._dates)

    def _date_dim__date(self):
        return self._dates.copy()

    def _date_dim__date_id(self):
        return np.array(
            [f"D{int(sk)}" for sk in date_to_sk(self._dates)], dtype=object
        )

    def _ymd(self):
        # vectorized civil calendar from days-since-epoch
        days = self._dates
        import datetime

        base = datetime.date(1970, 1, 1)
        ymd = np.array([
            (base + datetime.timedelta(days=int(d))).timetuple()[:3]
            for d in days
        ])
        return ymd[:, 0], ymd[:, 1], ymd[:, 2]

    def _date_dim__year(self):
        y, _, _ = self._ymd_cached()
        return y.astype(np.int64)

    def _ymd_cached(self):
        if not hasattr(self, "_ymd_memo"):
            self._ymd_memo = self._ymd()
        return self._ymd_memo

    def _date_dim__moy(self):
        _, m, _ = self._ymd_cached()
        return m.astype(np.int64)

    def _date_dim__dom(self):
        _, _, d = self._ymd_cached()
        return d.astype(np.int64)

    def _date_dim__qoy(self):
        _, m, _ = self._ymd_cached()
        return ((m - 1) // 3 + 1).astype(np.int64)

    def _date_dim__dow(self):
        # 1970-01-01 was a Thursday; spec dow 0 = Sunday
        return ((self._dates + 4) % 7).astype(np.int64)

    def _date_dim__week_seq(self):
        # weeks since the calendar start, Sunday-aligned (spec counts
        # from its own epoch; only equality/joins matter)
        return ((self._dates - DATE_LO + self._date_dim__dow()[0]) // 7 + 1).astype(np.int64)

    def _date_dim__month_seq(self):
        y, m, _ = self._ymd_cached()
        return ((y - 1990) * 12 + (m - 1)).astype(np.int64)

    def _date_dim__quarter_seq(self):
        y, m, _ = self._ymd_cached()
        return ((y - 1990) * 4 + (m - 1) // 3).astype(np.int64)

    def _date_dim__fy_year(self):
        return self._date_dim__year()

    def _date_dim__fy_quarter_seq(self):
        return self._date_dim__quarter_seq()

    def _date_dim__fy_week_seq(self):
        return self._date_dim__week_seq()

    def _date_dim__day_name(self):
        names = np.asarray([
            "Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
            "Friday", "Saturday",
        ], dtype=object)
        return names[self._date_dim__dow()]

    def _date_dim__quarter_name(self):
        y, m, _ = self._ymd_cached()
        return np.array(
            [f"{yy}Q{(mm - 1) // 3 + 1}" for yy, mm in zip(y, m)],
            dtype=object,
        )

    def _date_dim__holiday(self):
        _, m, d = self._ymd_cached()
        hol = ((m == 12) & (d == 25)) | ((m == 1) & (d == 1)) | (
            (m == 7) & (d == 4)
        )
        return np.where(hol, "Y", "N").astype(object)

    def _date_dim__weekend(self):
        dow = self._date_dim__dow()
        return np.where((dow == 0) | (dow == 6), "Y", "N").astype(object)

    def _date_dim__following_holiday(self):
        h = self._date_dim__holiday()
        return np.concatenate([["N"], h[:-1]]).astype(object)

    def _date_dim__first_dom(self):
        _, _, d = self._ymd_cached()
        return date_to_sk(self._dates - (d - 1))

    def _date_dim__last_dom(self):
        # approximation: sk of this month's 28th (only ordering is used)
        _, _, d = self._ymd_cached()
        return date_to_sk(self._dates - (d - 1) + 27)

    def _date_dim__same_day_ly(self):
        return date_to_sk(self._dates - 365)

    def _date_dim__same_day_lq(self):
        return date_to_sk(self._dates - 91)

    def _date_dim__current_day(self):
        return np.full(len(self._dates), "N", dtype=object)

    _date_dim__current_week = _date_dim__current_day
    _date_dim__current_month = _date_dim__current_day
    _date_dim__current_quarter = _date_dim__current_day
    _date_dim__current_year = _date_dim__current_day

    # ---- time_dim --------------------------------------------------------

    def _time_dim__time_sk(self):
        return np.arange(86_400, dtype=np.int64)

    def _time_dim__time(self):
        return np.arange(86_400, dtype=np.int64)

    def _time_dim__hour(self):
        return (np.arange(86_400) // 3600).astype(np.int64)

    def _time_dim__minute(self):
        return ((np.arange(86_400) % 3600) // 60).astype(np.int64)

    def _time_dim__second(self):
        return (np.arange(86_400) % 60).astype(np.int64)

    def _time_dim__am_pm(self):
        return np.where(np.arange(86_400) < 43_200, "AM", "PM").astype(object)

    def _time_dim__shift(self):
        h = self._time_dim__hour()
        return np.select(
            [h < 8, h < 16], ["third", "first"], "second"
        ).astype(object)

    def _time_dim__sub_shift(self):
        h = self._time_dim__hour()
        return np.select(
            [h < 6, h < 12, h < 18], ["night", "morning", "afternoon"],
            "evening",
        ).astype(object)

    def _time_dim__meal_time(self):
        h = self._time_dim__hour()
        return np.select(
            [(h >= 6) & (h < 9), (h >= 11) & (h < 14), (h >= 17) & (h < 21)],
            ["breakfast", "lunch", "dinner"], "",
        ).astype(object)

    # ---- income_band / demographics --------------------------------------

    def _income_band__lower_bound(self):
        return (np.arange(20, dtype=np.int64)) * 10_000

    def _income_band__upper_bound(self):
        return (np.arange(20, dtype=np.int64) + 1) * 10_000 - 1

    def _household_demographics__income_band_sk(self):
        return (np.arange(7_200, dtype=np.int64) % 20) + 1

    def _household_demographics__buy_potential(self):
        return np.asarray(_BUY_POTENTIAL, dtype=object)[
            np.arange(7_200) % len(_BUY_POTENTIAL)
        ]

    def _household_demographics__dep_count(self):
        return (np.arange(7_200, dtype=np.int64) // 6) % 10

    def _household_demographics__vehicle_count(self):
        return (np.arange(7_200, dtype=np.int64) // 60) % 5

    def _customer_demographics__gender(self):
        n = self.row_count("customer_demographics")
        return np.where(np.arange(n) % 2 == 0, "M", "F").astype(object)

    def _customer_demographics__marital_status(self):
        n = self.row_count("customer_demographics")
        pool = np.asarray(["M", "S", "D", "W", "U"], dtype=object)
        return pool[(np.arange(n) // 2) % 5]

    def _customer_demographics__education_status(self):
        n = self.row_count("customer_demographics")
        pool = np.asarray(_EDUCATION, dtype=object)
        return pool[(np.arange(n) // 10) % len(pool)]

    def _customer_demographics__credit_rating(self):
        n = self.row_count("customer_demographics")
        pool = np.asarray(_CREDIT, dtype=object)
        return pool[(np.arange(n) // 70) % len(pool)]

    def _customer_demographics__dep_count(self):
        n = self.row_count("customer_demographics")
        return ((np.arange(n, dtype=np.int64) // 280) % 7)

    def _customer_demographics__purchase_estimate(self):
        n = self.row_count("customer_demographics")
        return ((np.arange(n, dtype=np.int64) // 1960) % 20 + 1) * 500

    # ---- item ------------------------------------------------------------

    def _item__brand_id(self):
        rng = self._rng("item", "brand_id")
        return rng.integers(1_001_001, 1_010_016, self.n_item).astype(np.int64)

    def _item__brand(self):
        bid = self.column("item", "brand_id")
        return np.array(
            [f"brand#{int(b) % 1000}" for b in bid], dtype=object
        )

    def _item__category_id(self):
        rng = self._rng("item", "category_id")
        return rng.integers(1, len(_CATEGORIES) + 1, self.n_item).astype(np.int64)

    def _item__category(self):
        cid = self.column("item", "category_id")
        return np.asarray(_CATEGORIES, dtype=object)[cid - 1]

    def _item__class_id(self):
        rng = self._rng("item", "class_id")
        return rng.integers(1, len(_CLASSES) + 1, self.n_item).astype(np.int64)

    def _item__class(self):
        cid = self.column("item", "class_id")
        return np.asarray(_CLASSES, dtype=object)[cid - 1]

    def _item__manufact_id(self):
        rng = self._rng("item", "manufact_id")
        return rng.integers(1, 1_000, self.n_item).astype(np.int64)

    def _item__manufact(self):
        mid = self.column("item", "manufact_id")
        return np.array([f"manufact#{int(m)}" for m in mid], dtype=object)

    def _item__manager_id(self):
        rng = self._rng("item", "manager_id")
        return rng.integers(1, 101, self.n_item).astype(np.int64)

    def _item__current_price(self):
        rng = self._rng("item", "current_price")
        return rng.integers(100, 300_00, self.n_item).astype(np.int64)

    def _item__item_desc(self):
        rng = self._rng("item", "item_desc")
        words = np.asarray(_DESC_WORDS, dtype=object)
        k = 6
        picks = words[rng.integers(0, len(words), (self.n_item, k))]
        return np.array([" ".join(row) for row in picks], dtype=object)

    def _item__color(self):
        rng = self._rng("item", "color")
        return np.asarray(_COLORS, dtype=object)[
            rng.integers(0, len(_COLORS), self.n_item)
        ]

    # ---- sales facts: shared document structure --------------------------

    def _doc_lines(self, table: str, avg_lines: int):
        """(doc_id_per_row, line_count) — multi-line sales documents
        (ticket/order numbers repeating over consecutive rows)."""
        n = self.row_count(table)
        rng = self._rng(table, "doc")
        lens = rng.integers(1, 2 * avg_lines, n)  # enough docs to cover
        ends = np.cumsum(lens)
        doc_of_row = np.searchsorted(ends, np.arange(n), side="right")
        return (doc_of_row + 1).astype(np.int64)

    def _sold_date_sk(self, table: str):
        n = self.row_count(table)
        rng = self._rng(table, "sold_date")
        # one sale date per document so date filters align per order
        doc = self.column(table, _DOC_COL[table])
        n_docs = int(doc.max()) if n else 1
        doc_dates = rng.choice(self._sale_days, n_docs + 1)
        return date_to_sk(doc_dates[doc - 1])

    def _fact_prices(self, table: str, qty_col: str):
        """Internally consistent pricing block for one sales fact."""
        n = self.row_count(table)
        rng = self._rng(table, "pricing")
        qty = self.column(table, qty_col).astype(np.int64)
        wholesale = rng.integers(1_00, 100_00, n)
        markup = rng.integers(110, 220, n)
        list_p = wholesale * markup // 100
        discount = rng.integers(0, 60, n)
        sales_p = list_p * (100 - discount) // 100
        return qty, wholesale, list_p, sales_p

    # store_sales ----------------------------------------------------------

    def _store_sales__ticket_number(self):
        return self._doc_lines("store_sales", 10)

    def _store_sales__sold_date_sk(self):
        return self._sold_date_sk("store_sales")

    def _store_sales__quantity(self):
        rng = self._rng("store_sales", "quantity")
        return rng.integers(1, 101, self.row_count("store_sales")).astype(np.int64)

    def _store_sales__wholesale_cost(self):
        return self._fact_prices("store_sales", "quantity")[1]

    def _store_sales__list_price(self):
        return self._fact_prices("store_sales", "quantity")[2]

    def _store_sales__sales_price(self):
        return self._fact_prices("store_sales", "quantity")[3]

    def _store_sales__ext_discount_amt(self):
        q, _, lp, sp = self._fact_prices("store_sales", "quantity")
        return q * (lp - sp)

    def _store_sales__ext_sales_price(self):
        q, _, _, sp = self._fact_prices("store_sales", "quantity")
        return q * sp

    def _store_sales__ext_wholesale_cost(self):
        q, w, _, _ = self._fact_prices("store_sales", "quantity")
        return q * w

    def _store_sales__ext_list_price(self):
        q, _, lp, _ = self._fact_prices("store_sales", "quantity")
        return q * lp

    def _store_sales__ext_tax(self):
        return self._store_sales__ext_sales_price() * 8 // 100

    def _store_sales__coupon_amt(self):
        rng = self._rng("store_sales", "coupon")
        ext = self._store_sales__ext_sales_price()
        has = rng.random(len(ext)) < 0.1
        return np.where(has, ext // 10, 0)

    def _store_sales__net_paid(self):
        return (
            self._store_sales__ext_sales_price()
            - self._store_sales__coupon_amt()
        )

    def _store_sales__net_paid_inc_tax(self):
        return self._store_sales__net_paid() + self._store_sales__ext_tax()

    def _store_sales__net_profit(self):
        return (
            self._store_sales__net_paid()
            - self._store_sales__ext_wholesale_cost()
        )

    # catalog_sales / web_sales share the structure -------------------------

    def _catalog_sales__order_number(self):
        return self._doc_lines("catalog_sales", 6)

    def _catalog_sales__sold_date_sk(self):
        return self._sold_date_sk("catalog_sales")

    def _catalog_sales__ship_date_sk(self):
        rng = self._rng("catalog_sales", "ship_lag")
        lag = rng.integers(2, 90, self.row_count("catalog_sales"))
        return self.column("catalog_sales", "sold_date_sk") + lag

    def _catalog_sales__quantity(self):
        rng = self._rng("catalog_sales", "quantity")
        return rng.integers(1, 101, self.row_count("catalog_sales")).astype(np.int64)

    def _catalog_sales__wholesale_cost(self):
        return self._fact_prices("catalog_sales", "quantity")[1]

    def _catalog_sales__list_price(self):
        return self._fact_prices("catalog_sales", "quantity")[2]

    def _catalog_sales__sales_price(self):
        return self._fact_prices("catalog_sales", "quantity")[3]

    def _catalog_sales__ext_discount_amt(self):
        q, _, lp, sp = self._fact_prices("catalog_sales", "quantity")
        return q * (lp - sp)

    def _catalog_sales__ext_sales_price(self):
        q, _, _, sp = self._fact_prices("catalog_sales", "quantity")
        return q * sp

    def _catalog_sales__ext_wholesale_cost(self):
        q, w, _, _ = self._fact_prices("catalog_sales", "quantity")
        return q * w

    def _catalog_sales__ext_list_price(self):
        q, _, lp, _ = self._fact_prices("catalog_sales", "quantity")
        return q * lp

    def _catalog_sales__ext_tax(self):
        return self._catalog_sales__ext_sales_price() * 8 // 100

    def _catalog_sales__coupon_amt(self):
        rng = self._rng("catalog_sales", "coupon")
        ext = self._catalog_sales__ext_sales_price()
        has = rng.random(len(ext)) < 0.1
        return np.where(has, ext // 10, 0)

    def _catalog_sales__ext_ship_cost(self):
        return self._catalog_sales__ext_sales_price() // 20

    def _catalog_sales__net_paid(self):
        return (
            self._catalog_sales__ext_sales_price()
            - self._catalog_sales__coupon_amt()
        )

    def _catalog_sales__net_paid_inc_tax(self):
        return (
            self._catalog_sales__net_paid()
            + self._catalog_sales__ext_tax()
        )

    def _catalog_sales__net_paid_inc_ship(self):
        return (
            self._catalog_sales__net_paid()
            + self._catalog_sales__ext_ship_cost()
        )

    def _catalog_sales__net_paid_inc_ship_tax(self):
        return (
            self._catalog_sales__net_paid_inc_ship()
            + self._catalog_sales__ext_tax()
        )

    def _catalog_sales__net_profit(self):
        return (
            self._catalog_sales__net_paid()
            - self._catalog_sales__ext_wholesale_cost()
        )

    def _web_sales__order_number(self):
        return self._doc_lines("web_sales", 4)

    def _web_sales__sold_date_sk(self):
        return self._sold_date_sk("web_sales")

    def _web_sales__ship_date_sk(self):
        rng = self._rng("web_sales", "ship_lag")
        lag = rng.integers(1, 120, self.row_count("web_sales"))
        return self.column("web_sales", "sold_date_sk") + lag

    def _web_sales__quantity(self):
        rng = self._rng("web_sales", "quantity")
        return rng.integers(1, 101, self.row_count("web_sales")).astype(np.int64)

    def _web_sales__wholesale_cost(self):
        return self._fact_prices("web_sales", "quantity")[1]

    def _web_sales__list_price(self):
        return self._fact_prices("web_sales", "quantity")[2]

    def _web_sales__sales_price(self):
        return self._fact_prices("web_sales", "quantity")[3]

    def _web_sales__ext_discount_amt(self):
        q, _, lp, sp = self._fact_prices("web_sales", "quantity")
        return q * (lp - sp)

    def _web_sales__ext_sales_price(self):
        q, _, _, sp = self._fact_prices("web_sales", "quantity")
        return q * sp

    def _web_sales__ext_wholesale_cost(self):
        q, w, _, _ = self._fact_prices("web_sales", "quantity")
        return q * w

    def _web_sales__ext_list_price(self):
        q, _, lp, _ = self._fact_prices("web_sales", "quantity")
        return q * lp

    def _web_sales__ext_tax(self):
        return self._web_sales__ext_sales_price() * 8 // 100

    def _web_sales__coupon_amt(self):
        rng = self._rng("web_sales", "coupon")
        ext = self._web_sales__ext_sales_price()
        has = rng.random(len(ext)) < 0.1
        return np.where(has, ext // 10, 0)

    def _web_sales__ext_ship_cost(self):
        return self._web_sales__ext_sales_price() // 20

    def _web_sales__net_paid(self):
        return (
            self._web_sales__ext_sales_price()
            - self._web_sales__coupon_amt()
        )

    def _web_sales__net_paid_inc_tax(self):
        return self._web_sales__net_paid() + self._web_sales__ext_tax()

    def _web_sales__net_paid_inc_ship(self):
        return (
            self._web_sales__net_paid() + self._web_sales__ext_ship_cost()
        )

    def _web_sales__net_paid_inc_ship_tax(self):
        return (
            self._web_sales__net_paid_inc_ship()
            + self._web_sales__ext_tax()
        )

    def _web_sales__net_profit(self):
        return (
            self._web_sales__net_paid()
            - self._web_sales__ext_wholesale_cost()
        )

    # returns: subsets of the matching sales fact ---------------------------

    def _returns_pick(self, ret_table: str, sales_table: str):
        """Row indices into the sales fact that were returned."""
        n_ret = self.row_count(ret_table)
        n_sales = self.row_count(sales_table)
        rng = self._rng(ret_table, "pick")
        return rng.choice(n_sales, size=min(n_ret, n_sales), replace=False)

    def _ret_from_sales(self, ret_table, sales_table, col):
        pick = self._returns_pick(ret_table, sales_table)
        return self.column(sales_table, col)[pick]

    def _store_returns__ticket_number(self):
        return self._ret_from_sales(
            "store_returns", "store_sales", "ticket_number"
        )

    def _store_returns__item_sk(self):
        return self._ret_from_sales("store_returns", "store_sales", "item_sk")

    def _store_returns__customer_sk(self):
        return self._ret_from_sales(
            "store_returns", "store_sales", "customer_sk"
        )

    def _store_returns__store_sk(self):
        return self._ret_from_sales("store_returns", "store_sales", "store_sk")

    def _store_returns__returned_date_sk(self):
        rng = self._rng("store_returns", "lag")
        sold = self._ret_from_sales(
            "store_returns", "store_sales", "sold_date_sk"
        )
        return sold + rng.integers(1, 60, len(sold))

    def _store_returns__return_quantity(self):
        rng = self._rng("store_returns", "rq")
        q = self._ret_from_sales("store_returns", "store_sales", "quantity")
        return np.maximum(1, q * rng.integers(1, 101, len(q)) // 100)

    def _catalog_returns__order_number(self):
        return self._ret_from_sales(
            "catalog_returns", "catalog_sales", "order_number"
        )

    def _catalog_returns__item_sk(self):
        return self._ret_from_sales(
            "catalog_returns", "catalog_sales", "item_sk"
        )

    def _catalog_returns__returned_date_sk(self):
        rng = self._rng("catalog_returns", "lag")
        sold = self._ret_from_sales(
            "catalog_returns", "catalog_sales", "sold_date_sk"
        )
        return sold + rng.integers(1, 60, len(sold))

    def _catalog_returns__return_quantity(self):
        rng = self._rng("catalog_returns", "rq")
        q = self._ret_from_sales(
            "catalog_returns", "catalog_sales", "quantity"
        )
        return np.maximum(1, q * rng.integers(1, 101, len(q)) // 100)

    def _web_returns__order_number(self):
        return self._ret_from_sales(
            "web_returns", "web_sales", "order_number"
        )

    def _web_returns__item_sk(self):
        return self._ret_from_sales("web_returns", "web_sales", "item_sk")

    def _web_returns__returned_date_sk(self):
        rng = self._rng("web_returns", "lag")
        sold = self._ret_from_sales(
            "web_returns", "web_sales", "sold_date_sk"
        )
        return sold + rng.integers(1, 60, len(sold))

    def _web_returns__return_quantity(self):
        rng = self._rng("web_returns", "rq")
        q = self._ret_from_sales("web_returns", "web_sales", "quantity")
        return np.maximum(1, q * rng.integers(1, 101, len(q)) // 100)

    # inventory: weekly snapshots -------------------------------------------

    def _inventory__date_sk(self):
        weeks = date_to_sk(self._sale_days[::7])
        per_week = self.n_item * self.n_warehouse
        return np.repeat(weeks, per_week)

    def _inventory__item_sk(self):
        weeks = len(self._sale_days[::7])
        block = np.repeat(
            np.arange(1, self.n_item + 1, dtype=np.int64), self.n_warehouse
        )
        return np.tile(block, weeks)

    def _inventory__warehouse_sk(self):
        weeks = len(self._sale_days[::7])
        block = np.tile(
            np.arange(1, self.n_warehouse + 1, dtype=np.int64), self.n_item
        )
        return np.tile(block, weeks)

    def _inventory__quantity_on_hand(self):
        rng = self._rng("inventory", "qoh")
        return rng.integers(0, 1000, self.row_count("inventory")).astype(np.int64)

    # promotion -------------------------------------------------------------

    def _promotion__channel_dmail(self):
        rng = self._rng("promotion", "dmail")
        return np.where(
            rng.random(self.row_count("promotion")) < 0.5, "Y", "N"
        ).astype(object)

    _promotion__channel_email = _promotion__channel_dmail
    _promotion__channel_tv = _promotion__channel_dmail


def _sk_name(table: str) -> str:
    """The table's own surrogate-key column (bare name)."""
    return {
        "call_center": "call_center_sk",
        "catalog_page": "catalog_page_sk",
        "customer": "customer_sk",
        "customer_address": "address_sk",
        "customer_demographics": "demo_sk",
        "date_dim": "date_sk",
        "household_demographics": "demo_sk",
        "income_band": "income_band_sk",
        "item": "item_sk",
        "promotion": "promo_sk",
        "reason": "reason_sk",
        "ship_mode": "ship_mode_sk",
        "store": "store_sk",
        "time_dim": "time_sk",
        "warehouse": "warehouse_sk",
        "web_page": "web_page_sk",
        "web_site": "site_sk",
    }.get(table, "\x00none")


#: fk column (bare name) -> referenced table
_FK_TARGET = {
    "sold_date_sk": "date_dim", "ship_date_sk": "date_dim",
    "returned_date_sk": "date_dim", "sold_time_sk": "time_dim",
    "returned_time_sk": "time_dim", "return_time_sk": "time_dim",
    "item_sk": "item",
    "customer_sk": "customer", "bill_customer_sk": "customer",
    "ship_customer_sk": "customer", "refunded_customer_sk": "customer",
    "returning_customer_sk": "customer",
    "cdemo_sk": "customer_demographics",
    "bill_cdemo_sk": "customer_demographics",
    "ship_cdemo_sk": "customer_demographics",
    "refunded_cdemo_sk": "customer_demographics",
    "returning_cdemo_sk": "customer_demographics",
    "current_cdemo_sk": "customer_demographics",
    "hdemo_sk": "household_demographics",
    "bill_hdemo_sk": "household_demographics",
    "ship_hdemo_sk": "household_demographics",
    "refunded_hdemo_sk": "household_demographics",
    "returning_hdemo_sk": "household_demographics",
    "current_hdemo_sk": "household_demographics",
    "addr_sk": "customer_address", "bill_addr_sk": "customer_address",
    "ship_addr_sk": "customer_address",
    "refunded_addr_sk": "customer_address",
    "returning_addr_sk": "customer_address",
    "current_addr_sk": "customer_address",
    "store_sk": "store", "promo_sk": "promotion",
    "warehouse_sk": "warehouse", "call_center_sk": "call_center",
    "catalog_page_sk": "catalog_page", "ship_mode_sk": "ship_mode",
    "reason_sk": "reason", "web_page_sk": "web_page",
    "web_site_sk": "web_site", "site_sk": "web_site",
    "income_band_sk": "income_band",
    "first_shipto_date_sk": "date_dim",
    "first_sales_date_sk": "date_dim",
    "last_review_date_sk": "date_dim",
    "open_date_sk": "date_dim", "closed_date_sk": "date_dim",
    "close_date_sk": "date_dim", "start_date_sk": "date_dim",
    "end_date_sk": "date_dim", "creation_date_sk": "date_dim",
    "access_date_sk": "date_dim",
}

#: per-fact document-number column (bare name)
_DOC_COL = {
    "store_sales": "ticket_number",
    "catalog_sales": "order_number",
    "web_sales": "order_number",
}

#: text pools keyed by bare column name (fallback: _DESC_WORDS)
_TEXT_POOLS = {
    "city": _CITIES, "county": _COUNTIES, "state": _STATES,
    "street_name": _STREETS, "street_type": _STREET_TYPES,
    "country": ("United States",),
    "gender": ("M", "F"),
    "marital_status": ("M", "S", "D", "W", "U"),
    "education_status": _EDUCATION,
    "credit_rating": _CREDIT,
    "buy_potential": _BUY_POTENTIAL,
    "preferred_cust_flag": ("Y", "N"),
    "salutation": ("Mr.", "Mrs.", "Ms.", "Dr.", "Sir", "Miss"),
    "first_name": (
        "James", "John", "Robert", "Michael", "William", "David", "Mary",
        "Patricia", "Linda", "Barbara", "Elizabeth", "Jennifer",
    ),
    "last_name": (
        "Smith", "Johnson", "Williams", "Brown", "Jones", "Garcia",
        "Miller", "Davis", "Rodriguez", "Martinez", "Lopez", "Wilson",
    ),
    "birth_country": (
        "United States", "Canada", "Mexico", "Brazil", "Germany",
        "France", "Japan", "India", "China", "Australia",
    ),
    "color": _COLORS,
    "category": _CATEGORIES,
    "class": _CLASSES,
    "size": ("small", "medium", "large", "extra large", "petite", "N/A"),
    "units": ("Each", "Dozen", "Case", "Pallet", "Gross", "Box"),
    "container": ("Unknown", "Small Box", "Large Box", "Tub", "Crate"),
    "type": (
        "EXPRESS", "LIBRARY", "OVERNIGHT", "REGULAR", "TWO DAY",
        "NEXT DAY",
    ),
    "carrier": (
        "UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "TBS", "ZHOU",
        "LATVIAN",
    ),
    "am_pm": ("AM", "PM"),
    "hours": ("8AM-4PM", "8AM-8PM", "8AM-12AM"),
    "store_name": ("ought", "able", "pri", "ese", "anti", "cally"),
    "warehouse_name": (
        "Conventional childr", "Important issues liv", "Doors canno",
        "Bad cards must make.", "Operations can hide",
    ),
    "promo_name": ("ought", "able", "pri", "ese", "anti", "bar"),
    "purpose": ("Unknown", "ad hoc", "to build", "business"),
    "reason_desc": (
        "Package was damaged", "Stopped working", "Did not fit",
        "Not the product that was ordred", "Parts missing",
        "Found a better price in a store", "Gift exchange",
    ),
    "location_type": ("apartment", "condo", "single family"),
    "day_name": (
        "Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
        "Friday", "Saturday",
    ),
}
