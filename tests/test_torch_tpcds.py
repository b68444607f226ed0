"""TPC-DS and the window and set-operation statements through the port
(``trino_tpu_torch``, on the CPU) against sqlite, the JAX package and the
numpy references, at ``tiny``.

- The 12 queries of ``tests/test_tpcds_queries.py``'s ``SMOKE_LOCAL`` and
  the 15 TPC-DS queries with window functions run through
  ``QueryRunner.tpcds("tiny", device="cpu")`` against sqlite, with the
  same oracle forms and ``abs_tol`` as ``tests/test_tpcds_queries.py``.
- The statements the card runs (q3, q98, q51 over 1999's months and the
  totals of its windowed relation, q86, ``RANGE7_SQL``) must also equal
  the JAX package's rows exactly (a DOUBLE to relative 1e-9) and their
  numpy references (``numpy_reference.rows_match``). q51 as written
  filters ``d_month_seq`` between 1200 and 1211, months this generator
  does not have (it counts from 1990), so it runs at 108 (1999), where it
  has rows.
- The window and set-operation statements of
  ``tests/test_window_setops.py`` (``statements.WINDOW_STATEMENTS``, TPC-H
  ``tiny``) equal the JAX package's rows and match sqlite.
- Each TPC-DS numpy reference matches sqlite.
- TPC-DS q17 and q39 (stddev_samp) as written equal the JAX package's
  rows: none at ``tiny``, since q17's three-way store / returns / catalog
  match is empty in this generator and q39's ``cov > 1`` never holds
  (``inv_quantity_on_hand`` is uniform on [0, 1000)). So the card holds
  relations of theirs that have rows (``statements.SKETCH_CARD``:
  ``ds_q17_store``, ``ds_q39_inv``) beside two statements of the sketch
  and ``*_by`` aggregates over store_sales; these equal the JAX
  package's rows (a DOUBLE to relative 1e-9) and their numpy references.
- The other TPC-DS queries run against sqlite under the JAX package's
  ``tpcds_full`` marker (which implies slow): ``-m tpcds_full``.
"""

import math

import pytest

from trino_tpu.connectors.tpcds.queries import QUERIES as JAX_DS_QUERIES
from trino_tpu.engine import QueryRunner as JaxRunner
from trino_tpu.testing.golden import (
    assert_rows_match, load_tpcds_sqlite, load_tpch_sqlite, sqlite_supports,
    to_sqlite,
)
from trino_tpu_torch.connectors.tpcds.queries import QUERIES, SQLITE_ORACLE
from trino_tpu_torch.engine import QueryRunner as TorchRunner
from trino_tpu_torch.testing import numpy_reference as R
from trino_tpu_torch.testing.statements import (
    SKETCH_CARD, SQLITE_FORMS, WINDOW_STATEMENTS,
)

SMOKE_LOCAL = [
    "q3", "q7", "q19", "q25", "q42", "q52", "q55", "q68", "q72", "q95",
    "q96", "q98",
]
WINDOW_QUERIES = [
    "q12", "q20", "q36", "q44", "q47", "q49", "q51", "q53", "q57", "q63",
    "q67", "q70", "q86", "q89", "q98",
]

#: the card's TPC-DS statements: (SQL, numpy reference)
CARD = {
    "ds_q03": (QUERIES["q3"], R.ds_q03),
    "ds_q98": (QUERIES["q98"], R.ds_q98),
    "ds_q51": (R.q51_sql(108), R.ds_q51),
    "ds_q51_totals": (R.q51_totals_sql(108), R.ds_q51_totals),
    "ds_q86": (QUERIES["q86"], R.ds_q86),
    "ds_range7": (R.RANGE7_SQL, R.ds_range7),
}
#: the TPC-DS queries outside the tier-1 sets: the long tail
LONG_TAIL = sorted(
    set(QUERIES) - set(SMOKE_LOCAL) - set(WINDOW_QUERIES) - {"q17", "q39"},
    key=lambda q: int(q[1:]),
)
#: rows of the aggregate functions' card statements at tiny
SKETCH_ROWS = {
    "ds_sketch_item": 200, "ds_sketch_global": 1, "ds_q17_store": 125,
    "ds_q39_inv": 1,
}
#: sqlite forms where the engine's text needs one (ROLLUP)
CARD_SQLITE = {"ds_q86": SQLITE_ORACLE["q86"]}
#: statements whose sqlite comparison needs FULL OUTER JOIN
NEEDS_FULL_JOIN = {"q51", "ds_q51", "ds_q51_totals"}


@pytest.fixture(scope="module")
def torch_ds():
    return TorchRunner.tpcds("tiny", device="cpu")


@pytest.fixture(scope="module")
def jax_ds():
    return JaxRunner.tpcds("tiny")


@pytest.fixture(scope="module")
def ds_data(torch_ds):
    return torch_ds.metadata.connector("tpcds").data("tiny")


@pytest.fixture(scope="module")
def ds_oracle(ds_data):
    return load_tpcds_sqlite(ds_data)


@pytest.fixture(scope="module")
def torch_h():
    return TorchRunner.tpch("tiny", device="cpu")


@pytest.fixture(scope="module")
def jax_h():
    return JaxRunner.tpch("tiny")


@pytest.fixture(scope="module")
def h_oracle(jax_h):
    return load_tpch_sqlite(jax_h.metadata.connector("tpch").data("tiny"))


def _row_key(row):
    return tuple((v is None, str(v)) for v in row)


def _assert_equal_rows(got, want, ordered):
    """Exactly equal rows (a DOUBLE to relative 1e-9; NaN equals NaN)."""
    if not ordered:
        got, want = sorted(got, key=_row_key), sorted(want, key=_row_key)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert isinstance(a, float), (g, w)
                assert (math.isnan(a) and math.isnan(b)) or math.isclose(
                    a, b, rel_tol=1e-9
                ), (g, w)
            else:
                assert type(a) is type(b) and a == b, (g, w)


def _skip_without_full_join(name):
    if name in NEEDS_FULL_JOIN and not sqlite_supports("full_join"):
        pytest.skip("the oracle's sqlite lacks FULL OUTER JOIN")


@pytest.mark.parametrize("qid", sorted(set(SMOKE_LOCAL) | set(WINDOW_QUERIES)))
def test_tpcds_query_matches_sqlite(torch_ds, ds_oracle, qid):
    _skip_without_full_join(qid)
    assert QUERIES[qid] == JAX_DS_QUERIES[qid]
    result = torch_ds.execute(QUERIES[qid])
    expected = ds_oracle.execute(
        to_sqlite(SQLITE_ORACLE.get(qid, QUERIES[qid]))
    ).fetchall()
    # abs 0.02, as tests/test_tpcds_queries.py: the engine's decimal
    # avg/div round to the type's scale; sqlite keeps binary floats
    assert_rows_match(result.rows, expected, ordered=result.ordered, abs_tol=0.02)


@pytest.mark.parametrize("name", list(CARD))
def test_card_statement_matches_jax_sqlite_and_reference(
    torch_ds, jax_ds, ds_oracle, ds_data, name
):
    sql, ref = CARD[name]
    got = torch_ds.execute(sql)
    want = jax_ds.execute(sql)
    _assert_equal_rows(got.rows, want.rows, got.ordered)
    assert R.rows_match(name, got.rows, ref(ds_data))
    if name == "ds_q51_totals":
        assert [tuple(map(str, r)) for r in got.rows] == [
            ("6662", "6044", "6605", "1584038.66", "5766704.52")
        ]
    if name == "ds_range7":
        assert len(got.rows) == 4
        assert tuple(map(str, got.rows[0])) == ("1", "7515", "719287300.58")
    _skip_without_full_join(name)
    expected = ds_oracle.execute(to_sqlite(CARD_SQLITE.get(name, sql))).fetchall()
    assert_rows_match(got.rows, expected, ordered=got.ordered, abs_tol=0.02)


@pytest.mark.parametrize("name", list(CARD))
def test_numpy_reference_matches_sqlite(ds_oracle, ds_data, name):
    _skip_without_full_join(name)
    sql, ref = CARD[name]
    expected = ds_oracle.execute(to_sqlite(CARD_SQLITE.get(name, sql))).fetchall()
    # the references give ISO dates and Decimals; sqlite floats
    assert_rows_match(ref(ds_data), expected, ordered=True, abs_tol=0.02)


@pytest.mark.parametrize("name", list(WINDOW_STATEMENTS))
def test_window_statement_matches_jax_and_sqlite(torch_h, jax_h, h_oracle, name):
    sql = WINDOW_STATEMENTS[name]
    got = torch_h.execute(sql)
    _assert_equal_rows(got.rows, jax_h.execute(sql).rows, got.ordered)
    expected = h_oracle.execute(to_sqlite(SQLITE_FORMS.get(name, sql))).fetchall()
    assert_rows_match(got.rows, expected, ordered=got.ordered, abs_tol=0.01)


@pytest.mark.parametrize("qid", ["q17", "q39"])
def test_stddev_queries_match_jax(torch_ds, jax_ds, qid):
    got = torch_ds.execute(QUERIES[qid])
    want = jax_ds.execute(JAX_DS_QUERIES[qid])
    _assert_equal_rows(got.rows, want.rows, got.ordered)
    assert got.rows == []  # see the module docstring


@pytest.mark.parametrize("name", list(SKETCH_CARD))
def test_sketch_statement_matches_jax_and_reference(torch_ds, jax_ds, ds_data, name):
    sql = SKETCH_CARD[name]
    got = torch_ds.execute(sql)
    _assert_equal_rows(got.rows, jax_ds.execute(sql).rows, got.ordered)
    assert len(got.rows) == SKETCH_ROWS[name]
    assert R.rows_match(name, got.rows, getattr(R, name)(ds_data))
    if name == "ds_q39_inv":
        assert got.rows[0][:2] == (7200, 7200)


@pytest.mark.tpcds_full
@pytest.mark.parametrize("qid", LONG_TAIL)
def test_tpcds_long_tail_matches_sqlite(torch_ds, ds_oracle, qid):
    _skip_without_full_join(qid)
    result = torch_ds.execute(QUERIES[qid])
    expected = ds_oracle.execute(
        to_sqlite(SQLITE_ORACLE.get(qid, QUERIES[qid]))
    ).fetchall()
    assert_rows_match(result.rows, expected, ordered=result.ordered, abs_tol=0.02)
