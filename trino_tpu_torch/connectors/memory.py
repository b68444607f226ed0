"""In-memory tables connector.

The analog of the reference's trino-memory plugin
(plugin/trino-memory, ~2.3k LoC): tables live as host numpy columns,
created and filled through the connector API (``create_table``,
``insert``) and read through scans. This is the port's copy of the table
API of ``trino_tpu/connectors/memory.py``: the port has no DDL or DML
statements yet, so their write sinks, DELETE/UPDATE and the blackhole
connector are not copied.
"""

from __future__ import annotations

import threading

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.connectors.base import (
    Connector,
    Split,
    TableSchema,
    TableStats,
    compute_column_stats,
)

__all__ = ["MemoryConnector"]


class _Table:
    def __init__(self, schema: TableSchema):
        self.schema = schema
        self.columns: dict[str, np.ndarray] = {
            c: np.empty((0,), dtype=_storage_dtype(t))
            for c, t in schema.columns
        }
        self.valid: dict[str, np.ndarray | None] = {
            c: None for c, _ in schema.columns
        }
        self.n_rows = 0
        #: memoized TableStats; dropped on insert
        self.stats: TableStats | None = None


def _storage_dtype(t: T.DataType):
    if isinstance(t, (T.VarcharType, T.ArrayType, T.MapType, T.RowType)):
        # variable-width values store python objects (lists / pair
        # lists / tuples; None = NULL)
        return object
    return t.np_dtype


class MemoryConnector(Connector):
    def __init__(self):
        self._schemas: dict[str, dict[str, _Table]] = {"default": {}}
        self._lock = threading.Lock()

    # ---- metadata --------------------------------------------------------

    def list_schemas(self) -> list[str]:
        return list(self._schemas)

    def list_tables(self, schema: str) -> list[str]:
        return list(self._schemas.get(schema, {}))

    def table_schema(self, schema: str, table: str) -> TableSchema:
        return self._table(schema, table).schema

    def row_count(self, schema: str, table: str) -> int:
        return self._table(schema, table).n_rows

    def table_stats(self, schema: str, table: str) -> TableStats:
        """Exact stats computed on demand and memoized until the next
        insert (planning hits this several times per query; a
        recompute per call would sort every column each time), like
        the reference's MemoryMetadata.getTableStatistics."""
        t = self._table(schema, table)
        with self._lock:
            if t.stats is None:
                cols = {
                    c: compute_column_stats(t.columns[c], t.valid[c])
                    for c, _ in t.schema.columns
                }
                t.stats = TableStats(float(t.n_rows), cols)
            return t.stats

    def _table(self, schema: str, table: str) -> _Table:
        try:
            return self._schemas[schema][table]
        except KeyError:
            raise KeyError(f"table {schema}.{table} does not exist")

    # ---- tables ----------------------------------------------------------

    def create_table(self, schema: str, table: str, table_schema: TableSchema):
        with self._lock:
            tables = self._schemas.setdefault(schema, {})
            if table in tables:
                raise ValueError(f"table {schema}.{table} already exists")
            tables[table] = _Table(table_schema)

    def insert(self, schema: str, table: str, columns: dict) -> int:
        t = self._table(schema, table)
        with self._lock:
            n_new = None
            for c, _typ in t.schema.columns:
                vals = columns[c]
                valid = None
                if isinstance(vals, tuple):
                    vals, valid = vals
                if t.columns[c].dtype == object:
                    # element-wise fill: np.asarray would collapse
                    # same-length nested lists into a 2-D array
                    arr = np.empty(len(vals), dtype=object)
                    for i, v in enumerate(vals):
                        arr[i] = v
                    vals = arr
                else:
                    vals = np.asarray(vals, dtype=t.columns[c].dtype)
                n_new = len(vals) if n_new is None else n_new
                t.columns[c] = np.concatenate([t.columns[c], vals])
                old_valid = t.valid[c]
                if valid is not None or old_valid is not None:
                    ov = (
                        np.ones(t.n_rows, dtype=bool)
                        if old_valid is None else old_valid
                    )
                    nv = (
                        np.ones(len(vals), dtype=bool)
                        if valid is None else np.asarray(valid, dtype=bool)
                    )
                    t.valid[c] = np.concatenate([ov, nv])
            t.n_rows += n_new or 0
            t.stats = None  # stats reflect the pre-insert version
        return n_new or 0

    # ---- scan ------------------------------------------------------------

    def scan(
        self, schema: str, table: str, columns: list[str],
        split: Split | None = None,
    ):
        t = self._table(schema, table)
        out = {}
        for c in columns:
            vals = t.columns[c]
            valid = t.valid[c]
            if split is not None:
                vals = vals[split.start:split.start + split.count]
                valid = None if valid is None else valid[
                    split.start:split.start + split.count
                ]
            out[c] = vals if valid is None else (vals, valid)
        return out

