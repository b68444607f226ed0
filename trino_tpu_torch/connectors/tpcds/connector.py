"""TPC-DS connector: schemas tiny/sf1/sf10/sf100 of generated tables
(plugin/trino-tpcds/.../TpcdsConnectorFactory analog)."""

from __future__ import annotations

import numpy as np

from trino_tpu_torch.connectors.base import (
    Connector,
    Split,
    TableSchema,
    TableStats,
    compute_column_stats,
)
from trino_tpu_torch.connectors.tpcds.generator import (
    SCHEMA_SF,
    SCHEMAS,
    TpcdsData,
)

__all__ = ["TpcdsConnector"]


class TpcdsConnector(Connector):
    def __init__(self):
        self._data: dict[float, TpcdsData] = {}
        self._stats: dict[tuple[float, str], dict] = {}

    def data(self, schema: str) -> TpcdsData:
        sf = self._sf(schema)
        if sf not in self._data:
            self._data[sf] = TpcdsData(sf)
        return self._data[sf]

    @staticmethod
    def _sf(schema: str) -> float:
        if schema in SCHEMA_SF:
            return SCHEMA_SF[schema]
        if schema.startswith("sf"):
            try:
                return float(schema[2:])
            except ValueError:
                pass
        raise KeyError(f"unknown tpcds schema: {schema}")

    def list_schemas(self) -> list[str]:
        return list(SCHEMA_SF)

    def list_tables(self, schema: str) -> list[str]:
        return list(SCHEMAS)

    def table_schema(self, schema: str, table: str) -> TableSchema:
        return SCHEMAS[table]

    def row_count(self, schema: str, table: str) -> int:
        return self.data(schema).row_count(table)

    def column_stats(self, schema: str, table: str, column: str):
        """Per-column lazy stats (the reference ships precomputed tpcds
        stats files, plugin/trino-tpcds/.../statistics/): only columns
        a query touches are generated and measured."""
        sf = self._sf(schema)
        cols = self._stats.setdefault((sf, table), {})
        if column not in cols:
            cols[column] = compute_column_stats(
                self.data(schema).column(table, column)
            )
        return cols[column]

    def table_stats(self, schema: str, table: str) -> TableStats:
        cols = {
            c: self.column_stats(schema, table, c)
            for c in SCHEMAS[table].column_names
        }
        return TableStats(float(self.row_count(schema, table)), cols)

    def scan(
        self, schema: str, table: str, columns: list[str],
        split: Split | None = None,
    ) -> dict[str, np.ndarray]:
        data = self.data(schema)
        out = {}
        for c in columns:
            arr = data.column(table, c)
            if split is not None:
                arr = arr[split.start: split.start + split.count]
            out[c] = arr
        return out
