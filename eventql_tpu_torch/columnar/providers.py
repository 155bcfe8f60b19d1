"""Table providers backed by ingest formats
(reference: sql/CSTableScanProvider.{h,cc}, sql/drivers/csv/).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.core.types import SType
from eventql_tpu_torch.exec.relation import Relation
from eventql_tpu_torch.exec.runtime import TableInfo
from eventql_tpu_torch.plan.builder import TableProvider


class CSTableScanProvider(TableProvider):
    """Maps one table name to one cstable file
    (reference: sql/CSTableScanProvider.cc)."""

    def __init__(self, table_name: str, path: str):
        from eventql_tpu_torch.columnar.cstable import CSTableReader

        self.table_name = table_name
        self.path = path
        self.reader = CSTableReader(path)
        self._relation: Optional[Relation] = None

    def describe(self, table_name: str) -> Optional[TableInfo]:
        if table_name != self.table_name:
            return None
        cols = [(c.name, c.stype) for c in self.reader.columns]
        return TableInfo(table_name, cols)

    def list_tables(self):
        return [self.describe(self.table_name)]

    def get_table_data(self, table_name: str) -> Relation:
        if table_name != self.table_name:
            raise RuntimeError_(f"table not found: '{table_name}'")
        if self._relation is None:
            self._relation = self.reader.to_relation(flat_only=True)
        return self._relation

    def get_reader(self, table_name: str):
        return self.reader if table_name == self.table_name else None

    def table_cache_key(self, table_name: str):
        from eventql_tpu_torch.exec.query_cache import QueryCache

        if table_name != self.table_name:
            return None
        return QueryCache.file_cache_key(self.path)


class CSVTableProvider(TableProvider):
    """Maps one table name to one CSV file; all columns STRING
    (reference: sql/drivers/csv/CSVTableProvider.cc)."""

    def __init__(self, table_name: str, path: str, column_separator: bytes = b","):
        from eventql_tpu_torch.columnar.csv_ingest import load_csv_table

        self.table_name = table_name
        self._relation = load_csv_table(path, column_separator=column_separator)

    def describe(self, table_name: str) -> Optional[TableInfo]:
        if table_name != self.table_name:
            return None
        cols = [(n, SType.STRING) for n in self._relation.names]
        return TableInfo(table_name, cols)

    def list_tables(self):
        return [self.describe(self.table_name)]

    def get_table_data(self, table_name: str) -> Relation:
        if table_name != self.table_name:
            raise RuntimeError_(f"table not found: '{table_name}'")
        return self._relation


class CompositeTableProvider(TableProvider):
    def __init__(self, providers: Optional[List[TableProvider]] = None):
        self.providers: List[TableProvider] = providers or []

    def add(self, provider: TableProvider):
        self.providers.append(provider)

    def describe(self, table_name: str):
        for p in self.providers:
            info = p.describe(table_name)
            if info is not None:
                return info
        return None

    def list_tables(self):
        out = []
        for p in self.providers:
            out.extend(p.list_tables())
        return out

    def get_table_data(self, table_name: str) -> Relation:
        for p in self.providers:
            if p.describe(table_name) is not None:
                return p.get_table_data(table_name)
        raise RuntimeError_(f"table not found: '{table_name}'")

    def get_reader(self, table_name: str):
        for p in self.providers:
            if p.describe(table_name) is not None:
                return getattr(p, "get_reader", lambda n: None)(table_name)
        return None

    def table_cache_key(self, table_name: str):
        for p in self.providers:
            if p.describe(table_name) is not None:
                fn = getattr(p, "table_cache_key", None)
                return fn(table_name) if fn else None
        return None
