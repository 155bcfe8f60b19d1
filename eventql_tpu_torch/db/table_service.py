"""In-memory table service: CREATE/ALTER/DROP/INSERT.

The SQL-visible behavior of the reference's TableService
(reference: db/table_service.cc — create/alter/drop + the insert path)
over an in-memory columnar store. The durable LSM/partitioned storage
engine layers on top of the same interface.

Column types follow the reference's schema type names
(reference: util/protobuf/MessageObject.cc:41-53): STRING, BOOLEAN,
UINT32, UINT64, DOUBLE, DATETIME (case-insensitive). OBJECT/RECORD
columns flatten to dotted names like MessageSchema's columns.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.core.types import SType, SValue
from eventql_tpu_torch.exec.relation import Column, Relation, dtype_for
from eventql_tpu_torch.exec.runtime import TableInfo
from eventql_tpu_torch.plan.builder import TableProvider
from eventql_tpu_torch.plan.nodes import AlterTableNode, ColumnDefinition

# reference: fieldTypeFromString (MessageObject.cc:41-53)
_TYPE_MAP = {
    "STRING": SType.STRING,
    "BOOLEAN": SType.BOOL,
    "BOOL": SType.BOOL,
    "UINT32": SType.UINT64,
    "UINT64": SType.UINT64,
    "DOUBLE": SType.FLOAT64,
    "DATETIME": SType.TIMESTAMP64,
}


import uuid as _uuid

_BOOT_EPOCH = _uuid.uuid4().hex[:12]


def stype_from_name(name: str) -> SType:
    t = _TYPE_MAP.get(name.upper())
    if t is None:
        raise RuntimeError_(f"can't convert '{name.upper()}' to FieldType")
    return t


def _flatten_columns(
    defs: List[ColumnDefinition], prefix: str = ""
) -> List[Tuple[str, SType, bool]]:
    """Flatten RECORD columns to dotted names
    (reference: MessageSchema::flatColumns)."""
    out = []
    for d in defs:
        name = prefix + d.column_name
        if d.subcolumns is not None:
            out.extend(_flatten_columns(d.subcolumns, name + "."))
        else:
            out.append((name, stype_from_name(d.column_type), d.repeated))
    return out


class MemoryTable:
    def __init__(
        self, name, columns, primary_key, partition_key, properties,
        column_defs=None,
    ):
        self.name = name
        self.columns: List[Tuple[str, SType, bool]] = columns
        self.primary_key = primary_key
        self.partition_key = partition_key
        self.properties = dict(properties or [])
        self.column_defs: List[ColumnDefinition] = column_defs or []
        self.rows: List[Dict[str, SValue]] = []
        # raw record objects (for Dremel shredding of repeated fields)
        self.objs: List[dict] = []
        # arena primary-key index: record id (SHA1 of the packed pk) →
        # newest version among arena rows. Consulted at insert time so
        # stale/duplicate records (replayed replication pushes, client
        # retries) drop at WRITE time (reference:
        # partition_writer.cc:105-199 + PartitionArena's version map)
        self._arena_index: Dict[bytes, int] = {}
        # columnar arena batches (flat tables only): whole Relations
        # appended by the native batch-insert path — the TPU-native
        # arena representation (the reference's analog is the
        # column-shredded ShreddedRecordList batches its insert path
        # groups records into, db/table_service.cc:883-897)
        self._batches: List[Relation] = []
        # monotone data version: bumps on every mutation (keys the
        # partial-aggregate query cache and mapreduce result ids — the
        # reference's analog is the partition snapshot version,
        # db/partition_snapshot.h)
        self.mutation_count = 0
        self._relation_cache: Optional[Relation] = None
        self._reader_cache = None
        self._insert_meta = None
        # per-table (= per local partition) write lock: the server is
        # thread-per-connection (reference: db/database.cc:555-573) and
        # concurrent ingest must serialize the arena append + version
        # check + flush sequence (reference: LSMPartitionWriter's
        # commit/compact mutexes, partition_writer.cc:270,361). The
        # CPU-heavy shred runs BEFORE the lock (ctypes releases the
        # GIL), so parallel connections overlap shredding with the
        # serialized arena work.
        import threading

        self._write_lock = threading.RLock()

    @property
    def has_repeated(self) -> bool:
        return any(c[2] for c in self.columns)

    # -- record versions ------------------------------------------------
    def _record_id_row(self, row: Dict[str, SValue]) -> bytes:
        """SHA1 of the packed primary key — identical to the wire
        record ids in ShreddedRecordList.from_relation so replication
        pushes and local inserts agree on identity (reference:
        db/table_service.cc:795-837)."""
        import hashlib

        from eventql_tpu_torch.db.shredded_record_list import _wire_str

        parts = []
        for k in self.primary_key:
            v = row.get(k)
            parts.append(
                b"" if v is None or v.is_null else _wire_str(v.payload())
            )
        return hashlib.sha1(b"\x00".join(parts)).digest()

    def _head_versions(self, rec_ids: List[bytes]) -> "np.ndarray":
        """Newest known version per record id (0 = unknown). The LSM
        tier extends this with the per-segment index lookups."""
        return np.array(
            [self._arena_index.get(r, 0) for r in rec_ids], np.uint64
        )

    def head_version(self, rec_id: bytes) -> int:
        return int(self._head_versions([rec_id])[0])

    # -- mutation -------------------------------------------------------
    def insert_row(
        self,
        row: Dict[str, SValue],
        obj: Optional[dict] = None,
        version: Optional[int] = None,
    ) -> bool:
        """Insert one record; returns False when the record is stale
        (its version is not newer than the head version for its primary
        key) and was dropped at write time, True otherwise (reference:
        partition_writer.cc:169-187 record_flags_skip)."""
        with self._write_lock:
            return self._insert_row_locked(row, obj, version)

    def _insert_row_locked(self, row, obj, version) -> bool:
        known = {c[0] for c in self.columns}
        for cname in row:
            if cname not in known:
                raise RuntimeError_(f"column not found: '{cname}'")
        if self.primary_key:
            from eventql_tpu_torch.db.tablet_index import next_record_version

            rid = self._record_id_row(row)
            if version is None:
                version = next_record_version()
            if version <= self.head_version(rid):
                return False
            self._arena_index[rid] = version
        self.rows.append(row)
        self.mutation_count += 1
        if obj is None:
            obj = _undot({k: v.payload() if not v.is_null else None
                          for k, v in row.items()})
        self.objs.append(obj)
        self._relation_cache = None
        self._reader_cache = None
        return True

    def arena_rows(self) -> int:
        """Unflushed row count: dict rows + columnar batches."""
        return len(self.rows) + sum(b.num_rows for b in self._batches)

    def _batch_record_ids(self, rel: Relation) -> List[bytes]:
        """Record ids for a whole batch, with the wire-string encoding
        vectorized per column (the per-row SValue path costs ~10µs/row;
        this is the insert hot path — reference computes ids in C++,
        table_service.cc:795-837)."""
        import hashlib

        from eventql_tpu_torch.db.shredded_record_list import _wire_str

        # single numeric pk: whole-column C++ decimal-encode + SHA1
        # (native/eventql_native.cc evql_record_ids_*, round 5 — the
        # per-row hashlib loop was 1.5 of the 2.4 us/row insert wall)
        if len(self.primary_key) == 1:
            c = rel.columns[rel.names.index(self.primary_key[0])]
            if c.stype in (SType.UINT64, SType.TIMESTAMP64, SType.INT64):
                from eventql_tpu_torch.columnar import native as _native

                ids = _native.record_ids_numeric(c.data, c.valid)
                if ids is not None:
                    # one tobytes + Python-bytes slicing: ~3x the
                    # per-row numpy bytes() conversions
                    allb = ids.tobytes()
                    return [allb[i : i + 20] for i in range(0, len(allb), 20)]

        cols_bytes = []
        for k in self.primary_key:
            c = rel.columns[rel.names.index(k)]
            n = rel.num_rows
            if c.stype == SType.STRING:
                enc = c.dictionary[c.data]
                if not c.valid.all():
                    enc = enc.copy()
                    enc[~c.valid] = b""
            elif c.stype in (SType.UINT64, SType.TIMESTAMP64,
                             SType.INT64):
                # decimal encoding identical to str(int(v))
                enc = np.char.encode(c.data.astype("U21")).astype(object)
                if not c.valid.all():
                    enc[~c.valid] = b""
            elif c.stype == SType.BOOL:
                enc = np.where(
                    c.valid & c.data.astype(bool),
                    np.array(b"true", object),
                    np.where(
                        c.valid, np.array(b"false", object),
                        np.array(b"", object),
                    ),
                )
            else:
                # FLOAT64/NIL keys: per-row repr fallback (rare as pk)
                enc = np.array(
                    [
                        _wire_str(c.value_at(i).payload())
                        if c.valid[i] else b""
                        for i in range(n)
                    ],
                    dtype=object,
                )
            cols_bytes.append(enc)
        if len(cols_bytes) == 1:
            payloads = cols_bytes[0]
        else:
            payloads = cols_bytes[0]
            for extra in cols_bytes[1:]:
                payloads = payloads + b"\x00" + extra
        # string/compound keys: pack once, batch-SHA1 in C++
        from eventql_tpu_torch.columnar import native as _native

        lens = np.fromiter(
            (len(p) for p in payloads), np.uint64, len(payloads)
        )
        offsets = np.zeros(len(payloads) + 1, np.uint64)
        np.cumsum(lens, out=offsets[1:])
        ids = _native.sha1_rows(b"".join(payloads), offsets)
        if ids is not None:
            allb = ids.tobytes()
            return [allb[i : i + 20] for i in range(0, len(allb), 20)]
        sha1 = hashlib.sha1
        return [sha1(p).digest() for p in payloads]

    def insert_batch(self, rel: Relation, versions=None,
                     record_ids=None) -> int:
        """Append a columnar batch (flat tables only). Pending dict
        rows are folded into a batch first so scan order stays exactly
        insertion order.

        On a primary-keyed table each record gets a version (explicit
        `versions`, or a fresh monotone timestamp block) and records
        whose version is not newer than the head version for their pk
        drop at write time (reference: partition_writer.cc:166-191).
        Returns the number of rows actually inserted."""
        with self._write_lock:
            return self._insert_batch_locked(rel, versions, record_ids)

    def _insert_batch_locked(self, rel, versions, record_ids) -> int:
        if self.has_repeated:
            raise RuntimeError_(
                "batch insert requires a flat schema: "
                f"'{self.name}' has repeated columns"
            )
        if list(rel.names) != [c[0] for c in self.columns]:
            raise RuntimeError_("batch column mismatch")
        if self.primary_key and rel.num_rows:
            # record_ids: precomputed by the native shredder's SHA1
            # pass (columnar/native.py records_shred) — skips the
            # python wire-string hashing on the insert hot path
            rids = record_ids if record_ids is not None else \
                self._batch_record_ids(rel)
            if versions is None:
                # fresh inserts always have version > head; skip the
                # filter entirely and only update the arena index
                from eventql_tpu_torch.db.tablet_index import (
                    next_record_version_block,
                )

                base = next_record_version_block(rel.num_rows)
                self._arena_index.update(
                    zip(rids, range(base, base + rel.num_rows))
                )
            else:
                head = self._head_versions(rids)
                keep = []
                pending: Dict[bytes, int] = {}
                for i, rid in enumerate(rids):
                    v = int(versions[i])
                    if v <= max(int(head[i]), pending.get(rid, 0)):
                        continue
                    pending[rid] = v
                    keep.append(i)
                if len(keep) < rel.num_rows:
                    rel = rel.gather(np.array(keep, dtype=np.int64))
                self._arena_index.update(pending)
                if not rel.num_rows:
                    return 0
        if self.rows:
            self._batches.append(self._rows_relation())
            self.rows = []
            self.objs = []
        self._batches.append(rel)
        self.mutation_count += 1
        self._relation_cache = None
        self._reader_cache = None
        return rel.num_rows

    def truncate(self):
        """Drop every row but keep the schema (partition unload:
        reference analog PartitionMap::dropLocalPartition)."""
        self.rows = []
        self.objs = []
        self._batches = []
        self._arena_index = {}
        self.mutation_count += 1
        self._relation_cache = None
        self._reader_cache = None

    def add_column(self, coldef: ColumnDefinition):
        for flat in _flatten_columns([coldef]):
            if any(c[0] == flat[0] for c in self.columns):
                raise RuntimeError_(f"column already exists: '{flat[0]}'")
            self.columns.append(flat)
        self.column_defs.append(coldef)
        self.mutation_count += 1
        self._relation_cache = None
        self._reader_cache = None
        self._insert_meta = None

    def drop_column(self, name: str):
        if name in self.primary_key:
            raise RuntimeError_(f"can't drop primary key column: '{name}'")
        before = len(self.columns)
        self.columns = [c for c in self.columns if c[0] != name]
        if len(self.columns) == before:
            raise RuntimeError_(f"column not found: '{name}'")
        self.column_defs = [d for d in self.column_defs if d.column_name != name]
        self.mutation_count += 1
        self._relation_cache = None
        self._reader_cache = None
        self._insert_meta = None

    def insert_meta(self):
        """Schema lookups for the insert hot path, cached per schema
        version: (flat schema dict, names under a REPEATED root,
        proper prefixes of dotted columns = record names)."""
        meta = getattr(self, "_insert_meta", None)
        if meta is None:
            schema = {c[0]: c[1] for c in self.columns}
            rroots = _repeated_roots(self.column_defs)
            prefixes = set()
            for k in schema:
                parts = k.split(".")
                for i in range(1, len(parts)):
                    prefixes.add(".".join(parts[:i]))
            under_rep = {
                n
                for n in (set(schema) | prefixes | set(rroots))
                if any(n == rr or n.startswith(rr + ".") for rr in rroots)
            }
            meta = (schema, under_rep, prefixes)
            self._insert_meta = meta
        return meta

    # -- reads ----------------------------------------------------------
    def get_reader(self):
        """Dremel-assembly reader over the raw records; only built for
        tables with REPEATED columns (flat tables use to_relation)."""
        if not self.has_repeated:
            return None
        if self._reader_cache is None:
            from eventql_tpu_torch.columnar.shredder import ShreddedTableReader

            self._reader_cache = ShreddedTableReader(self.column_defs, self.objs)
        return self._reader_cache

    def _rows_relation(self) -> Relation:
        """Columnarize the dict-row arena part."""
        n = len(self.rows)
        names, cols = [], []
        for cname, ctype, rep in self.columns:
            if rep:
                continue  # repeated columns only exist on the nested path
            names.append(cname)
            if ctype == SType.STRING:
                vals = []
                for r in self.rows:
                    v = r.get(cname)
                    vals.append(None if v is None or v.is_null else v.payload())
                cols.append(Column.from_strings(vals))
            else:
                data = np.zeros(n, dtype=dtype_for(ctype))
                valid = np.zeros(n, dtype=bool)
                for i, r in enumerate(self.rows):
                    v = r.get(cname)
                    if v is not None and not v.is_null and v.stype != SType.NIL:
                        data[i] = v.payload()
                        valid[i] = True
                cols.append(Column(ctype, data, valid))
        return Relation(names, cols, n)

    def _align_to_schema(self, rel: Relation) -> Relation:
        """Re-shape an arena batch to the CURRENT flat schema: ALTER
        TABLE after a batch insert adds (all-NULL) or drops columns the
        batch was built without (reference analog: CSTableScan fills
        columns missing from older segments with NULLs)."""
        names = [c[0] for c in self.columns if not c[2]]
        if list(rel.names) == names:
            return rel
        by_name = dict(zip(rel.names, rel.columns))
        n = rel.num_rows
        cols = []
        for cname, ctype, rep in self.columns:
            if rep:
                continue
            c = by_name.get(cname)
            if c is None:
                if ctype == SType.STRING:
                    c = Column.from_strings([None] * n)
                else:
                    c = Column(
                        ctype,
                        np.zeros(n, dtype=dtype_for(ctype)),
                        np.zeros(n, dtype=bool),
                    )
            cols.append(c)
        return Relation(names, cols, n)

    def to_relation(self) -> Relation:
        if self._relation_cache is not None:
            return self._relation_cache
        parts = [self._align_to_schema(b) for b in self._batches]
        if self.rows or not parts:
            parts.append(self._rows_relation())
        rel = parts[0] if len(parts) == 1 else _concat_arena(parts)
        if self.primary_key and not self.has_repeated:
            # primary-key upsert visibility: the newest write for a key
            # wins. Versions are monotone with arena position (the
            # insert path drops out-of-order versions), so keep-last by
            # position resolves exactly (reference: the arena replaces
            # records in place on update, partition_arena.cc — here the
            # arena is append-only and the read view dedups instead)
            rel = _dedup_keep_last(rel, self.primary_key)
        self._relation_cache = rel
        return rel

    def stream_chunks(self, chunk_rows: int):
        """Yield the table's rows as bounded Relation chunks, in the
        exact row order of to_relation() — the streaming-cursor source
        (reference: LSMPartitionReader pulls batches through the
        operator tree, sql/result_cursor.h:35-75). A memory table's
        data already lives in RAM; chunking here bounds the DOWNSTREAM
        footprint (formatted result rows, wire frames)."""
        yield from self.to_relation().iter_chunks(chunk_rows)


class TableService(TableProvider):
    """Mutable catalog + store, usable directly as the engine's table
    provider (reference: db/table_service.h:52)."""

    def __init__(self):
        self.tables: Dict[str, MemoryTable] = {}
        self.databases: Dict[str, None] = {}
        # bumped on any schema change; keys the server plan cache
        # (exec/runtime.py PlanCache) so cached plans invalidate on DDL
        self._schema_version = 0

    def bump_schema_version(self) -> None:
        self._schema_version += 1

    def plan_cache_key(self):
        return self._schema_version

    # -- DDL ------------------------------------------------------------
    def create_table(self, node) -> None:
        # reference: TableService::createTable — first PRIMARY KEY column
        # must be DATETIME, STRING or UINT64 (table_service.cc:140-160)
        if node.table_name in self.tables:
            raise RuntimeError_(f"table already exists: '{node.table_name}'")
        columns = _flatten_columns(node.columns)
        if node.primary_key:
            by_name = {c[0]: c[1] for c in columns}
            first = node.primary_key[0]
            if first not in by_name:
                raise RuntimeError_(f"column not found: '{first}'")
            if by_name[first] not in (
                SType.TIMESTAMP64,
                SType.STRING,
                SType.UINT64,
            ):
                raise RuntimeError_(
                    "first column in the PRIMARY KEY must be of type "
                    "DATETIME, STRING or UINT64"
                )
        self.tables[node.table_name] = MemoryTable(
            node.table_name,
            columns,
            list(node.primary_key),
            node.partition_key,
            node.properties,
            column_defs=list(node.columns),
        )
        self.bump_schema_version()

    def drop_table(self, table_name: str) -> None:
        if table_name not in self.tables:
            raise RuntimeError_(f"table not found: '{table_name}'")
        del self.tables[table_name]
        self.bump_schema_version()

    def truncate_table(self, table_name: str) -> None:
        """Unload a table's local rows, keeping the schema (reference
        analog: partition UNLOAD, db/partition_map.cc dropLocalPartition
        — our partitions are keyrange views over one local store, so an
        unload drops the whole store once no range is served here)."""
        table = self.tables.get(table_name)
        if table is None:
            raise RuntimeError_(f"table not found: '{table_name}'")
        table.truncate()

    def create_database(self, name: str) -> None:
        self.databases[name] = None

    def alter_table(self, node) -> None:
        table = self.tables.get(node.table_name)
        if table is None:
            raise RuntimeError_(f"table not found: '{node.table_name}'")
        for kind, payload in node.operations:
            if kind == AlterTableNode.ADD_COLUMN:
                table.add_column(payload)
            elif kind == AlterTableNode.DROP_COLUMN:
                table.drop_column(payload)
            elif kind == AlterTableNode.SET_PROPERTY:
                table.properties[payload[0]] = payload[1]
        self.bump_schema_version()

    # -- DML ------------------------------------------------------------
    def insert(self, table_name: str, columns: List[str], values: List[SValue]):
        table = self.tables.get(table_name)
        if table is None:
            raise RuntimeError_(f"table not found: '{table_name}'")
        if len(columns) != len(values):
            raise RuntimeError_(
                "number of columns and values must match in INSERT"
            )
        schema = table.insert_meta()[0]
        row = {}
        for cname, val in zip(columns, values):
            if cname not in schema:
                raise RuntimeError_(f"column not found: '{cname}'")
            row[cname] = _coerce(val, schema[cname])
        table.insert_row(row)

    def insert_json(self, table_name: str, json_str: str, version=None):
        try:
            obj = json.loads(json_str)
        except json.JSONDecodeError as e:
            raise RuntimeError_(f"invalid JSON: {e}")
        if not isinstance(obj, dict):
            raise RuntimeError_("JSON insert requires an object")
        return self._insert_obj(table_name, obj, version=version)

    def insert_json_batch(
        self, table_name: str, records_json: bytes, versions=None
    ) -> int:
        """Insert a JSON ARRAY of records in one native pass (the
        reference's insert path is C++ end to end: JSON parse +
        column shredding into ShreddedRecordList batches,
        db/table_service.cc:883-897). Falls back to the per-record
        Python path for nested schemas or values only Python converts;
        on a row error, rows before it stay inserted (matching the
        per-record loop's semantics) and the same error raises.
        Returns the number of rows inserted."""
        table = self.tables.get(table_name)
        if table is None:
            raise RuntimeError_(f"table not found: '{table_name}'")
        if isinstance(records_json, str):
            records_json = records_json.encode("utf-8")
        schema, _under_rep, record_prefixes = table.insert_meta()

        native_ok = (
            not table.has_repeated
            and not record_prefixes
            and not any(t == SType.INT64 for t in schema.values())
        )
        if native_ok:
            from eventql_tpu_torch.columnar import native

            names = [c[0] for c in table.columns]
            stypes = [c[1] for c in table.columns]
            try:
                out = native.json_shred(records_json, names, stypes)
            except native.ShredError as e:
                nrows, cols = e.partial
                if nrows:
                    table.insert_batch(
                        _shred_to_relation(names, stypes, cols, nrows),
                        versions=versions[:nrows] if versions else None,
                    )
                raise RuntimeError_(str(e))
            if out is not None:
                nrows, cols = out
                if nrows:
                    return table.insert_batch(
                        _shred_to_relation(names, stypes, cols, nrows),
                        versions=versions,
                    )
                return nrows

        # Python path (nested schemas / values the native shredder
        # defers on)
        try:
            objs = json.loads(records_json)
        except json.JSONDecodeError as e:
            raise RuntimeError_(f"invalid JSON: {e}")
        if not isinstance(objs, list):
            raise RuntimeError_("JSON batch insert requires an array")
        inserted = 0
        for i, obj in enumerate(objs):
            if not isinstance(obj, dict):
                raise RuntimeError_("JSON insert requires an object")
            if self._insert_obj(
                table_name, obj,
                version=versions[i] if versions else None,
            ):
                inserted += 1
        return inserted

    def insert_records_wire(
        self, table_name: str, region: bytes, count: int
    ) -> int:
        """Native-protocol INSERT hot path: shred `count` lenenc-framed
        JSON records straight from the frame body in ONE native pass —
        frame walk, JSON parse, typed conversion, AND primary-key SHA1
        record ids all in C++ (reference: the whole insert path is C++,
        db/table_service.cc:758-926). Falls back to the per-record
        Python path for nested schemas, fallback values, or row errors
        (resuming at the failing record so rows before it stand and
        the error text matches the reference's per-record loop)."""
        table = self.tables.get(table_name)
        if table is None:
            raise RuntimeError_(f"table not found: '{table_name}'")
        schema, _under_rep, record_prefixes = table.insert_meta()
        native_ok = (
            not table.has_repeated
            and not record_prefixes
            and not any(t == SType.INT64 for t in schema.values())
        )
        start = 0
        inserted = 0
        if native_ok:
            from eventql_tpu_torch.columnar import native

            names = [c[0] for c in table.columns]
            stypes = [c[1] for c in table.columns]
            pk_idx = (
                [names.index(k) for k in table.primary_key]
                if table.primary_key
                else None
            )
            out = native.records_shred(
                region, count, names, stypes, pk_idx=pk_idx
            )
            if out is not None:
                nrows, cols, rids, complete = out
                if nrows:
                    inserted += table.insert_batch(
                        _shred_to_relation(names, stypes, cols, nrows),
                        record_ids=rids,
                    )
                if complete:
                    return inserted
                start = nrows  # resume the tail with the Python path

        # per-record Python path (tail after a native stop, or whole
        # batch when native can't run)
        pos = 0
        for i in range(count):
            ln, pos = _read_varint(region, pos)
            rec = region[pos : pos + ln]
            pos += ln
            if i < start:
                continue
            if self.insert_json(table_name, rec.decode("utf-8")):
                inserted += 1
        return inserted

    def _insert_obj(self, table_name: str, obj: dict, version=None):
        flat = {}
        table = self.tables.get(table_name)
        if table is None:
            raise RuntimeError_(f"table not found: '{table_name}'")
        schema, under_rep, record_prefixes = table.insert_meta()

        def walk2(o, prefix=""):
            for k, v in o.items():
                name = prefix + k
                if name in schema:
                    if name in under_rep:
                        continue  # handled by the shredder
                    flat[name] = v
                elif name in record_prefixes:
                    if name in under_rep:
                        continue
                    if not isinstance(v, dict):
                        raise RuntimeError_(
                            f"expected object for record column '{name}'"
                        )
                    walk2(v, name + ".")
                else:
                    raise RuntimeError_(f"column not found: '{name}'")

        walk2(obj)
        row = {}
        for k, v in flat.items():
            row[k] = _coerce(_from_json(v), schema[k])
        return table.insert_row(row, obj=obj, version=version)

    # -- TableProvider interface ---------------------------------------
    def describe(self, table_name: str) -> Optional[TableInfo]:
        table = self.tables.get(table_name)
        if table is None:
            return None
        return TableInfo(table_name, [(c[0], c[1]) for c in table.columns])

    def list_tables(self):
        return [self.describe(n) for n in sorted(self.tables)]

    def get_table_data(self, table_name: str) -> Relation:
        table = self.tables.get(table_name)
        if table is None:
            raise RuntimeError_(f"table not found: '{table_name}'")
        return table.to_relation()

    def get_table_chunks(self, table_name: str, chunk_rows: int):
        """Bounded-memory chunk iterator over the table's rows (row
        order identical to get_table_data); the streaming-cursor data
        source (reference: result_cursor.h:35-75)."""
        table = self.tables.get(table_name)
        if table is None:
            raise RuntimeError_(f"table not found: '{table_name}'")
        return table.stream_chunks(chunk_rows)

    def table_version(self, table_name: str) -> str:
        """Data version keying persistent caches (reference analog: the
        partition snapshot version). The per-process boot epoch makes
        versions never repeat across restarts — the in-memory mutation
        counter resets to 0 on reopen, and without the epoch a restart
        would serve pre-restart cache entries for post-restart data."""
        table = self.tables.get(table_name)
        if table is None:
            raise RuntimeError_(f"table not found: '{table_name}'")
        return f"{_BOOT_EPOCH}-{table.mutation_count}"

    def get_reader(self, table_name: str):
        table = self.tables.get(table_name)
        if table is None:
            return None
        return table.get_reader()


def _read_varint(buf: bytes, pos: int):
    v = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return v, pos


def _concat_arena(parts: List[Relation]) -> Relation:
    from eventql_tpu_torch.parallel.partitioned import _concat_columns

    names = list(parts[0].names)
    cols = [
        _concat_columns([p.columns[i] for p in parts])
        for i in range(len(names))
    ]
    return Relation(names, cols, sum(p.num_rows for p in parts))


def _dedup_keep_last(rel: Relation, pk_names: List[str]) -> Relation:
    """Keep the LAST row for each primary key, preserving the relative
    order of kept rows — vectorized (lexsort + group-boundary scan), no
    per-row Python on the read path. String keys compare by dictionary
    id, which is consistent within one concatenated relation."""
    n = rel.num_rows
    if n == 0:
        return rel
    key_arrays = []
    for k in pk_names:
        c = rel.columns[rel.names.index(k)]
        d = c.data
        if d.dtype == np.bool_:
            d = d.astype(np.uint8)
        elif d.dtype == np.float64:
            # bit-pattern equality: exact for every non-NaN float key
            d = d.view(np.uint64)
        key_arrays.append(d)
        key_arrays.append(c.valid)  # NULL keys stay distinct from 0
    rows = np.arange(n)
    # lexsort: last key is the primary sort key; the row index as the
    # least significant key makes groups ascend by position
    order = np.lexsort((rows,) + tuple(reversed(key_arrays)))
    new_group = np.zeros(n, dtype=bool)
    new_group[0] = True
    for k in key_arrays:
        ks = k[order]
        np.logical_or(
            new_group[1:], ks[1:] != ks[:-1], out=new_group[1:]
        )
    if new_group.all():
        return rel  # no duplicate keys at all (the common case)
    last_of_group = np.empty(n, dtype=bool)
    last_of_group[:-1] = new_group[1:]
    last_of_group[-1] = True
    keep = np.zeros(n, dtype=bool)
    keep[order[last_of_group]] = True
    return rel.gather(np.flatnonzero(keep))


def _shred_to_relation(names, stypes, shred_cols, nrows: int) -> Relation:
    """Build a Relation from the native shredder's column buffers."""
    cols = []
    for stype, buf in zip(stypes, shred_cols):
        if stype == SType.STRING:
            off, raw, valid = buf
            # slice from ONE Python bytes object (bytes(np_slice) per
            # row measured ~3x slower); offsets to python ints once
            raw_b = raw.tobytes() if hasattr(raw, "tobytes") else bytes(raw)
            off_l = off.tolist()
            if valid.all():
                vals = [
                    raw_b[off_l[i]:off_l[i + 1]] for i in range(nrows)
                ]
            else:
                vals = [
                    raw_b[off_l[i]:off_l[i + 1]] if valid[i] else None
                    for i in range(nrows)
                ]
            cols.append(Column.from_strings(vals))
        else:
            vals_u64, valid = buf
            if stype == SType.BOOL:
                data = vals_u64 != 0
            else:
                data = vals_u64.view(dtype_for(stype))
            cols.append(Column(stype, data, valid.astype(bool)))
    return Relation(list(names), cols, nrows)


def _undot(flat: Dict[str, object]) -> dict:
    """{"a.b": 1} → {"a": {"b": 1}} (for shredding rows inserted via
    SQL VALUES lists)."""
    out: dict = {}
    for k, v in flat.items():
        parts = k.split(".")
        tgt = out
        for p in parts[:-1]:
            tgt = tgt.setdefault(p, {})
        tgt[parts[-1]] = v
    return out


def _repeated_roots(defs, prefix="") -> List[str]:
    """Dotted names of fields that are REPEATED (at any nesting)."""
    out = []
    for d in defs:
        name = prefix + d.column_name
        if d.repeated:
            out.append(name)
        if d.subcolumns is not None:
            out.extend(_repeated_roots(d.subcolumns, name + "."))
    return out


def _from_json(v) -> SValue:
    if v is None:
        return SValue.new_null()
    if isinstance(v, bool):
        return SValue.new_bool(v)
    if isinstance(v, int):
        return SValue.new_uint64(v) if v >= 0 else SValue.new_int64(v)
    if isinstance(v, float):
        return SValue.new_float64(v)
    return SValue.new_string(str(v))


def _coerce(val: SValue, want: SType) -> SValue:
    """Insert-time coercion mirroring the reference's record shredding
    (strings parse to numbers, numbers format to strings)."""
    if val.is_null or val.stype == SType.NIL:
        return SValue.new_null()
    if val.stype == want:
        return val
    payload = val.payload()
    try:
        if want == SType.STRING:
            return SValue.new_string(val.to_string())
        if want in (SType.UINT64, SType.TIMESTAMP64):
            if isinstance(payload, bytes):
                payload = float(payload.decode() or 0)
            v = SValue.new_uint64(int(payload))
            return v if want == SType.UINT64 else SValue.new_timestamp64(v.data)
        if want == SType.FLOAT64:
            if isinstance(payload, bytes):
                payload = payload.decode() or 0
            return SValue.new_float64(float(payload))
        if want == SType.BOOL:
            if isinstance(payload, bytes):
                return SValue.new_bool(payload == b"true")
            return SValue.new_bool(bool(payload))
    except (ValueError, TypeError):
        raise RuntimeError_(
            f"can't convert {val.to_string()} to {want.name}"
        )
    raise RuntimeError_(f"can't convert value to {want.name}")
