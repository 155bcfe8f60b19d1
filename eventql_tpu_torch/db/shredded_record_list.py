"""ShreddedRecordList: the reference's column-shredded record batch
wire encoding, used by replication pushes (EVQL_OP_REPL_INSERT) and the
insert forwarding path.

Format (reference: db/shredded_record.cc:82-136 encode/decode):
  u8 magic 0x01
  varint nrecords, varint ncolumns
  nrecords × 20-byte SHA1 record ids
  nrecords × varint record versions
  per column: lenenc column_name, varint nvalues,
              nvalues × (varint dlvl, varint rlvl, lenenc value)

Values travel as strings (the reference's shredded values are string
payloads re-typed by the receiving insert path); dlvl=0 with an empty
value encodes NULL for flat columns.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Tuple

from eventql_tpu_torch.server.native_tcp import (
    read_lenencstr,
    read_varint,
    write_lenencstr,
    write_varint,
)


@dataclass
class ShreddedColumn:
    column_name: str
    # (dlvl, rlvl, value bytes)
    values: List[Tuple[int, int, bytes]] = field(default_factory=list)


@dataclass
class ShreddedRecordList:
    record_ids: List[bytes] = field(default_factory=list)  # 20-byte SHA1s
    record_versions: List[int] = field(default_factory=list)
    columns: List[ShreddedColumn] = field(default_factory=list)

    def encode(self) -> bytes:
        out = bytearray()
        out.append(0x01)
        out += write_varint(len(self.record_ids))
        out += write_varint(len(self.columns))
        for rid in self.record_ids:
            assert len(rid) == 20
            out += rid
        for v in self.record_versions:
            out += write_varint(v)
        for col in self.columns:
            out += write_lenencstr(col.column_name.encode("utf-8"))
            out += write_varint(len(col.values))
            for dlvl, rlvl, value in col.values:
                out += write_varint(dlvl)
                out += write_varint(rlvl)
                out += write_lenencstr(value)
        return bytes(out)

    @staticmethod
    def decode(buf: bytes) -> "ShreddedRecordList":
        if not buf or buf[0] != 0x01:
            raise ValueError("bad ShreddedRecordList magic")
        pos = 1
        nrecs, pos = read_varint(buf, pos)
        ncols, pos = read_varint(buf, pos)
        out = ShreddedRecordList()
        for _ in range(nrecs):
            out.record_ids.append(bytes(buf[pos:pos + 20]))
            pos += 20
        for _ in range(nrecs):
            v, pos = read_varint(buf, pos)
            out.record_versions.append(v)
        for _ in range(ncols):
            name, pos = read_lenencstr(buf, pos)
            n, pos = read_varint(buf, pos)
            col = ShreddedColumn(name.decode("utf-8"))
            for _ in range(n):
                dlvl, pos = read_varint(buf, pos)
                rlvl, pos = read_varint(buf, pos)
                value, pos = read_lenencstr(buf, pos)
                col.values.append((dlvl, rlvl, value))
            out.columns.append(col)
        return out


def _wire_str(v) -> bytes:
    """Stringify a payload for the wire so the receiving insert path's
    string coercion re-types it exactly (floats use repr's shortest
    round-trip; the display formatter's fixed 6 decimals would lose
    precision)."""
    if isinstance(v, bytes):
        return v
    if isinstance(v, bool):
        return b"true" if v else b"false"
    if isinstance(v, float):
        return repr(v).encode()
    return str(v).encode()


def from_relation(rel, pk_names=None, version: int = 1) -> ShreddedRecordList:
    """Build a flat-record list from a Relation. Record ids are SHA1 of
    the packed primary key (the reference keys records by their pk
    SHA1, db/table_service.cc:795-837)."""
    out = ShreddedRecordList()
    cols = []
    for name, col in zip(rel.names, rel.columns):
        sc = ShreddedColumn(name)
        for i in range(rel.num_rows):
            if col.valid[i]:
                sc.values.append((1, 0, _wire_str(col.value_at(i).payload())))
            else:
                sc.values.append((0, 0, b""))
        cols.append(sc)
    out.columns = cols
    pk_idx = (
        [rel.names.index(k) for k in pk_names] if pk_names else []
    )
    for i in range(rel.num_rows):
        if pk_idx:
            key = b"\x00".join(
                _wire_str(rel.columns[j].value_at(i).payload())
                for j in pk_idx
            )
        else:
            key = b"\x00".join(
                _wire_str(c.value_at(i).payload()) if c.valid[i] else b""
                for c in rel.columns
            )
        out.record_ids.append(hashlib.sha1(key).digest())
        out.record_versions.append(version)
    return out


def to_row_dicts(records: ShreddedRecordList, schema=None) -> List[dict]:
    """Flat records back to row dicts for the insert path. With a
    schema ({column: SType}) the wire strings re-type losslessly here
    (uint64 via int(), not the insert path's float() coercion — which
    would corrupt keys above 2^53 and leave anti-entropy re-pushing
    the same rows forever); unknown columns stay strings and re-type
    through the standard insert coercions."""
    from eventql_tpu_torch.core.types import SType

    nrecs = len(records.record_ids)
    rows = [dict() for _ in range(nrecs)]
    schema = schema or {}
    for col in records.columns:
        if len(col.values) != nrecs:
            raise ValueError(
                f"column '{col.column_name}' has {len(col.values)} values "
                f"for {nrecs} records (nested records not supported here)"
            )
        want = schema.get(col.column_name)
        for i, (dlvl, _rlvl, value) in enumerate(col.values):
            if dlvl <= 0:
                continue
            s = value.decode("utf-8", "surrogateescape")
            if want in (SType.UINT64, SType.INT64, SType.TIMESTAMP64):
                v = int(s)
            elif want == SType.FLOAT64:
                v = float(s)
            elif want == SType.BOOL:
                v = s == "true"
            else:
                v = s
            rows[i][col.column_name] = v
    return rows
