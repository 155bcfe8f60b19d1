"""cstable v0.2 file writer — the reference's current default format.

Layout (reference: io/cstable/cstable.h:63-110):

  header   magic(4) ver=2(u16) flags(u64) | metablock a | metablock b |
           reserved(128) | varint ncols | column_info* | pad to 512
  pages    value streams split into pages appended after the header
           (page_manager.cc allocPage: sequential offsets)
  index    varint count + (entry_type, column_id, offset, size) varints
           written after the last data page (cstable.cc:197-211)
  commit   a metablock (txid, num_rows, index_offset, index_size, sha1)
           written into slot txid % 2 (cstable_file.cc:151-176)

Column streams (columns/page_writer_*.cc):
  rlevels  bitpacked, u32 max_value prefix, 128-value simdbp blocks
  dlevels  bitpacked, same layout
  data     LEB128 varints / plain LE u64 / IEEE754 LE f64 /
           bitpacked (bool, uint32) / varint-length strings

The writer keeps one exactly-sized page per stream (the reference
splits at fixed page sizes; readers only follow the index, so page
granularity is a writer choice).
"""

from __future__ import annotations

import hashlib
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.core.types import SType
from eventql_tpu_torch.exec.relation import Column, Relation
from eventql_tpu_torch.columnar.cstable import (
    BOOLEAN_BITPACKED,
    FLOAT_IEEE754,
    STRING_PLAIN,
    UINT64_LEB128,
    _bits,
)
from eventql_tpu_torch.columnar.cstable_writer import leb128_encode, simdbp128_pack

_MAGIC = b"\x23\x17\x23\x17"
_SECTOR = 512

# page index entry types (cstable.h:102-105)
PAGE_DATA = 0x1
PAGE_RLEVEL = 0x2
PAGE_DLEVEL = 0x3

# logical column types (cstable.h:112-120)
_LOGICAL_BOOLEAN = 1
_LOGICAL_UINT = 2
_LOGICAL_STRING = 4
_LOGICAL_FLOAT = 5

_ENC_LOGICAL = {
    BOOLEAN_BITPACKED: _LOGICAL_BOOLEAN,
    UINT64_LEB128: _LOGICAL_UINT,
    FLOAT_IEEE754: _LOGICAL_FLOAT,
    STRING_PLAIN: _LOGICAL_STRING,
}


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _bitpacked_stream(values: np.ndarray, max_value: int) -> bytes:
    """u32 max_value prefix + simdbp 128-value blocks
    (page_writer_bitpacked.cc:40-82). Empty when max_value is 0."""
    if max_value == 0:
        return b""
    return struct.pack("<I", max_value) + simdbp128_pack(
        np.asarray(values), _bits(max_value)
    )


class CSTableV2Writer:
    """Streaming-shape writer: columns are declared with their levels,
    values are appended as (rlvls, dlvls, values) triples, and commit()
    lays out pages + index + metablock."""

    def __init__(self, path: str):
        self.path = path
        self.columns: List[Tuple[str, int, int, int]] = []  # name enc rmax dmax
        self._streams: Dict[str, Tuple[np.ndarray, np.ndarray, object]] = {}

    def add_column(self, name: str, encoding: int, rlevel_max: int, dlevel_max: int):
        self.columns.append((name, encoding, rlevel_max, dlevel_max))

    def set_column_values(self, name: str, rlvls, dlvls, values):
        """values: ndarray for fixed-width encodings, list[bytes] for
        strings — one entry per dlvl == dlevel_max slot."""
        self._streams[name] = (
            np.asarray(rlvls, dtype=np.uint32),
            np.asarray(dlvls, dtype=np.uint32),
            values,
        )

    def _encode_data(self, enc: int, values) -> bytes:
        if enc == UINT64_LEB128:
            return leb128_encode(np.asarray(values))
        if enc == FLOAT_IEEE754:
            return np.asarray(values, dtype="<f8").tobytes()
        if enc == BOOLEAN_BITPACKED:
            return _bitpacked_stream(np.asarray(values, dtype=np.uint64), 1)
        if enc == STRING_PLAIN:
            parts = []
            for s in values:
                parts.append(_varint(len(s)) + bytes(s))
            return b"".join(parts)
        raise RuntimeError_(f"unsupported v0.2 encoding: {enc}")

    def commit(self, num_rows: int, transaction_id: int = 1):
        # -- header (sector padded) -------------------------------------
        hdr = bytearray()
        hdr += _MAGIC
        hdr += struct.pack("<H", 2)
        hdr += struct.pack("<Q", 0)  # flags
        assert len(hdr) == 14  # kMetaBlockPosition
        hdr += b"\x00" * (48 * 2)  # metablock slots
        hdr += b"\x00" * 128  # reserved
        hdr += _varint(len(self.columns))
        for col_id, (name, enc, rmax, dmax) in enumerate(self.columns, 1):
            nb = name.encode()
            hdr += _varint(_ENC_LOGICAL[enc])
            hdr += _varint(enc)
            hdr += _varint(col_id)
            hdr += _varint(len(nb)) + nb
            hdr += _varint(rmax)
            hdr += _varint(dmax)
        pad = (-len(hdr)) % _SECTOR
        hdr += b"\x00" * pad

        # -- pages -------------------------------------------------------
        pages = bytearray()
        index: List[Tuple[int, int, int, int]] = []
        base = len(hdr)

        def alloc(etype: int, col_id: int, data: bytes):
            if not data:
                return
            index.append((etype, col_id, base + len(pages), len(data)))
            pages.extend(data)

        for col_id, (name, enc, rmax, dmax) in enumerate(self.columns, 1):
            rlvls, dlvls, values = self._streams.get(
                name, (np.zeros(0, np.uint32), np.zeros(0, np.uint32), [])
            )
            if rmax > 0:
                alloc(PAGE_RLEVEL, col_id, _bitpacked_stream(rlvls, rmax))
            if dmax > 0:
                alloc(PAGE_DLEVEL, col_id, _bitpacked_stream(dlvls, dmax))
            alloc(PAGE_DATA, col_id, self._encode_data(enc, values))

        # -- index -------------------------------------------------------
        index_offset = base + len(pages)
        idx = bytearray(_varint(len(index)))
        for etype, col_id, off, size in index:
            idx += _varint(etype) + _varint(col_id) + _varint(off) + _varint(size)

        # -- metablock ---------------------------------------------------
        mb_body = struct.pack(
            "<QQQI", transaction_id, num_rows, index_offset, len(idx)
        )
        mb = mb_body + hashlib.sha1(mb_body).digest()
        slot = transaction_id % 2
        hdr[14 + 48 * slot : 14 + 48 * slot + 48] = mb

        with open(self.path, "wb") as f:
            f.write(bytes(hdr))
            f.write(bytes(pages))
            f.write(bytes(idx))


def _flat_column_streams(col: Column):
    """(dlvls, values) for a flat nullable column (rmax=0, dmax=1)."""
    n = len(col.data)
    dlvls = col.valid.astype(np.uint32)
    if col.stype == SType.STRING:
        strs = col.dictionary[col.data]
        values = [bytes(strs[i]) for i in range(n) if col.valid[i]]
    else:
        values = col.data[col.valid]
        if col.stype in (SType.UINT64, SType.TIMESTAMP64, SType.INT64):
            values = values.view(np.uint64)
    return dlvls, values


def _flat_encoding(stype: SType) -> int:
    if stype == SType.STRING:
        return STRING_PLAIN
    if stype == SType.BOOL:
        return BOOLEAN_BITPACKED
    if stype == SType.FLOAT64:
        return FLOAT_IEEE754
    if stype in (SType.UINT64, SType.TIMESTAMP64, SType.INT64):
        return UINT64_LEB128
    raise RuntimeError_(f"unsupported column type for cstable: {stype}")


def write_cstable_v2(path: str, rel: Relation, transaction_id: int = 1):
    """Write a Relation of flat nullable columns as a cstable v0.2 file."""
    w = CSTableV2Writer(path)
    for name, col in zip(rel.names, rel.columns):
        enc = _flat_encoding(col.stype)
        w.add_column(name, enc, 0, 1)
        dlvls, values = _flat_column_streams(col)
        w.set_column_values(name, np.zeros(len(dlvls), np.uint32), dlvls, values)
    w.commit(rel.num_rows, transaction_id)
