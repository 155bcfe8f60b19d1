"""cstable columnar file reader (vectorized).

Re-implements BOTH on-disk versions of the reference's cstable format:

v0.1 (format spec: io/cstable/cstable.h:38-135; header parse:
io/cstable/cstable.cc:87-132; per-column body layout:
io/cstable/columns/v1/ColumnReader.h — [vals_total u64][rlvl_size u64]
[dlvl_size u64][data_size u64][rlvl simdbp128][dlvl simdbp128][data]).

v0.2 (format spec: cstable.h:63-110): sector-padded header with dual
sha1-checksummed metablocks (cstable.cc:106-166), then data pages
tracked by a page index ((entry_type, column_id, offset, size) rows,
cstable.cc:197-223); per-column value streams are split across pages:
rlevels/dlevels as bitpacked pages with a u32 max_value prefix
(columns/page_writer_bitpacked.cc), data as LEB128 / plain u64/u32 /
IEEE754 / varint-length strings (columns/page_writer_*.cc). The row
count lives in the winning metablock (highest transaction id).

Levels use simdcomp's SIMD-BP128 vertical bit-packing (128-value blocks,
util/util/BitPackDecoder.cc + libsimdcomp); decoded here as whole-column
numpy bit arithmetic instead of the reference's per-value decoder loop.

Data encodings (io/cstable/columns/v1/*.cc):
  BOOLEAN_BITPACKED   simdbp128, maxbits=1
  UINT32_BITPACKED    [u32 max_value][simdbp128 with bits(max_value)]
  UINT32_PLAIN        little-endian u32
  UINT64_PLAIN        little-endian u64
  UINT64_LEB128       LEB128 varints
  FLOAT_IEEE754       little-endian f64
  STRING_PLAIN        [u32 len][bytes]
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.core.types import SType
from eventql_tpu_torch.exec.relation import Column, Relation

# column encodings (reference: cstable.h:122-130)
BOOLEAN_BITPACKED = 1
UINT32_BITPACKED = 10
UINT32_PLAIN = 11
UINT64_PLAIN = 12
UINT64_LEB128 = 13
FLOAT_IEEE754 = 14
STRING_PLAIN = 100

_ENCODING_STYPE = {
    BOOLEAN_BITPACKED: SType.BOOL,
    UINT32_BITPACKED: SType.UINT64,
    UINT32_PLAIN: SType.UINT64,
    UINT64_PLAIN: SType.UINT64,
    UINT64_LEB128: SType.UINT64,
    FLOAT_IEEE754: SType.FLOAT64,
    STRING_PLAIN: SType.STRING,
}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    v = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return v, pos


def _bits(v: int) -> int:
    b = 0
    while v:
        b += 1
        v >>= 1
    return b


def simdbp128_unpack(buf: bytes, n: int, maxbits: int) -> np.ndarray:
    """Decode n values from simdcomp vertical bit-packing: blocks of 128
    values, 16*maxbits bytes per block; value order within a block is
    out[4*k + lane] for lane-major SIMD lanes."""
    if maxbits == 0:
        return np.zeros(n, dtype=np.uint32)
    from eventql_tpu_torch.columnar import native

    out = native.simdbp128_unpack(bytes(buf), n, maxbits)
    if out is not None:
        return out
    nblocks = (n + 127) // 128
    need = nblocks * 16 * maxbits
    words = np.frombuffer(buf, dtype="<u4", count=need // 4)
    # (block, word, lane)
    W = words.reshape(nblocks, maxbits, 4)
    # per lane, bits of the 32-value stream, LSB-first within each word
    # -> bit matrix (block, lane, 32*maxbits)
    Wb = W.transpose(0, 2, 1).copy()  # (block, lane, word)
    bytes_view = Wb.view(np.uint8).reshape(nblocks, 4, maxbits * 4)
    bits = np.unpackbits(bytes_view, axis=2, bitorder="little")
    # value k of lane j = bits[k*maxbits:(k+1)*maxbits]
    bits = bits.reshape(nblocks, 4, 32, maxbits)
    weights = (1 << np.arange(maxbits, dtype=np.uint64))
    vals = (bits.astype(np.uint64) * weights).sum(axis=3)  # (block, lane, k)
    # output order 4*k + lane → transpose to (block, k, lane)
    out = vals.transpose(0, 2, 1).reshape(-1)
    return out[:n].astype(np.uint32)


def leb128_decode(buf: bytes, count: int) -> np.ndarray:
    """Vectorized LEB128 varint decode of `count` values."""
    if count == 0:
        return np.zeros(0, dtype=np.uint64)
    from eventql_tpu_torch.columnar import native

    out = native.leb128_decode(bytes(buf), count)
    if out is not None:
        return out
    b = np.frombuffer(buf, dtype=np.uint8)
    cont = (b & 0x80) != 0
    # value index per byte: increments after a byte without cont bit
    ends = ~cont
    vidx = np.concatenate([[0], np.cumsum(ends)[:-1]])
    nvals = int(vidx[-1]) + 1
    if nvals < count:
        raise RuntimeError_("corrupt LEB128 column data")
    # byte position within its value
    starts = np.concatenate([[0], np.nonzero(ends)[0] + 1])
    pos = np.arange(len(b)) - starts[vidx]
    out = np.zeros(nvals, dtype=np.uint64)
    np.add.at(out, vidx, (b & 0x7F).astype(np.uint64) << (7 * pos.astype(np.uint64)))
    return out[:count]


@dataclass
class ColumnConfig:
    name: str
    encoding: int
    stype: SType
    rlevel_max: int
    dlevel_max: int
    body_offset: int
    body_size: int


@dataclass
class DecodedColumn:
    config: ColumnConfig
    rlvls: np.ndarray  # per-value repetition levels
    dlvls: np.ndarray  # per-value definition levels
    values: object  # ndarray for fixed width; list[bytes] for strings
    # values has one entry per dlvl==dlevel_max position


class CSTableReader:
    def __init__(self, path: str, fd: int = None):
        if fd is not None:
            # read through a pinned descriptor: the path may have been
            # renamed/unlinked since the caller snapshotted it (LSM
            # compaction retiring segments mid-stream) — POSIX keeps
            # the open file's data readable
            self.data = os.pread(fd, os.fstat(fd).st_size, 0)
        else:
            with open(path, "rb") as f:
                self.data = f.read()
        if self.data[:4] != b"\x23\x17\x23\x17":
            raise RuntimeError_("not a valid cstable file")
        version = self.data[4]
        if version == 1:
            self._parse_v1()
        elif version == 2:
            self._parse_v2()
        else:
            raise RuntimeError_(f"unsupported cstable version: {version}")

    # -- header ---------------------------------------------------------
    def _parse_v1(self):
        d = self.data
        (_flags, num_rows) = struct.unpack("<QQ", d[6:22])
        (ncols,) = struct.unpack("<I", d[22:26])
        self.num_rows = num_rows
        cols = []
        off = 26
        for _ in range(ncols):
            ctype, nlen = struct.unpack("<II", d[off : off + 8])
            off += 8
            name = d[off : off + nlen].decode()
            off += nlen
            rmax, dmax = struct.unpack("<II", d[off : off + 8])
            off += 8
            cstart, csz = struct.unpack("<QQ", d[off : off + 16])
            off += 16
            if ctype not in _ENCODING_STYPE:
                raise RuntimeError_(f"unsupported column type: {ctype}")
            cols.append(
                ColumnConfig(
                    name, ctype, _ENCODING_STYPE[ctype], rmax, dmax, cstart, csz
                )
            )
        # reference sorts columns by name (cstable.cc:126-131)
        cols.sort(key=lambda c: c.name)
        self.columns = cols
        self._by_name = {c.name: c for c in cols}
        self._decoded: Dict[str, DecodedColumn] = {}

    def _parse_v2(self):
        import hashlib

        d = self.data
        # header: magic(4) ver(2) flags(8) mb_a(48) mb_b(48) reserved(128)
        pos = 14
        metablocks = []
        for _ in range(2):
            blk = d[pos : pos + 48]
            pos += 48
            body, digest = blk[:28], blk[28:48]
            if hashlib.sha1(body).digest() == digest:
                txid, nrows, idx_off, idx_size = struct.unpack("<QQQI", body)
                metablocks.append((txid, nrows, idx_off, idx_size))
        if not metablocks:
            raise RuntimeError_("can't open cstable: no valid metablocks found")
        txid, num_rows, idx_off, idx_size = max(metablocks)
        self.num_rows = num_rows
        self.transaction_id = txid

        pos += 128  # reserved
        ncols, pos = _read_varint(d, pos)
        cols = []
        self._col_ids = {}
        for _ in range(ncols):
            _ltype, pos = _read_varint(d, pos)
            enc, pos = _read_varint(d, pos)
            col_id, pos = _read_varint(d, pos)
            nlen, pos = _read_varint(d, pos)
            name = d[pos : pos + nlen].decode()
            pos += nlen
            rmax, pos = _read_varint(d, pos)
            dmax, pos = _read_varint(d, pos)
            if enc not in _ENCODING_STYPE:
                raise RuntimeError_(f"unsupported column type: {enc}")
            cols.append(
                ColumnConfig(name, enc, _ENCODING_STYPE[enc], rmax, dmax, 0, 0)
            )
            self._col_ids[name] = col_id
        self.columns = cols
        self._by_name = {c.name: c for c in cols}
        self._decoded: Dict[str, DecodedColumn] = {}

        # page index: varint count + (type, col_id, offset, size) rows
        ipos = idx_off
        nentries, ipos = _read_varint(d, ipos)
        self._page_index: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        for _ in range(nentries):
            etype, ipos = _read_varint(d, ipos)
            col_id, ipos = _read_varint(d, ipos)
            off, ipos = _read_varint(d, ipos)
            size, ipos = _read_varint(d, ipos)
            self._page_index.setdefault((etype, col_id), []).append((off, size))
        self.version = 2

    def _pages(self, etype: int, col_id: int) -> bytes:
        """Concatenated page data for one (entry type, column) stream."""
        parts = [
            self.data[off : off + size]
            for off, size in self._page_index.get((etype, col_id), [])
        ]
        return b"".join(parts)

    def _decode_bitpacked_stream(self, buf: bytes, count_hint: int) -> np.ndarray:
        """A v0.2 bitpacked level stream: u32 max_value then 128-value
        simdbp blocks (with zero padding in the final block)."""
        if not buf:
            return np.zeros(count_hint, dtype=np.uint32)
        (max_value,) = struct.unpack("<I", buf[:4])
        maxbits = _bits(max_value)
        if maxbits == 0:
            return np.zeros(count_hint, dtype=np.uint32)
        navail = (len(buf) - 4) // (16 * maxbits) * 128
        return simdbp128_unpack(buf[4:], min(count_hint, navail), maxbits)

    def _decode_column_v2(self, cfg: ColumnConfig) -> DecodedColumn:
        col_id = self._col_ids[cfg.name]
        data = self._pages(0x1, col_id)
        rl_buf = self._pages(0x2, col_id)
        dl_buf = self._pages(0x3, col_id)

        if cfg.rlevel_max == 0:
            # flat column: exactly one value slot per row
            vals_total = self.num_rows
            rlvls = np.zeros(vals_total, dtype=np.uint32)
        else:
            # the value count isn't stored; the final bitpacked block is
            # zero-padded, and each padding zero would begin a spurious
            # record — cut the stream after the num_rows-th record
            upper = (len(rl_buf) - 4) * 8  # generous bound
            rl_all = self._decode_bitpacked_stream(rl_buf, upper)
            starts = np.nonzero(rl_all == 0)[0]
            if len(starts) > self.num_rows:
                vals_total = int(starts[self.num_rows])
            else:
                vals_total = len(rl_all)
            rlvls = rl_all[:vals_total]

        if cfg.dlevel_max == 0:
            dlvls = np.zeros(vals_total, dtype=np.uint32)
        else:
            dlvls = self._decode_bitpacked_stream(dl_buf, vals_total)
        ndefined = int((dlvls == cfg.dlevel_max).sum())

        enc = cfg.encoding
        if enc == UINT64_LEB128:
            values = leb128_decode(data, ndefined)
        elif enc == UINT64_PLAIN:
            values = np.frombuffer(data, dtype="<u8", count=ndefined).astype(np.uint64)
        elif enc == UINT32_PLAIN:
            values = np.frombuffer(data, dtype="<u4", count=ndefined).astype(np.uint64)
        elif enc == FLOAT_IEEE754:
            values = np.frombuffer(data, dtype="<f8", count=ndefined).astype(np.float64)
        elif enc == BOOLEAN_BITPACKED:
            values = self._decode_bitpacked_stream(data, ndefined).astype(bool)
        elif enc == UINT32_BITPACKED:
            values = self._decode_bitpacked_stream(data, ndefined).astype(np.uint64)
        elif enc == STRING_PLAIN:
            # v0.2 strings are varint-length-prefixed
            # (page_writer_lenencstring.cc), unlike v0.1's u32 prefix
            values = []
            q = 0
            for _ in range(ndefined):
                slen, q = _read_varint(data, q)
                values.append(data[q : q + slen])
                q += slen
        else:
            raise RuntimeError_(f"unsupported column type: {enc}")

        return DecodedColumn(cfg, rlvls, dlvls, values)

    # -- column decode --------------------------------------------------
    def has_column(self, name: str) -> bool:
        return name in self._by_name

    def column_config(self, name: str) -> Optional[ColumnConfig]:
        return self._by_name.get(name)

    def decode_column(self, name: str) -> DecodedColumn:
        if name in self._decoded:
            return self._decoded[name]
        cfg = self._by_name.get(name)
        if cfg is None:
            raise RuntimeError_(f"column(s) not found: '{name}'")
        if getattr(self, "version", 1) == 2:
            out = self._decode_column_v2(cfg)
            self._decoded[name] = out
            return out
        body = self.data[cfg.body_offset : cfg.body_offset + cfg.body_size]
        vals_total, rlvl_size, dlvl_size, data_size = struct.unpack(
            "<QQQQ", body[:32]
        )
        p = 32
        rl_buf = body[p : p + rlvl_size]
        p += rlvl_size
        dl_buf = body[p : p + dlvl_size]
        p += dlvl_size
        data = body[p:]

        rlvls = simdbp128_unpack(rl_buf, vals_total, _bits(cfg.rlevel_max))
        dlvls = simdbp128_unpack(dl_buf, vals_total, _bits(cfg.dlevel_max))
        ndefined = int((dlvls == cfg.dlevel_max).sum())

        enc = cfg.encoding
        if enc == UINT64_LEB128:
            values = leb128_decode(data, ndefined)
        elif enc == UINT64_PLAIN:
            values = np.frombuffer(data, dtype="<u8", count=ndefined).astype(np.uint64)
        elif enc == UINT32_PLAIN:
            values = np.frombuffer(data, dtype="<u4", count=ndefined).astype(np.uint64)
        elif enc == FLOAT_IEEE754:
            values = np.frombuffer(data, dtype="<f8", count=ndefined).astype(np.float64)
        elif enc == BOOLEAN_BITPACKED:
            values = simdbp128_unpack(data, ndefined, 1).astype(bool)
        elif enc == UINT32_BITPACKED:
            (max_value,) = struct.unpack("<I", data[:4])
            values = simdbp128_unpack(
                data[4:], ndefined, _bits(max_value)
            ).astype(np.uint64)
        elif enc == STRING_PLAIN:
            values = []
            q = 0
            for _ in range(ndefined):
                (slen,) = struct.unpack("<I", data[q : q + 4])
                q += 4
                values.append(data[q : q + slen])
                q += slen
        else:
            raise RuntimeError_(f"unsupported column type: {enc}")

        out = DecodedColumn(cfg, rlvls, dlvls, values)
        self._decoded[name] = out
        return out

    # -- flat relation view --------------------------------------------
    def flat_column(self, name: str) -> Column:
        """Decode a column as one value per row. Only valid for flat
        columns (rlevel_max == 0)."""
        dec = self.decode_column(name)
        cfg = dec.config
        if cfg.rlevel_max != 0:
            raise RuntimeError_(
                f"column '{name}' is repeated; flat scan unsupported"
            )
        valid = dec.dlvls == cfg.dlevel_max
        n = len(dec.dlvls)
        if cfg.stype == SType.STRING:
            vals: List[Optional[bytes]] = [None] * n
            it = iter(dec.values)
            for i in np.nonzero(valid)[0]:
                vals[i] = next(it)
            return Column.from_strings(vals)
        from eventql_tpu_torch.exec.relation import dtype_for

        data = np.zeros(n, dtype=dtype_for(cfg.stype))
        data[valid] = dec.values
        return Column(cfg.stype, data, valid.astype(bool))

    def to_relation(self, flat_only: bool = True) -> Relation:
        """Materialize all flat columns as a Relation; repeated columns
        are skipped in flat mode (the reference's vectorized scan path
        also rejects them: sql/CSTableScan.cc:783-784)."""
        names, cols = [], []
        for cfg in self.columns:
            if cfg.rlevel_max != 0:
                if flat_only:
                    continue
                raise RuntimeError_("nested materialization not supported yet")
            names.append(cfg.name)
            cols.append(self.flat_column(cfg.name))
        return Relation(names, cols, self.num_rows)


def load_cstable_table(path: str) -> Relation:
    return CSTableReader(path).to_relation()
