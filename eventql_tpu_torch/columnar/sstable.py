"""sstable v3: append-only (key, value) row files.

Re-implements the reference's sstable binary format v3
(reference: io/sstable/binaryformat.h:33-80):

  header  magic 17171717, u16 version=3, u64 flags (1 = finalized),
          u64 num_rows, u64 body_size, u32 userdata_checksum,
          u32 userdata_size, userdata
  row     u32 checksum, u32 key_size, u32 data_size, key, data
          (checksum = FNV-1a-32 over key_size|data_size|key|data,
          RowWriter.cc:36-42)

The reference uses sstables for MapReduce shuffle/result files
(mapreduce_service.cc:177, 460); ours serve the same role.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List, Optional, Tuple

from eventql_tpu_torch.core.errors import RuntimeError_

_MAGIC = b"\x17\x17\x17\x17"
_VERSION = 3
FLAG_FINALIZED = 1

_FNV32_BASIS = 0x811C9DC5
_FNV32_PRIME = 0x01000193


def _fnv32(*chunks: bytes) -> int:
    h = _FNV32_BASIS
    for chunk in chunks:
        for b in chunk:
            h = ((h ^ b) * _FNV32_PRIME) & 0xFFFFFFFF
    return h


def _row_checksum(key: bytes, data: bytes) -> int:
    return _fnv32(
        struct.pack("<I", len(key)), struct.pack("<I", len(data)), key, data
    )


class SSTableWriter:
    """Streaming writer (reference: SSTableWriter::create +
    RowWriter::appendRow; finalize rewrites the header with the row
    count, body size, and the FINALIZED flag)."""

    def __init__(self, path: str, userdata: bytes = b""):
        self.path = path
        self.userdata = userdata
        self.num_rows = 0
        self.body_size = 0
        self._f = open(path, "wb")
        self._write_header(finalized=False)

    def _write_header(self, finalized: bool):
        hdr = bytearray()
        hdr += _MAGIC
        hdr += struct.pack("<H", _VERSION)
        hdr += struct.pack("<Q", FLAG_FINALIZED if finalized else 0)
        hdr += struct.pack("<Q", self.num_rows)
        hdr += struct.pack("<Q", self.body_size)
        hdr += struct.pack("<I", _fnv32(self.userdata))
        hdr += struct.pack("<I", len(self.userdata))
        hdr += self.userdata
        self._f.seek(0)
        self._f.write(bytes(hdr))

    def append(self, key: bytes, data: bytes):
        row = (
            struct.pack(
                "<III", _row_checksum(key, data), len(key), len(data)
            )
            + key
            + data
        )
        self._f.seek(0, os.SEEK_END)
        self._f.write(row)
        self.num_rows += 1
        self.body_size += len(row)

    def finalize(self):
        self._write_header(finalized=True)
        self._f.close()


class SSTableReader:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.data = f.read()
        if self.data[:4] != _MAGIC:
            raise RuntimeError_("not a valid sstable file")
        (version,) = struct.unpack("<H", self.data[4:6])
        if version != _VERSION:
            raise RuntimeError_(f"unsupported sstable version: {version}")
        (self.flags,) = struct.unpack("<Q", self.data[6:14])
        (self.num_rows,) = struct.unpack("<Q", self.data[14:22])
        (self.body_size,) = struct.unpack("<Q", self.data[22:30])
        (_ud_csum,) = struct.unpack("<I", self.data[30:34])
        (ud_size,) = struct.unpack("<I", self.data[34:38])
        self.userdata = self.data[38 : 38 + ud_size]
        if _fnv32(self.userdata) != _ud_csum:
            raise RuntimeError_("sstable userdata checksum mismatch")
        self._body_offset = 38 + ud_size

    @property
    def finalized(self) -> bool:
        return bool(self.flags & FLAG_FINALIZED)

    def cursor(self) -> Iterator[Tuple[bytes, bytes]]:
        pos = self._body_offset
        end = self._body_offset + self.body_size
        while pos < end:
            csum, ksize, dsize = struct.unpack(
                "<III", self.data[pos : pos + 12]
            )
            pos += 12
            key = self.data[pos : pos + ksize]
            pos += ksize
            data = self.data[pos : pos + dsize]
            pos += dsize
            if _row_checksum(key, data) != csum:
                raise RuntimeError_("sstable row checksum mismatch")
            yield key, data

    def rows(self) -> List[Tuple[bytes, bytes]]:
        return list(self.cursor())
