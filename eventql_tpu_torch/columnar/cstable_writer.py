"""cstable v0.1 file writer.

Produces files our reader (and the reference's v0.1 reader) can open
(format: io/cstable/cstable.h:44-60 v0.1 header; column body layout
io/cstable/columns/v1/ColumnReader.h: [vals_total u64][rlvl_size u64]
[dlvl_size u64][data_size u64][rlvl simdbp128][dlvl simdbp128][data]).

Flat nullable columns (rlevel_max=0, dlevel_max=1). Encodings:
UINT64_LEB128 for integers/timestamps, FLOAT_IEEE754, STRING_PLAIN,
BOOLEAN_BITPACKED.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.core.types import SType
from eventql_tpu_torch.exec.relation import Column, Relation
from eventql_tpu_torch.columnar.cstable import (
    BOOLEAN_BITPACKED,
    FLOAT_IEEE754,
    STRING_PLAIN,
    UINT64_LEB128,
)

_MAGIC = b"\x23\x17\x23\x17"


def simdbp128_pack(values: np.ndarray, maxbits: int) -> bytes:
    """Inverse of simdbp128_unpack (vectorized)."""
    if maxbits == 0:
        return b""
    n = len(values)
    nblocks = -(-n // 128)
    padded = np.zeros(nblocks * 128, dtype=np.uint64)
    padded[:n] = values.astype(np.uint64)
    # (block, k, lane) -> per-lane stream of 32 values
    v = padded.reshape(nblocks, 32, 4)
    # bits (block, lane, 32*maxbits) little-endian per value
    shifts = np.arange(maxbits, dtype=np.uint64)
    bits = ((v[:, :, :, None] >> shifts) & np.uint64(1)).astype(np.uint8)
    # order: lane-major streams: (block, lane, k, bit)
    bits = bits.transpose(0, 2, 1, 3).reshape(nblocks, 4, 32 * maxbits)
    packed = np.packbits(bits, axis=2, bitorder="little")  # (block, lane, 4*maxbits)
    # back to word-interleaved layout: (block, word, lane)
    words = np.ascontiguousarray(
        packed.reshape(nblocks, 4, maxbits, 4)
    )  # lane, word, byte
    words_u32 = words.view("<u4").reshape(nblocks, 4, maxbits)
    out = words_u32.transpose(0, 2, 1)  # (block, word, lane)
    return np.ascontiguousarray(out).astype("<u4").tobytes()


def leb128_encode(values: np.ndarray) -> bytes:
    # native C encoder when available (the Python per-byte loop was
    # 66% of the whole insert wall — PERF.md insert ladder); the two
    # are differentially tested bit-for-bit (tests/test_native_codec)
    from eventql_tpu_torch.columnar import native as _native

    encoded = _native.leb128_encode(np.asarray(values))
    if encoded is not None:
        return encoded
    out = bytearray()
    for v in values:
        v = int(v)
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out.append(b | 0x80)
            else:
                out.append(b)
                break
    return bytes(out)


def _encode_column(col: Column):
    """Returns (encoding, body bytes) for a flat nullable column."""
    n = len(col.data)
    valid = col.valid.astype(np.uint64)
    dlvl_buf = simdbp128_pack(valid, 1)

    if col.stype == SType.STRING:
        enc = STRING_PLAIN
        strs = col.dictionary[col.data]
        parts = []
        for i in range(n):
            if col.valid[i]:
                s = bytes(strs[i])
                parts.append(struct.pack("<I", len(s)) + s)
        data = b"".join(parts)
    elif col.stype == SType.BOOL:
        enc = BOOLEAN_BITPACKED
        vals = col.data[col.valid].astype(np.uint64)
        data = simdbp128_pack(vals, 1)
    elif col.stype == SType.FLOAT64:
        enc = FLOAT_IEEE754
        data = col.data[col.valid].astype("<f8").tobytes()
    elif col.stype in (SType.UINT64, SType.TIMESTAMP64, SType.INT64):
        enc = UINT64_LEB128
        data = leb128_encode(col.data[col.valid].view(np.uint64))
    else:
        raise RuntimeError_(f"unsupported column type for cstable: {col.stype}")

    body = (
        struct.pack("<QQQQ", n, 0, len(dlvl_buf), len(data))
        + dlvl_buf
        + data
    )
    return enc, body


def write_cstable(path: str, rel: Relation):
    """Write a Relation as a cstable v0.1 file."""
    encoded = []
    for name, col in zip(rel.names, rel.columns):
        enc, body = _encode_column(col)
        encoded.append((name, enc, body))

    # header layout: magic, version u16, flags u64, nrows u64, ncols u32,
    # then per-column: type u32, namelen u32, name, rmax u32, dmax u32,
    # offset u64, size u64  (cstable.cc:87-132)
    header_size = 4 + 2 + 8 + 8 + 4
    for name, _enc, _body in encoded:
        header_size += 4 + 4 + len(name.encode()) + 4 + 4 + 8 + 8

    out = bytearray()
    out += _MAGIC
    out += struct.pack("<H", 1)
    out += struct.pack("<Q", 0)  # flags
    out += struct.pack("<Q", rel.num_rows)
    out += struct.pack("<I", len(encoded))

    offset = header_size
    bodies = []
    for name, enc, body in encoded:
        nb = name.encode()
        out += struct.pack("<II", enc, len(nb))
        out += nb
        out += struct.pack("<II", 0, 1)  # rmax, dmax
        out += struct.pack("<QQ", offset, len(body))
        bodies.append(body)
        offset += len(body)

    with open(path, "wb") as f:
        f.write(bytes(out))
        for body in bodies:
            f.write(body)
