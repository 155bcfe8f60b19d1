"""The general GROUP BY on the card: a hash aggregate.

Replaces no TPU kernel. The JAX package groups with ``lax.sort`` and
``associative_scan`` (eventql_tpu/kernels/groupby.py:
``masked_grouped_aggregate``, ``masked_grouped_count_distinct``), since
the TPU has no per-lane scatter. Hopper has global 64-bit atomics, so
``csrc/hash_groupby.cu`` builds an open-addressed table of the key
tuples in device memory and aggregates with atomics, with no sort:

* ``evql_hash_group_ids``: each masked-in row finds or claims the slot
  of its key tuple (``atomicCAS`` of its row index, the tuple compared
  with the holder's), then the occupied slots take dense group ids;
* ``evql_hash_aggregate``: count, first row, and per value stream a sum,
  min, max or mean by group, with 64-bit atomics;
* ``evql_hash_count_distinct``: a second table keyed by (group,
  payload), whose first insert counts.

It is bound by bytes (each key, value and mask stream read once); the
table (``table_slots(n)`` int32 slots, at least 2n) and the 4-byte slot
of each row come on top, and so does one read of the group count before
the aggregates are allocated.

``hash_groupby`` launches the kernels for CUDA tensors and uses the
plain version (``hash_groupby_plain``: ``masked_grouped_aggregate`` and
``masked_grouped_count_distinct`` of kernels/groupby.py) for CPU tensors
only; both return a ``Grouped``, and both follow kernels/groupby.py's
contract: exact counts and integer sums, min / max of u64 streams in
unsigned order, NaN that wins a min / max / mean, -0.0 read as +0.0 by
min / max, float sums in no guaranteed order. Groups come in no
particular order (the plain version: ascending keys; the kernel: hash
order); ``in_first_row_order`` puts either in the order of their first
rows. ``LAUNCHES`` counts the wrapper's calls that launched the
kernels.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from eventql_tpu_torch.kernels import _build
from eventql_tpu_torch.kernels.groupby import (
    AGG_KINDS,
    masked_grouped_aggregate,
    masked_grouped_count_distinct,
)

# wrapper calls that launched the kernels (plain-version calls do not count)
LAUNCHES = {"hash_groupby": 0}

MAX_KEYS = 9  # key words of one tuple (csrc: MAX_KEYS)
MAX_VALUES = 16  # value streams of one aggregate launch (csrc: MAX_VALUES)
MAX_ROWS = 1 << 30  # int32 row indices in a table of 2n slots

_DT_I16, _DT_U16, _DT_I32, _DT_U32, _DT_I64, _DT_F64, _DT_U8 = range(7)
_OP = {("sum", "int"): 0, ("min", "u64"): 1, ("max", "u64"): 2, ("min", "int"): 3,
       ("max", "int"): 4, ("min", "float"): 5, ("max", "float"): 6,
       ("sum", "float"): 7, ("mean", "float"): 8}


class Grouped(NamedTuple):
    """G groups: each one's smallest row index, its row count, one
    tensor per value stream (int64, u64 as bit patterns, or float64),
    and one per count_distinct stream (int64)."""

    first_index: torch.Tensor
    counts: torch.Tensor
    aggregates: Tuple[torch.Tensor, ...]
    distinct: Tuple[torch.Tensor, ...]


def in_first_row_order(g: Grouped) -> Grouped:
    """The same groups, ordered by their first rows (the host engine's
    group order)."""
    order = torch.argsort(g.first_index)
    return Grouped(g.first_index[order], g.counts[order],
                   tuple(a[order] for a in g.aggregates),
                   tuple(d[order] for d in g.distinct))


def table_slots(n: int) -> int:
    """Slots of the group table for n rows: a power of two, at least 2n."""
    return 1 << max(1, (2 * int(n) - 1).bit_length())


def _key_dt(t: torch.Tensor) -> int:
    codes = {torch.int16: _DT_I16, torch.int32: _DT_I32, torch.int64: _DT_I64,
             torch.float64: _DT_F64, torch.bool: _DT_U8, torch.uint8: _DT_U8}
    if t.dtype not in codes:
        raise TypeError(f"unsupported stream dtype {t.dtype}")
    return codes[t.dtype]


def _value_dt(t: torch.Tensor, unsigned: bool) -> int:
    dt = _key_dt(t)
    if unsigned and dt in (_DT_I16, _DT_I32):
        return dt + 1  # U16 / U32: zero-extended
    return dt


def _op(kind: str, t: torch.Tensor, unsigned: bool) -> int:
    if t.dtype == torch.float64:
        return _OP[(kind, "float")]
    if kind == "mean":
        raise TypeError("mean needs a float64 stream")
    return _OP[(kind, "u64" if unsigned and kind != "sum" else "int")]


def _check(keys, n, mask, values, kinds, values_unsigned, distinct):
    n = int(n)
    keys, values, distinct = tuple(keys), tuple(values), tuple(distinct)
    if not 0 <= n < MAX_ROWS:
        raise ValueError(f"n = {n} out of range [0, {MAX_ROWS})")
    if len(keys) > MAX_KEYS:
        raise ValueError(f"at most {MAX_KEYS} key streams, got {len(keys)}")
    if len(kinds) != len(values):
        raise ValueError("one kind per value stream")
    if values_unsigned is None:
        values_unsigned = (False,) * len(values)
    if len(values_unsigned) != len(values):
        raise ValueError("one unsigned flag per value stream")
    streams = [("key", t) for t in keys] + [("value", t) for t in values]
    streams += [("distinct", t) for t in distinct]
    if mask is not None:
        if mask.dtype not in (torch.bool, torch.uint8):
            raise TypeError("mask: need a bool or uint8 tensor")
        streams.append(("mask", mask))
    device = streams[0][1].device if streams else torch.device("cpu")
    for name, t in streams:
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous 1-d tensor")
        if t.shape[0] < n:
            raise ValueError(f"{name}: {t.shape[0]} rows < n = {n}")
        if t.device != device:
            raise ValueError(f"{name}: on {t.device}, first stream on {device}")
        _key_dt(t)  # raises on a dtype the kernel does not read
    for kind, v, uns in zip(kinds, values, values_unsigned):
        if kind not in AGG_KINDS:
            raise ValueError(f"unknown aggregate kind {kind!r}")
        _op(kind, v, uns)
    for t in distinct:
        if t.dtype == torch.float64:
            raise TypeError("count_distinct needs an integer stream")
    return n, keys, values, tuple(values_unsigned), distinct, device


def hash_groupby_plain(keys, n, mask=None, values=(), kinds=(), values_unsigned=None,
                       distinct=()) -> Grouped:
    """Plain PyTorch version of ``hash_groupby`` on the tensors' device."""
    n, keys, values, uns, distinct, _dev = _check(
        keys, n, mask, values, kinds, values_unsigned, distinct)
    first, counts, aggs = masked_grouped_aggregate(mask, keys, values, tuple(kinds), uns, n)
    return Grouped(first, counts, aggs, tuple(
        masked_grouped_count_distinct(mask, keys, d, n) for d in distinct))


_lib_ready = False


def _lib():
    global _lib_ready
    lib = _build.load("hash_groupby")
    if not _lib_ready:
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        pvp, pci = ctypes.POINTER(vp), ctypes.POINTER(ci)
        lib.evql_hash_group_ids.argtypes = [pvp, pci, ci, vp, cll, vp, cll, vp, vp, vp]
        lib.evql_hash_aggregate.argtypes = [vp, vp, cll, ci, pvp, pci, pci, vp, cll, vp]
        lib.evql_hash_count_distinct.argtypes = [vp, vp, cll, vp, ci, vp, cll, vp, cll, vp]
        for fn in (lib.evql_hash_group_ids, lib.evql_hash_aggregate,
                   lib.evql_hash_count_distinct):
            fn.restype = ci
        _lib_ready = True
    return lib


def _raise_cuda(fn: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} at launch")


def hash_groupby(
    keys: Sequence[torch.Tensor],
    n: int,
    mask: Optional[torch.Tensor] = None,
    values: Sequence[torch.Tensor] = (),
    kinds: Sequence[str] = (),
    values_unsigned: Optional[Sequence[bool]] = None,
    distinct: Sequence[torch.Tensor] = (),
) -> Grouped:
    """Group the first ``n`` rows that ``mask`` keeps by the tuple of
    ``keys`` (each compared by its stored bits; none: one group) and
    aggregate: per group its first row and count, ``values[j]`` reduced
    by ``kinds[j]`` ("sum", "min", "max"; "mean" of a float64 stream),
    a narrow integer stream zero-extended and a 64-bit one ordered as
    unsigned where ``values_unsigned[j]``, and the number of distinct
    payloads of each ``distinct`` stream."""
    from eventql_tpu_torch.kernels.sort import read_host

    n, keys, values, uns, distinct, device = _check(
        keys, n, mask, values, kinds, values_unsigned, distinct)
    if device.type != "cuda":
        return hash_groupby_plain(keys, n, mask, values, kinds, uns, distinct)
    lib = _lib()
    cap = table_slots(n)
    table = torch.empty(cap, dtype=torch.int32, device=device)
    row_slot = torch.empty(n, dtype=torch.int32, device=device)
    num_groups = torch.empty(1, dtype=torch.int64, device=device)
    nk = len(keys)
    key_ptrs = (ctypes.c_void_p * max(1, nk))(*[k.data_ptr() for k in keys])
    key_dts = (ctypes.c_int * max(1, nk))(*[_key_dt(k) for k in keys])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _raise_cuda("evql_hash_group_ids", lib.evql_hash_group_ids(
            key_ptrs, key_dts, nk, None if mask is None else mask.data_ptr(), n,
            table.data_ptr(), cap, row_slot.data_ptr(), num_groups.data_ptr(), stream))
        G = int(read_host(num_groups)[0])
        first = counts = None
        aggs = []
        for lo in range(0, max(1, len(values)), MAX_VALUES):
            chunk = range(lo, min(len(values), lo + MAX_VALUES))
            out = torch.empty((2 + len(chunk), G), dtype=torch.int64, device=device)
            nv = len(chunk)
            ptrs = (ctypes.c_void_p * max(1, nv))(*[values[j].data_ptr() for j in chunk])
            dts = (ctypes.c_int * max(1, nv))(*[_value_dt(values[j], uns[j]) for j in chunk])
            ops = (ctypes.c_int * max(1, nv))(*[_op(kinds[j], values[j], uns[j])
                                                for j in chunk])
            _raise_cuda("evql_hash_aggregate", lib.evql_hash_aggregate(
                row_slot.data_ptr(), table.data_ptr(), n, nv, ptrs, dts, ops,
                out.data_ptr(), G, stream))
            if first is None:
                counts, first = out[0], out[1]
            aggs += [out[2 + i].view(torch.float64) if values[j].dtype == torch.float64
                     else out[2 + i] for i, j in enumerate(chunk)]
        dist = []
        if distinct:
            seen = torch.empty(cap, dtype=torch.int32, device=device)
            for d in distinct:
                out = torch.empty(G, dtype=torch.int64, device=device)
                _raise_cuda("evql_hash_count_distinct", lib.evql_hash_count_distinct(
                    row_slot.data_ptr(), table.data_ptr(), n, d.data_ptr(), _key_dt(d),
                    seen.data_ptr(), cap, out.data_ptr(), G, stream))
                dist.append(out)
    LAUNCHES["hash_groupby"] += 1
    return Grouped(first, counts, tuple(aggs), tuple(dist))
