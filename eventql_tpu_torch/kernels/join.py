"""Device hash-join kernels (fact-dim join + aggregate).

The counterpart of eventql_tpu/kernels/join.py. The reference's hash
join builds a CPU multimap over the joined table and probes per row
(reference: sql/statements/select/hash_join.cc:29-33, 123-230); here the
probe runs on the card and no join pair ever materialises: each fact
row gets the bucket of its dimension row (or -1), and the grouped
aggregate kernel (kernels/groupby_agg.py) takes that as its key.

The two TPU kernels and their ports (``csrc/join.cu``):

* ``dim_join_gid`` replaces ``_join_kernel`` / ``pallas_dim_join_gid``:
  at most ``MAX_COMPARE_DIMS`` dimension rows, held as a hash table in
  each block's shared memory, built in the kernel from the unsorted
  rows. It has no fingerprint precondition. Its launcher shapes the
  table from D and the fact stream's width (``dim_table`` mirrors the
  rule for the tests): a u16 / u32 stream gets a table of only the
  dimension keys that fit its width, in 8-byte slots of a 32-bit key
  and the bucket, at a load of 1/8; a u64 stream 12-byte slots at 1/4;
  fewer slots, down to a load of 1/2, where the shared memory holds no
  more. Each thread probes eight rows a turn, their keys read as
  16-byte vectors, all first probes read before any is compared. It is
  bound by n * (key width + 4) + 12 D bytes; on an H100 it reaches 0.82
  of that bound at the join query's shape (u32 keys, D = 1024, 2^26
  rows: 0.196 ms against 0.160) and 0.65 at D = 8192 with u64 keys,
  where the table's load is 1/2 (``chip_smoke.py`` phase 5).
* ``probe_join_gid`` replaces ``_window_join_kernel`` /
  ``_window_join_pallas`` (reached through ``merge_join_gid``): any
  number of dimension rows, in any order. ``build_join_table`` builds an
  open-addressed hash table of 16-byte slots in global memory on the
  card (``table_slots`` of them: a power of two, at least twice the
  rows), and the probe kernel looks every fact row up in it, in row
  order. Neither side is sorted.

Both compare all 64 bits of the key and return the whole int32 bucket;
among duplicate dimension keys the lowest row wins. Both are bound by
bytes: the fact key read once at its stored width, one int32 written per
row, the dimension table read once. What the big-table probe waits for
is random 32-byte sectors from the L2 (about 1.25 a row), so each thread
keeps eight lookups in flight.

Keys are unsigned 64-bit integers carried as int64 bit patterns
(kernels/groupby.py). A fact key stream may also be the int32 / int16
tensor of a physically narrowed unsigned column; kernels and plain
versions zero-extend it. ``build_side`` returns bit patterns in
ascending *unsigned* order; the torch ops below sort and search
``key ^ (1 << 63)``.

Each wrapper launches its kernels for CUDA tensors and uses the plain
PyTorch version (``*_plain``: ``build_side`` + ``dim_join_gather`` + a
bucket gather) for CPU tensors only. ``LAUNCHES`` counts kernel launches
per wrapper.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from eventql_tpu_torch.kernels import _build
from eventql_tpu_torch.kernels.groupby_agg import groupby_agg
from eventql_tpu_torch.utils import trace

# kernel launches per wrapper (plain-version calls do not count)
LAUNCHES = {"dim_join_gid": 0, "probe_join_gid": 0, "build_join_table": 0}

# tier boundary: up to here the dimension side fits the shared-memory
# hash table of dim_join_gid (16384 slots at a load of one half); above
# it probe_join_gid probes a hash table in global memory
MAX_COMPARE_DIMS = 8192
# dim_join_gid's table, as its launcher shapes it (csrc/join.cu:dim_slots):
# slots a dimension row for 8-byte slots (u16 / u32 streams) and for
# 12-byte slots (u64 streams), as measured on the H100, and the most bytes
# a table may take: under the 227 KB of shared memory the kernel's one
# block an SM may opt in to
DIM_SLOTS_PER_ROW = {8: 8, 12: 4}  # bytes a slot -> slots a row
DIM_TABLE_SHARED_BYTES = 224 * 1024

_SIGN = -(1 << 63)  # int64 with only the top bit set
_DT_U16, _DT_U32, _DT_U64 = 1, 2, 3
_KEY_DT = {torch.int16: _DT_U16, torch.int32: _DT_U32, torch.int64: _DT_U64}


def _u64_bits(keys: torch.Tensor) -> torch.Tensor:
    """A key stream as int64 bit patterns (narrow streams zero-extend)."""
    if keys.dtype == torch.int64:
        return keys
    return keys.to(torch.int64) & ((1 << (8 * keys.element_size())) - 1)


# -- torch-op functions (what the plain versions are made of) -----------------


def build_side(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort the build side: returns (sorted keys, perm). The keys come
    back as bit patterns in ascending unsigned order; the sort is
    stable, so equal keys keep their row order."""
    k = _u64_bits(keys)
    sk, perm = torch.sort(k ^ _SIGN, stable=True)
    return sk ^ _SIGN, perm


def probe_ranges(sorted_keys: torch.Tensor, probe_keys: torch.Tensor):
    """For each probe key: (start, count) of its match range in the
    sorted build side."""
    sk = sorted_keys ^ _SIGN
    pk = _u64_bits(probe_keys) ^ _SIGN
    start = torch.searchsorted(sk, pk, right=False)
    end = torch.searchsorted(sk, pk, right=True)
    return start, end - start


def dim_join_gather(
    sorted_keys: torch.Tensor, perm: torch.Tensor, probe_keys: torch.Tensor
):
    """Unique-key join: per probe row, the build row index (or -1), and
    whether it matched. Among equal build keys the first in sorted
    order is taken."""
    pk = _u64_bits(probe_keys)
    if sorted_keys.shape[0] == 0:
        return (
            torch.full(pk.shape, -1, dtype=torch.int64, device=pk.device),
            torch.zeros(pk.shape, dtype=torch.bool, device=pk.device),
        )
    pos = torch.searchsorted(sorted_keys ^ _SIGN, pk ^ _SIGN, right=False)
    pos = pos.clamp(0, sorted_keys.shape[0] - 1)
    matched = sorted_keys[pos] == pk
    return torch.where(matched, perm[pos], -1), matched


def _gather_gid(dim_bucket, idx, matched, fact_mask):
    safe_idx = torch.where(matched, idx, 0)
    gid = dim_bucket[safe_idx].to(torch.int32)
    return gid, fact_mask & matched


# -- the probe kernels --------------------------------------------------------


def _checked(fact_keys, dim_keys, dim_bucket, n, max_dims=(1 << 31) - 1):
    if fact_keys.dim() != 1 or not fact_keys.is_contiguous():
        raise ValueError("fact_keys: need a contiguous 1-d tensor")
    if fact_keys.dtype not in _KEY_DT:
        raise TypeError(
            f"fact_keys: need int64 bit patterns or a narrowed int32 / int16"
            f" stream, got {fact_keys.dtype}"
        )
    n = fact_keys.shape[0] if n is None else int(n)
    if not 0 <= n <= fact_keys.shape[0]:
        raise ValueError(f"n = {n} outside the key stream's {fact_keys.shape[0]} rows")
    if dim_keys.dim() != 1 or not dim_keys.is_contiguous() or dim_keys.dtype != torch.int64:
        raise TypeError("dimension keys: need a contiguous 1-d int64 tensor (u64 bits)")
    if (
        dim_bucket.dim() != 1
        or not dim_bucket.is_contiguous()
        or dim_bucket.dtype != torch.int32
        or dim_bucket.shape[0] != dim_keys.shape[0]
    ):
        raise TypeError("dimension buckets: need contiguous int32, one per key")
    if dim_keys.device != fact_keys.device or dim_bucket.device != fact_keys.device:
        raise ValueError("fact and dimension tensors lie on different devices")
    if dim_keys.shape[0] > max_dims:
        raise ValueError(f"{dim_keys.shape[0]} dimension rows: at most {max_dims}")
    return n


def _plain(fact_keys, n, sorted_keys, perm, dim_bucket):
    idx, matched = dim_join_gather(sorted_keys, perm, fact_keys[:n])
    if dim_bucket.shape[0] == 0:
        return torch.full((n,), -1, dtype=torch.int32, device=fact_keys.device)
    return torch.where(matched, dim_bucket[idx.clamp(min=0)], -1).to(torch.int32)


def dim_join_gid_plain(fact_keys, dim_keys, dim_bucket, n=None):
    """Plain PyTorch version of ``dim_join_gid`` on the tensors' device."""
    n = _checked(fact_keys, dim_keys, dim_bucket, n, MAX_COMPARE_DIMS)
    sk, perm = build_side(dim_keys)
    return _plain(fact_keys, n, sk, perm, dim_bucket)


def probe_join_gid_plain(fact_keys, dim_keys, dim_bucket, n=None):
    """Plain PyTorch version of ``probe_join_gid``."""
    n = _checked(fact_keys, dim_keys, dim_bucket, n)
    sk, perm = build_side(dim_keys)
    return _plain(fact_keys, n, sk, perm, dim_bucket)


def table_slots(n_dims: int) -> int:
    """Slots of the global-memory hash table for ``n_dims`` dimension
    rows: the power of two that keeps the load at or under one half
    (at least 2, so that an empty slot always ends a search)."""
    if n_dims < 1:
        raise ValueError("a hash table needs at least one dimension row")
    return 1 << max(1, (2 * int(n_dims) - 1).bit_length())


class DimTable(NamedTuple):
    slots: int  # a power of two, at least twice the dimension rows
    slot_bytes: int  # 8: a u32 key and the bucket; 12: a u64 key and the bucket
    key_bits: int  # the table holds the dimension keys below 2^key_bits


def dim_table(n_dims: int, key_bytes: int) -> DimTable:
    """The shared-memory table ``dim_join_gid`` builds in every block for
    ``n_dims`` dimension rows and a fact key stream of ``key_bytes`` a key
    (2, 4 or 8). A narrow stream can only equal a dimension key that fits
    its width, so its table holds only those, as 32-bit keys. The slots:
    the power of two at or above ``DIM_SLOTS_PER_ROW`` a row, halved
    while the table is above ``DIM_TABLE_SHARED_BYTES``, but never below
    two a row (the kernel's searches end at an empty slot).

    The kernel's launcher chooses the table itself (``dim_slots`` in
    ``csrc/join.cu``, exported as ``evql_dim_table_slots``); this is its
    mirror, for the tests."""
    if not 1 <= n_dims <= MAX_COMPARE_DIMS:
        raise ValueError(f"{n_dims} dimension rows: need 1 .. {MAX_COMPARE_DIMS}")
    if key_bytes not in (2, 4, 8):
        raise ValueError(f"fact keys of {key_bytes} bytes: need 2, 4 or 8")
    slot_bytes = 12 if key_bytes == 8 else 8
    least = table_slots(n_dims)
    slots = max(least, 1 << (DIM_SLOTS_PER_ROW[slot_bytes] * int(n_dims) - 1).bit_length())
    while slots > least and slots * slot_bytes > DIM_TABLE_SHARED_BYTES:
        slots //= 2
    return DimTable(slots, slot_bytes, 8 * key_bytes)


_lib_ready = False


def _lib():
    global _lib_ready
    lib = _build.load("join")
    if not _lib_ready:
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.evql_dim_join_gid.argtypes = [vp, ci, cll, vp, vp, ci, vp, vp]
        lib.evql_dim_table_slots.argtypes = [ci, ci]
        lib.evql_dim_table_slots.restype = cll
        lib.evql_build_join_table.argtypes = [vp, vp, ci, cll, vp, vp]
        lib.evql_probe_join_table.argtypes = [vp, ci, cll, vp, cll, vp, vp]
        for fn in (lib.evql_dim_join_gid, lib.evql_build_join_table,
                   lib.evql_probe_join_table):
            fn.restype = ci
        _lib_ready = True
    return lib


def _raise_cuda(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


@trace.spanned("kernel.build_join_table")
def build_join_table(dim_keys: torch.Tensor, dim_bucket: torch.Tensor) -> torch.Tensor:
    """The hash table ``probe_join_gid`` looks its fact keys up in, built
    on the card from D >= 1 dimension rows in any order: int64
    [2 * (table_slots(D) + 1)], two words a slot (the key; the bucket in
    the low half of the second), the last slot for the all-ones key. The
    slots' order depends on the order the card's threads ran in; what a
    key finds does not. CUDA tensors only: the plain version has no
    table."""
    if not dim_keys.is_cuda:
        raise ValueError("build_join_table: the table is built on a CUDA device only")
    _checked(dim_keys, dim_keys, dim_bucket, 0)
    slots = table_slots(dim_keys.shape[0])
    table = torch.empty(2 * (slots + 1), dtype=torch.int64, device=dim_keys.device)
    with torch.cuda.device(dim_keys.device):
        rc = _lib().evql_build_join_table(
            dim_keys.data_ptr(), dim_bucket.data_ptr(), dim_keys.shape[0], slots,
            table.data_ptr(), torch.cuda.current_stream(dim_keys.device).cuda_stream,
        )
    _raise_cuda("build_join_table", rc)
    LAUNCHES["build_join_table"] += 1
    return table


def _no_rows(n, device):
    return torch.full((n,), -1, dtype=torch.int32, device=device)


@trace.spanned("kernel.dim_join_gid")
def dim_join_gid(
    fact_keys: torch.Tensor,
    dim_keys: torch.Tensor,
    dim_bucket: torch.Tensor,
    n: Optional[int] = None,
) -> torch.Tensor:
    """Per fact row < ``n``: the bucket of the dimension row whose key is
    equal, or -1 when no dimension key is. At most ``MAX_COMPARE_DIMS``
    dimension rows, in any order. Duplicate dimension keys are not an
    error: the lowest dimension row wins. An empty dimension table gives
    all -1.

    fact_keys: int64 (u64 bits) or a narrowed int32 / int16 stream
    [>= n]; dim_keys: int64 [D]; dim_bucket: int32 [D]; returns
    int32 [n]."""
    if not fact_keys.is_cuda:
        return dim_join_gid_plain(fact_keys, dim_keys, dim_bucket, n)
    n = _checked(fact_keys, dim_keys, dim_bucket, n, MAX_COMPARE_DIMS)
    device = fact_keys.device
    if n == 0 or dim_keys.shape[0] == 0:
        return _no_rows(n, device)  # nothing to probe, or nothing to find
    out = torch.empty(n, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        rc = _lib().evql_dim_join_gid(
            fact_keys.data_ptr(), _KEY_DT[fact_keys.dtype], n,
            dim_keys.data_ptr(), dim_bucket.data_ptr(), dim_keys.shape[0],
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_cuda("dim_join_gid", rc)
    LAUNCHES["dim_join_gid"] += 1
    return out


@trace.spanned("kernel.probe_join_gid")
def probe_join_gid(
    fact_keys: torch.Tensor,
    dim_keys: torch.Tensor,
    dim_bucket: torch.Tensor,
    n: Optional[int] = None,
) -> torch.Tensor:
    """Per fact row < ``n``, in row order: the bucket of the equal key
    in a dimension table of any size, or -1. The dimension rows come in
    any order (``build_join_table`` hashes them on the card; sorted keys
    are as good as any). Among duplicate dimension keys the lowest
    dimension row wins. An empty dimension table gives all -1.

    Shapes and types as ``dim_join_gid``."""
    if not fact_keys.is_cuda:
        return probe_join_gid_plain(fact_keys, dim_keys, dim_bucket, n)
    n = _checked(fact_keys, dim_keys, dim_bucket, n)
    device = fact_keys.device
    if n == 0 or dim_keys.shape[0] == 0:
        return _no_rows(n, device)
    table = build_join_table(dim_keys, dim_bucket)
    out = torch.empty(n, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        rc = _lib().evql_probe_join_table(
            fact_keys.data_ptr(), _KEY_DT[fact_keys.dtype], n, table.data_ptr(),
            table_slots(dim_keys.shape[0]), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_cuda("probe_join_gid", rc)
    LAUNCHES["probe_join_gid"] += 1
    return out


def join_gid(fact_keys, dim_keys, dim_bucket, n=None) -> torch.Tensor:
    """The probe by tier, chosen from the dimension count alone: up to
    ``MAX_COMPARE_DIMS`` rows ``dim_join_gid``, above it
    ``probe_join_gid``. Neither sorts."""
    if dim_keys.shape[0] <= MAX_COMPARE_DIMS:
        return dim_join_gid(fact_keys, dim_keys, dim_bucket, n)
    return probe_join_gid(fact_keys, dim_keys, dim_bucket, n)


# -- aggregate entry points ---------------------------------------------------


def _aggregate(gid, fact_values, fact_mask, num_buckets, value_bits):
    # rows whose gid is -1 (no dimension match) fall outside [0, K) and
    # the aggregate kernel drops them itself: no `mask & (gid >= 0)` pass
    out = groupby_agg(
        gid, gid.shape[0], num_buckets, values=fact_values.contiguous(),
        value_bits=value_bits, mask=fact_mask,
    )
    return out[0], out[1]


def fact_dim_join_aggregate(
    fact_keys: torch.Tensor,
    fact_values: torch.Tensor,
    fact_mask: Optional[torch.Tensor],
    dim_keys: torch.Tensor,
    dim_bucket: torch.Tensor,
    num_buckets: int,
):
    """SELECT d.bucket, count(*), sum(f.value)
       FROM fact f JOIN dim d ON f.key = d.key [WHERE mask]
       GROUP BY d.bucket

    dim_bucket must be int32 in [0, num_buckets). Unmatched fact rows
    drop (inner join). Returns (counts, sums), each int64[K] holding u64
    bit patterns; sums are exact mod 2^64."""
    gid = join_gid(fact_keys, dim_keys, dim_bucket)
    return _aggregate(gid, fact_values, fact_mask, num_buckets, 64)


def sorted_merge_join_aggregate(
    fact_keys: torch.Tensor,
    fact_values: torch.Tensor,
    fact_mask: Optional[torch.Tensor],
    dim_keys: torch.Tensor,
    dim_bucket: torch.Tensor,
    num_buckets: int,
    block: Optional[int] = None,
    window: Optional[int] = None,
    value_bits: int = 64,
    key_bound=None,
):
    """fact-dim join + GROUP BY aggregate for a dimension table of any
    size: every fact row is probed, in row order, against a hash table
    of the dimension side (``probe_join_gid``), and the grouped
    aggregate kernel takes the buckets.

    The signature is the JAX function's, and so is the name: nothing is
    sorted or merged here. ``block``, ``window`` and ``key_bound`` only
    shaped the TPU's sort of the fact side and its windowed merge, so
    they are accepted and have no effect. ``value_bits`` bounds the
    value width as there: the sum takes the low ``value_bits`` of each
    value (rounded up to whole bytes).

    Returns (counts, sums) as ``fact_dim_join_aggregate``."""
    gid = probe_join_gid(fact_keys, dim_keys, dim_bucket)
    return _aggregate(gid, fact_values, fact_mask, num_buckets, value_bits)
