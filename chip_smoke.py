#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (eventql_tpu_torch) on one GPU.

    python3 chip_smoke.py     # needs one CUDA device and nvcc; no arguments

Phases (any mismatch or exception ends the run with a non-zero code):
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles the CUDA kernels from eventql_tpu_torch/kernels/csrc;
  3. kernels: every kernel wrapper against its plain PyTorch version on
     the card, exact equality (integer sums and row indices: tolerance 0;
     the hash aggregate's groups in first-row order, its floats multiples
     of 1/64, so that every sum is exact in any order), the hash
     aggregate in each of its tiers (shared, direct global, hash) and
     count_distinct forms (shared bitmap, global bitmap, set) at their
     edges (u32 keys of 2^31 and more, a NULL key outside the stats, a
     negative base, one hot key, streams off a 16-byte boundary), and its
     tier rule against the launcher's at the boundaries;
  4. main paths: SQL text -> Runtime(device="cuda") -> ResultList on a
     partition-sized table (2^26 rows, ~2.8 GB on the device): first the
     GROUP BY sum/count queries, then the general GROUP BY queries G1-G5
     (min / max / mean, a key beyond K_CAP, two keys, count_distinct,
     float sums: the hash aggregate, each in the tier its key spans
     choose, with its peak device memory), then
     the ORDER BY [LIMIT] queries, then the fact-dim JOIN + GROUP BY
     queries (dimension tables of 1024 and 2^18 rows; J1 with min / max
     through the join route's general branch), each path with the launch
     counts set to 0 just before it and read just after. Every query's
     rows equal an independent numpy answer and, on a 2^20-row prefix,
     the port's own host engine; route and launch counters rose as they
     must;
  5. the main paths' shapes: every kernel call the queries of phase 4
     made is repeated on the same tensors through the wrapper and the
     plain version, which must be equal (tolerance 0); then CUDA-event
     times of both beside the bound and a library call (for the hash
     aggregate the chain torch.unique + scatter_reduce_, the same call in
     the hash tier with the spans withheld, its slots + count + first row
     alone, the bytes it allocates; and its G1 call with every row on one
     key, in both tiers), and the warm
     end-to-end time per query; the big-table join probe also against
     dimension tables of 16384 and 2^22 rows, and its table build alone;
     the small-table probe also at D = 8192 and D = 1024 with u64 keys
     (beside the big-table probe and its global table's build at D =
     8192), its kernel's device time at one row (its table build), and
     the library calls beside B1's other shapes.

With EVQL_PARENT_JOIN_CU naming an earlier join.cu whose
evql_dim_join_gid has this one's C interface (the argument types
kernels/join.py gives it), phase 2 builds it too and phase 5 holds its
small-table probe against this one and times it on the same inputs.

Prints one JSON line {"kernels": [...]} and, as the last line,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import ctypes
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from eventql_tpu_torch.core.types import SType
from eventql_tpu_torch.exec import device_exec
from eventql_tpu_torch.exec.relation import relation_from_numpy
from eventql_tpu_torch.exec.runtime import (
    PlanCache,
    RelationTableProvider,
    Runtime,
)
from eventql_tpu_torch.kernels import _build
from eventql_tpu_torch.kernels import extract as ex
from eventql_tpu_torch.kernels import groupby_agg as ga
from eventql_tpu_torch.kernels import hash_groupby as hg
from eventql_tpu_torch.kernels import join as kj
from eventql_tpu_torch.kernels import sort as ksort

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and
# the float32 rate outside the tensor cores, taken as the rate of the
# 32-bit integer compares and adds these kernels do
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

N_ROWS = 1 << 26  # the partition
N_PREFIX_ROWS = 1 << 20  # compared with the host engine
N_KERNEL_CASE_ROWS = 1_000_003  # phase 3: a multiple of nothing
REPS = 5  # runs of each query; the first warms the column cache
N_KEYS = 1024
BIG_BASE = 20_000_000
BIG_SPAN = 100_000
CAT_LO, CAT_HI = -40, 60
N_DIMS = 1024  # the small dimension table: shared-memory probe
DIM_MULT = 7919
N_BIG_DIMS = 1 << 18  # the large one: hash table in global memory
BIG_DIM_MULT = 2654435761
N_REGIONS = 1024
FAST_TOPK_ROWS = 1 << 22  # from here on a single-key top-k takes the histograms
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


_T0 = time.perf_counter()


def log(msg):
    if msg.startswith("phase "):  # with the seconds since the script began
        msg += f" [{time.perf_counter() - _T0:.1f} s]"
    print(msg, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


# -- phase 3: kernels against their plain versions ----------------------------

_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32,
           np.dtype(np.uint64): np.int64}


def dev_tensor(arr, device):
    arr = np.ascontiguousarray(arr)
    view = _SIGNED.get(arr.dtype)
    return torch.from_numpy(arr.view(view) if view else arr).to(device)


def kernel_cases(n, device, rng):
    """Yield (kernel name, label, kwargs for wrapper and plain version)."""

    def keys(K, dt, lo=0):
        return dev_tensor(rng.integers(lo - 2, lo + K + 2, n).astype(dt), device)

    v16 = dev_tensor(rng.integers(0, 60000, n).astype(np.uint16), device)
    v32 = dev_tensor(rng.integers(0, 1 << 32, n, dtype=np.uint32), device)
    v64 = dev_tensor(rng.integers(0, 1 << 64, n, dtype=np.uint64), device)
    p16 = dev_tensor(rng.integers(-20000, 20000, n).astype(np.int16), device)
    p32 = dev_tensor(rng.integers(0, 1 << 20, n).astype(np.int32), device)
    pu16 = dev_tensor(rng.integers(0, 65535, n).astype(np.uint16), device)
    mask = dev_tensor(rng.random(n) < 0.7, device)

    value_lt = [ga.Pred("value", "lt", 30000)]
    for K in (1, 128, 1024, 8192, 100_000, 131_073):
        widths = [(np.int32, False)]
        if K + 2 < (1 << 15):
            widths.append((np.int16, False))
        if K + 2 < (1 << 16):
            widths.append((np.uint16, True))
        for dt, uns in widths:
            lo = 2 if uns else 0  # keep unsigned keys non-negative
            base = lo
            yield "groupby_agg", f"K={K} key={np.dtype(dt).name}", dict(
                gid=keys(K, dt, lo), n=n, num_buckets=K, values=v16,
                value_bits=16, preds=value_lt, gid_base=base,
                gid_unsigned=uns, values_unsigned=True)
    g1024 = keys(1024, np.int16)
    for op in ("lt", "le", "gt", "ge", "eq", "ne"):
        yield "groupby_agg", f"op={op}", dict(
            gid=g1024, n=n, num_buckets=1024, values=v16, value_bits=16,
            preds=[ga.Pred("value", op, 31000)], values_unsigned=True)
    two = {
        "value+value": [ga.Pred("value", "ge", 1000), ga.Pred("value", "lt", 50000)],
        "value+stream": [ga.Pred("value", "lt", 30000), ga.Pred("stream", "ge", 1 << 19, p32)],
        "stream+stream": [ga.Pred("stream", "gt", 0, p16), ga.Pred("stream", "le", 40000, pu16, True)],
        "gid+stream": [ga.Pred("gid", "ge", 100), ga.Pred("stream", "ne", 7, p16)],
        "gid+gid": [ga.Pred("gid", "ge", 100), ga.Pred("gid", "lt", 900)],
    }
    for label, preds in two.items():
        for comb in ("and", "or"):
            count_only = label.startswith("gid")
            yield "groupby_agg", f"two preds {label} {comb}", dict(
                gid=g1024, n=n, num_buckets=1024,
                values=None if count_only else v16, value_bits=16,
                preds=preds, combine=comb, values_unsigned=True)
    for base in (-1000, 20_000_000, (1 << 32) - 5000):
        k = rng.integers(0, 500, n) + base
        arr = (k & 0xFFFFFFFF).astype(np.uint32) if base > 0 else k.astype(np.int32)
        yield "groupby_agg", f"gid_base={base}", dict(
            gid=dev_tensor(arr, device), n=n, num_buckets=500, values=v32,
            value_bits=32, preds=[ga.Pred("gid", "ge", -(1 << 31))],
            gid_base=base)
    for bits, vals in ((16, v16), (32, v32), (64, v64), (48, v64)):
        yield "groupby_agg", f"value_bits={bits} masked", dict(
            gid=g1024, n=n, num_buckets=1024, values=vals, value_bits=bits,
            mask=mask, values_unsigned=bits == 16)
    yield "groupby_agg", "all rows filtered", dict(
        gid=g1024, n=n, num_buckets=1024, values=v16, value_bits=16,
        preds=[ga.Pred("value", "gt", 70000)], values_unsigned=True)
    yield "groupby_agg", "byte-mask predicate stream", dict(
        gid=g1024, n=n, num_buckets=1024, values=v16, value_bits=16,
        preds=[ga.Pred("stream", "ge", 1, mask)], values_unsigned=True)
    yield "groupby_agg", "count only, masked, ragged n", dict(
        gid=g1024, n=n - 12345, num_buckets=1024, mask=mask)
    g32 = keys(1024, np.int32)
    gbig = keys(100_000, np.int32)
    for S in (2, 3):
        streams = [v16, v32, p32][:S]
        bits = [16, 32, 24][:S]
        uns = [True, False, False][:S]
        for label, g, K in (("K=1024", g32, 1024), ("K=100000", gbig, 100_000)):
            yield "groupby_multi_agg", f"S={S} {label}", dict(
                gid=g, n=n, num_buckets=K, streams=streams, stream_bits=bits,
                mask=mask, streams_unsigned=uns)
    yield "groupby_multi_agg", "S=2 no mask", dict(
        gid=g32, n=n, num_buckets=1024, streams=[v16, v32],
        stream_bits=[16, 32], streams_unsigned=[True, False])

    # streams that start 1, 3 and 7 rows into their allocations (no 16-byte
    # boundary: the scalar loads), the shortest streams and a long one,
    # every stream type: i16 / u16 / i32 / i64 keys, u16 / u32 / u64
    # values, an i16 predicate stream, the byte mask
    typed = ((np.int16, False, v16, 16, True), (np.uint16, True, v32, 32, False),
             (np.int32, False, v64, 64, False), (np.int64, False, v16, 16, True))
    for off in (1, 3, 7):
        for rows in (*range(1, 18), n - off):
            dt, uns, vals, bits, vuns = typed[(rows + off) % len(typed)]
            yield "groupby_agg", f"offset {off} n={rows} key={np.dtype(dt).name}", dict(
                gid=keys(5, dt, 2)[off:], n=rows, num_buckets=5, values=vals[off:],
                value_bits=bits, mask=mask[off:], gid_base=2, gid_unsigned=uns,
                preds=[ga.Pred("stream", "ge", -15000, p16[off:])],
                values_unsigned=vuns)
        for rows in (1, 4, 5, 9, 17, n - off):
            yield "groupby_multi_agg", f"offset {off} n={rows}", dict(
                gid=g32[off:], n=rows, num_buckets=1024,
                streams=[v16[off:], v64[off:], v32[off:]], stream_bits=[16, 64, 32],
                mask=mask[off:], streams_unsigned=[True, False, False])
    # one stream off its boundary is enough to take the scalar loads
    yield "groupby_agg", "only the value stream sliced", dict(
        gid=g1024[:n - 1], n=n - 1, num_buckets=1024, values=v16[1:], value_bits=16,
        values_unsigned=True)
    # K on both sides of the edge between the table in shared memory and
    # the table in global memory, for no sum, one sum and eight
    eight = [v16, v32, v64, p32, v16, v64, v32, v64]
    eight_bits = [16, 32, 64, 24, 8, 48, 32, 64]
    eight_uns = [True, False, False, False, True, False, False, False]
    for S in (0, 1, 8):
        for K in table_form_edges(S, device) + ([131_073] if S == 8 else []):
            form = ("shared" if ga.table_in_shared_memory(K, S, ga.smem_optin(device))
                    else "global")
            g = keys(K, np.int32)
            if S == 8:
                yield "groupby_multi_agg", f"S=8 K={K} form={form}", dict(
                    gid=g, n=n, num_buckets=K, streams=eight, stream_bits=eight_bits,
                    mask=mask, streams_unsigned=eight_uns)
            else:
                yield "groupby_agg", f"S={S} K={K} form={form}", dict(
                    gid=g, n=n, num_buckets=K, values=v64 if S else None,
                    value_bits=64, mask=mask)
    # every row in one bucket, 64-bit values: the low word wraps on every
    # other add and each wrap must carry
    hot = torch.zeros(n, dtype=torch.int32, device=device)
    for bits, vals in ((64, v64), (32, v32)):
        yield "groupby_agg", f"one hot key, {bits}-bit values", dict(
            gid=hot, n=n, num_buckets=3, values=vals, value_bits=bits)
    yield "groupby_multi_agg", "one hot key, three sums", dict(
        gid=hot, n=n, num_buckets=1, streams=[v64, v32, v16], stream_bits=[64, 32, 16],
        streams_unsigned=[False, False, True])


def table_form_edges(nsums, device):
    """The largest bucket count whose table of ``nsums`` sums a block of
    this device keeps in its shared memory, and the next, whose table
    lies in global memory (kernels/groupby_agg.table_in_shared_memory)."""
    optin = ga.smem_optin(device)
    whole = optin // (8 * (1 + nsums))
    check(ga.table_in_shared_memory(whole, nsums, optin)
          and not ga.table_in_shared_memory(whole + 1, nsums, optin),
          f"no edge between the table forms at K = {whole} for {nsums} sums")
    return [whole, whole + 1]


def extract_cases(n, rng):
    """Yield (label, values int32[n], threshold, cap, rows or None) for
    extract_ge: the corners of the compaction (no match, the ragged
    tail, the cap, the int32 ends)."""
    base = rng.integers(0, 1000, n).astype(np.int32)

    def planted(rows, value=9000):
        v = base.copy()
        v[rows] = value
        return v

    tail = np.arange(n - (n % 4096 or 1), n)
    yield "no match", base, 5000, 64, None
    yield "one match in the last row", planted([n - 1]), 5000, 64, None
    yield "matches only in the ragged tail", planted(tail), 5000, len(tail) + 7, None
    some = rng.choice(n, size=min(300, n), replace=False)
    yield "exactly cap matches", planted(some), 5000, len(some), None
    many = rng.choice(n, size=min(1000, n), replace=False)
    yield "more than cap matches", planted(many), 5000, max(1, len(many) // 3), None
    yield "every row a match", base, 0, min(n, 4096), None
    yield "cap = 1", planted(many), 5000, 1, None
    yield "half the rows, cap = n", base, 500, n, None
    signed = rng.integers(I32_MIN, I32_MAX, n, dtype=np.int64).astype(np.int32)
    yield "threshold INT32_MIN", signed, I32_MIN, min(n, 100), None
    yield "threshold INT32_MAX", planted(some, I32_MAX), I32_MAX, len(some) + 5, None
    yield "n below the stream's length", planted(many), 5000, 2000, n - n // 3


def _fingerprint_twin(lo, hi):
    """A key with the high word ``hi`` and the 32-bit fingerprint of the
    key (0, lo) under the mix the TPU kernel compared by: the pair its
    precondition ruled out."""
    f = (((hi << 13) & 0xFFFFFFFF) | ((hi >> 19) & 0x1FFF)) ^ ((hi >> 7) & 0x01FFFFFF)
    return (hi << 32) | (lo ^ f)


def join_cases(n, device, rng):
    """Yield (kernel name, label, kwargs) for the two join probes: the
    dimension counts around the tier boundary, a ragged n, misses, keys
    with the top bit set, the all-ones key (the hash table's empty
    mark), colliding fingerprints, narrowed fact key streams."""
    ALL_ONES = 0xFFFFFFFFFFFFFFFF

    def dims(D, top_bit=False, all_ones=False, narrow_to=None):
        if narrow_to is not None:
            keys = rng.choice(1 << narrow_to, D, replace=False).astype(np.uint64)
            keys[0] = (1 << narrow_to) - 1  # the narrow type's top bit
        else:
            keys = rng.permutation(np.arange(D, dtype=np.uint64) * 104729 + 11)
        if top_bit:
            keys[::2] |= np.uint64(1 << 63)
        if all_ones:
            keys[D // 2] = ALL_ONES
        return keys, rng.integers(0, 100_000, D).astype(np.int32)

    def facts(keys, dtype=np.uint64):
        # two rows in three hit a dimension key, the rest are near misses
        hit = keys[rng.integers(0, len(keys), n)]
        return np.where(rng.random(n) < 0.67, hit, hit + np.uint64(1)).astype(dtype)

    def mixed_dims(D):
        """D dimension keys for streams of every width: u16 keys (with
        0xFFFF), u32 keys (with the u32 all-ones key 0xFFFFFFFF), keys of
        2^32 and more (with the 64-bit all-ones key), half of them with
        the low word of a narrower key of the set, and one key in 16
        again further down under another bucket (the lowest row wins)."""
        unique = D - D // 16
        k16 = rng.choice(0xFFFF, unique // 4, replace=False).astype(np.uint64)
        k32 = rng.choice(0xFFFFFFFF - 0x10000, unique // 4, replace=False) + 0x10000
        k32 = k32.astype(np.uint64)
        k16[0], k32[0] = 0xFFFF, 0xFFFFFFFF
        lows = np.concatenate([k16, k32])
        m = unique - len(lows)
        low = np.where(np.arange(m) % 2 == 0, lows[rng.integers(0, len(lows), m)],
                       rng.integers(0, 1 << 32, m).astype(np.uint64))
        high = (rng.integers(1, 1 << 32, m).astype(np.uint64) << np.uint64(32)) | low
        high[0] = ALL_ONES
        keys = rng.permutation(np.concatenate([lows, high]))
        check(len(np.unique(keys)) == unique, "mixed_dims: duplicate keys drawn")
        bucket = rng.integers(0, 100_000, unique).astype(np.int32)
        again = rng.choice(unique, D - unique, replace=False)
        return (np.concatenate([keys, keys[again]]),
                np.concatenate([bucket, bucket[again] + 1]))

    def mixed_facts(keys, dtype):
        """n fact keys stored as ``dtype``: each dimension key cut to the
        stream's width (for a key of 2^32 or more on a u32 stream that is
        a hit only where its low word is a key too), random keys of the
        width (misses), and the width's all-ones key; with one hit and
        one miss of the width."""
        bits = 8 * np.dtype(dtype).itemsize
        mask = np.uint64((1 << bits) - 1) if bits < 64 else np.uint64(ALL_ONES)
        f = np.where(rng.random(n) < 0.6, keys[rng.integers(0, len(keys), n)] & mask,
                     rng.integers(0, 1 << min(bits, 63), n, dtype=np.uint64))
        f[::97] = mask
        fits = keys[keys <= mask]
        absent = np.setdiff1d(np.arange(64, dtype=np.uint64), keys)
        return f.astype(dtype), fits[0], absent[0]

    def both(label, keys, bucket, fact, rows=None, probe_only=False, skip=0):
        dk, db, f = (dev_tensor(a, device) for a in (keys, bucket, fact))
        f = f[skip:]  # skip > 0: the stream starts off a 16-byte boundary
        if not probe_only:
            yield "dim_join_gid", label, dict(
                fact_keys=f, dim_keys=dk, dim_bucket=db, n=rows)
        yield "probe_join_gid", label, dict(
            fact_keys=f, dim_keys=dk, dim_bucket=db, n=rows)

    for D in (1, 127, 1024, kj.MAX_COMPARE_DIMS):
        keys, bucket = dims(D)
        yield from both(f"D={D}", keys, bucket, facts(keys))
    for D in (kj.MAX_COMPARE_DIMS + 1, N_BIG_DIMS, 1 << 22):
        keys, bucket = dims(D)
        yield from both(f"D={D}", keys, bucket, facts(keys), probe_only=True)
    # the dimension rows sorted (as valid an order as any), and with every
    # third key again further down under another bucket: the lowest row wins
    for D in (3001, 20_011):
        keys, bucket = dims(D, top_bit=True)
        order = np.argsort(keys, kind="stable")
        yield from both(f"D={D} sorted dims", keys[order], bucket[order], facts(keys),
                        probe_only=D > kj.MAX_COMPARE_DIMS)
        dup = np.concatenate([keys, keys[::3]])
        dup_bucket = np.concatenate([bucket, bucket[::3] + 1])
        yield from both(f"D={len(dup)} duplicate keys", dup, dup_bucket, facts(keys),
                        probe_only=len(dup) > kj.MAX_COMPARE_DIMS)
    # the shortest streams, the sizes around one tile of the probe (256
    # threads x 8 rows), streams off their boundary, all three widths
    keys, bucket = dims(20_011, all_ones=True)
    for rows in (1, 2, 7, 8, 9, 2047, 2048, 2049):
        for skip in (0, 3):
            f = facts(keys)[:rows + skip]
            f[skip] = keys[5]  # the first row probed is a hit, the last a miss
            f[-1] = keys[5 * (rows == 1)] + np.uint64(rows > 1)
            yield from both(f"n={rows} skip={skip}", keys, bucket, f, rows=rows,
                            probe_only=True, skip=skip)
    for bits, dt in ((16, np.uint16), (32, np.uint32), (64, np.uint64)):
        keys, bucket = dims(9001, narrow_to=min(bits, 40))
        f = np.where(rng.random(n) < 0.67, keys[rng.integers(0, 9001, n)],
                     rng.integers(0, 1 << min(bits, 40), n).astype(np.uint64)).astype(dt)
        for skip in (0, 1):
            yield from both(f"D=9001 fact keys u{bits} skip={skip}", keys, bucket, f,
                            rows=n - 7, probe_only=True, skip=skip)
    # the same for both probes against D <= 8192 (dim_join_gid's tier, up to
    # its edge): the sizes around one tile of dim_join_gid (1024 threads x 8
    # rows; 512 x 8 and the probe's tile too), streams off their boundary, all
    # three widths, each against dimension keys of every width
    for D in (1000, kj.MAX_COMPARE_DIMS):
        keys, bucket = mixed_dims(D)
        for bits, dt in ((16, np.uint16), (32, np.uint32), (64, np.uint64)):
            f, hit, miss = mixed_facts(keys, dt)
            for skip in (0, 1):
                yield from both(f"D={D} mixed dims, u{bits} skip={skip}", keys, bucket, f,
                                rows=n - 7, skip=skip)
            if D != kj.MAX_COMPARE_DIMS:
                continue
            for rows in (1, 2, 7, 8, 9, 2049, 4095, 4096, 4097, 8191, 8192, 8193, 16385):
                for skip in (0, 3):
                    g = f[:rows + skip].copy()
                    g[skip] = hit  # the first row probed is a hit, the last a miss
                    if rows > 1:
                        g[-1] = miss
                    yield from both(f"D={D} mixed dims, u{bits} n={rows} skip={skip}",
                                    keys, bucket, g, rows=rows, skip=skip)
    keys, bucket = dims(5003)
    yield from both("ragged n", keys, bucket, facts(keys), rows=n - 12345)
    keys, bucket = dims(3001, top_bit=True)
    f = facts(keys)
    f[::7] ^= np.uint64(1 << 63)  # the same low 63 bits: misses
    yield from both("top-bit keys", keys, bucket, f)
    keys, bucket = dims(2000, top_bit=True, all_ones=True)
    f = facts(keys)
    f[::5] = ALL_ONES
    yield from both("all-ones key among the dims", keys, bucket, f)
    keys, bucket = dims(2000)
    f = facts(keys)
    f[::5] = ALL_ONES
    yield from both("all-ones key only among the facts", keys, bucket, f)
    lows = rng.choice(1 << 31, 500, replace=False)
    keys = np.array([int(lo) for lo in lows]
                    + [_fingerprint_twin(int(lo), 1 + i) for i, lo in enumerate(lows)],
                    dtype=np.uint64)
    yield from both("colliding fingerprints", keys,
                    rng.integers(0, 512, len(keys)).astype(np.int32), facts(keys))
    for bits, dt in ((16, np.uint16), (32, np.uint32)):
        keys, bucket = dims(700, narrow_to=bits)
        f = np.where(rng.random(n) < 0.67, keys[rng.integers(0, 700, n)],
                     rng.integers(0, 1 << bits, n).astype(np.uint64)).astype(dt)
        yield from both(f"fact keys narrowed to u{bits}", keys, bucket, f)


def hash_cases(n, device, rng):
    """Yield (label, kwargs of hash_groupby and its plain version): 1, 2
    and 3 keys of every width the kernel reads, NULL keys beside a real
    key 0, every row a group of its own, one hot key, u64 maxima of 2^63
    and more, negative i64 minima, NaN and -0.0 under min / max / mean,
    count_distinct. Floats are multiples of 1/64: every sum is exact in
    any order."""
    def t(a):
        return dev_tensor(a, device)

    mask = t(rng.random(n) < 0.7)
    u64 = rng.integers(0, 1 << 40, n).astype(np.uint64)
    u64[rng.integers(0, n, n // 100)] |= np.uint64(1 << 63)
    i64 = rng.integers(-(1 << 50), 1 << 50, n).astype(np.int64)
    f = rng.integers(-(1 << 20), 1 << 20, n) / 64.0
    f[rng.integers(0, n, 40)] = np.nan
    f[rng.integers(0, n, 1000)] = -0.0
    u16 = t(rng.integers(0, 65536, n).astype(np.uint16))
    small = t(rng.integers(0, 50, n).astype(np.int32))
    every = dict(
        values=[t(u64)] * 3 + [t(i64)] * 3 + [t(f)] * 4 + [u16] * 3,
        kinds=["sum", "min", "max"] * 2 + ["sum", "min", "max", "mean"] + ["sum", "min", "max"],
        values_unsigned=[True] * 3 + [False] * 3 + [False] * 4 + [True] * 3,
        distinct=[small, t(u64 % np.uint64(997))])
    k5000 = rng.integers(0, 5000, n)
    yield "1 key (i64), every kind, masked", dict(
        keys=[t(k5000.astype(np.int64))], n=n, mask=mask, **every)
    yield "2 keys (i16, i32)", dict(
        keys=[t((k5000 % 300).astype(np.int16)), t((k5000 // 300).astype(np.int32))],
        n=n, mask=mask, **every)
    fk = (k5000 % 5).astype(np.float64)
    fk[(k5000 % 5 == 0) & (k5000 % 3 == 0)] = -0.0  # -0.0 and +0.0: two groups
    yield "3 keys (i16, u8, f64)", dict(
        keys=[t((k5000 % 40).astype(np.int16)), t(k5000 % 2 == 0), t(fk)],
        n=n - 17, mask=mask, **every)
    valid = rng.random(n) < 0.9
    real0 = np.where(valid, k5000 % 64, 0)  # NULL keys fold to 0 beside real 0s
    yield "NULL keys beside a real key 0", dict(
        keys=[t(real0.astype(np.int32)), t((~valid).astype(np.int64))], n=n, mask=None,
        **every)
    yield "every row its own group (about 2^20 groups)", dict(
        keys=[t(rng.permutation(n).astype(np.int64))], n=n, mask=None, **every)
    yield "one hot key", dict(
        keys=[t(np.zeros(n, np.int64))], n=n, mask=mask, **every)
    more = hg.MAX_VALUES + 4  # more value streams than one aggregate launch takes
    yield f"{more} value streams", dict(
        keys=[t((k5000 % 500).astype(np.int32))], n=n, mask=mask,
        values=[t(i64 + j) for j in range(more)], kinds=["sum", "min", "max", "sum"] * (more // 4))
    # the direct tiers: keys with spans (TIER_CASES names the tier and the
    # count_distinct forms each must take at phase 3's size)
    yield "shared tier: 2 keys, 1000 slots, every kind", dict(
        keys=[t((k5000 % 50).astype(np.int16)), t((k5000 // 50 % 20).astype(np.int32))],
        n=n, mask=mask, key_spans=[(0, 50, False), (0, 20, False)], **every,
        distinct_spans=[(0, 50, False), (0, 997, True)])
    yield "global tier: 1 key, 5000 slots, every kind", dict(
        keys=[t(k5000.astype(np.int64))], n=n, mask=mask, key_spans=[(0, 5000, False)],
        **every, distinct_spans=[(0, 50, False), (0, 997, True)])
    u32 = (np.uint64(1 << 31) + (k5000 % 3000).astype(np.uint64)).astype(np.uint32)
    three = dict(values=every["values"][:3], kinds=every["kinds"][:3],
                 values_unsigned=every["values_unsigned"][:3])
    yield "u32 keys >= 2^31 (read zero-extended)", dict(
        keys=[t(u32)], n=n, mask=mask, key_spans=[(1 << 31, 3000, True)], **three)
    valid_k = rng.random(n) < 0.8
    yield "NULL key outside the stats ([100, 200), NULL read as 0)", dict(
        keys=[t(np.where(valid_k, 100 + k5000 % 100, 0).astype(np.int64)),
              t((~valid_k).astype(np.int64))],
        n=n, mask=mask, key_spans=[(0, 200, False), (0, 2, False)], **three)
    yield "negative base", dict(
        keys=[t((k5000 % 500 - 1000).astype(np.int64))], n=n, mask=None,
        key_spans=[(-1000, 500, False)], **three)
    yield "bitmap count_distinct, global bitmap, and a set", dict(
        keys=[t(k5000.astype(np.int32))], n=n, mask=mask, key_spans=[(0, 5000, False)],
        distinct=[small, t(u64 % np.uint64(997)), t(u64)],
        distinct_spans=[(0, 50, False), (0, 997, True), None])
    zeros = t(np.zeros(n, np.int16))
    yield "one hot key, shared tier", dict(
        keys=[zeros], n=n, mask=mask, key_spans=[(0, 1024, False)], **every)
    yield "one hot key, global tier", dict(
        keys=[zeros], n=n, mask=mask, key_spans=[(0, 40000, False)], **every)
    yield "no key, shared tier", dict(keys=[], n=n, mask=mask, key_spans=[], **every)
    yield "unaligned streams, shared tier", dict(
        keys=[t((k5000 % 1000).astype(np.int16))[1:]], n=n - 1, mask=mask[1:],
        values=[v[1:] for v in every["values"]], kinds=every["kinds"],
        values_unsigned=every["values_unsigned"], key_spans=[(0, 1000, False)])
    yield f"{more} value streams, shared tier", dict(
        keys=[t((k5000 % 500).astype(np.int32))], n=n, mask=mask,
        key_spans=[(0, 500, False)],
        values=[t(i64 + j) for j in range(more)], kinds=["sum", "min", "max", "sum"] * (more // 4))


# the tier and count_distinct forms each spanned case of hash_cases takes at
# phase 3's size
TIER_CASES = {
    "shared tier: 2 keys, 1000 slots, every kind": ("shared", {"bitmap_shared": 2}),
    "global tier: 1 key, 5000 slots, every kind": ("global", {"bitmap_shared": 1,
                                                              "bitmap_global": 1}),
    "u32 keys >= 2^31 (read zero-extended)": ("shared", {}),
    "NULL key outside the stats ([100, 200), NULL read as 0)": ("shared", {}),
    "negative base": ("shared", {}),
    "bitmap count_distinct, global bitmap, and a set": (
        "shared", {"bitmap_shared": 1, "bitmap_global": 1, "set": 1}),
    "one hot key, shared tier": ("shared", {"set": 2}),
    "one hot key, global tier": ("global", {"set": 2}),
    "no key, shared tier": ("shared", {"set": 2}),
    "unaligned streams, shared tier": ("shared", {}),
    f"{hg.MAX_VALUES + 4} value streams, shared tier": ("shared", {}),
}


def expected_forms(kw, smem):
    """The tier and count_distinct forms of a hash_groupby call, by the
    wrapper's mirror of the launchers' rules."""
    spans, n = kw.get("key_spans"), kw["n"]
    tier = hg.tier_of(spans, min(len(kw.get("values", ())), hg.MAX_VALUES), n, smem)
    out = {tier: 1}
    dspans = kw.get("distinct_spans") or [None] * len(kw.get("distinct", ()))
    for sp in dspans:
        form = "set" if tier == "hash" else hg.distinct_form(
            hg._slots(spans), sp, n, smem)
        out[form] = out.get(form, 0) + 1
    return out


def tier_edges(smem, n):
    """(span sizes, nv, n, tier) at the tier rule's boundaries: one slot
    either side of the shared cap and of the direct-global memory limit,
    a span product that overflows int64, a key with no span, no key. For
    n of 100 000 rows or more (below, the limit lies under the cap)."""
    lim = hg.direct_limit(n)
    out = []
    for nv in (0, 3, hg.MAX_VALUES):
        cap = smem // (8 + 8 * nv)
        top = lim // (8 * (2 + nv))
        out += [([cap], nv, n, "shared"), ([cap + 1], nv, n, "global"),
                ([2, cap // 2], nv, n, "shared"), ([2, cap // 2 + 1], nv, n, "global"),
                ([top], nv, n, "global"), ([top + 1], nv, n, "hash")]
    out += [([1 << 31, 1 << 31, 4], 0, n, "hash"), ([10, None], 0, n, "hash"),
            ([None], 0, n, "hash"), ([], 0, n, "shared"), ([1], 16, 0, "shared")]
    return out


def distinct_edges(smem, n):
    """(slots, payload span, n, form) at the count_distinct form's
    boundaries."""
    lim = hg.direct_limit(n)
    words = smem // 4
    return [(words, 32, n, "bitmap_shared"), (words, 33, n, "bitmap_global"),
            (words + 1, 32, n, "bitmap_global"), (lim // 4, 32, n, "bitmap_global"),
            (lim // 4 + 1, 32, n, "set"), (1, None, n, "set"), (3, 1, n, "bitmap_shared"),
            (1 << 30, 1 << 30, n, "set")]


def same_grouped(got, want):
    """(equal?, max |difference|) of two Grouped, compared in the order
    of their first rows: integers exactly, floats by their bits (the sign
    of zero too) except that a NaN equals a NaN."""
    g, w = hg.in_first_row_order(got), hg.in_first_row_order(want)
    if g.first_index.shape != w.first_index.shape:
        return False, float("inf")
    ok = torch.equal(g.first_index, w.first_index) and torch.equal(g.counts, w.counts)
    err = 0.0
    for a, b in zip((*g.aggregates, *g.distinct), (*w.aggregates, *w.distinct)):
        if a.dtype != b.dtype:
            return False, float("inf")
        if a.dtype == torch.float64:
            na, nb = torch.isnan(a), torch.isnan(b)
            ok = ok and torch.equal(na, nb) and torch.equal(
                a[~na].view(torch.int64), b[~na].view(torch.int64))
            if int((~na).sum()) and torch.equal(na, nb):
                err = max(err, float((a[~na] - b[~na]).abs().max()))
        else:
            ok = ok and torch.equal(a, b)
            if a.numel():
                err = max(err, float((a - b).abs().max()))
    return ok, err


def check_hash_case(label, got, want):
    ok, err = same_grouped(got, want)
    check(ok, f"hash_groupby [{label}]: kernel and plain version disagree"
          f" (max |diff| {err})")
    check(int((got.counts > 0).sum()) > 0, f"hash_groupby [{label}]: no group")
    return err


class _Kernel:
    """One wrapper of the port: where it lives, its plain version, and
    the module that counts its launches."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.wrapper = getattr(module, name)
        self.plain = getattr(module, name + "_plain")

    @property
    def launches(self):
        return self.module.LAUNCHES[self.name]


_KERNELS = {
    "groupby_agg": _Kernel(ga, "groupby_agg"),
    "groupby_multi_agg": _Kernel(ga, "groupby_multi_agg"),
    "extract_ge": _Kernel(ex, "extract_ge"),
    "dim_join_gid": _Kernel(kj, "dim_join_gid"),
    "probe_join_gid": _Kernel(kj, "probe_join_gid"),
    "hash_groupby": _Kernel(hg, "hash_groupby"),
}


def launch_counts():
    return {name: k.launches for name, k in _KERNELS.items()}


def _forms_since(forms):
    """hash_groupby's launches by tier and count_distinct form since
    ``forms`` (a copy of hg.FORMS)."""
    return {k: hg.FORMS[k] - forms[k] for k in hg.FORMS if hg.FORMS[k] != forms[k]}


def zero_launch_counts():
    for k in _KERNELS.values():
        for name in k.module.LAUNCHES:  # the table-build kernel's count too
            k.module.LAUNCHES[name] = 0


def check_extract(label, got, want, values, threshold, cap, rows):
    """extract_ge against its plain version, and the contract itself:
    ascending row indices of matches, then -1."""
    check(got.dtype == torch.int32 and got.shape == (cap,),
          f"extract_ge [{label}]: shape/dtype")
    check(torch.equal(got, want),
          f"extract_ge [{label}]: kernel and plain version disagree")
    rows = values.shape[0] if rows is None else rows
    total = int((values[:rows] >= threshold).sum())
    kept = min(total, cap)
    check(bool((got[kept:] == -1).all()) and bool((got[:kept] >= 0).all()),
          f"extract_ge [{label}]: {kept} matches expected before the -1 padding")
    return kept


def phase_kernels(device, n):
    """The case grid: options and widths the main path may not reach."""
    rng = np.random.default_rng(7)
    cases = 0
    for label, values, threshold, cap, rows in extract_cases(n, rng):
        v = dev_tensor(values, device)
        got = ex.extract_ge(v, threshold, cap, rows)
        want = ex.extract_ge_plain(v, threshold, cap, rows)
        torch.cuda.synchronize()
        kept = check_extract(label, got, want, v, threshold, cap, rows)
        check((kept > 0) == (label != "no match"), f"extract_ge [{label}]: vacuous")
        cases += 1
    for name, label, kw in kernel_cases(n, device, rng):
        wrapper, plain = _KERNELS[name].wrapper, _KERNELS[name].plain
        got = wrapper(**kw)
        want = plain(**kw)
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name} [{label}]: shape/dtype differ from the plain version")
        err = int((got - want).abs().max()) if got.numel() else 0
        check(torch.equal(got, want),
              f"{name} [{label}]: kernel and plain version disagree (max |diff| {err})")
        if label == "all rows filtered":
            check(int(got.sum()) == 0, "filtered rows were counted")
        elif kw["n"] >= 1000:  # a handful of rows may all be filtered
            check(int(got[0].sum()) > 0, f"{name} [{label}]: nothing counted")
        cases += 1
    for name, label, kw in join_cases(n, device, rng):
        got = _KERNELS[name].wrapper(**kw)
        want = _KERNELS[name].plain(**kw)
        torch.cuda.synchronize()
        rows = kw["fact_keys"].shape[0] if kw["n"] is None else kw["n"]
        check(got.dtype == torch.int32 and got.shape == (rows,),
              f"{name} [{label}]: shape/dtype")
        check(torch.equal(got, want),
              f"{name} [{label}]: kernel and plain version disagree on"
              f" {int((got != want).sum())} rows")
        hits = int((got >= 0).sum())
        check(0 < hits and (hits < rows or rows == 1),
              f"{name} [{label}]: {hits} hits in {rows} rows")
        cases += 1
    smem = ga.smem_optin(device)
    for label, kw in hash_cases(n, device, rng):
        forms = dict(hg.FORMS)
        got = hg.hash_groupby(**kw)
        want = hg.hash_groupby_plain(**kw)
        torch.cuda.synchronize()
        check_hash_case(label, got, want)
        took = _forms_since(forms)
        want_forms = expected_forms(kw, smem)
        if n == N_KERNEL_CASE_ROWS and label in TIER_CASES:
            tier, distinct_forms = TIER_CASES[label]
            check(want_forms == {tier: 1, **distinct_forms},
                  f"hash_groupby [{label}]: the rule gives {want_forms}")
        check(took == want_forms, f"hash_groupby [{label}]: took {took}, expected {want_forms}")
        if label.startswith("1 key"):
            a = got.aggregates  # u64 sum/min/max, i64 sum/min/max, f64 sum/min/max/mean
            check(bool((a[2] < 0).any()), "no group's u64 max is 2^63 or more")
            check(bool((a[4] < 0).any()), "no group's i64 min is negative")
            check(all(bool(torch.isnan(a[j]).any()) for j in (7, 8, 9)),
                  "no NaN group under min, max and mean")
            check(bool((got.distinct[0] > 1).all()), "count_distinct: nothing repeated")
        if label.startswith("one hot key"):
            check(hg.in_first_row_order(got).counts.tolist() == [int(kw["mask"][:n].sum())],
                  f"{label}: one group")
        cases += 1
    # the tier rule and the count_distinct form: kernels/hash_groupby.py
    # mirrors the launcher's
    for spans, nv, rows, tier in tier_edges(smem, n):
        check(hg.launcher_tier(spans, nv, rows, smem) == tier
              == hg.tier_of(None if None in spans else [(0, s, False) for s in spans],
                            nv, rows, smem),
              f"tier of spans {spans}, {nv} values, {rows} rows: expected {tier}")
    for slots, span, rows, form in distinct_edges(smem, n):
        check(hg.launcher_distinct_form(slots, span, rows, smem) == form
              == hg.distinct_form(slots, None if span is None else (0, span, False), rows,
                                  smem),
              f"count_distinct form of {slots} slots, payload span {span}: expected {form}")
    # dim_join_gid's launcher shapes its table; kernels/join.py mirrors the rule
    slots_of = kj._lib().evql_dim_table_slots
    for key_bytes in (2, 4, 8):
        for D in range(1, kj.MAX_COMPARE_DIMS + 1):
            check(slots_of(D, key_bytes) == kj.dim_table(D, key_bytes).slots,
                  f"dim_table({D}, {key_bytes}) is not the launcher's slot rule")
    for name, count in launch_counts().items():
        check(count > 0, f"{name}: no kernel launch in phase 3")
    log(f"phase 3: {cases} kernel cases equal to their plain versions"
        f" (n = {n}, tolerance 0)")


# -- phase 4: the main paths --------------------------------------------------

COLUMNS = [("k", SType.STRING), ("v", SType.UINT64), ("w", SType.UINT64),
           ("cat", SType.INT64), ("big", SType.UINT64), ("ts", SType.UINT64),
           ("dk", SType.UINT64), ("dk2", SType.UINT64)]


def make_table(n, seed):
    """The sql_groupby deployment of the JAX package's bench at
    partition size: a dictionary-encoded string key plus numeric
    columns that narrow to 16 and 32 bits; the sort column of its
    sql_topk deployment, a full-range 64-bit timestamp; and the fact
    keys of its join and join_bigdim deployments: ``dk`` (narrows to 32
    bits; half its rows have no dimension row) and ``dk2`` (64 bits)."""
    rng = np.random.default_rng(seed)
    cols = {
        "k": rng.integers(0, N_KEYS, n).astype(np.int32),
        "v": rng.integers(0, 1000, n).astype(np.uint64),
        "w": rng.integers(0, 1 << 20, n).astype(np.uint64),
        "cat": rng.integers(CAT_LO, CAT_HI, n).astype(np.int64),
        "big": (rng.integers(0, BIG_SPAN, n) + BIG_BASE).astype(np.uint64),
        "ts": rng.integers(0, 1 << 63, n, dtype=np.uint64),
        "dk": rng.integers(0, 2 * N_DIMS, n).astype(np.uint64) * DIM_MULT + 3,
        "dk2": rng.integers(0, N_BIG_DIMS, n).astype(np.uint64) * BIG_DIM_MULT + 3,
    }
    dictionary = np.array([b"k%05d" % i for i in range(N_KEYS)], dtype=object)
    return cols, dictionary


def provider_of(cols, dictionary, n):
    ones = np.ones(n, bool)
    rel = relation_from_numpy(
        [name for name, _st in COLUMNS],
        [(st, cols[name][:n], ones, dictionary if st == SType.STRING else None)
         for name, st in COLUMNS],
    )
    p = RelationTableProvider()
    p.add_table("t", rel)
    return p


def make_dims(seed):
    """The two dimension tables: name -> (ordinal of each row's key,
    region of each row); row i has the key ordinal * multiplier + 3, the
    rows are in a random order, and ``region`` has N_REGIONS values."""
    rng = np.random.default_rng(seed)
    return {
        name: (rng.permutation(d), rng.integers(0, N_REGIONS, d))
        for name, d in (("d1", N_DIMS), ("d2", N_BIG_DIMS))
    }


def add_dims(provider, dims):
    regions = np.array([b"r%04d" % i for i in range(N_REGIONS)], dtype=object)
    for (name, (ordinal, region)), mult in zip(dims.items(), (DIM_MULT, BIG_DIM_MULT)):
        ones = np.ones(len(ordinal), bool)
        provider.add_table(name, relation_from_numpy(
            ["k", "region"],
            [(SType.UINT64, ordinal.astype(np.uint64) * mult + 3, ones, None),
             (SType.STRING, region.astype(np.int32), ones, regions)],
        ))
    return provider


def _bincounts(key, K, keep, *weights):
    """Independent answer: occupied buckets with count and sums, via
    np.bincount (float64 weights are exact: every sum is below 2^53)."""
    key = key[keep]
    counts = np.bincount(key, minlength=K)
    sums = []
    for w in weights:
        s = np.bincount(key, weights=w[keep].astype(np.float64), minlength=K)
        check(s.max(initial=0) < 2.0**53, "expected sum not exact in float64")
        sums.append(s.astype(np.uint64))
    occ = np.nonzero(counts)[0]
    return occ, counts[occ], [s[occ] for s in sums]


def queries(c, dictionary):
    """(name, sql, kernel it must launch, fused?, expected rows)."""
    names = [d.decode() for d in dictionary]
    k, v, w = c["k"], c["v"], c["w"]
    cat = (c["cat"] - CAT_LO).astype(np.int64)
    big = (c["big"] - BIG_BASE).astype(np.int64)
    everything = np.ones(len(k), bool)

    def rows(occ, key_fn, *cols):
        return sorted(
            [key_fn(int(o))] + [str(int(x[i])) for x in cols]
            for i, o in enumerate(occ)
        )

    out = []
    occ, cnt, (sv,) = _bincounts(k, N_KEYS, v < 800, v)
    out.append(("headline",
                "select k, count(1), sum(v) from t where v < 800 group by k;",
                "groupby_agg", True, rows(occ, lambda o: names[o], cnt, sv)))
    occ, cnt, (sv,) = _bincounts(k, N_KEYS, (v < 100) | (w >= 524288), v)
    out.append(("or_two_columns",
                "select k, count(1), sum(v) from t where v < 100 or w >= 524288"
                " group by k;",
                "groupby_agg", True, rows(occ, lambda o: names[o], cnt, sv)))
    occ, cnt, _ = _bincounts(k, N_KEYS, everything)
    out.append(("count_only", "select k, count(1) from t group by k;",
                "groupby_agg", True, rows(occ, lambda o: names[o], cnt)))
    occ, cnt, (sv,) = _bincounts(cat, CAT_HI - CAT_LO, v < 800, v)
    out.append(("numeric_key_base",
                "select cat, count(1), sum(v) from t where v < 800 group by cat;",
                "groupby_agg", True,
                rows(occ, lambda o: str(o + CAT_LO), cnt, sv)))
    occ, cnt, (sw,) = _bincounts(big, BIG_SPAN, v < 800, w)
    out.append(("k_100000",
                "select big, count(1), sum(w) from t where v < 800 group by big;",
                "groupby_agg", True,
                rows(occ, lambda o: str(o + BIG_BASE), cnt, sw)))
    occ, cnt, (sv,) = _bincounts(k, N_KEYS, v + w < 500000, v)
    out.append(("mask_form",
                "select k, sum(v) from t where v + w < 500000 group by k;",
                "groupby_agg", True, rows(occ, lambda o: names[o], sv)))
    occ, cnt, (sv, sw) = _bincounts(k, N_KEYS, v < 800, v, w)
    out.append(("multi_sum",
                "select k, sum(v), sum(w), count(1) from t where v < 800"
                " group by k;",
                "groupby_multi_agg", False,
                rows(occ, lambda o: names[o], sv, sw, cnt)))
    return out


def _first_rows(keys, keep, w):
    """Independent answer of ORDER BY ... LIMIT: the first ``w`` rows in
    the ascending lexicographic order of ``keys`` (most significant
    first; ties to the lower row index) among the rows ``keep`` selects.
    A partition finds the w-th smallest leading key, and only the rows
    up to it (all its ties included) are sorted."""
    rows = np.arange(len(keys[0])) if keep is None else np.nonzero(keep)[0]
    lead = keys[0][rows]
    if 0 < w < len(rows):
        rows = rows[lead <= np.partition(lead, w - 1)[w - 1]]
    order = np.lexsort([key[rows] for key in reversed(keys)])  # stable
    return rows[order][:w]


def order_queries(c, dictionary, n):
    """(name, sql, route, fast-path?, launches per run, expected rows in
    order). ``fast-path`` marks a single-key top-k, which takes the two
    histograms once the table has FAST_TOPK_ROWS rows; the heavy-tie
    query overflows the candidate cap there and never extracts."""
    names = [d.decode() for d in dictionary]
    k, v, w, ts = c["k"][:n], c["v"][:n], c["w"][:n], c["ts"][:n]
    fast = n >= FAST_TOPK_ROWS
    hist = {"groupby_agg": 2 if fast else 0}
    none = {}

    def rows(idx, *cols):
        return [[names[int(x[i])] if x is k else str(int(x[i])) for x in cols]
                for i in idx]

    ts_desc = ~ts  # the unsigned complement reverses the order
    out = []
    out.append(("topk_ts_desc",
                "select ts, v from t order by ts desc limit 100;",
                "topk", dict(hist, extract_ge=1 if fast else 0),
                rows(_first_rows([ts_desc], None, 100), ts, v)))
    out.append(("topk_ts_asc_where_offset",
                "select ts, v from t where v < 800 order by ts limit 10 offset 5;",
                "topk", dict(hist, extract_ge=1 if fast else 0),
                rows(_first_rows([ts], v < 800, 15)[5:], ts, v)))
    out.append(("topk_v_desc_ties",
                "select ts, v from t order by v desc limit 100;",
                "topk", hist,
                rows(_first_rows([np.uint64(999) - v], None, 100), ts, v)))
    out.append(("topk_string_then_ts_desc",
                "select k, ts from t order by k, ts desc limit 50;",
                "topk", none,
                rows(_first_rows([k, ts_desc], None, 50), k, ts)))
    keep = (v < 10) & (w < 65536)  # 1 row in 1600: the host emits every kept row
    out.append(("order_ts_where",
                "select ts, v from t where v < 10 and w < 65536 order by ts;",
                "order", none,
                rows(_first_rows([ts], keep, int(keep.sum())), ts, v)))
    return out


def join_queries(c, dims, n):
    """(name, sql, launches per run, expected rows in order, or None for
    the query the host engine must serve). The independent answer undoes
    the key arithmetic: a fact key is ordinal * multiplier + 3, and the
    region of an ordinal is looked up in a table indexed by ordinal.
    The rows come in the order of each region's first surviving row."""
    v, w = c["v"][:n], c["w"][:n]
    region_of = {}
    for (name, (ordinal, region)), slots in zip(dims.items(), (2 * N_DIMS, N_BIG_DIMS)):
        lut = np.full(slots, -1, np.int64)  # ordinals without a row: no match
        lut[ordinal] = region
        region_of[name] = lut
    r1 = region_of["d1"][(c["dk"][:n] - 3) // DIM_MULT]
    r2 = region_of["d2"][(c["dk2"][:n] - 3) // BIG_DIM_MULT]
    check(0.4 < (r1 < 0).mean() < 0.6 and (r2 >= 0).all(),
          "half of dk and all of dk2 should find a dimension row")

    def rows(region, keep, *cols, count_last=False):
        keep = keep & (region >= 0)
        occ, cnt, sums = _bincounts(region, N_REGIONS, keep, *cols)
        # first surviving row per region: every region shows up early
        head = np.nonzero(keep[: 1 << 20])[0]
        seen, first = np.unique(region[head], return_index=True)
        check(len(seen) == len(occ) or n <= (1 << 20),
              "a region has no row in the first 2^20")
        if len(seen) != len(occ):
            seen, first = np.unique(region[keep], return_index=True)
        order = np.argsort(first, kind="stable")
        at = {int(o): i for i, o in enumerate(occ)}
        out = []
        for o in seen[order]:
            i = at[int(o)]
            aggs = [str(int(x[i])) for x in sums]
            count = [str(int(cnt[i]))]
            out.append(["r%04d" % o] + (aggs + count if count_last else count + aggs))
        return out

    everything = np.ones(n, bool)
    agg, multi = "groupby_agg", "groupby_multi_agg"
    return [
        ("join_small_dim",
         "select d1.region, count(1), sum(t.v) from t join d1 on t.dk = d1.k"
         " group by d1.region;",
         {"dim_join_gid": 1, agg: 1}, rows(r1, everything, v)),
        ("join_small_dim_where",
         "select d1.region, count(1), sum(t.w) from t join d1 on t.dk = d1.k"
         " where t.v < 800 group by d1.region;",
         {"dim_join_gid": 1, agg: 1}, rows(r1, v < 800, w)),
        ("join_small_dim_two_sums",
         "select d1.region, sum(t.v), sum(t.w), count(1) from t join d1 on"
         " t.dk = d1.k group by d1.region;",
         {"dim_join_gid": 1, multi: 1}, rows(r1, everything, v, w, count_last=True)),
        ("join_big_dim",
         "select d2.region, count(1), sum(t.v) from t join d2 on t.dk2 = d2.k"
         " group by d2.region;",
         {"probe_join_gid": 1, agg: 1}, rows(r2, everything, v)),
        (J1[0], J1[1], {"dim_join_gid": 1, "hash_groupby": 1},
         join_min_max_rows(r1, v, w)),
    ]


# the general GROUP BY path: every plan the bounded route declines
GENERAL_SQL = {
    "G1_min_max_mean": "select k, min(v), max(w), mean(v) from t where v < 800 group by k;",
    "G2_key_beyond_k_cap": "select w, count(1), sum(v) from t group by w;",
    "G3_two_keys": "select k, cat, count(1), max(ts) from t group by k, cat;",
    "G4_count_distinct": "select k, count_distinct(v) from t group by k;",
    "G5_float_sums": "select cat, sum(v / 64), mean(w) from t group by cat;",
}
# the join route's general branch (min / max after the small-table probe)
J1 = ("join_min_max",
      "select d1.region, min(t.v), max(t.w) from t join d1 on t.dk = d1.k"
      " group by d1.region;")


def _first_rows_of(group, G):
    """Per group id in [0, G): its first row (n where it has none)."""
    n = len(group)
    first = np.full(G, n, np.int64)
    np.minimum.at(first, group, np.arange(n, dtype=np.int64))
    return first


def general_queries(c, dictionary, n):
    """(name, sql, expected rows in order): independent numpy answers,
    groups in the order of their first rows, floats as the port prints
    them ("%f"; every sum here is exact in float64)."""
    names = np.array([d.decode() for d in dictionary], dtype=object)
    k, v, w, ts = c["k"][:n], c["v"][:n], c["w"][:n], c["ts"][:n]
    cat = (c["cat"][:n] - CAT_LO).astype(np.int64)

    def ordered(first, *cols):
        occ = np.nonzero(first < n)[0]
        occ = occ[np.argsort(first[occ], kind="stable")]
        return [list(r) for r in zip(*(col(occ) for col in cols))]

    def num(a):
        return lambda occ: a[occ].astype(str).tolist()

    def flt(a):
        return lambda occ: ["%f" % x for x in a[occ]]

    out = []
    keep = v < 800
    kk = np.where(keep, k, N_KEYS)  # dropped rows in a spare group
    mn = np.full(N_KEYS + 1, 1 << 20, np.uint64)
    mx = np.zeros(N_KEYS + 1, np.uint64)
    np.minimum.at(mn, kk, v)
    np.maximum.at(mx, kk, w)
    cnt = np.bincount(kk, minlength=N_KEYS + 1)
    sv = np.bincount(kk, weights=v.astype(np.float64), minlength=N_KEYS + 1)
    first = _first_rows_of(kk, N_KEYS + 1)
    first[N_KEYS] = n
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = sv / cnt
    out.append(("G1_min_max_mean", ordered(
        first, lambda o: names[o].tolist(), num(mn), num(mx), flt(mean))))
    W = 1 << 20
    wi = w.astype(np.int64)
    out.append(("G2_key_beyond_k_cap", ordered(
        _first_rows_of(wi, W), lambda o: o.astype(str).tolist(),
        num(np.bincount(wi, minlength=W)),
        num(np.bincount(wi, weights=v.astype(np.float64), minlength=W).astype(np.uint64)))))
    pair = k.astype(np.int64) * (CAT_HI - CAT_LO) + cat
    P = N_KEYS * (CAT_HI - CAT_LO)
    tmax = np.zeros(P, np.uint64)
    np.maximum.at(tmax, pair, ts)
    out.append(("G3_two_keys", ordered(
        _first_rows_of(pair, P), lambda o: names[o // (CAT_HI - CAT_LO)].tolist(),
        lambda o: (o % (CAT_HI - CAT_LO) + CAT_LO).astype(str).tolist(),
        num(np.bincount(pair, minlength=P)), num(tmax))))
    seen = np.zeros((N_KEYS, 1000), bool)
    seen[k, v] = True
    out.append(("G4_count_distinct", ordered(
        _first_rows_of(k, N_KEYS), lambda o: names[o].tolist(), num(seen.sum(1)))))
    C = CAT_HI - CAT_LO
    ccount = np.bincount(cat, minlength=C)
    sv = np.bincount(cat, weights=v.astype(np.float64), minlength=C)
    sw = np.bincount(cat, weights=w.astype(np.float64), minlength=C)
    with np.errstate(invalid="ignore", divide="ignore"):
        out.append(("G5_float_sums", ordered(
            _first_rows_of(cat, C), lambda o: (o + CAT_LO).astype(str).tolist(),
            flt(sv / 64), flt(sw / ccount))))
    return [(name, GENERAL_SQL[name], rows) for name, rows in out]


def join_min_max_rows(region, v, w):
    """J1's independent answer: per region of a row's dimension row
    (-1: none), min(v) and max(w), regions in the order of their first
    rows."""
    n = len(region)
    keep = region >= 0
    r = np.where(keep, region, N_REGIONS)
    mn = np.full(N_REGIONS + 1, 1 << 20, np.uint64)
    mx = np.zeros(N_REGIONS + 1, np.uint64)
    np.minimum.at(mn, r, v)
    np.maximum.at(mx, r, w)
    first = _first_rows_of(r, N_REGIONS + 1)
    first[N_REGIONS] = n
    occ = np.nonzero(first < n)[0]
    occ = occ[np.argsort(first[occ], kind="stable")]
    return [["r%04d" % o, str(int(mn[o])), str(int(mx[o]))] for o in occ]


# the tier (and count_distinct form) each general query's hash_groupby
# call takes: the spans of a dictionary, of cached min / max, of a join's
# buckets
GENERAL_TIERS = {
    "G1_min_max_mean": {"shared": 1},
    "G2_key_beyond_k_cap": {"global": 1},
    "G3_two_keys": {"global": 1},
    "G4_count_distinct": {"shared": 1, "bitmap_shared": 1},
    "G5_float_sums": {"shared": 1},
    J1[0]: {"shared": 1},
}


def general_path(rt, full, qs, reps):
    """The general GROUP BY path at full size: rows and their order must
    equal the numpy answer, the route counter rise once a run, and each
    run launch the hash aggregate once, in the tier GENERAL_TIERS names.
    Returns (e2e, launches per query, the last run's kernel calls per
    query)."""
    e2e, launches_by_query, calls = {}, {}, {}
    for name, sql, expected in qs:
        forms = dict(hg.FORMS)
        before = launch_counts()
        route0 = device_exec.GENERAL_GROUPBY_COUNT
        reads0 = ksort.READBACKS
        torch.cuda.reset_peak_memory_stats()
        res, times, n_calls, recorded = _timed_runs(rt, full, sql, reps)
        peak = torch.cuda.max_memory_allocated()
        got = res.rows
        check(len(got) == len(expected),
              f"{name}: {len(got)} groups, expected {len(expected)}")
        check(got == expected, f"{name}: rows or their order differ from the numpy answer")
        check(device_exec.GENERAL_GROUPBY_COUNT - route0 == reps,
              f"{name}: general route counter")
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        want = {k: reps * (k == "hash_groupby") for k in after}
        check(delta == want, f"{name}: launches {delta}, expected {want}")
        check(n_calls == reps and [c[0] for c in recorded] == ["hash_groupby"],
              f"{name}: recorded calls")
        took = {k: c // reps for k, c in _forms_since(forms).items()}
        check(took == GENERAL_TIERS[name], f"{name}: tiers {took}, expected"
              f" {GENERAL_TIERS[name]}")
        calls[name] = recorded
        launches_by_query[name] = {"hash_groupby": 1}
        e2e[name] = _e2e(times, groups=len(got), tier=took, peak_bytes=peak,
                         readbacks=(ksort.READBACKS - reads0) // reps)
    return e2e, launches_by_query, calls


def run_query(rt, provider, sql):
    txn = rt.new_transaction(provider)
    return rt.build_query_plan(txn, sql).execute(0)


class _RecordedCalls:
    """While active, the kernel wrappers of the port keep a record of
    the keyword form of each call and then run as they are, so that
    phase 5 can repeat exactly what the routes asked of each kernel."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        for name, k in _KERNELS.items():
            setattr(k.module, name, self._recording(name, k.wrapper))
        return self

    def __exit__(self, *exc):
        for name, k in _KERNELS.items():
            setattr(k.module, name, k.wrapper)

    def _recording(self, name, wrapper):
        sig = inspect.signature(wrapper)

        def call(*args, **kwargs):
            self.calls.append((name, dict(sig.bind(*args, **kwargs).arguments)))
            return wrapper(*args, **kwargs)

        return call


def _timed_runs(rt, provider, sql, reps):
    """Run the query ``reps`` times; returns the last ResultList, the
    wall times (each ends in a synchronise), the number of kernel calls
    in all runs and the recorded calls of the last run (earlier records
    are dropped at once: they would keep every run's tensors alive)."""
    times, n_calls = [], 0
    with _RecordedCalls() as rec:
        for _ in range(reps):
            rec.calls.clear()
            t = time.perf_counter()
            res = run_query(rt, provider, sql)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            n_calls += len(rec.calls)
    return res, times, n_calls, rec.calls


def _e2e(times, **more):
    # warm = every run after the first (columns on the card, plan cached)
    return dict(first_ms=times[0], warm_ms_median=statistics.median(times[1:]),
                warm_ms_min=min(times[1:]), **more)


def groupby_path(rt, full, qs, reps):
    """The GROUP BY sum/count path at full size. Returns (e2e, launches
    per query, the last run's kernel call per query)."""
    fused0 = device_exec.FUSED_GROUPBY_COUNT
    multi0 = device_exec.MULTI_SUM_GROUPBY_COUNT
    e2e, launches_by_query, calls = {}, {}, {}
    for name, sql, kernel, fused, expected in qs:
        before = launch_counts()
        f_before = device_exec.FUSED_GROUPBY_COUNT
        m_before = device_exec.MULTI_SUM_GROUPBY_COUNT
        res, times, n_calls, recorded = _timed_runs(rt, full, sql, reps)
        check(n_calls == reps and [c[0] for c in recorded] == [kernel],
              f"{name}: expected {reps} calls of {kernel}")
        calls[name] = recorded[0]
        got = sorted(res.rows)
        check(len(got) == len(expected),
              f"{name}: {len(got)} groups, expected {len(expected)}")
        check(got == expected, f"{name}: rows differ from the numpy answer")
        check(device_exec.FUSED_GROUPBY_COUNT - f_before == (reps if fused else 0),
              f"{name}: fused route counter")
        check(device_exec.MULTI_SUM_GROUPBY_COUNT - m_before
              == (0 if fused else reps), f"{name}: multi-sum route counter")
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        check(delta[kernel] == reps and sum(delta.values()) == reps,
              f"{name}: expected {reps} launches of {kernel}, got {delta}")
        launches_by_query[name] = {kernel: delta[kernel] // reps}
        e2e[name] = _e2e(times, groups=len(got))
    check(device_exec.FUSED_GROUPBY_COUNT > fused0, "fused route never taken")
    check(device_exec.MULTI_SUM_GROUPBY_COUNT > multi0, "multi-sum route never taken")
    return e2e, launches_by_query, calls


def order_path(rt, full, qs, reps):
    """The ORDER BY [LIMIT] path at full size: rows AND their order must
    equal the numpy answer. Returns (e2e, launches per query, the last
    run's kernel calls per query)."""
    e2e, launches_by_query, calls = {}, {}, {}
    for name, sql, route, per_run, expected in qs:
        before = launch_counts()
        topk0, order0 = device_exec.SCAN_TOPK_COUNT, device_exec.SCAN_ORDER_COUNT
        reads0 = ksort.READBACKS
        res, times, n_calls, recorded = _timed_runs(rt, full, sql, reps)
        got = res.rows
        check(len(got) == len(expected),
              f"{name}: {len(got)} rows, expected {len(expected)}")
        check(got == expected, f"{name}: rows or their order differ from the"
              " numpy answer")
        check(device_exec.SCAN_TOPK_COUNT - topk0 == (reps if route == "topk" else 0)
              and device_exec.SCAN_ORDER_COUNT - order0
              == (reps if route == "order" else 0), f"{name}: route counters")
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        want = {k: reps * per_run.get(k, 0) for k in after}
        check(delta == want, f"{name}: launches {delta}, expected {want}")
        check(n_calls == reps * sum(per_run.values())
              and len(recorded) == sum(per_run.values()), f"{name}: recorded calls")
        calls[name] = recorded
        launches_by_query[name] = {k: c for k, c in per_run.items() if c}
        e2e[name] = _e2e(times, rows=len(got),
                         readbacks=(ksort.READBACKS - reads0) // reps)
    return e2e, launches_by_query, calls


def join_path(rt, full, qs, reps):
    """The fact-dim JOIN + GROUP BY path at full size: rows and their
    order must equal the numpy answer. Returns (e2e, launches per query,
    the last run's kernel calls per query)."""
    e2e, launches_by_query, calls = {}, {}, {}
    for name, sql, per_run, expected in qs:
        if expected is None:
            continue  # the host engine's: run on the prefix only
        forms = dict(hg.FORMS)
        before = launch_counts()
        route0 = device_exec.JOIN_GROUPBY_COUNT
        reads0 = ksort.READBACKS
        res, times, n_calls, recorded = _timed_runs(rt, full, sql, reps)
        got = res.rows
        check(len(got) == len(expected),
              f"{name}: {len(got)} groups, expected {len(expected)}")
        check(got == expected, f"{name}: rows or their order differ from the"
              " numpy answer")
        check(device_exec.JOIN_GROUPBY_COUNT - route0 == reps,
              f"{name}: join route counter")
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        want = {k: reps * per_run.get(k, 0) for k in after}
        check(delta == want, f"{name}: launches {delta}, expected {want}")
        check(n_calls == reps * len(per_run)
              and [c[0] for c in recorded] == list(per_run), f"{name}: recorded calls")
        took = {k: c // reps for k, c in _forms_since(forms).items()}
        check(took == GENERAL_TIERS.get(name, {}), f"{name}: tiers {took}")
        calls[name] = recorded
        launches_by_query[name] = dict(per_run)
        e2e[name] = _e2e(times, groups=len(got),
                         readbacks=(ksort.READBACKS - reads0) // reps,
                         **({"tier": took} if took else {}))
    return e2e, launches_by_query, calls


def phase_main_path(device, n, n_prefix, reps):
    """Both paths of the port at ``n`` rows, then both on the prefix
    against the host engine. Returns a dict: launches (per kernel, the
    paths' counts added), launches_by_path, per_query, e2e, calls
    (query -> list of (kernel, kwargs)), resident bytes."""
    t0 = time.perf_counter()
    cols, dictionary = make_table(n, seed=42)
    dims = make_dims(seed=43)
    full = add_dims(provider_of(cols, dictionary, n), dims)
    prefix = add_dims(provider_of(cols, dictionary, n_prefix), dims)
    gqs = queries(cols, dictionary)
    oqs = order_queries(cols, dictionary, n)
    jqs = join_queries(cols, dims, n)
    hqs = general_queries(cols, dictionary, n)
    log(f"phase 4: table of {n} rows and expected answers made in"
        f" {time.perf_counter() - t0:.1f} s")

    rt = Runtime(plan_cache=PlanCache(), device=device)
    host_rt = Runtime(device=None)

    zero_launch_counts()
    g_e2e, g_per_query, g_calls = groupby_path(rt, full, gqs, reps)
    g_launches = launch_counts()
    for name in ("groupby_agg", "groupby_multi_agg"):
        check(g_launches[name] > 0, f"{name}: not launched on the GROUP BY path")
    log(f"phase 4: {len(gqs)} GROUP BY queries x {reps} equal to numpy at {n}"
        f" rows; launches {g_launches}")

    zero_launch_counts()
    h_e2e, h_per_query, h_calls = general_path(rt, full, hqs, reps)
    h_launches = launch_counts()
    peak = max(e["peak_bytes"] for e in h_e2e.values())
    check(h_launches["hash_groupby"] > 0, "hash_groupby: not launched on the general path")
    total = torch.cuda.get_device_properties(device).total_memory
    check(peak < total // 2, f"general path: peak {peak} bytes of {total}")
    log(f"phase 4: {len(hqs)} general GROUP BY queries x {reps} equal to numpy at {n}"
        f" rows, in order; launches {h_launches}")

    zero_launch_counts()
    o_e2e, o_per_query, o_calls = order_path(rt, full, oqs, reps)
    o_launches = launch_counts()
    if n >= FAST_TOPK_ROWS:
        for name in ("groupby_agg", "extract_ge"):
            check(o_launches[name] > 0, f"{name}: not launched on the ORDER BY path")
    log(f"phase 4: {len(oqs)} ORDER BY queries x {reps} equal to numpy at {n}"
        f" rows, in order; launches {o_launches}")

    zero_launch_counts()
    j_e2e, j_per_query, j_calls = join_path(rt, full, jqs, reps)
    j_launches = launch_counts()
    for name in ("dim_join_gid", "probe_join_gid", "groupby_agg", "groupby_multi_agg"):
        check(j_launches[name] > 0, f"{name}: not launched on the JOIN path")
    # probe_join_gid is two device functions: every probe had its table built
    table_builds = kj.LAUNCHES["build_join_table"]
    check(table_builds == j_launches["probe_join_gid"],
          f"{table_builds} table builds for {j_launches['probe_join_gid']} probes")
    log(f"phase 4: {len(j_e2e)} JOIN + GROUP BY queries x {reps} equal to numpy at"
        f" {n} rows, in order; launches {j_launches}")

    # bytes of the table's columns as the column cache holds them
    resident = sum(
        t.numel() * t.element_size()
        for c in full.get_table_data("t").columns
        for t in c._device_cache[str(device)]
    )
    check(resident > n * 34, "the table is not resident on the device")
    log(f"phase 4: device memory held {resident} bytes; peak allocated on the general"
        f" GROUP BY path {peak} bytes of {total}")

    # the same queries on a prefix: device routes against the host engine
    for name, sql, *_rest in gqs:
        a = sorted(run_query(rt, prefix, sql).rows)
        b = sorted(run_query(host_rt, prefix, sql).rows)
        check(a == b and len(a) > 0,
              f"{name}: device route and host engine differ on the prefix")
    for name, sql, *_rest in oqs:
        a = run_query(rt, prefix, sql).rows
        b = run_query(host_rt, prefix, sql).rows
        check(a == b and len(a) > 0,
              f"{name}: device route and host engine differ on the prefix")
    for name, sql, _rows in hqs:
        route0 = device_exec.GENERAL_GROUPBY_COUNT
        a = run_query(rt, prefix, sql).rows
        b = run_query(host_rt, prefix, sql).rows
        check(a == b and len(a) > 0,
              f"{name}: device route and host engine differ on the prefix")
        check(device_exec.GENERAL_GROUPBY_COUNT - route0 == 1,
              f"{name}: general route counter on the prefix")
    for name, sql, per_run, expected in jqs:
        route0 = device_exec.JOIN_GROUPBY_COUNT
        a = run_query(rt, prefix, sql).rows
        b = run_query(host_rt, prefix, sql).rows
        check(a == b and len(a) > 0,
              f"{name}: device route and host engine differ on the prefix")
        check(device_exec.JOIN_GROUPBY_COUNT - route0 == (expected is not None),
              f"{name}: join route counter on the prefix")
    log(f"phase 4: {len(gqs) + len(hqs) + len(oqs) + len(jqs)} queries equal to the"
        f" host engine at {n_prefix} rows")
    # the counts as read after each path's full-size queries: the prefix
    # runs above and phase 5 launch too, and are not the main path
    return dict(
        launches={k: g_launches[k] + h_launches[k] + o_launches[k] + j_launches[k]
                  for k in g_launches},
        launches_by_path={"group_by": g_launches, "general_group_by": h_launches,
                          "order_by": o_launches, "join": j_launches},
        per_query={**g_per_query, **h_per_query, **o_per_query, **j_per_query},
        e2e={**g_e2e, **h_e2e, **o_e2e, **j_e2e},
        calls={**{q: [c] for q, c in g_calls.items()}, **h_calls, **o_calls, **j_calls},
        resident=resident,
        peak_general=peak,
    )


# -- phase 5: the main paths' shapes, checked and timed -------------------------


def cuda_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _streams_of(kw):
    """(role, tensor) of every stream a recorded call reads, each
    tensor once (a "value" predicate rereads the value stream)."""
    named = [("key", kw["gid"]), ("value", kw.get("values")),
             ("mask", kw.get("mask"))]
    named += [("value", t) for t in kw.get("streams", ())]
    named += [("pred", p.stream) for p in kw.get("preds", ())]
    seen, out = set(), []
    for role, t in named:
        if t is not None and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            out.append((role, t))
    return out


def _bound(nbytes, nops, shape):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ALU_OPS_PER_S * 1e3
    return dict(bytes=nbytes, ops=nops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                shape=shape)


def bound_of(kw):
    """Least time for the call: every stream read once at its stored
    width and the tables written once, over the memory rate; against
    the compares, base subtract, bound check and adds over the ALU rate."""
    n, K = kw["n"], kw["num_buckets"]
    streams = _streams_of(kw)
    tables = 1 + len(kw.get("streams", ())) + (kw.get("values") is not None)
    nbytes = n * sum(t.element_size() for _r, t in streams) + tables * K * 8
    nops = n * (2 + len(kw.get("preds", ())) + ("mask" in dict(streams)) + tables)
    shape = f"n={n} K={K} " + " ".join(
        f"{r}={str(t.dtype).split('.')[-1]}" for r, t in streams)
    return _bound(nbytes, nops, shape)


def check_and_time(kernel, label, kw, iters):
    """Hold the wrapper against the plain version on exactly these
    arguments (tolerance 0), then time both."""
    wrapper, plain = _KERNELS[kernel].wrapper, _KERNELS[kernel].plain
    got, want = wrapper(**kw), plain(**kw)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{kernel} [{label}]: shape/dtype differ from the plain version")
    err = int((got - want).abs().max())
    check(torch.equal(got, want),
          f"{kernel} [{label}]: kernel and plain version disagree at the"
          f" main path's shape (max |diff| {err})")
    check(int(got[0].sum()) > 0, f"{kernel} [{label}]: nothing counted")
    del got, want
    out = dict(max_abs_err=float(err),
               ms=cuda_ms(lambda: wrapper(**kw), iters),
               plain_ms=cuda_ms(lambda: plain(**kw), 2, warmup=1))
    out.update(bound_of(kw))
    return out


def check_and_time_extract(label, kw, iters):
    """extract_ge on a recorded call: equal to the plain version
    (tolerance 0), then timed beside torch.nonzero, the one library call
    that compacts (it returns every match as int64 and is not capped)."""
    values, threshold, cap = kw["values"], kw["threshold"], kw["cap"]
    rows = kw.get("n")
    got = ex.extract_ge(values, threshold, cap, rows)
    want = ex.extract_ge_plain(values, threshold, cap, rows)
    torch.cuda.synchronize()
    kept = check_extract(label, got, want, values, threshold, cap, rows)
    check(kept > 0, f"extract_ge [{label}]: no candidate on the main path")
    err = int((got - want).abs().max())
    del got, want
    n = values.shape[0] if rows is None else rows
    out = dict(
        max_abs_err=float(err), candidates=kept,
        ms=cuda_ms(lambda: ex.extract_ge(values, threshold, cap, rows), iters),
        plain_ms=cuda_ms(
            lambda: ex.extract_ge_plain(values, threshold, cap, rows), 5, warmup=1),
        library_ms=cuda_ms(
            lambda: torch.nonzero(values[:n] >= threshold), 5, warmup=1),
        library="torch.nonzero(values >= threshold) (int64 indices, no cap)",
    )
    # the values read once, the cap indices written once; one compare a row
    out.update(_bound(4 * n + 4 * cap, n, f"n={n} cap={cap} values=int32"))
    return out


def check_and_time_join(kernel, label, kw, iters):
    """A join probe on a recorded call (the dimension side unsorted, as
    the route hands it over): equal to the plain version (tolerance 0),
    then timed beside the chain of library calls that does the same on
    keys made ready beforehand (widened to int64 with the top bit
    flipped, the dimension side sorted): no single PyTorch call computes
    the probe. For probe_join_gid the time covers both of its device
    functions, the table build and the probe; the build is also timed
    alone."""
    wrapper, plain = _KERNELS[kernel].wrapper, _KERNELS[kernel].plain
    got, want = wrapper(**kw), plain(**kw)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == torch.int32,
          f"{kernel} [{label}]: shape/dtype differ from the plain version")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    check(torch.equal(got, want),
          f"{kernel} [{label}]: kernel and plain version disagree at the main"
          f" path's shape ({int((got != want).sum())} rows)")
    hits = int((got >= 0).sum())
    check(hits > 0, f"{kernel} [{label}]: no fact row found its dimension row")
    del got, want

    facts, n = kw["fact_keys"], kw["n"]
    n = facts.shape[0] if n is None else n
    sk, perm = kj.build_side(kw["dim_keys"])
    bucket = kw["dim_bucket"][perm].contiguous()
    D = sk.shape[0]
    flip = -(1 << 63)
    sk_f, pk = sk ^ flip, kj._u64_bits(facts[:n])
    pk_f = pk ^ flip

    def chain():
        pos = torch.searchsorted(sk_f, pk_f).clamp_(max=D - 1)
        return torch.where(sk[pos] == pk, bucket[pos], -1)

    check(torch.equal(chain().to(torch.int32), wrapper(**kw)),
          f"{kernel} [{label}]: the library chain disagrees")
    out = dict(
        max_abs_err=float(err), hits=hits,
        ms=cuda_ms(lambda: wrapper(**kw), iters),
        plain_ms=cuda_ms(lambda: plain(**kw), 2, warmup=1),
        library_ms=cuda_ms(chain, 3, warmup=1),
        library="chain of 5 calls, no single one does the probe: torch.searchsorted,"
                " clamp_, two gathers, ==, where (on int64 keys flipped and a"
                " dimension side sorted beforehand)",
    )
    if kernel == "probe_join_gid":
        out["build_ms"] = cuda_ms(
            lambda: kj.build_join_table(kw["dim_keys"], kw["dim_bucket"]), iters)
    # the fact keys read once at their stored width, one int32 written a
    # row, the dimension table read once; a hash (two 64-bit multiplies,
    # three shifts), a slot index and two compares a row
    width = facts.element_size()
    out.update(_bound(n * (width + 4) + D * 12, n * 12,
                      f"n={n} D={D} fact_keys={str(facts.dtype).split('.')[-1]}"))
    return out


def probe_shapes_off_the_main_path(device, n, iters):
    """probe_join_gid at two dimension sizes no query of phase 4 has: a
    table that fits well inside the L2 (16384 rows: 512 KB of slots) and
    one beyond it (2^22 rows: 128 MB of slots), u64 keys, every fact row
    a hit, as the 2^18-row query has it."""
    gen = torch.Generator(device=device).manual_seed(11)  # made on the card
    out = {}
    for D in (16_384, 1 << 22):
        kw = dict(
            fact_keys=torch.randint(D, (n,), generator=gen, device=device)
            * BIG_DIM_MULT + 3,
            dim_keys=torch.randperm(D, generator=gen, device=device) * BIG_DIM_MULT + 3,
            dim_bucket=torch.randint(N_REGIONS, (D,), generator=gen, device=device,
                                     dtype=torch.int32),
            n=n)
        out[f"D={D} (not a query)"] = check_and_time_join(
            "probe_join_gid", f"D={D}", kw, iters)
    return out


def kernel_device_ms(fn, iters=20):
    """Device time of one call of ``fn`` whose kernels are shorter than
    the host's time to launch them: CUDA events around ``iters`` calls
    that the host queues behind a sleep kernel (about 9 ms), so that the
    card runs them back to back, with no host gap between them; each
    launch's own start on the card still counts."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1 << 24)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


PARENT_JOIN_CU = "EVQL_PARENT_JOIN_CU"  # an earlier join.cu, to time its B4 beside this one


def start_parent_build():
    """Start compiling the join.cu named by $EVQL_PARENT_JOIN_CU beside
    the package's own build; None when it is unset."""
    path = os.environ.get(PARENT_JOIN_CU)
    if not path:
        return None
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, "parent_join.so")
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", out, path]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)


def parent_dim_join(build):
    """The earlier B4 as a function of dim_join_gid's arguments. Its
    evql_dim_join_gid must take what the package's does: the argument
    types are the ones kernels/join.py gives its own."""
    if build is None:
        return None
    out, proc = build
    log, _ = proc.communicate()
    check(proc.returncode == 0, f"the earlier join.cu did not build:\n{log}")
    fn = ctypes.CDLL(out).evql_dim_join_gid
    own = kj._lib().evql_dim_join_gid
    fn.argtypes, fn.restype = own.argtypes, own.restype

    def call(fact_keys, dim_keys, dim_bucket, n=None):
        n = fact_keys.shape[0] if n is None else n
        got = torch.empty(n, dtype=torch.int32, device=fact_keys.device)
        rc = fn(fact_keys.data_ptr(), kj._KEY_DT[fact_keys.dtype], n, dim_keys.data_ptr(),
                dim_bucket.data_ptr(), dim_keys.shape[0], got.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"the earlier dim_join_gid: CUDA error {rc}")
        return got

    return call


def dim_join_extras(kw, iters, parent):
    """Beside a timed dim_join_gid call: its kernel's device time at one
    row (one block: the table build and the launch, against a one-row
    table for the launch alone), and the earlier B4 on the same
    arguments, equal to this one (tolerance 0) and timed."""
    one = dict(kw, n=1)
    out = dict(
        one_row_device_ms=kernel_device_ms(lambda: kj.dim_join_gid(**one)),
        one_row_one_dim_device_ms=kernel_device_ms(lambda: kj.dim_join_gid(
            kw["fact_keys"], kw["dim_keys"][:1], kw["dim_bucket"][:1], 1)))
    if parent is None:
        out["parent_ms"] = None
        out["parent"] = f"not measured: ${PARENT_JOIN_CU} is unset"
        return out
    check(torch.equal(parent(**kw), kj.dim_join_gid(**kw)),
          "the earlier dim_join_gid and this one disagree")
    out["parent_ms"] = cuda_ms(lambda: parent(**kw), iters)
    out["parent"] = os.environ[PARENT_JOIN_CU]
    return out


def dim_shapes_off_the_main_path(device, n, iters, parent):
    """dim_join_gid at two shapes no query of phase 4 has, with u64 fact
    keys: D = 8192 (the tier's edge, a 192 KB table), every fact row a
    hit; D = 1024 with half the rows missing, as the query's u32 stream
    has it. Beside each: the earlier B4, and at D = 8192 probe_join_gid
    (the big-table tier) on the same inputs, and the device time of its
    table build in global memory (what building B4's table once, for all
    blocks, would cost at the least)."""
    gen = torch.Generator(device=device).manual_seed(13)  # made on the card
    out = {}
    for D, span in ((kj.MAX_COMPARE_DIMS, kj.MAX_COMPARE_DIMS), (N_DIMS, 2 * N_DIMS)):
        kw = dict(
            fact_keys=torch.randint(span, (n,), generator=gen, device=device)
            * BIG_DIM_MULT + 3,
            dim_keys=torch.randperm(D, generator=gen, device=device) * BIG_DIM_MULT + 3,
            dim_bucket=torch.randint(N_REGIONS, (D,), generator=gen, device=device,
                                     dtype=torch.int32),
            n=n)
        label = f"D={D} u64 keys, {'every row a hit' if span == D else 'half the rows miss'}"
        res = check_and_time_join("dim_join_gid", label, kw, iters)
        res.update(dim_join_extras(kw, iters, parent))
        if D == kj.MAX_COMPARE_DIMS:
            check(torch.equal(kj.probe_join_gid(**kw), kj.dim_join_gid(**kw)),
                  "the two tiers disagree at D = 8192")
            res["probe_join_gid_ms"] = cuda_ms(lambda: kj.probe_join_gid(**kw), iters)
            res["global_table_build_device_ms"] = kernel_device_ms(
                lambda: kj.build_join_table(kw["dim_keys"], kw["dim_bucket"]))
        out[label + " (not a query)"] = res
    return out


def _topk_context(device, calls):
    """Whole-operation yardsticks for the headline top-k, as context and
    not as a port: the port's topk_permutation (host clock, it waits on
    the card twice), torch.topk and torch.sort on the same 64-bit key."""
    f24 = calls["topk_ts_desc"][0][1]["gid"]  # only for the row count
    n = f24.shape[0]
    key = torch.randint(-(1 << 63), (1 << 63) - 1, (n,), dtype=torch.int64,
                        device=device)

    def wall_ms(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / iters

    return {
        "rows": n, "k": 100,
        "topk_permutation_wall_ms": wall_ms(lambda: ksort.topk_permutation(key, 100)),
        "torch_topk_ms": cuda_ms(lambda: torch.topk(key, 100), 5, warmup=1),
        "torch_sort_ms": cuda_ms(lambda: torch.sort(key), 3, warmup=1),
        "torch_sort_stable_ms": cuda_ms(
            lambda: torch.sort(key, stable=True), 3, warmup=1),
    }


def _as_int64(t, unsigned):
    wide = t.to(torch.int64)
    return wide & ((1 << (8 * t.element_size())) - 1) if unsigned else wide


def b1_library_ms(kw):
    """One library call beside a recorded groupby_agg call: index_add_ of
    the value stream as int64 at the buckets, or torch.bincount of the
    buckets where the call sums nothing. Neither filters. The buckets
    (key - base) are made beforehand, those outside [0, K), which the
    kernel drops, shifted into one spare slot."""
    n, K = kw["n"], kw["num_buckets"]
    key = _as_int64(kw["gid"][:n], kw.get("gid_unsigned", False)) - kw.get("gid_base", 0)
    idx = torch.where((key >= 0) & (key < K), key + 1, 0)
    del key
    if kw.get("values") is None:
        return dict(library_ms=cuda_ms(lambda: torch.bincount(idx, minlength=K + 1), 5,
                                       warmup=1),
                    library="torch.bincount (int64 buckets shifted by one beforehand, no"
                            " filter)")
    vals = _as_int64(kw["values"][:n], kw.get("values_unsigned", False))
    lib = torch.zeros(K + 1, dtype=torch.int64, device=idx.device)
    return dict(library_ms=cuda_ms(lambda: lib.index_add_(0, idx, vals), 5, warmup=1),
                library="torch.Tensor.index_add_ (int64, sums only, no filter; buckets"
                        " shifted by one beforehand)")


def _hash_streams(kw):
    """(role, tensor) of every stream a recorded hash_groupby call reads,
    each tensor once."""
    named = [("key", t) for t in kw["keys"]] + [("value", t) for t in kw.get("values", ())]
    named += [("distinct", t) for t in kw.get("distinct", ())] + [("mask", kw.get("mask"))]
    seen, out = set(), []
    for role, t in named:
        if t is not None and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            out.append((role, t))
    return out


def hash_bound_of(kw, groups):
    """Least time for the call: every key, value and mask stream read
    once at its stored width and the results (count, first row, one
    word per aggregate) written once, over the memory rate; against a
    hash, a compare and an atomic a key word and a row, and one atomic
    per aggregate, over the ALU rate."""
    n = kw["n"]
    streams = _hash_streams(kw)
    outs = 2 + len(kw.get("values", ())) + len(kw.get("distinct", ()))
    nbytes = n * sum(t.element_size() for _r, t in streams) + groups * outs * 8
    nops = n * (3 * len(kw["keys"]) + outs)
    shape = f"n={n} groups={groups} " + " ".join(
        f"{r}={str(t.dtype).split('.')[-1]}" for r, t in streams)
    return _bound(nbytes, nops, shape)


_SCATTER = {"sum": "sum", "min": "amin", "max": "amax", "mean": "mean"}


def hash_library_ms(kw):
    """The library chain beside a recorded call: torch.unique
    (return_inverse) of the masked-in key tuples, one scatter_reduce_ per
    aggregate on the values as stored, and for count_distinct a unique of
    (group, value) pairs and a bincount. The mask is applied and the keys
    are widened and stacked beforehand. Not the kernel's semantics at
    every corner (a u64 min in signed order), a yardstick of the time."""
    n = kw["n"]
    rows = torch.arange(n, device=kw["keys"][0].device) if kw.get("mask") is None else (
        torch.nonzero(kw["mask"][:n]).flatten())
    keys = [k[:n][rows].to(torch.int64) for k in kw["keys"]]
    key = keys[0] if len(keys) == 1 else torch.stack(keys, 1)
    vals = [v[:n][rows] for v in kw.get("values", ())]
    vals = [v if v.dtype == torch.float64 else v.to(torch.int64) for v in vals]
    dist = [d[:n][rows].to(torch.int64) for d in kw.get("distinct", ())]
    kinds = kw.get("kinds", ())

    def chain():
        if key.dim() == 1:
            uniq, inv = torch.unique(key, return_inverse=True)
        else:
            uniq, inv = torch.unique(key, dim=0, return_inverse=True)
        G = uniq.shape[0]
        for v, kind in zip(vals, kinds):
            torch.zeros(G, dtype=v.dtype, device=v.device).scatter_reduce_(
                0, inv, v, _SCATTER[kind], include_self=False)
        for d in dist:
            pairs = torch.unique(torch.stack([inv, d], 1), dim=0)
            torch.bincount(pairs[:, 0], minlength=G)

    return dict(library_ms=cuda_ms(chain, 3, warmup=1),
                library="torch.unique(return_inverse) + one scatter_reduce_ per aggregate"
                        " (+ unique of (group, value) pairs and bincount per count_distinct);"
                        " mask applied, keys widened and stacked beforehand")


def _peak_bytes(fn):
    """Device bytes a call allocates at its peak beyond what was held."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - held


def check_and_time_hash(label, kw, iters):
    """hash_groupby on a recorded call: equal to its plain version (in
    first-row order; integers exactly, order-proof floats by their bits),
    then the kernel in its tier, the same call in the hash tier (spans
    withheld, also held to the plain version), the plain version and the
    library chain timed, and the bytes each tier allocates at its peak."""
    forms = dict(hg.FORMS)
    got, want = hg.hash_groupby(**kw), hg.hash_groupby_plain(**kw)
    torch.cuda.synchronize()
    tier = [k for k in hg.TIERS if hg.FORMS[k] > forms[k]][0]
    err = check_hash_case(label, got, want)
    as_hash = dict(kw, key_spans=None, distinct_spans=None)
    err = max(err, check_hash_case(label + " (hash tier)", hg.hash_groupby(**as_hash), want))
    groups = int(want.first_index.numel())
    del got, want
    out = dict(max_abs_err=err, groups=groups, tier=tier,
               ms=cuda_ms(lambda: hg.hash_groupby(**kw), iters),
               hash_tier_ms=cuda_ms(lambda: hg.hash_groupby(**as_hash), iters),
               plain_ms=cuda_ms(lambda: hg.hash_groupby_plain(**kw), 2, warmup=1),
               # the group ids (slots), count and first row alone, in the
               # call's tier and in the hash tier: the rest of ms is the
               # value streams' atomics and count_distinct
               ids_count_first_ms=cuda_ms(lambda: hg.hash_groupby(
                   kw["keys"], kw["n"], kw.get("mask"), key_spans=kw.get("key_spans")), iters),
               hash_tier_ids_count_first_ms=cuda_ms(
                   lambda: hg.hash_groupby(kw["keys"], kw["n"], kw.get("mask")), iters),
               peak_bytes=_peak_bytes(lambda: hg.hash_groupby(**kw)),
               hash_tier_peak_bytes=_peak_bytes(lambda: hg.hash_groupby(**as_hash)))
    out.update(hash_library_ms(kw))
    out.update(hash_bound_of(kw, groups))
    return out


def phase_times(device, calls, parent=None):
    """Every call the main paths made (as recorded in phase 4: the same
    tensors, sizes and options) goes through its wrapper and its plain
    version once more; the results must be equal, and only then are
    both timed. ``calls`` maps query name to a list of
    (kernel name, keyword arguments)."""
    headline_of = {"groupby_agg": "headline", "groupby_multi_agg": "multi_sum",
                   "extract_ge": "topk_ts_desc", "dim_join_gid": "join_small_dim",
                   "probe_join_gid": "join_big_dim", "hash_groupby": "G1_min_max_mean"}
    out = {name: {"other_shapes": {}} for name in _KERNELS}
    checked = 0
    for query, recorded in calls.items():
        for i, (kernel, kw) in enumerate(recorded):
            head = headline_of[kernel] == query
            iters = 20 if head else 5
            if kernel == "extract_ge":
                res = check_and_time_extract(query, kw, iters)
            elif kernel == "hash_groupby":
                res = check_and_time_hash(query, kw, 10 if head else 3)
            elif kernel in ("dim_join_gid", "probe_join_gid"):
                res = check_and_time_join(kernel, query, kw, iters)
            else:
                res = check_and_time(kernel, query, kw, iters)
            checked += 1
            if head:
                out[kernel].update(res)
            else:
                label = query if len(recorded) == 1 else f"{query} call {i + 1}"
                out[kernel]["other_shapes"][label] = res

    kernel, kw = calls["headline"][0]
    check(kernel == "groupby_agg" and kw["gid"].dtype == torch.int16
          and kw["values"].dtype == torch.int16
          and kw["num_buckets"] == N_KEYS + 1 and len(kw["preds"]) == 1
          and kw["preds"][0].src == "value",
          "the headline query did not reach the kernel as i16 key, u16 value"
          " compared in place")
    # every row in one bucket: the slowest the shared-table atomics get
    hot = dict(kw, gid=torch.zeros_like(kw["gid"]), num_buckets=1)
    out["groupby_agg"]["other_shapes"]["one_hot_key (not a query)"] = (
        check_and_time("groupby_agg", "one hot key", hot, 5))

    # the library yardsticks of B1's other shapes, on the very recorded
    # arguments: index_add_ on int64 (sums only, no filter, no count), and
    # for the count-only query torch.bincount
    for query, res in out["groupby_agg"]["other_shapes"].items():
        if query in ("or_two_columns", "numeric_key_base", "mask_form", "k_100000",
                     "count_only", "one_hot_key (not a query)"):
            res.update(b1_library_ms(hot if query.startswith("one_hot") else
                                     calls[query][0][1]))

    # the library yardstick (never called by the port): index_add_ on
    # int64, sums only, no filter, no count
    n, K = kw["n"], kw["num_buckets"]
    idx64, v64 = kw["gid"][:n].to(torch.int64), kw["values"][:n].to(torch.int64)
    lib = torch.zeros(K, dtype=torch.int64, device=device)
    out["groupby_agg"]["library_ms"] = cuda_ms(
        lambda: lib.index_add_(0, idx64, v64), 5, warmup=1)
    out["groupby_agg"]["library"] = (
        "torch.Tensor.index_add_ (int64, sums only, no filter)")
    del idx64, v64

    kernel, kw = calls["multi_sum"][0]
    check(kernel == "groupby_multi_agg" and len(kw["streams"]) == 2
          and kw["mask"] is not None,
          "the multi-sum query did not reach the kernel with two streams"
          " and a mask")
    n, K = kw["n"], kw["num_buckets"]
    idx64 = kw["gid"][:n].to(torch.int64)
    vw = torch.stack([t[:n].to(torch.int64) for t in kw["streams"]], dim=1)
    lib2 = torch.zeros((K, 2), dtype=torch.int64, device=device)
    out["groupby_multi_agg"]["library_ms"] = cuda_ms(
        lambda: lib2.index_add_(0, idx64, vw), 5, warmup=1)
    out["groupby_multi_agg"]["library"] = (
        "torch.Tensor.index_add_ (int64 [n, 2], sums only, no filter)")
    del idx64, vw

    if "ms" in out["extract_ge"]:
        # the top-k route reached the kernels as the histogram pair: a
        # count-only pass over a 32-bit prefix stream, then the same
        # restricted by an in-kernel `eq` on the first stream
        (k1, kw1), (k2, kw2), (k3, _kw3) = calls["topk_ts_desc"]
        check((k1, k2, k3) == ("groupby_agg", "groupby_agg", "extract_ge")
              and kw1["gid"].dtype == torch.int32 and kw1.get("values") is None
              and not kw1.get("preds") and kw1["num_buckets"] == 4096
              and len(kw2["preds"]) == 1 and kw2["preds"][0].op == "eq"
              and kw2["preds"][0].src == "stream",
              "the headline top-k did not reach the kernels as two 4096-bucket"
              " count histograms and one extraction")
        # level 1 is a plain count per bucket, which one library call does
        level1 = out["groupby_agg"]["other_shapes"]["topk_ts_desc call 1"]
        prefix = kw1["gid"][:kw1["n"]]
        level1["library_ms"] = cuda_ms(
            lambda: torch.bincount(prefix, minlength=4096), 5, warmup=1)
        level1["library"] = "torch.bincount (int32 keys, no predicate)"
        level2 = out["groupby_agg"]["other_shapes"]["topk_ts_desc call 2"]
        level2["library_ms"] = None
        level2["library"] = (
            "none: no single call counts per bucket only the rows a compare on a"
            " second stream selects (bincount takes float weights, not a filter)")
    # the join queries reached the probes as the narrowed (32-bit) and
    # the 64-bit fact key stream, at the two dimension sizes
    (k1, kw1), (k2, kw2) = calls["join_small_dim"]
    check((k1, k2) == ("dim_join_gid", "groupby_agg")
          and kw1["fact_keys"].dtype == torch.int32
          and kw1["dim_keys"].shape[0] == N_DIMS and kw2["gid"].dtype == torch.int32
          and kw2["values"].dtype == torch.int16
          and 0 < kw2["num_buckets"] <= N_REGIONS,
          "the small-dim join did not reach the kernels as a u32 key stream"
          " against 1024 dims, then i32 buckets with the u16 value stream")
    out["dim_join_gid"].update(dim_join_extras(kw1, 20, parent))
    out["dim_join_gid"]["other_shapes"].update(
        dim_shapes_off_the_main_path(device, kw1["n"], 20, parent))
    # B1 after a join: index_add_ on int64, the bucket shifted by one
    # beforehand so that -1 (no dimension row) lands in a spare slot
    n, K = kw2["n"], kw2["num_buckets"]
    idx64 = kw2["gid"][:n].to(torch.int64) + 1
    v64 = kw2["values"][:n].to(torch.int64)
    lib3 = torch.zeros(K + 1, dtype=torch.int64, device=device)
    after_join = out["groupby_agg"]["other_shapes"]["join_small_dim call 2"]
    after_join["library_ms"] = cuda_ms(
        lambda: lib3.index_add_(0, idx64, v64), 5, warmup=1)
    after_join["library"] = (
        "torch.Tensor.index_add_ (int64, sums only, buckets shifted by one"
        " beforehand so that -1 has a slot)")
    del idx64, v64
    (k1, kw1), (k2, kw2) = calls["join_big_dim"]
    check((k1, k2) == ("probe_join_gid", "groupby_agg")
          and kw1["fact_keys"].dtype == torch.int64
          and kw1["dim_keys"].shape[0] == N_BIG_DIMS
          and not bool((kw1["dim_keys"][1:] > kw1["dim_keys"][:-1]).all()),
          "the big-dim join did not reach the kernels as a u64 key stream"
          " against 2^18 unsorted dims")
    out["probe_join_gid"]["other_shapes"].update(
        probe_shapes_off_the_main_path(device, kw1["n"], 5))
    # the general GROUP BY reached the hash aggregate as the stored i16 key
    # (dictionary ids), the mask, the u16 and u32 streams as stored and
    # mean's float64 argument; every row on one key is its slowest shape
    kernel, hkw = calls["G1_min_max_mean"][0]
    check(kernel == "hash_groupby" and [k.dtype for k in hkw["keys"]] == [torch.int16]
          and hkw["mask"] is not None and list(hkw["kinds"]) == ["min", "max", "mean"]
          and [v.dtype for v in hkw["values"]] == [torch.int16, torch.int32, torch.float64],
          "G1 did not reach the hash aggregate as an i16 key, a mask, u16 / u32 streams"
          " as stored and a float64 stream")
    check(hkw["key_spans"] == [(0, N_KEYS, False)], "G1's key span is not its dictionary's")
    hot_key = dict(hkw, keys=[torch.zeros_like(hkw["keys"][0])])
    out["hash_groupby"]["other_shapes"]["one_hot_key (not a query)"] = (
        check_and_time_hash("one hot key", hot_key, 5))
    # the same in the direct global tier: G3's call (two keys, 102 400
    # slots) with every row on the slot of (0, 0)
    kernel, g3 = calls["G3_two_keys"][0]
    hot_key = dict(g3, keys=[torch.zeros_like(k) for k in g3["keys"]])
    out["hash_groupby"]["other_shapes"]["G3 with one hot key (not a query)"] = (
        check_and_time_hash("G3, one hot key", hot_key, 5))
    check(out["hash_groupby"]["other_shapes"]["G3 with one hot key (not a query)"]["tier"]
          == "global", "G3's hot key did not take the direct global tier")
    del hot_key

    for name, d in out.items():
        d["max_abs_err"] = max([d.get("max_abs_err", 0.0)] + [
            o["max_abs_err"] for o in d["other_shapes"].values()])
    log(f"phase 5: {checked + 1} main-path shapes equal to their plain"
        f" versions (tolerance 0), then timed")
    return out


_REPLACES = {
    "hash_groupby": ("eventql_tpu_torch/kernels/csrc/hash_groupby.cu",
                     "eventql_tpu/kernels/groupby.py:246 (not a TPU kernel:"
                     " masked_grouped_aggregate, and :380 masked_grouped_count_distinct)",
                     "evql_hash_direct + evql_hash_distinct_direct (shared and global"
                     " tiers); evql_hash_group_ids + evql_hash_aggregate +"
                     " evql_hash_count_distinct (hash tier)"),
    "groupby_agg": ("eventql_tpu_torch/kernels/csrc/groupby_agg.cu",
                    "eventql_tpu/kernels/pallas_groupby.py:109", "evql_groupby_agg"),
    "groupby_multi_agg": ("eventql_tpu_torch/kernels/csrc/groupby_agg.cu",
                          "eventql_tpu/kernels/pallas_groupby.py:698",
                          "evql_groupby_multi_agg"),
    "extract_ge": ("eventql_tpu_torch/kernels/csrc/extract.cu",
                   "eventql_tpu/kernels/extract.py:29", "evql_extract_ge"),
    "dim_join_gid": ("eventql_tpu_torch/kernels/csrc/join.cu",
                     "eventql_tpu/kernels/join.py:142", "evql_dim_join_gid"),
    "probe_join_gid": ("eventql_tpu_torch/kernels/csrc/join.cu",
                       "eventql_tpu/kernels/join.py:449",
                       "evql_build_join_table + evql_probe_join_table"),
}


def main():
    if len(sys.argv) > 1:
        sys.exit("chip_smoke: takes no arguments; the size is the slice's")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    device = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    parent_build = start_parent_build()
    secs = _build.build_all(verbose=True)
    for name in _build.sources():
        _build.load(name)
    parent = parent_dim_join(parent_build)
    log(f"phase 2: kernels built in {secs:.1f} s: {_build.sources()}"
        + (f"; the earlier join.cu from ${PARENT_JOIN_CU}" if parent else ""))

    phase_kernels(device, N_KERNEL_CASE_ROWS)
    run = phase_main_path(device, N_ROWS, N_PREFIX_ROWS, REPS)
    times = phase_times(device, run["calls"], parent)
    context = _topk_context(device, run["calls"])
    kernels = []
    for name, t in times.items():
        source, replaces, entry = _REPLACES[name]
        check(run["launches"][name] > 0, f"{name}: not launched on a main path")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "entry": entry,
            "replaces": replaces,
            "launches": run["launches"][name],
            "launches_by_path": {p: c[name]
                                 for p, c in run["launches_by_path"].items()},
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": t["library"],
            "shape": t["shape"],
            "bytes": t["bytes"],
            "other_shapes": t["other_shapes"],
        })
        # probe_join_gid: its table-build kernels alone; dim_join_gid: one
        # row (its table build) and the earlier kernel; hash_groupby: its
        # groups, and its group ids + count + first row alone
        for key in ("build_ms", "one_row_device_ms", "one_row_one_dim_device_ms",
                    "parent_ms", "parent", "groups", "ids_count_first_ms", "tier",
                    "hash_tier_ms", "hash_tier_ids_count_first_ms", "peak_bytes",
                    "hash_tier_peak_bytes"):
            if key in t:
                kernels[-1][key] = t[key]
    log(json.dumps({"e2e_ms": run["e2e"], "rows": N_ROWS,
                    "launches_per_query": run["per_query"],
                    "device_bytes_held": run["resident"],
                    "peak_bytes_general_group_by": run["peak_general"],
                    "topk_context": context}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
