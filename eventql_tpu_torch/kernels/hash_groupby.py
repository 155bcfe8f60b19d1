"""The general GROUP BY on the card: a grouped aggregate in three tiers.

Replaces no TPU kernel. The JAX package groups with ``lax.sort`` and
``associative_scan`` (eventql_tpu/kernels/groupby.py:
``masked_grouped_aggregate``, ``masked_grouped_count_distinct``), since
the TPU has no per-lane scatter. Hopper has shared and global atomics,
so ``csrc/hash_groupby.cu`` finds each row's group slot and aggregates
with atomics, with no sort. How it finds the slot is the tier, chosen
from the key spans alone (``tier_of``, the mirror of the launcher's
``evql_hash_tier``):

* **shared**: every key has a span ``(base, span, unsigned)`` (the key
  lies in ``[base, base + span)``) and one copy of the slots (the
  spans' product; ``8 + 8 nv`` bytes a slot) fits the shared memory a
  block may opt in to. A row's slot is the mixed-radix number of its
  keys; each block adds into up to 32 copies in shared memory and adds
  its occupied slots to the global words once (``evql_hash_direct``);
* **global**: the spans are known but larger, and the ``(2 + nv)``
  words a slot take no more device memory than the hash tier's table
  and row slots would (``direct_limit``): the same pass with atomics on
  the global words;
* **hash**: a key without a span: an open-addressed table of the key
  tuples (``evql_hash_group_ids``: ``atomicCAS`` of the row index, the
  tuple compared with the holder's), dense ids, then the aggregates
  through each row's slot (``evql_hash_aggregate``).

count_distinct: in a direct tier, a bitmap of (slot, payload) bits where
the payload has a span too (per block in shared memory where it fits,
else in global memory), else a table keyed by (slot, payload)
(``evql_hash_distinct_direct``; ``distinct_form`` mirrors its choice);
in the hash tier, a table keyed by (group, payload)
(``evql_hash_count_distinct``).

The direct tiers return one entry per slot, empty slots with count 0
(no group), and need no readback; the hash tier reads the group count
before it allocates the aggregates, and returns its groups dense. It is
bound by bytes (each key, value and mask stream read once).

``hash_groupby`` launches the kernels for CUDA tensors and uses the
plain version (``hash_groupby_plain``: ``masked_grouped_aggregate`` and
``masked_grouped_count_distinct`` of kernels/groupby.py, and a check
that every masked-in key lies in its given span) for CPU tensors only;
both return a ``Grouped`` on the caller's ``device``, and both follow kernels/groupby.py's
contract: exact counts and integer sums, min / max of u64 streams in
unsigned order, NaN that wins a min / max / mean, -0.0 read as +0.0 by
min / max, float sums in no guaranteed order. Groups come in no
particular order (the plain version: ascending keys; the kernel: slot
or hash order); ``compact_groups`` drops empty slots on the tensors'
device, puts the rest in the order of their first rows and gathers
what the caller reads of each group, so that only O(groups) words
leave the device (the counterpart of the JAX route's
``_device_compact_groups``, eventql_tpu/exec/device_exec.py).
``LAUNCHES`` counts the wrapper's calls that launched the kernels,
``FORMS`` the launches by tier and by count_distinct form.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from eventql_tpu_torch.kernels import _build
from eventql_tpu_torch.utils import trace
from eventql_tpu_torch.kernels.groupby import (
    AGG_KINDS,
    masked_grouped_aggregate,
    masked_grouped_count_distinct,
    widen,
)

# wrapper calls that launched the kernels (plain-version calls do not count)
LAUNCHES = {"hash_groupby": 0}
# the same launches by tier, and count_distinct launches by form
TIERS = ("shared", "global", "hash")
DISTINCT_FORMS = ("bitmap_shared", "bitmap_global", "set")
FORMS = {name: 0 for name in TIERS + DISTINCT_FORMS}

MAX_KEYS = 9  # key words of one tuple (csrc: MAX_KEYS)
MAX_VALUES = 16  # value streams of one aggregate launch (csrc: MAX_VALUES)
MAX_ROWS = 1 << 30  # int32 row indices in a table of 2n slots
MAX_DIRECT_SLOTS = 1 << 40  # csrc: MAX_DIRECT_SLOTS

_DT_I16, _DT_U16, _DT_I32, _DT_U32, _DT_I64, _DT_F64, _DT_U8 = range(7)
_OP = {("sum", "int"): 0, ("min", "u64"): 1, ("max", "u64"): 2, ("min", "int"): 3,
       ("max", "int"): 4, ("min", "float"): 5, ("max", "float"): 6,
       ("sum", "float"): 7, ("mean", "float"): 8}


class Grouped(NamedTuple):
    """G groups (or slots: an empty slot has count 0 and is no group):
    each one's smallest row index, its row count, one tensor per value
    stream (int64, u64 as bit patterns, or float64), and one per
    count_distinct stream (int64). ``dense``: every entry is a group (the
    hash tier and the plain version), so no slot needs dropping."""

    first_index: torch.Tensor
    counts: torch.Tensor
    aggregates: Tuple[torch.Tensor, ...]
    distinct: Tuple[torch.Tensor, ...]
    dense: bool = False


@trace.spanned("kernel.compact_groups")
def compact_groups(g: Grouped, order="first_row", gather: Sequence[torch.Tensor] = ()):
    """The groups of ``g`` on its device: the occupied slots (count > 0;
    all of a dense result), ordered by their first rows (``order`` =
    "first_row", the host engine's group order), by a per-slot tensor
    (``order`` a tensor of unique values over the groups) or left in slot
    order (None). Returns (the groups as a dense Grouped, each ``gather``
    stream's value at each group's first row). No device -> host copy
    but the size of ``torch.nonzero`` where slots are dropped."""
    keep = None if g.dense else torch.nonzero(g.counts > 0).flatten()
    if order is not None:
        key = g.first_index if isinstance(order, str) else order
        key = key if keep is None else key[keep]
        by = torch.sort(key, stable=True).indices
        keep = by if keep is None else keep[by]
    if keep is None:
        out = g
    else:
        out = Grouped(g.first_index[keep], g.counts[keep],
                      tuple(a[keep] for a in g.aggregates),
                      tuple(d[keep] for d in g.distinct))
    return out._replace(dense=True), [s[out.first_index] for s in gather]


def in_first_row_order(g: Grouped) -> Grouped:
    """The groups (empty slots dropped), ordered by their first rows (the
    host engine's group order)."""
    return compact_groups(g)[0]


def table_slots(n: int) -> int:
    """Slots of the group table for n rows: a power of two, at least 2n."""
    return 1 << max(1, (2 * int(n) - 1).bit_length())


def direct_limit(n: int) -> int:
    """Bytes a direct tier may take for n rows: those of the hash tier's
    table and row slots."""
    return 4 * table_slots(n) + 4 * int(n)


def _slots(spans) -> Optional[int]:
    """The product of the span sizes, or None where a key has none or the
    product passes MAX_DIRECT_SLOTS."""
    slots = 1
    for sp in spans:
        if sp is None or sp[1] < 1 or slots > MAX_DIRECT_SLOTS // sp[1]:
            return None
        slots *= sp[1]
    return slots


def tier_of(key_spans, nv: int, n: int, smem_optin: int) -> str:
    """The tier of a call with ``key_spans`` (None, or per key stream
    ``(base, span, unsigned)`` or None), ``nv`` value streams in one
    launch, ``n`` rows, on a device whose blocks may opt in to
    ``smem_optin`` bytes of shared memory: "shared", "global" or "hash".
    The launcher's own rule (``evql_hash_tier`` in csrc/hash_groupby.cu),
    mirrored for the CPU tests."""
    slots = None if key_spans is None else _slots(key_spans)
    if slots is None:
        return "hash"
    if slots * (8 + 8 * nv) <= smem_optin:
        return "shared"
    if slots * 8 * (2 + nv) <= direct_limit(n):
        return "global"
    return "hash"


def distinct_form(slots: int, span, n: int, smem_optin: int) -> str:
    """The form of one count_distinct in a direct tier of ``slots`` slots
    whose payload has ``span`` (``(base, span, unsigned)`` or None):
    "bitmap_shared", "bitmap_global" or "set" (``evql_hash_distinct_form``'s
    rule, mirrored)."""
    if span is None or span[1] < 1 or slots < 1 or span[1] > MAX_DIRECT_SLOTS:
        return "set"
    wps = (span[1] + 31) // 32
    if slots > MAX_DIRECT_SLOTS // wps:
        return "set"
    nbytes = slots * wps * 4
    if nbytes <= smem_optin:
        return "bitmap_shared"
    if nbytes <= direct_limit(n):
        return "bitmap_global"
    return "set"


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


def _bits64(x: int) -> int:
    """An integer in [-2^63, 2^64) as the int64 of its 64 bits."""
    x = int(x)
    if not -(1 << 63) <= x < (1 << 64):
        raise ValueError(f"span base {x} is not a 64-bit value")
    return x - (1 << 64) if x >= (1 << 63) else x


def _check_spans(spans, streams, what):
    if spans is None:
        return None
    spans = tuple(spans)
    if len(spans) != len(streams):
        raise ValueError(f"one {what} span (or None) per {what} stream")
    out = []
    for sp in spans:
        if sp is None:
            out.append(None)
            continue
        base, span, unsigned = sp
        if int(span) < 1:
            raise ValueError(f"{what} span {span}: need at least 1")
        out.append((_bits64(base), int(span), bool(unsigned)))
    return tuple(out)


def _check(keys, n, mask, values, kinds, values_unsigned, distinct, key_spans,
           distinct_spans, device):
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
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif streams:
        device = streams[0][1].device
    else:
        raise ValueError("no stream to take the device from: pass device")
    for name, t in streams:
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous 1-d tensor")
        if t.shape[0] < n:
            raise ValueError(f"{name}: {t.shape[0]} rows < n = {n}")
        if t.device != device:
            raise ValueError(f"{name}: on {t.device}, the call on {device}")
        _key_dt(t)  # raises on a dtype the kernel does not read
    for kind, v, uns in zip(kinds, values, values_unsigned):
        if kind not in AGG_KINDS:
            raise ValueError(f"unknown aggregate kind {kind!r}")
        _op(kind, v, uns)
    for t in distinct:
        if t.dtype == torch.float64:
            raise TypeError("count_distinct needs an integer stream")
    if not keys and key_spans is None:
        key_spans = ()  # no key: one slot, a direct tier
    key_spans = _check_spans(key_spans, keys, "key")
    distinct_spans = _check_spans(distinct_spans, distinct, "distinct")
    return (n, keys, values, tuple(values_unsigned), distinct, key_spans, distinct_spans,
            device)


def _outside_span(streams, spans, mask, n, what):
    """Raise where a masked-in row of a stream lies outside its span."""
    keep = None if mask is None else mask[:n].to(torch.bool)
    for j, (t, sp) in enumerate(zip(streams, spans or ())):
        if sp is None:
            continue
        base, span, unsigned = sp
        x = widen(t[:n], unsigned)
        if keep is not None:
            x = x[keep]
        d = x - base  # wraps as the kernel's u64 subtract does
        if bool(((d < 0) | (d >= span)).any()):
            raise ValueError(f"{what} stream {j}: a masked-in value outside its span"
                             f" [{base}, {base} + {span})")


def hash_groupby_plain(keys, n, mask=None, values=(), kinds=(), values_unsigned=None,
                       distinct=(), key_spans=None, distinct_spans=None, *,
                       device=None) -> Grouped:
    """Plain PyTorch version of ``hash_groupby`` on ``device``: the groups
    only (no empty slot), after checking that every masked-in key and
    count_distinct payload lies in its given span."""
    n, keys, values, uns, distinct, key_spans, distinct_spans, device = _check(
        keys, n, mask, values, kinds, values_unsigned, distinct, key_spans, distinct_spans,
        device)
    _outside_span(keys, key_spans, mask, n, "key")
    _outside_span(distinct, distinct_spans, mask, n, "count_distinct")
    first, counts, aggs = masked_grouped_aggregate(mask, keys, values, tuple(kinds), uns, n,
                                                   device)
    return Grouped(first, counts, aggs, tuple(
        masked_grouped_count_distinct(mask, keys, d, n) for d in distinct), dense=True)


_lib_ready = False


def _lib():
    global _lib_ready
    lib = _build.load("hash_groupby")
    if not _lib_ready:
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        pvp, pci, pcll = ctypes.POINTER(vp), ctypes.POINTER(ci), ctypes.POINTER(cll)
        lib.evql_hash_group_ids.argtypes = [pvp, pci, ci, vp, cll, vp, cll, vp, vp, vp]
        lib.evql_hash_aggregate.argtypes = [vp, vp, cll, ci, pvp, pci, pci, vp, cll, vp]
        lib.evql_hash_count_distinct.argtypes = [vp, vp, cll, vp, ci, vp, cll, vp, cll, vp]
        lib.evql_hash_tier.argtypes = [pcll, ci, ci, cll, cll]
        lib.evql_hash_distinct_form.argtypes = [cll, cll, cll, cll]
        lib.evql_hash_direct.argtypes = [pvp, pci, pcll, pcll, ci, vp, cll, ci, pvp, pci, pci,
                                         vp, ci, vp]
        lib.evql_hash_distinct_direct.argtypes = [pvp, pci, pcll, pcll, ci, vp, cll, vp, ci,
                                                  cll, cll, ci, vp, cll, vp, vp]
        for fn in (lib.evql_hash_group_ids, lib.evql_hash_aggregate,
                   lib.evql_hash_count_distinct, lib.evql_hash_tier,
                   lib.evql_hash_distinct_form, lib.evql_hash_direct,
                   lib.evql_hash_distinct_direct):
            fn.restype = ci
        _lib_ready = True
    return lib


def launcher_tier(spans, nv: int, n: int, smem_optin: int) -> str:
    """``evql_hash_tier`` itself (on a machine with the kernels), for
    holding ``tier_of`` to it: ``spans`` the span sizes, None for none."""
    arr = (ctypes.c_longlong * max(1, len(spans)))(*[-1 if s is None else s for s in spans])
    return TIERS[_lib().evql_hash_tier(arr, len(spans), nv, n, smem_optin)]


def launcher_distinct_form(slots: int, span: Optional[int], n: int, smem_optin: int) -> str:
    """``evql_hash_distinct_form`` itself, for holding ``distinct_form``
    to it."""
    return DISTINCT_FORMS[_lib().evql_hash_distinct_form(
        slots, -1 if span is None else span, n, smem_optin)]


def _raise_cuda(fn: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} at launch")


def _arrays(ctype, items):
    return (ctype * max(1, len(items)))(*items)


def _value_args(values, kinds, uns, chunk):
    return (_arrays(ctypes.c_void_p, [values[j].data_ptr() for j in chunk]),
            _arrays(ctypes.c_int, [_value_dt(values[j], uns[j]) for j in chunk]),
            _arrays(ctypes.c_int, [_op(kinds[j], values[j], uns[j]) for j in chunk]))


def _chunks(nvalues):
    """Value streams in launches of at most MAX_VALUES (one launch when
    there is none: the count and first row)."""
    return [range(lo, min(nvalues, lo + MAX_VALUES))
            for lo in range(0, max(1, nvalues), MAX_VALUES)]


def _grouped_of(outs, values, chunks, dist, dense):
    counts, first = outs[0][0], outs[0][1]
    aggs = []
    for out, chunk in zip(outs, chunks):
        aggs += [out[2 + i].view(torch.float64) if values[j].dtype == torch.float64
                 else out[2 + i] for i, j in enumerate(chunk)]
    return Grouped(first, counts, tuple(aggs), tuple(dist), dense)


def _hash_tier(lib, keys, n, mask, values, kinds, uns, distinct, device, stream):
    from eventql_tpu_torch.kernels.sort import read_host

    cap = table_slots(n)
    table = torch.empty(cap, dtype=torch.int32, device=device)
    row_slot = torch.empty(n, dtype=torch.int32, device=device)
    num_groups = torch.empty(1, dtype=torch.int64, device=device)
    nk = len(keys)
    _raise_cuda("evql_hash_group_ids", lib.evql_hash_group_ids(
        _arrays(ctypes.c_void_p, [k.data_ptr() for k in keys]),
        _arrays(ctypes.c_int, [_key_dt(k) for k in keys]), nk,
        None if mask is None else mask.data_ptr(), n, table.data_ptr(), cap,
        row_slot.data_ptr(), num_groups.data_ptr(), stream))
    G = int(read_host(num_groups)[0])
    chunks = _chunks(len(values))
    outs = []
    for chunk in chunks:
        out = torch.empty((2 + len(chunk), G), dtype=torch.int64, device=device)
        ptrs, dts, ops = _value_args(values, kinds, uns, chunk)
        _raise_cuda("evql_hash_aggregate", lib.evql_hash_aggregate(
            row_slot.data_ptr(), table.data_ptr(), n, len(chunk), ptrs, dts, ops,
            out.data_ptr(), G, stream))
        outs.append(out)
    dist = []
    if distinct:
        seen = torch.empty(cap, dtype=torch.int32, device=device)
        for d in distinct:
            out = torch.empty(G, dtype=torch.int64, device=device)
            _raise_cuda("evql_hash_count_distinct", lib.evql_hash_count_distinct(
                row_slot.data_ptr(), table.data_ptr(), n, d.data_ptr(), _key_dt(d),
                seen.data_ptr(), cap, out.data_ptr(), G, stream))
            dist.append(out)
            FORMS["set"] += 1
    return _grouped_of(outs, values, chunks, dist, True)


def _direct_tier(lib, tier, keys, n, mask, values, kinds, uns, distinct, key_spans,
                 distinct_spans, smem, device, stream):
    nk = len(keys)
    slots = _slots(key_spans)
    key_args = (
        _arrays(ctypes.c_void_p, [k.data_ptr() for k in keys]),
        _arrays(ctypes.c_int, [_value_dt(k, sp[2]) for k, sp in zip(keys, key_spans)]),
        _arrays(ctypes.c_longlong, [sp[0] for sp in key_spans]),
        _arrays(ctypes.c_longlong, [sp[1] for sp in key_spans]),
        nk, None if mask is None else mask.data_ptr(), n)
    chunks = _chunks(len(values))
    outs = []
    for chunk in chunks:
        # chunks past the first have fewer streams: their own tier rule
        code = TIERS.index(tier_of(key_spans, len(chunk), n, smem))
        out = torch.empty((2 + len(chunk), slots), dtype=torch.int64, device=device)
        ptrs, dts, ops = _value_args(values, kinds, uns, chunk)
        _raise_cuda("evql_hash_direct", lib.evql_hash_direct(
            *key_args, len(chunk), ptrs, dts, ops, out.data_ptr(), code, stream))
        outs.append(out)
    dist = []
    spans = distinct_spans or (None,) * len(distinct)
    for d, sp in zip(distinct, spans):
        form = distinct_form(slots, sp, n, smem)
        words = (table_slots(n) if form == "set" else slots * ((sp[1] + 31) // 32))
        scratch = torch.empty(words, dtype=torch.int32, device=device)
        out = torch.empty(slots, dtype=torch.int64, device=device)
        base, span, unsigned = sp if sp is not None else (0, -1, False)
        _raise_cuda("evql_hash_distinct_direct", lib.evql_hash_distinct_direct(
            *key_args, d.data_ptr(), _value_dt(d, unsigned), base, span,
            DISTINCT_FORMS.index(form), scratch.data_ptr(), words, out.data_ptr(), stream))
        dist.append(out)
        FORMS[form] += 1
    return _grouped_of(outs, values, chunks, dist, False)


@trace.spanned("kernel.hash_groupby")
def hash_groupby(
    keys: Sequence[torch.Tensor],
    n: int,
    mask: Optional[torch.Tensor] = None,
    values: Sequence[torch.Tensor] = (),
    kinds: Sequence[str] = (),
    values_unsigned: Optional[Sequence[bool]] = None,
    distinct: Sequence[torch.Tensor] = (),
    key_spans: Optional[Sequence] = None,
    distinct_spans: Optional[Sequence] = None,
    *,
    device: Optional[torch.device] = None,
) -> Grouped:
    """Group the first ``n`` rows that ``mask`` keeps by the tuple of
    ``keys`` (each compared by its stored bits; none: one group) and
    aggregate: per group its first row and count, ``values[j]`` reduced
    by ``kinds[j]`` ("sum", "min", "max"; "mean" of a float64 stream),
    a narrow integer stream zero-extended and a 64-bit one ordered as
    unsigned where ``values_unsigned[j]``, and the number of distinct
    payloads of each ``distinct`` stream.

    ``key_spans`` (per key: ``(base, span, unsigned)`` or None) promise
    that every masked-in key, read zero-extended where ``unsigned``, lies
    in ``[base, base + span)``; ``distinct_spans`` the same of the
    count_distinct payloads. They choose the tier (``tier_of``); in the
    direct tiers the result has one entry per slot, an empty slot with
    count 0.

    ``device``: where the call runs and its result lies; every stream
    must be on it. It may be left out only where a stream gives it: a
    call with no stream (no key, no value, no mask: the first ``n`` rows
    as one group) raises without it. On a CUDA device the kernels launch,
    on the CPU the plain version runs."""
    n, keys, values, uns, distinct, key_spans, distinct_spans, device = _check(
        keys, n, mask, values, kinds, values_unsigned, distinct, key_spans, distinct_spans,
        device)
    if device.type != "cuda":
        return hash_groupby_plain(keys, n, mask, values, kinds, uns, distinct, key_spans,
                                  distinct_spans, device=device)
    from eventql_tpu_torch.kernels.groupby_agg import smem_optin

    lib = _lib()
    smem = smem_optin(device)
    tier = tier_of(key_spans, min(len(values), MAX_VALUES), n, smem)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if tier == "hash":
            res = _hash_tier(lib, keys, n, mask, values, kinds, uns, distinct, device, stream)
        else:
            res = _direct_tier(lib, tier, keys, n, mask, values, kinds, uns, distinct,
                               key_spans, distinct_spans, smem, device, stream)
    LAUNCHES["hash_groupby"] += 1
    FORMS[tier] += 1
    return res
