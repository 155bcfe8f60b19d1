"""Fused scan + WHERE + GROUP BY count/sum for bounded keys.

The port of the two TPU kernels of eventql_tpu/kernels/pallas_groupby.py:

* ``groupby_agg`` replaces ``_agg_kernel`` (entries ``pallas_sum_count``,
  ``pallas_sum_count_fused``, ``pallas_count_fused``, ``pallas_count``):
  count and at most one sum per bucket, rows selected by a byte mask
  and / or up to two compares against literals evaluated in the kernel;
* ``groupby_multi_agg`` replaces ``_multi_agg_kernel``
  (``pallas_multi_sum``): count and S sums per bucket under one pass.

Both are the CUDA C++ template in ``csrc/groupby_agg.cu``. The kernel is
bound by bytes: each stream is read once at its stored width, so the
least time is n x (sum of stream widths) over the card's memory
bandwidth. To come near it a thread takes 8 consecutive rows per loop
turn (4 above two sums) and reads each stream with 16-byte loads before
its first add; a stream that does not start on a 16-byte boundary takes
scalar loads in the same kernel. After that the instructions per row
are what is left, so each compare reaches the kernel as a closed range.
The adds go to a table in each block's shared memory as 32-bit atomics
with a carry (a 64-bit add there is a compare-and-swap loop), flushed to
the result at the end; when (1+S) x K slots do not fit one block
(``table_in_shared_memory``), 64-bit atomics go straight to the result
in global memory. Nothing of the TPU design (one-hot matmul, int8 limb
planes, carry planes, bucket chunking) is carried over.

Contract, shared with the TPU kernels: counts are exact, sums are exact
mod 2^64 over the low ``value_bits`` of each value read as unsigned.
Integer adds commute, so kernel, plain version and the JAX reference
agree bit for bit.

torch's unsigned types cannot be computed with, so unsigned data is
carried in the signed type of the same width: u64 results are int64 bit
patterns, and a 16-bit stream that holds an unsigned payload is an
int16 tensor passed with its ``*_unsigned`` flag set (the kernel then
zero-extends it). 32-bit predicate operands are compared as int32, as
in the TPU kernel; callers gate payloads >= 2^31.

Each wrapper launches the kernel for CUDA tensors and uses the plain
PyTorch version (``*_plain``, ``index_add_`` on int64) for CPU tensors
only. ``LAUNCHES`` counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from eventql_tpu_torch.kernels import _build
from eventql_tpu_torch.utils import trace

# kernel launches per wrapper (plain-version calls do not count)
LAUNCHES = {"groupby_agg": 0, "groupby_multi_agg": 0}

MAX_SUMS = 8

_DT_I16, _DT_U16, _DT_I32, _DT_I64, _DT_U8 = 0, 1, 2, 3, 4
_OPS = {"lt": 0, "le": 1, "gt": 2, "ge": 3, "eq": 4, "ne": 5}
_SRC_NONE, _SRC_GID, _SRC_VALUE, _SRC_STREAM = 0, 1, 2, 3
_SRCS = {"gid": _SRC_GID, "value": _SRC_VALUE, "stream": _SRC_STREAM}


class Pred(NamedTuple):
    """One in-kernel compare ``operand <op> thr``. ``src`` picks the
    operand: "gid" (the key before the base subtract), "value" (the
    value stream) or "stream" (``stream``, a tensor of its own)."""

    src: str
    op: str
    thr: int
    stream: Optional[torch.Tensor] = None
    unsigned: bool = False


def _dt_code(t: torch.Tensor, unsigned: bool) -> int:
    if t.dtype == torch.int16:
        return _DT_U16 if unsigned else _DT_I16
    if t.dtype == torch.int32:
        return _DT_I32
    if t.dtype == torch.int64:
        return _DT_I64
    if t.dtype in (torch.uint8, torch.bool):
        return _DT_U8
    raise TypeError(f"unsupported stream dtype {t.dtype}")


def _check_stream(name: str, t: torch.Tensor, n: int, device) -> None:
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous 1-d tensor")
    if t.shape[0] < n:
        raise ValueError(f"{name}: {t.shape[0]} rows < n = {n}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, key stream on {device}")
    _dt_code(t, False)  # raises on a dtype the kernel does not read


def _value_mask(value_bits: int) -> int:
    """Low 8*ceil(value_bits/8) bits, as the TPU kernel's limb count."""
    nbytes = -(-max(1, min(int(value_bits), 64)) // 8)
    return (1 << (8 * nbytes)) - 1


def _fold_i32(x: int) -> int:
    return ((int(x) & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def _fold_i64(x: int) -> int:
    return ((int(x) & 0xFFFFFFFFFFFFFFFF) ^ (1 << 63)) - (1 << 63)


# -- plain PyTorch versions ---------------------------------------------------


def _load_ext(t: torch.Tensor, unsigned: bool, n: int) -> torch.Tensor:
    x = t[:n].to(torch.int64)
    if unsigned and t.dtype == torch.int16:
        x = x & 0xFFFF
    return x


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    return ((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def _compare(op: str, a: torch.Tensor, thr: int) -> torch.Tensor:
    if op == "lt":
        return a < thr
    if op == "le":
        return a <= thr
    if op == "gt":
        return a > thr
    if op == "ge":
        return a >= thr
    if op == "eq":
        return a == thr
    if op == "ne":
        return a != thr
    raise ValueError(f"unknown compare op {op!r}")


def _plain(gid, n, num_buckets, values, value_masks, mask, preds, combine,
           gid_base, gid_unsigned, values_unsigned):
    """The kernel's arithmetic in plain tensor ops, on the tensors' own
    device. Returns int64[1 + S, K] (counts, then one row per sum)."""
    K = int(num_buckets)
    S = len(values)
    out = torch.zeros((1 + S, K), dtype=torch.int64, device=gid.device)
    if n <= 0 or K <= 0:
        return out
    g = _wrap_i32(_load_ext(gid, gid_unsigned, n))
    vals = [_load_ext(v, u, n) for v, u in zip(values, values_unsigned)]
    keep = None
    if preds:
        terms = []
        for p in preds:
            if p.src == "gid":
                operand = g
            elif p.src == "value":
                operand = _wrap_i32(vals[0])
            else:
                operand = _wrap_i32(_load_ext(p.stream, p.unsigned, n))
            terms.append(_compare(p.op, operand, _fold_i32(p.thr)))
        keep = terms[0]
        if len(terms) == 2:
            keep = (keep | terms[1]) if combine == "or" else (keep & terms[1])
    if mask is not None:
        m = mask[:n] != 0
        keep = m if keep is None else (keep & m)
    bucket = _wrap_i32(g - _fold_i32(gid_base))
    ok = (bucket >= 0) & (bucket < K)
    if keep is not None:
        ok = ok & keep
    idx = bucket[ok]
    out[0].index_add_(0, idx, torch.ones_like(idx))
    for s in range(S):
        out[1 + s].index_add_(0, idx, vals[s][ok] & _fold_i64(value_masks[s]))
    return out


# -- kernel launches ----------------------------------------------------------

def table_in_shared_memory(num_buckets: int, nsums: int, smem_optin: int) -> bool:
    """Whether the (1 + nsums) x num_buckets table of 64-bit slots fits
    the ``smem_optin`` bytes of shared memory one block may opt in to,
    so that every block accumulates into a table of its own; otherwise
    the kernel adds straight into the result in global memory."""
    return (1 + int(nsums)) * int(num_buckets) * 8 <= int(smem_optin)


_smem_optin = {}  # device index -> bytes


def smem_optin(device: torch.device) -> int:
    """Bytes of shared memory one block may opt in to on ``device``."""
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _smem_optin:
        nbytes = ctypes.c_int(0)
        with torch.cuda.device(index):
            _raise_cuda("smem_optin", _lib().evql_groupby_smem_optin(ctypes.byref(nbytes)))
        _smem_optin[index] = nbytes.value
    return _smem_optin[index]


_lib_ready = False


def _lib():
    global _lib_ready
    lib = _build.load("groupby_agg")
    if not _lib_ready:
        vp, ci, cll, cull = (
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_longlong,
            ctypes.c_ulonglong,
        )
        lib.evql_groupby_agg.argtypes = [
            vp, ci, vp,
            vp, ci, ci, ci, ci,
            vp, ci, ci, ci, ci,
            ci,
            vp, ci, cull,
            ci, cll, ci, ci, vp,
            vp,
        ]
        lib.evql_groupby_agg.restype = ci
        lib.evql_groupby_multi_agg.argtypes = [
            vp, ci, vp,
            ci, ctypes.POINTER(vp), ctypes.POINTER(ci), ctypes.POINTER(cull),
            cll, ci, ci, vp,
            vp,
        ]
        lib.evql_groupby_multi_agg.restype = ci
        lib.evql_groupby_smem_optin.argtypes = [ctypes.POINTER(ci)]
        lib.evql_groupby_smem_optin.restype = ci
        _lib_ready = True
    return lib


def _raise_cuda(fn: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} at launch")


def _checked(gid, n, num_buckets, values, mask, preds):
    n = int(n)
    K = int(num_buckets)
    if n > gid.shape[0]:
        raise ValueError(f"n = {n} exceeds the key stream's {gid.shape[0]} rows")
    if not 0 < K < (1 << 31):
        raise ValueError(f"num_buckets out of range: {K}")
    dev = gid.device
    _check_stream("gid", gid, n, dev)
    for i, v in enumerate(values):
        _check_stream(f"values[{i}]", v, n, dev)
    if mask is not None:
        _check_stream("mask", mask, n, dev)
        if mask.dtype not in (torch.bool, torch.uint8):
            raise TypeError("mask: need a bool or uint8 tensor")
    for p in preds:
        if p.op not in _OPS or p.src not in _SRCS:
            raise ValueError(f"bad predicate {p!r}")
        if p.src == "stream":
            _check_stream("pred", p.stream, n, dev)
        if p.src == "value" and not values:
            raise ValueError("a 'value' predicate needs a value stream")
    return n, K


@trace.spanned("kernel.groupby_agg")
def groupby_agg(
    gid: torch.Tensor,
    n: int,
    num_buckets: int,
    values: Optional[torch.Tensor] = None,
    value_bits: int = 64,
    mask: Optional[torch.Tensor] = None,
    preds: Sequence[Pred] = (),
    combine: str = "and",
    gid_base: int = 0,
    gid_unsigned: bool = False,
    values_unsigned: bool = False,
) -> torch.Tensor:
    """count (and sum of ``values``) per bucket over the first ``n`` rows.

    Returns int64[2, K] (counts, sums as u64 bit patterns), or
    int64[1, K] when ``values`` is None."""
    preds = tuple(preds)
    if len(preds) > 2 or combine not in ("and", "or"):
        raise ValueError("at most two predicates, joined by 'and' or 'or'")
    vals = () if values is None else (values,)
    n, K = _checked(gid, n, num_buckets, vals, mask, preds)
    vmask = _value_mask(value_bits)
    if not gid.is_cuda:
        return _plain(gid, n, K, vals, (vmask,) * len(vals), mask, preds,
                      combine, gid_base, gid_unsigned, (values_unsigned,))
    out = torch.zeros((1 + len(vals), K), dtype=torch.int64, device=gid.device)
    if n == 0:
        return out

    def pred_args(i):
        if i >= len(preds):
            return (None, 0, _SRC_NONE, 0, 0)
        p = preds[i]
        if p.src == "stream":
            return (p.stream.data_ptr(), _dt_code(p.stream, p.unsigned),
                    _SRC_STREAM, _OPS[p.op], _fold_i32(p.thr))
        return (None, 0, _SRCS[p.src], _OPS[p.op], _fold_i32(p.thr))

    with torch.cuda.device(gid.device):
        rc = _lib().evql_groupby_agg(
            gid.data_ptr(), _dt_code(gid, gid_unsigned),
            None if mask is None else mask.data_ptr(),
            *pred_args(0),
            *pred_args(1),
            1 if combine == "or" else 0,
            None if values is None else values.data_ptr(),
            0 if values is None else _dt_code(values, values_unsigned),
            vmask,
            _fold_i32(gid_base), n, K,
            table_in_shared_memory(K, len(vals), smem_optin(gid.device)),
            out.data_ptr(),
            torch.cuda.current_stream(gid.device).cuda_stream,
        )
    _raise_cuda("groupby_agg", rc)
    LAUNCHES["groupby_agg"] += 1
    return out


def groupby_agg_plain(gid, n, num_buckets, values=None, value_bits=64,
                      mask=None, preds=(), combine="and", gid_base=0,
                      gid_unsigned=False, values_unsigned=False):
    """Plain PyTorch version of ``groupby_agg`` on the tensors' device."""
    preds = tuple(preds)
    vals = () if values is None else (values,)
    n, K = _checked(gid, n, num_buckets, vals, mask, preds)
    return _plain(gid, n, K, vals, (_value_mask(value_bits),) * len(vals),
                  mask, preds, combine, gid_base, gid_unsigned,
                  (values_unsigned,))


def _multi_args(streams, stream_bits, streams_unsigned):
    streams = tuple(streams)
    if not 1 <= len(streams) <= MAX_SUMS:
        raise ValueError(f"need 1..{MAX_SUMS} value streams")
    if len(stream_bits) != len(streams):
        raise ValueError("one stream_bits entry per stream")
    if streams_unsigned is None:
        streams_unsigned = (False,) * len(streams)
    return streams, tuple(_value_mask(b) for b in stream_bits), tuple(streams_unsigned)


@trace.spanned("kernel.groupby_multi_agg")
def groupby_multi_agg(
    gid: torch.Tensor,
    n: int,
    num_buckets: int,
    streams: Sequence[torch.Tensor],
    stream_bits: Sequence[int],
    mask: Optional[torch.Tensor] = None,
    gid_unsigned: bool = False,
    streams_unsigned: Optional[Sequence[bool]] = None,
) -> torch.Tensor:
    """count and S sums per bucket in one pass over the first ``n``
    rows. Stream s contributes its low ``stream_bits[s]`` bits as an
    unsigned payload; sums are exact mod 2^64. Returns int64[1 + S, K]."""
    streams, vmasks, unsigned = _multi_args(streams, stream_bits, streams_unsigned)
    n, K = _checked(gid, n, num_buckets, streams, mask, ())
    if not gid.is_cuda:
        return _plain(gid, n, K, streams, vmasks, mask, (), "and", 0,
                      gid_unsigned, unsigned)
    S = len(streams)
    out = torch.zeros((1 + S, K), dtype=torch.int64, device=gid.device)
    if n == 0:
        return out
    ptrs = (ctypes.c_void_p * S)(*[s.data_ptr() for s in streams])
    dts = (ctypes.c_int * S)(*[_dt_code(s, u) for s, u in zip(streams, unsigned)])
    masks = (ctypes.c_ulonglong * S)(*vmasks)
    with torch.cuda.device(gid.device):
        rc = _lib().evql_groupby_multi_agg(
            gid.data_ptr(), _dt_code(gid, gid_unsigned),
            None if mask is None else mask.data_ptr(),
            S, ptrs, dts, masks,
            n, K, table_in_shared_memory(K, S, smem_optin(gid.device)),
            out.data_ptr(),
            torch.cuda.current_stream(gid.device).cuda_stream,
        )
    _raise_cuda("groupby_multi_agg", rc)
    LAUNCHES["groupby_multi_agg"] += 1
    return out


def groupby_multi_agg_plain(gid, n, num_buckets, streams, stream_bits,
                            mask=None, gid_unsigned=False,
                            streams_unsigned=None):
    """Plain PyTorch version of ``groupby_multi_agg``."""
    streams, vmasks, unsigned = _multi_args(streams, stream_bits, streams_unsigned)
    n, K = _checked(gid, n, num_buckets, streams, mask, ())
    return _plain(gid, n, K, streams, vmasks, mask, (), "and", 0,
                  gid_unsigned, unsigned)
