"""Flagged-row extraction (stream compaction).

The port of the TPU kernel of eventql_tpu/kernels/extract.py:
``extract_ge`` replaces ``_extract_kernel`` / ``extract_ge`` there. It
returns the ascending indices of the rows whose int32 value is at least
a threshold: the first ``cap`` of them by row, padded with -1.

The kernel is the CUDA C++ of ``csrc/extract.cu``: per-block match
counts, an exclusive scan of the counts, then an ordered write (ballot
and popcount ranks). It is bound by bytes: the values are read once,
``cap`` indices are written. The kernel takes ``n`` and masks its own
ragged edge, so nothing is padded.

Used by the top-k pipeline (kernels/sort.py): histogram -> threshold ->
extract candidates -> exact small top-k.

The wrapper launches the kernel for CUDA tensors and uses the plain
PyTorch version (``extract_ge_plain``) for CPU tensors only.
``LAUNCHES`` counts wrapper calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from eventql_tpu_torch.kernels import _build

# kernel launches of the wrapper (plain-version calls do not count)
LAUNCHES = {"extract_ge": 0}

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def _checked(values: torch.Tensor, threshold, cap, n):
    if values.dim() != 1 or not values.is_contiguous():
        raise ValueError("values: need a contiguous 1-d tensor")
    if values.dtype != torch.int32:
        raise TypeError(f"values: need int32, got {values.dtype}")
    n = values.shape[0] if n is None else int(n)
    if not 0 <= n <= values.shape[0]:
        raise ValueError(f"n = {n} outside the value stream's {values.shape[0]} rows")
    if n > _I32_MAX:
        raise ValueError("row indices are int32: n must be below 2^31")
    cap = int(cap)
    if not 0 < cap <= _I32_MAX:
        raise ValueError(f"cap out of range: {cap}")
    threshold = int(threshold)
    if not _I32_MIN <= threshold <= _I32_MAX:
        raise ValueError(f"threshold is not an int32: {threshold}")
    return threshold, cap, n


def _plain(values, threshold, cap, n):
    out = torch.full((cap,), -1, dtype=torch.int32, device=values.device)
    idx = torch.nonzero(values[:n] >= threshold).flatten()[:cap]
    out[: idx.shape[0]] = idx.to(torch.int32)
    return out


def extract_ge_plain(values, threshold, cap, n=None):
    """Plain PyTorch version of ``extract_ge`` on the tensor's device."""
    threshold, cap, n = _checked(values, threshold, cap, n)
    return _plain(values, threshold, cap, n)


_lib_ready = False


def _lib():
    global _lib_ready
    lib = _build.load("extract")
    if not _lib_ready:
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.evql_extract_scratch_ints.argtypes = [cll]
        lib.evql_extract_scratch_ints.restype = cll
        lib.evql_extract_ge.argtypes = [vp, cll, ci, ci, vp, vp, vp]
        lib.evql_extract_ge.restype = ci
        _lib_ready = True
    return lib


def extract_ge(
    values: torch.Tensor, threshold: int, cap: int, n: Optional[int] = None
) -> torch.Tensor:
    """Indices (ascending) of the rows < ``n`` with ``values >=
    threshold``, padded with -1 to ``cap``. If more than ``cap`` rows
    qualify, the first ``cap`` by row order are returned; callers detect
    the overflow by counting the qualifying rows themselves.

    values: int32 [>= n]; returns int32 [cap]."""
    threshold, cap, n = _checked(values, threshold, cap, n)
    if not values.is_cuda:
        return _plain(values, threshold, cap, n)
    if n == 0:
        return torch.full((cap,), -1, dtype=torch.int32, device=values.device)
    lib = _lib()
    out = torch.empty(cap, dtype=torch.int32, device=values.device)
    scratch = torch.empty(
        lib.evql_extract_scratch_ints(n), dtype=torch.int32, device=values.device
    )
    with torch.cuda.device(values.device):
        rc = lib.evql_extract_ge(
            values.data_ptr(), n, threshold, cap, out.data_ptr(),
            scratch.data_ptr(),
            torch.cuda.current_stream(values.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"extract_ge: CUDA error {rc} at launch")
    LAUNCHES["extract_ge"] += 1
    return out
