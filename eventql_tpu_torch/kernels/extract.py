"""Flagged-row extraction (stream compaction).

The port of the TPU kernel of eventql_tpu/kernels/extract.py:
``extract_ge`` replaces ``_extract_kernel`` / ``extract_ge`` there. It
returns the ascending indices of the rows whose int32 value is at least
a threshold: the first ``cap`` of them by row, padded with -1.

The kernel is the CUDA C++ of ``csrc/extract.cu``: one launch, one pass
over the values with decoupled look-back. Each block claims the next
tile of ``TILE_ROWS`` rows, reads it once with 16-byte loads, ranks its
matches (popcount and a warp scan of the counts), takes its prefix from
its predecessors' 64-bit status words and writes its matches in row
order; the last tile writes the -1 padding. It is bound by bytes: the
values are read once, ``cap`` indices are written. The kernel takes
``n`` and masks its own head (a base off a 16-byte boundary) and ragged
tail, so nothing is padded.

The kernel's state (a tile counter and a status word a tile) is kept
between calls, one per device and stream (``_State``), so that no launch
resets it: each call passes the counter's value and an epoch of its own,
which its status words carry.

Used by the top-k pipeline (kernels/sort.py): histogram -> threshold ->
extract candidates -> exact small top-k.

The wrapper launches the kernel for CUDA tensors and uses the plain
PyTorch version (``extract_ge_plain``) for CPU tensors only.
``LAUNCHES`` counts wrapper calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from eventql_tpu_torch.kernels import _build
from eventql_tpu_torch.utils import trace

# kernel launches of the wrapper (plain-version calls do not count)
LAUNCHES = {"extract_ge": 0}

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1

# rows a block of the kernel reads (csrc/extract.cu: kTileRows, checked when
# the library loads); the tests and chip_smoke.py size their cases around it
TILE_ROWS = 8192


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
        vp, ci, cll, cu, cull = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                 ctypes.c_uint, ctypes.c_ulonglong)
        lib.evql_extract_state_words.argtypes = [cll]
        lib.evql_extract_state_words.restype = cll
        lib.evql_extract_max_epoch.argtypes = []
        lib.evql_extract_max_epoch.restype = cu
        lib.evql_extract_ge.argtypes = [vp, cll, ci, ci, vp, vp, cull, cu, vp]
        lib.evql_extract_ge.restype = cll
        lib.evql_extract_tile_rows.argtypes = []
        lib.evql_extract_tile_rows.restype = ci
        if lib.evql_extract_tile_rows() != TILE_ROWS:
            raise RuntimeError(f"extract.cu's tile holds {lib.evql_extract_tile_rows()} rows,"
                               f" TILE_ROWS says {TILE_ROWS}")
        _lib_ready = True
    return lib


class _State:
    """The kernel's state on one device and stream: ``words`` int64 (the
    tile counter, then a status word a tile), zeroed when made; ``base``:
    the counter's value after the calls enqueued so far; ``epoch``: the
    last call's. Calls on one stream run in the order they were enqueued,
    so each finds the counter at the ``base`` it was given."""

    def __init__(self, words, device):
        self.words = torch.zeros(words, dtype=torch.int64, device=device)
        self.base = 0
        self.epoch = 0


_STATES = {}  # (device index, stream) -> _State
_STATES_LOCK = threading.Lock()


@trace.spanned("kernel.extract_ge")
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
    device = values.device
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    out = torch.empty(cap, dtype=torch.int32, device=device)
    words = lib.evql_extract_state_words(n)
    with _STATES_LOCK, torch.cuda.device(device):
        # this device and stream's state, made (zeroed) when it is missing,
        # too small or out of epochs
        state = _STATES.get((device.index, stream))
        if (state is None or state.words.numel() < words
                or state.epoch >= lib.evql_extract_max_epoch()):
            state = _STATES[device.index, stream] = _State(words, device)
        state.epoch += 1
        tiles = lib.evql_extract_ge(
            values.data_ptr(), n, threshold, cap, out.data_ptr(), state.words.data_ptr(),
            state.base, state.epoch, stream,
        )
        if tiles < 0:
            # the kernel may have been enqueued all the same (an error left
            # pending by an earlier call): the counter is no longer known
            del _STATES[device.index, stream]
            raise RuntimeError(f"extract_ge: CUDA error {-tiles} at launch")
        state.base += tiles
    LAUNCHES["extract_ge"] += 1
    return out
