"""The kernels of the repository's three TPU probes (``scripts/probe_*.py``).

* ``place_runs`` replaces ``_placement_kernel`` / ``placement`` of
  scripts/probe_radix.py (body :162, ``pl.pallas_call`` :181): run
  placement, the scatter step of a block-radix partition. For each run
  ``i``, rows ``[src_off[i], src_off[i] + rows)`` of ``src`` are copied to
  rows ``[dst_off[i], ...)`` of the result. Bound by bytes: each copied
  word is read once and written once, 2 x 4 B x 128 a row, plus 8 B of
  offsets a run (0.080 ms for 2^25 words on the H100's 3.35 TB/s).
* ``int8_form`` replaces the five kernel bodies of
  scripts/probe_int8_ops.py that ``run_case`` launches (:17,
  ``pl.pallas_call`` :20): five elementwise int8 forms of two int32
  arrays, widened back to int32, int8 wrapping as JAX's ``astype(int8)``
  does. Bound by bytes: 12 B an element (8 for ``convert_i32_i8``, which
  reads only ``a``; ``int8_form_bytes``).
* scripts/probe_groupby_i8.py's ``sum_count_i8`` (:91, body
  ``_agg_kernel_i8`` :26, ``pl.pallas_call`` :109) computes B1's contract
  (an exact count and a u64 sum per bucket under a mask) with int8 one-hot
  and limb planes on the MXU, a TPU workaround. Its counterpart is
  ``groupby_agg`` (kernels/groupby_agg.py); no kernel here.

Both kernels are the CUDA C++ of ``csrc/probes.cu``. ``place_runs`` has
no VMEM staging and no serial grid: a warp copies a run (a long run in
pieces of 8 rows) with 16-byte loads and stores, and the offsets live in
device memory, so there is no cap on the number of runs (the TPU's: 65536
in SMEM). ``int8_form`` runs an exact grid of ``FORM_BLOCK_ELEMENTS``
elements a block, four 16-byte loads of each input a thread before the
first compare, read-only loads and streaming stores (masked scalars for
the ragged end and for an operand off a 16-byte boundary). u32 words are carried as int32 bit
patterns (ROADMAP C1).

Each wrapper launches its kernel for CUDA tensors and uses the plain
PyTorch version (``*_plain``) for CPU tensors only. ``LAUNCHES`` counts
wrapper calls that launched a kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from eventql_tpu_torch.kernels import _build

# kernel launches of the wrappers (plain-version calls do not count)
LAUNCHES = {"place_runs": 0, "int8_form": 0}

ROW_WORDS = 128  # 32-bit words a row of place_runs' arrays (the TPU's lane width)

# elements a block of int8_form's kernel takes (csrc/probes.cu: kFormBlock,
# checked when the library loads); chip_smoke.py sizes its edge cases around it
FORM_BLOCK_ELEMENTS = 2048

# the five forms, in the order of scripts/probe_int8_ops.py's main
INT8_CASES = ("select_i8_const", "muli_i8", "convert_i32_i8", "select_i8_value",
              "mul_i32_then_i8")


def _check_rows(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: need int32 (u32 as its bit pattern), got {t.dtype}")
    if t.dim() != 2 or t.shape[1] != ROW_WORDS or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous (R, {ROW_WORDS}) tensor, got"
                         f" {tuple(t.shape)}")


def _checked_runs(src, src_off, dst_off, rows, out):
    _check_rows("src", src)
    for name, t in (("src_off", src_off), ("dst_off", dst_off)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous 1-d int32 tensor")
        if t.device != src.device:
            raise ValueError(f"{name}: on {t.device}, src on {src.device}")
    if src_off.shape != dst_off.shape:
        raise ValueError(f"src_off {tuple(src_off.shape)} and dst_off"
                         f" {tuple(dst_off.shape)} differ")
    rows = int(rows)
    if rows < 1:
        raise ValueError(f"rows must be at least 1, got {rows}")
    if out is None:
        out = torch.zeros_like(src)
    else:
        _check_rows("out", out)
        if out.device != src.device:
            raise ValueError(f"out: on {out.device}, src on {src.device}")
        if out.untyped_storage().data_ptr() == src.untyped_storage().data_ptr():
            raise ValueError("out must not share memory with src")
    return rows, out


def _place(src, src_off, dst_off, rows, out):
    s = src_off.to(torch.int64)
    d = dst_off.to(torch.int64)
    fits = (s >= 0) & (d >= 0) & (s + rows <= src.shape[0]) & (d + rows <= out.shape[0])
    step = torch.arange(rows, device=src.device)
    out[(d[fits, None] + step).reshape(-1)] = src[(s[fits, None] + step).reshape(-1)]
    return out


def place_runs_plain(src, src_off, dst_off, rows, out=None):
    """Plain PyTorch version of ``place_runs`` on the tensors' device."""
    rows, out = _checked_runs(src, src_off, dst_off, rows, out)
    return _place(src, src_off, dst_off, rows, out)


def _wrap8(x: torch.Tensor) -> torch.Tensor:
    return ((x & 0xFF) ^ 0x80) - 0x80


def _case_index(case: str) -> int:
    if case not in INT8_CASES:
        raise ValueError(f"unknown int8 form {case!r}: one of {INT8_CASES}")
    return INT8_CASES.index(case)


def _checked_form(a, b, case):
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous int32 tensor")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(f"a {tuple(a.shape)} on {a.device} and b {tuple(b.shape)} on"
                         f" {b.device} differ")
    return _case_index(case)


def _form(a, b, k):
    eq = (a == b).to(torch.int32)
    if k == 0:
        return eq
    if k == 1:
        return _wrap8(_wrap8(a) * _wrap8(b))
    if k == 2:
        return _wrap8(a)
    if k == 3:
        return _wrap8(b) * eq
    return _wrap8(b * eq)


def int8_form_bytes(case: str, n: int) -> int:
    """Bytes a form must move over n elements: ``a`` and ``b`` read (only
    ``a`` for ``convert_i32_i8``), the result written."""
    _case_index(case)
    return (8 if case == "convert_i32_i8" else 12) * int(n)


def int8_form_plain(a, b, case):
    """Plain PyTorch version of ``int8_form`` on the tensors' device."""
    return _form(a, b, _checked_form(a, b, case))


_lib_ready = False


def _lib():
    global _lib_ready
    lib = _build.load("probes")
    if not _lib_ready:
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.evql_place_runs.argtypes = [vp, cll, vp, vp, cll, ci, vp, cll, vp]
        lib.evql_place_runs.restype = ci
        lib.evql_int8_form.argtypes = [vp, vp, vp, cll, ci, vp]
        lib.evql_int8_form.restype = ci
        lib.evql_int8_form_block_elements.argtypes = []
        lib.evql_int8_form_block_elements.restype = ci
        if lib.evql_int8_form_block_elements() != FORM_BLOCK_ELEMENTS:
            raise RuntimeError(f"probes.cu's int8_form block takes"
                               f" {lib.evql_int8_form_block_elements()} elements,"
                               f" FORM_BLOCK_ELEMENTS says {FORM_BLOCK_ELEMENTS}")
        _lib_ready = True
    return lib


def place_runs(
    src: torch.Tensor,
    src_off: torch.Tensor,
    dst_off: torch.Tensor,
    rows: int,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Copy run ``i`` of ``rows`` rows from row ``src_off[i]`` of ``src``
    to row ``dst_off[i]`` of ``out`` (written in place and returned; zeros
    of ``src``'s shape when None), for every run.

    src, out: int32 [R, 128] (u32 words as bit patterns); src_off,
    dst_off: int32 [nruns]. Rows that no run writes keep ``out``'s values.
    A run whose source or destination range leaves its array is not
    copied. Where destination ranges overlap, which run's rows land there
    is not specified."""
    rows, out = _checked_runs(src, src_off, dst_off, rows, out)
    if not src.is_cuda:
        return _place(src, src_off, dst_off, rows, out)
    nruns = src_off.shape[0]
    if nruns == 0:
        return out
    with torch.cuda.device(src.device):
        rc = _lib().evql_place_runs(
            src.data_ptr(), src.shape[0], src_off.data_ptr(), dst_off.data_ptr(), nruns,
            rows, out.data_ptr(), out.shape[0],
            torch.cuda.current_stream(src.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"place_runs: CUDA error {rc} at launch")
    LAUNCHES["place_runs"] += 1
    return out


def int8_form(a: torch.Tensor, b: torch.Tensor, case: str) -> torch.Tensor:
    """One of the five int8 forms named in ``INT8_CASES``,
    elementwise over int32 tensors of one shape, widened back to int32:
    ``a == b ? 1 : 0``; ``i8(i8(a) * i8(b))``; ``i8(a)``; ``a == b ? i8(b)
    : 0``; ``i8(b * (a == b))``. ``i8`` keeps the low 8 bits as a signed
    byte (wrapping, as JAX's ``astype(int8)``)."""
    k = _checked_form(a, b, case)
    if not a.is_cuda:
        return _form(a, b, k)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        rc = _lib().evql_int8_form(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), k,
            torch._C._cuda_getCurrentRawStream(a.device.index),
        )
    if rc != 0:
        raise RuntimeError(f"int8_form: CUDA error {rc} at launch")
    LAUNCHES["int8_form"] += 1
    return out
