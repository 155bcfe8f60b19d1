"""The expression program's kernel: layout, op codes and launch.

``exec/torch_expr.py`` compiles an expression tree into a program
(``HostProgram``: instructions, literals, the kind of each input
stream); ``launch`` runs it over n rows with one launch of the CUDA C++
kernel of ``csrc/expr_program.cu``, an interpreter of such programs. It
replaces no TPU kernel: the JAX package left each expression to XLA,
which fused the tree into one loop. The kernel's plain version is
torch_expr's PyTorch path, which the program reproduces bit for bit and
which the CPU runs.

A program holds up to ``MAX_INS`` instructions, ``MAX_SLOTS`` slots,
``MAX_IMMS`` literals and ``MAX_STREAMS`` streams. An instruction is
(op, three operands as (source, index), save slot or ``NO_SLOT``); it
leaves its result in the accumulator, or ANDs or ORs it into the
accumulator (``COMBINE``, in the op byte's top bits). Values are 64-bit
words: int64 bits (u64 as its bits), float64 bits, or a bool as 0 / 1.
"""

from __future__ import annotations

import ctypes

import torch

from eventql_tpu_torch.kernels import _build

MAX_STREAMS = 12
MAX_IMMS = 24
MAX_INS = 48
MAX_SLOTS = 8
NO_SLOT = 255
# rows a block of the kernel takes (csrc/expr_program.cu: kBlockRows)
BLOCK_ROWS = 1024

# stream kinds: the stored dtype a stream is read at, and how it widens
KINDS = ("i16", "u16", "i32", "u32", "i64", "f64", "b8")
KIND = {k: i for i, k in enumerate(KINDS)}
# operand sources
NONE, ACC, SLOT, IMM, STREAM = range(5)
# op codes, in the kernel's order (csrc/expr_program.cu: enum Op)
OPS = (
    "mov",
    "iadd", "isub", "imul",
    "fadd", "fsub", "fmul",
    "ilt", "ile", "igt", "ige",
    "ult", "ule", "ugt", "uge",
    "ieq", "ine",
    "flt", "fle", "fgt", "fge", "feq", "fne",
    "and", "or", "not",
    "ineg", "fneg",
    "i2f", "u2f", "f2i", "f2u", "ftrunc",
    "sel",
)
OP = {name: i for i, name in enumerate(OPS)}
# what an instruction does with its result (the op byte's top two bits):
# replace the accumulator, or AND / OR it into the accumulator
COMBINE_SHIFT = 6
COMBINE = {None: 0, "and": 1, "or": 2}


class Ins(ctypes.Structure):
    _fields_ = [(f, ctypes.c_uint8) for f in ("op", "ak", "a", "bk", "b", "ck", "c", "save")]


class HostProgram(ctypes.Structure):
    """The program as the launcher takes it (csrc/expr_program.cu)."""

    _fields_ = [
        ("imm", ctypes.c_uint64 * MAX_IMMS),
        ("ins", Ins * MAX_INS),
        ("kind", ctypes.c_uint8 * MAX_STREAMS),
        ("nstreams", ctypes.c_int),
        ("nins", ctypes.c_int),
        ("nslots", ctypes.c_int),
        ("valid_slot", ctypes.c_int),
        ("out_bool", ctypes.c_int),
    ]


_lib_ready = False


def _lib():
    global _lib_ready
    lib = _build.load("expr_program")
    if not _lib_ready:
        vp = ctypes.c_void_p
        lib.evql_expr_program.argtypes = [vp, vp, ctypes.c_longlong, vp, vp, vp]
        lib.evql_expr_program.restype = ctypes.c_int
        lib.evql_expr_program_layout.argtypes = [ctypes.c_int]
        lib.evql_expr_program_layout.restype = ctypes.c_int
        want = (ctypes.sizeof(HostProgram), MAX_STREAMS, MAX_IMMS, MAX_INS, MAX_SLOTS,
                BLOCK_ROWS, len(OPS))
        got = tuple(lib.evql_expr_program_layout(i) for i in range(len(want)))
        if got != want:
            raise RuntimeError(f"expr_program.cu's layout {got} is not expr_program.py's {want}")
        _lib_ready = True
    return lib


def launch(program: HostProgram, streams, n: int, out: torch.Tensor, valid_out=None) -> None:
    """Run ``program`` over rows [0, n): ``streams`` the CUDA tensors it
    reads (contiguous, n elements each, in the program's stream order),
    ``out`` its result (int64 / float64, or bool where the program says),
    ``valid_out`` the bool validity it computes, where it computes one.
    Enqueued on the current stream of ``out``'s device."""
    lib = _lib()
    device = out.device
    ptrs = (ctypes.c_void_p * max(1, len(streams)))(*(s.data_ptr() for s in streams))
    vout = valid_out.data_ptr() if valid_out is not None else None
    with torch.cuda.device(device):
        rc = lib.evql_expr_program(
            ctypes.byref(program), ptrs, n, out.data_ptr(), vout,
            torch._C._cuda_getCurrentRawStream(device.index))
    if rc != 0:
        raise RuntimeError(f"expr_program: CUDA error {rc} at launch")
