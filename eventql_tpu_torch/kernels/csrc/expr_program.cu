// The expression program: one launch evaluates a whole expression tree over
// the stored columns, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package left each expression to XLA, which
// fused the tree into one loop (eventql_tpu/exec/jax_expr.py); the port's
// PyTorch version (exec/torch_expr.py) runs each node as its own pass over
// 8-byte rows. exec/torch_expr.py compiles a tree into a short program
// (kernels/expr_program.py holds its layout and op codes), and this kernel
// interprets it: one binary serves every expression, so no plan builds code.
//
// Program: up to kMaxIns instructions over one accumulator (R values a
// thread, in registers), kMaxSlots slots (shared memory), kMaxImms literals
// and kMaxStreams input streams. An instruction reads up to three operands
// (the accumulator, a slot, a literal or a stream), leaves its result in the
// accumulator (or ANDs / ORs it into the accumulator) and may save the
// accumulator to a slot. A value is a 64-bit word: an int64
// (the u64 of unsigned types as its bits), a float64's bits, or a bool as
// 0 / 1. Integer arithmetic wraps mod 2^64 (in unsigned types); float
// arithmetic is each IEEE operation alone, rounded to nearest
// (__dadd_rn / __dsub_rn / __dmul_rn: never fused); conversions are the
// helpers of torch_expr (_u64_to_f64 is __ull2double_rn; _f64_to_i64 and
// _f64_to_u64 truncate, saturate and send NaN to 0).
//
// Bound: bytes. Each input stream is read once at its stored width (int16 /
// int32 narrowed, zero-extended where the kind says unsigned, int64, float64,
// or a bool / validity byte), and the result written once: 8 bytes a row,
// 1 for a bool, plus a validity byte a row where the program computes one.
//
// Design: a block takes kBlockRows rows, a thread R neighbouring rows (a
// template parameter: 8 for a program of two or more instructions, so that
// decoding an instruction costs little a row; 4 for one instruction, where
// the kernel is a copy and more threads a block keep more stores in flight).
// First every stream's tile is copied to shared memory with asynchronous
// copies (cp.async through __pipeline_memcpy_async: 4 to 64 bytes a thread
// and stream, all in flight before the first instruction runs and with no
// register held), or with scalar loads where a stream lies off a 16-byte
// boundary or the block is the ragged last one. Then the program runs: the
// instruction loop is the same for every thread (warp-uniform); operands
// come from the tile (vector loads), slots live in shared memory ([slot][row]
// [thread], 8-byte words: conflict-free), never in a register array indexed
// at run time (which would spill to local memory). Last the accumulator is
// stored with 16-byte stores (4- or 8-byte ones for a bool). The program
// travels in the launch's parameters (__grid_constant__), literals included,
// so a launch copies nothing from the host.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockRows = 1024;                // rows a block
constexpr int kMaxStreams = 12;
constexpr int kMaxImms = 24;
constexpr int kMaxIns = 48;
constexpr int kMaxSlots = 8;
constexpr int kNoSlot = 255;
constexpr int kMaxSmem = 232448;                // what a block may opt in to
constexpr int kDefaultSmem = 48 * 1024;

// stream kinds (kernels/expr_program.py: KINDS)
enum Kind { kI16 = 0, kU16, kI32, kU32, kI64, kF64, kB8 };
// operand sources
enum Src { kNone = 0, kAcc, kSlot, kImm, kStream };
// op codes (kernels/expr_program.py: OPS, in this order)
enum Op {
  kMov = 0,
  kIAdd, kISub, kIMul,
  kFAdd, kFSub, kFMul,
  kILt, kILe, kIGt, kIGe,
  kULt, kULe, kUGt, kUGe,
  kIEq, kINe,
  kFLt, kFLe, kFGt, kFGe, kFEq, kFNe,
  kAnd, kOr, kNot,
  kINeg, kFNeg,
  kI2F, kU2F, kF2I, kF2U, kFTrunc,
  kSel,
  kNumOps
};

// an instruction's op byte: the op code, and in the top two bits whether
// its result replaces the accumulator or is ANDed / ORed into it (so that
// a conjunction of compares takes one instruction a compare, and no slot)
constexpr int kCombineShift = 6;
constexpr int kOpMask = (1 << kCombineShift) - 1;
enum Combine { kReplace = 0, kAndAcc, kOrAcc };

struct Ins {
  uint8_t op, ak, a, bk, b, ck, c, save;
};

// what the host passes (kernels/expr_program.py: HostProgram)
struct HostProgram {
  unsigned long long imm[kMaxImms];
  Ins ins[kMaxIns];
  uint8_t kind[kMaxStreams];
  int nstreams, nins, nslots, valid_slot, out_bool;
};

// what the kernel reads: the host's program, the streams' addresses and
// where each stream's tile lies in shared memory
struct Program {
  const void* ptr[kMaxStreams];
  unsigned long long imm[kMaxImms];
  Ins ins[kMaxIns];
  unsigned int stage[kMaxStreams];
  uint8_t kind[kMaxStreams];
  int nstreams, nins, nslots, valid_slot, out_bool, vec_mask;
};

__host__ __device__ inline int width_of(int kind) {
  return kind == kB8 ? 1 : kind <= kU16 ? 2 : kind <= kU32 ? 4 : 8;
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

__device__ __forceinline__ double as_f(uint64_t x) { return __longlong_as_double((long long)x); }
__device__ __forceinline__ uint64_t as_u(double x) { return (uint64_t)__double_as_longlong(x); }

// loops of constant trip count: unrolled, so the arrays stay in registers
#define EACH for (int r = 0; r < R; ++r)

// element r of a stream's tile row set, scalar: w bytes from src or 0
__device__ __forceinline__ void copy_elem(unsigned char* dst, const unsigned char* src, int w,
                                          bool here) {
  switch (w) {
    case 1: *dst = here ? *src : 0; break;
    case 2: *(uint16_t*)dst = here ? *(const uint16_t*)src : 0; break;
    case 4: *(uint32_t*)dst = here ? *(const uint32_t*)src : 0u; break;
    default: *(unsigned long long*)dst = here ? *(const unsigned long long*)src : 0ull; break;
  }
}

// kBytes (4, 8 or a multiple of 16) at q, aligned to min(kBytes, 16), as
// 32-bit words: one 4- or 8-byte load, else 16-byte loads
template <int kBytes>
__device__ __forceinline__ void load_words(const unsigned char* q, uint32_t (&w)[kBytes / 4]) {
  if constexpr (kBytes == 4) {
    w[0] = *(const uint32_t*)q;
  } else if constexpr (kBytes == 8) {
    const uint2 x = *(const uint2*)q;
    w[0] = x.x;
    w[1] = x.y;
  } else {
    for (int k = 0; k < kBytes / 16; ++k) {
      const uint4 x = ((const uint4*)q)[k];
      w[4 * k] = x.x;
      w[4 * k + 1] = x.y;
      w[4 * k + 2] = x.z;
      w[4 * k + 3] = x.w;
    }
  }
}

// a stream's R values of this thread from its tile, widened
template <int R>
__device__ __forceinline__ void fetch_stream(int kind, const unsigned char* q, int t0,
                                             uint64_t (&v)[R]) {
  switch (kind) {
    case kI16:
    case kU16: {
      uint32_t w[R / 2];
      load_words<2 * R>(q + 2 * t0, w);
      if (kind == kI16)
        EACH v[r] = (uint64_t)(long long)(short)(w[r >> 1] >> (16 * (r & 1)));
      else
        EACH v[r] = (w[r >> 1] >> (16 * (r & 1))) & 0xFFFFu;
      break;
    }
    case kI32:
    case kU32: {
      uint32_t w[R];
      load_words<4 * R>(q + 4 * t0, w);
      if (kind == kI32)
        EACH v[r] = (uint64_t)(long long)(int)w[r];
      else
        EACH v[r] = w[r];
      break;
    }
    case kB8: {
      uint32_t w[R / 4];
      load_words<R>(q + t0, w);
      EACH v[r] = ((w[r >> 2] >> (8 * (r & 3))) & 0xFFu) != 0;
      break;
    }
    default: {  // kI64, kF64
      uint32_t w[2 * R];
      load_words<8 * R>(q + 8 * t0, w);
      EACH v[r] = w[2 * r] | (uint64_t)w[2 * r + 1] << 32;
      break;
    }
  }
}

// the R values of an operand, widened to 64-bit words
template <int R>
__device__ __forceinline__ void fetch(const Program& p, int src, int idx, const uint64_t (&acc)[R],
                                      const unsigned char* smem, int t0, uint64_t (&v)[R]) {
  constexpr int kThreads = kBlockRows / R;
  switch (src) {
    case kAcc:
      EACH v[r] = acc[r];
      break;
    case kSlot: {
      const uint64_t* s = (const uint64_t*)smem + (size_t)idx * kBlockRows + threadIdx.x;
      EACH v[r] = s[r * kThreads];
      break;
    }
    case kImm: {
      const uint64_t x = p.imm[idx];
      EACH v[r] = x;
      break;
    }
    case kStream:
      fetch_stream<R>(p.kind[idx], smem + p.stage[idx], t0, v);
      break;
    default:
      break;
  }
}

__device__ __forceinline__ uint64_t f2i(double x) {
  if (x != x) return 0;
  if (x >= 9223372036854775808.0) return 0x7FFFFFFFFFFFFFFFull;
  if (x <= -9223372036854775808.0) return 0x8000000000000000ull;
  return (uint64_t)(long long)x;
}

__device__ __forceinline__ uint64_t f2u(double x) {
  if (x >= 18446744073709551616.0) return ~0ull;
  if (!(x > 0.0)) return 0;  // NaN too
  if (x >= 9223372036854775808.0)
    return (uint64_t)(long long)(x - 9223372036854775808.0) ^ 0x8000000000000000ull;
  return (uint64_t)(long long)x;
}

template <int kComb>
__device__ __forceinline__ void put(uint64_t& acc, uint64_t v) {
  if constexpr (kComb == kAndAcc)
    acc &= v;
  else if constexpr (kComb == kOrAcc)
    acc |= v;
  else
    acc = v;
}

// one instruction over the thread's rows; the result meets the accumulator
// as kComb says (a template, so that no row branches on it)
template <int R, int kComb>
__device__ __forceinline__ void run_ins(const Program& p, const Ins& in, const uint64_t (&a)[R],
                                        const uint64_t (&b)[R], const unsigned char* smem,
                                        int t0, uint64_t (&acc)[R]) {
#define PUT(x) EACH put<kComb>(acc[r], (x))
  switch (in.op & kOpMask) {
    case kMov: PUT(a[r]); break;
    case kIAdd: PUT(a[r] + b[r]); break;
    case kISub: PUT(a[r] - b[r]); break;
    case kIMul: PUT(a[r] * b[r]); break;
    case kFAdd: PUT(as_u(__dadd_rn(as_f(a[r]), as_f(b[r])))); break;
    case kFSub: PUT(as_u(__dsub_rn(as_f(a[r]), as_f(b[r])))); break;
    case kFMul: PUT(as_u(__dmul_rn(as_f(a[r]), as_f(b[r])))); break;
    case kILt: PUT((long long)a[r] < (long long)b[r]); break;
    case kILe: PUT((long long)a[r] <= (long long)b[r]); break;
    case kIGt: PUT((long long)a[r] > (long long)b[r]); break;
    case kIGe: PUT((long long)a[r] >= (long long)b[r]); break;
    case kULt: PUT(a[r] < b[r]); break;
    case kULe: PUT(a[r] <= b[r]); break;
    case kUGt: PUT(a[r] > b[r]); break;
    case kUGe: PUT(a[r] >= b[r]); break;
    case kIEq: PUT(a[r] == b[r]); break;
    case kINe: PUT(a[r] != b[r]); break;
    case kFLt: PUT(as_f(a[r]) < as_f(b[r])); break;
    case kFLe: PUT(as_f(a[r]) <= as_f(b[r])); break;
    case kFGt: PUT(as_f(a[r]) > as_f(b[r])); break;
    case kFGe: PUT(as_f(a[r]) >= as_f(b[r])); break;
    case kFEq: PUT(as_f(a[r]) == as_f(b[r])); break;
    case kFNe: PUT(as_f(a[r]) != as_f(b[r])); break;
    case kAnd: PUT(a[r] & b[r]); break;
    case kOr: PUT(a[r] | b[r]); break;
    case kNot: PUT(a[r] ^ 1ull); break;
    case kINeg: PUT(0ull - a[r]); break;
    case kFNeg: PUT(a[r] ^ 0x8000000000000000ull); break;
    case kI2F: PUT(as_u(__ll2double_rn((long long)a[r]))); break;
    case kU2F: PUT(as_u(__ull2double_rn(a[r]))); break;
    case kF2I: PUT(f2i(as_f(a[r]))); break;
    case kF2U: PUT(f2u(as_f(a[r]))); break;
    case kFTrunc: PUT(as_u(trunc(as_f(a[r])))); break;
    case kSel: {
      uint64_t c[R];  // the third operand: only a select reads one
      fetch<R>(p, in.ck, in.c, acc, smem, t0, c);
      PUT(a[r] ? b[r] : c[r]);
      break;
    }
    default: break;
  }
#undef PUT
}

// R rows a thread, kBlockRows / R threads a block
template <int R>
__global__ void __launch_bounds__(kBlockRows / R)
expr_program_kernel(const __grid_constant__ Program p, long long n, void* __restrict__ out,
                    unsigned char* __restrict__ valid_out, int out_vec) {
  constexpr int kThreads = kBlockRows / R;
  extern __shared__ __align__(16) unsigned char smem[];
  const long long row0 = (long long)blockIdx.x * kBlockRows;
  const int here = n - row0 < kBlockRows ? (int)(n - row0) : kBlockRows;
  const int t0 = threadIdx.x * R;  // the thread's first row in the block
  const bool full = t0 + R <= here;

  // 1. every stream's rows of this thread into its tile
  bool pending = false;
  for (int s = 0; s < p.nstreams; ++s) {
    const int w = width_of(p.kind[s]);
    unsigned char* dst = smem + p.stage[s] + t0 * w;
    const unsigned char* src = (const unsigned char*)p.ptr[s] + (row0 + t0) * w;
    if (full && ((p.vec_mask >> s) & 1)) {
      const int bytes = R * w;
      if (bytes == 4)
        __pipeline_memcpy_async(dst, src, 4);
      else if (bytes == 8)
        __pipeline_memcpy_async(dst, src, 8);
      else
        for (int k = 0; k < bytes; k += 16) __pipeline_memcpy_async(dst + k, src + k, 16);
      pending = true;
    } else {
      for (int r = 0; r < R; ++r) copy_elem(dst + r * w, src + r * w, w, t0 + r < here);
    }
  }
  if (pending) {
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }

  // 2. the program (a thread reads only its own rows: no barrier)
  uint64_t acc[R];
  EACH acc[r] = 0;
  for (int i = 0; i < p.nins; ++i) {
    const Ins in = p.ins[i];
    uint64_t a[R], b[R];
    fetch<R>(p, in.ak, in.a, acc, smem, t0, a);
    fetch<R>(p, in.bk, in.b, acc, smem, t0, b);
    switch (in.op >> kCombineShift) {
      case kAndAcc: run_ins<R, kAndAcc>(p, in, a, b, smem, t0, acc); break;
      case kOrAcc: run_ins<R, kOrAcc>(p, in, a, b, smem, t0, acc); break;
      default: run_ins<R, kReplace>(p, in, a, b, smem, t0, acc); break;
    }
    if (in.save != kNoSlot) {
      uint64_t* s = (uint64_t*)smem + (size_t)in.save * kBlockRows + threadIdx.x;
      EACH s[r * kThreads] = acc[r];
    }
  }

  // 3. the result, and the validity the program computed
  const long long row = row0 + t0;
  const bool vec = full && out_vec;
  if (p.out_bool) {
    unsigned char* o = (unsigned char*)out + row;
    if (vec) {
      uint32_t w[R / 4];
      for (int k = 0; k < R / 4; ++k) w[k] = 0u;
      EACH w[r >> 2] |= (uint32_t)(acc[r] & 0xFFu) << (8 * (r & 3));
      if constexpr (R == 4)
        *(uint32_t*)o = w[0];
      else
        *(uint2*)o = make_uint2(w[0], w[1]);
    } else {
      EACH if (t0 + r < here) o[r] = (unsigned char)acc[r];
    }
  } else {
    unsigned long long* o = (unsigned long long*)out + row;
    if (vec) {
      for (int k = 0; k < R / 2; ++k)
        ((ulonglong2*)o)[k] = make_ulonglong2(acc[2 * k], acc[2 * k + 1]);
    } else {
      EACH if (t0 + r < here) o[r] = acc[r];
    }
  }
  if (p.valid_slot >= 0) {
    const uint64_t* s = (const uint64_t*)smem + (size_t)p.valid_slot * kBlockRows + threadIdx.x;
    unsigned char* o = valid_out + row;
    EACH if (t0 + r < here) o[r] = (unsigned char)s[r * kThreads];
  }
}

template <int R>
cudaError_t launch(const Program& p, long long blocks, size_t smem, long long n, void* out,
                   void* valid_out, int out_vec, cudaStream_t stream) {
  if (smem > (size_t)kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        expr_program_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  expr_program_kernel<R><<<(unsigned)blocks, kBlockRows / R, smem, stream>>>(
      p, n, out, (unsigned char*)valid_out, out_vec);
  return cudaGetLastError();
}

}  // namespace

// hp: the program as the host built it (HostProgram); ptrs: the address of
// each of its hp->nstreams streams, n elements each; out: int64 / float64 [n]
// (a bool [n] where hp->out_bool); valid_out: bool [n] where hp->valid_slot
// >= 0, else unused. Returns the CUDA error of the launch, 0 when fine
// (n == 0 launches nothing).
extern "C" int evql_expr_program(const void* hp_, const void* const* ptrs, long long n,
                                 void* out, void* valid_out, void* stream) {
  const HostProgram* hp = (const HostProgram*)hp_;
  if (n < 0 || hp->nstreams < 0 || hp->nstreams > kMaxStreams || hp->nins < 1 ||
      hp->nins > kMaxIns || hp->nslots < 0 || hp->nslots > kMaxSlots ||
      hp->valid_slot >= hp->nslots || (hp->valid_slot >= 0 && valid_out == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < hp->nins; ++i) {
    const Ins& in = hp->ins[i];
    if ((in.op & kOpMask) >= kNumOps || (in.op >> kCombineShift) > kOrAcc ||
        (in.save != kNoSlot && in.save >= hp->nslots))
      return (int)cudaErrorInvalidValue;
    const uint8_t srcs[3][2] = {{in.ak, in.a}, {in.bk, in.b}, {in.ck, in.c}};
    for (const auto& s : srcs) {
      if ((s[0] == kSlot && s[1] >= hp->nslots) || (s[0] == kImm && s[1] >= kMaxImms) ||
          (s[0] == kStream && s[1] >= hp->nstreams) || s[0] > kStream)
        return (int)cudaErrorInvalidValue;
    }
  }
  if (n == 0) return 0;
  const long long blocks = (n + kBlockRows - 1) / kBlockRows;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;

  Program p;
  for (int i = 0; i < kMaxImms; ++i) p.imm[i] = hp->imm[i];
  for (int i = 0; i < kMaxIns; ++i) p.ins[i] = hp->ins[i];
  p.nstreams = hp->nstreams;
  p.nins = hp->nins;
  p.nslots = hp->nslots;
  p.valid_slot = hp->valid_slot;
  p.out_bool = hp->out_bool;
  p.vec_mask = 0;
  size_t smem = (size_t)hp->nslots * kBlockRows * 8;
  for (int s = 0; s < kMaxStreams; ++s) {
    p.ptr[s] = s < hp->nstreams ? ptrs[s] : nullptr;
    p.kind[s] = s < hp->nstreams ? hp->kind[s] : (uint8_t)kB8;
    p.stage[s] = (unsigned int)smem;
    if (s < hp->nstreams) {
      if (hp->kind[s] > kB8) return (int)cudaErrorInvalidValue;
      if (aligned16(ptrs[s])) p.vec_mask |= 1 << s;
      smem += (size_t)kBlockRows * width_of(hp->kind[s]);  // a multiple of 16
    }
  }
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int out_vec = aligned16(out) ? 1 : 0;
  // one instruction: four rows a thread; more: eight
  return hp->nins == 1 ? (int)launch<4>(p, blocks, smem, n, out, valid_out, out_vec,
                                        (cudaStream_t)stream)
                       : (int)launch<8>(p, blocks, smem, n, out, valid_out, out_vec,
                                        (cudaStream_t)stream);
}

// The layout and limits the Python side builds against.
extern "C" int evql_expr_program_layout(int what) {
  switch (what) {
    case 0: return (int)sizeof(HostProgram);
    case 1: return kMaxStreams;
    case 2: return kMaxImms;
    case 3: return kMaxIns;
    case 4: return kMaxSlots;
    case 5: return kBlockRows;
    case 6: return kNumOps;
    default: return -1;
  }
}
