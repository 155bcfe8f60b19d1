// Fused scan + WHERE + GROUP BY count/sum for bounded keys, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of eventql_tpu/kernels/pallas_groupby.py:
//   _agg_kernel        (pallas_sum_count, pallas_sum_count_fused,
//                       pallas_count_fused, pallas_count)   -> evql_groupby_agg
//   _multi_agg_kernel  (pallas_multi_sum)                    -> evql_groupby_multi_agg
//
// What is computed, per row < n:
//   * load the group key at its stored width (i16 / u16 / i32 / i64) as int32
//   * up to two compares (lt le gt ge eq ne) of an int32 operand against a
//     literal, joined by AND or OR; the operand is the key itself (before the
//     base subtract), the first value stream, or a stream of its own
//   * an optional byte mask (non-zero keeps the row)
//   * bucket = key - gid_base in 32-bit modular arithmetic; rows with
//     bucket outside [0, K) or a false predicate are dropped
//   * count[bucket] += 1 and, per value stream s, sum[s][bucket] += the low
//     value_bits of the value read as unsigned; all adds wrap mod 2^64
//
// Bound: bytes. Every stream is read once at its stored width and the
// (1+S) x K table is written once, so the least time is
// n * sum(stream widths) / HBM bandwidth.
//
// Design: one template over the number of value streams S, the rows a thread
// takes per loop turn R (8 up to two sums, 4 above: registers), and whether
// the table lies in shared memory. Integer adds commute, so the result does
// not depend on the order blocks and threads run in.
//
//   Loads. A thread takes a run of R consecutive rows per turn and reads each
//   stream with 16-byte loads (8 bytes for the byte mask, and for 16-bit
//   streams at R = 4), all started before the first atomic, so that enough
//   bytes are in flight for the memory rate. Widths stay run-time codes: one
//   switch per stream and run, not per row. A stream that does not start on a
//   16-byte boundary, and the last, ragged run, take scalar loads in the same
//   kernel.
//
//   Per-row work. With the loads out of the way the kernel is bound by the
//   instructions it executes per row, so what can be decided once is: the
//   launcher turns each compare into a closed int32 range and a negate flag
//   (two compares a row, no switch over the operator), and the operand's
//   source is chosen outside the loop over the run's rows.
//
//   Accumulation. A 64-bit atomicAdd on shared memory is a compare-and-swap
//   loop on this card (ATOMS.CAST.SPIN.64); a 32-bit one is one instruction.
//   So a block's table takes each 64-bit slot as two 32-bit words: the count
//   adds to the low word only (the launcher keeps a block under 2^32 rows), a
//   sum adds its low word, and the thread whose add wraps it carries one into
//   the high word together with the value's own high word (nothing, for
//   values of 32 bits or fewer).
//
//   Table. When the (1+S) x K slots fit one block's shared memory (227 KB),
//   each block has a private table, one block of 1024 threads an SM (512
//   above two sums) so that few tables are flushed, and adds its non-zero
//   slots to the global table when it is done; otherwise 64-bit atomics go
//   straight to the global table (groupby_agg.table_in_shared_memory). A
//   table split over a thread-block cluster of 8, added to through
//   distributed shared memory, was built and measured for K = 100 000 and was
//   no faster than the global table (see PERF.md), so it is not kept.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define EVQL_MAX_SUMS 8

// stream element kinds
enum { DT_I16 = 0, DT_U16 = 1, DT_I32 = 2, DT_I64 = 3, DT_U8 = 4 };
// compare ops
enum { OP_LT = 0, OP_LE = 1, OP_GT = 2, OP_GE = 3, OP_EQ = 4, OP_NE = 5 };
// predicate operand sources
enum { SRC_NONE = 0, SRC_GID = 1, SRC_VALUE = 2, SRC_STREAM = 3 };

typedef unsigned long long u64;

// one compare, as the launcher hands it to the kernel: keep the row iff
// (lo <= operand <= hi) != negate
struct RangePred {
  const void* stream;
  int dt;
  int src;
  int32_t lo, hi;
  int negate;
};

struct AggParams {
  const void* gid;
  int gid_dt;
  const uint8_t* mask;  // optional, 1 byte per row
  RangePred pred[2];
  int combine_or;
  const void* val[EVQL_MAX_SUMS];
  int val_dt[EVQL_MAX_SUMS];
  u64 val_mask[EVQL_MAX_SUMS];
  int32_t gid_base;
  long long n;
  int K;
  int vec;   // every stream starts on a 16-byte boundary
  u64* out;  // [(1+S) * K]: counts, then one plane per sum
};

__device__ __forceinline__ long long load_ext(const void* p, int dt, long long i) {
  switch (dt) {
    case DT_I16: return (long long)((const int16_t*)p)[i];
    case DT_U16: return (long long)((const uint16_t*)p)[i];
    case DT_I32: return (long long)((const int32_t*)p)[i];
    case DT_I64: return ((const long long*)p)[i];
    default: return (long long)((const uint8_t*)p)[i];
  }
}

__device__ __forceinline__ long long ext16(uint32_t h, bool is_signed) {
  return is_signed ? (long long)(int16_t)h : (long long)h;
}

// R consecutive rows of one stream from row0 on, sign- or zero-extended.
// `vec` (uniform over the grid) and a whole run take vector loads; otherwise
// rows >= cnt read as 0 and are dropped by the caller's keep bits.
template <int R>
__device__ __forceinline__ void load_run(const void* p, int dt, long long row0, int cnt,
                                         bool vec, long long (&out)[R]) {
  static_assert(R == 4 || R == 8, "a run is 4 or 8 rows");
  if (vec && cnt == R) {
    switch (dt) {
      case DT_I16:
      case DT_U16: {
        uint32_t w[R / 2];
        const uint16_t* q = (const uint16_t*)p + row0;
        if constexpr (R == 8) {
          const uint4 x = __ldg((const uint4*)q);
          w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
        } else {
          const uint2 x = __ldg((const uint2*)q);
          w[0] = x.x; w[1] = x.y;
        }
        const bool is_signed = dt == DT_I16;
#pragma unroll
        for (int i = 0; i < R / 2; ++i) {
          out[2 * i] = ext16(w[i] & 0xFFFFu, is_signed);
          out[2 * i + 1] = ext16(w[i] >> 16, is_signed);
        }
        return;
      }
      case DT_I32: {
        const int4* q = (const int4*)((const int32_t*)p + row0);
#pragma unroll
        for (int j = 0; j < R / 4; ++j) {
          const int4 x = __ldg(q + j);
          out[4 * j] = x.x; out[4 * j + 1] = x.y;
          out[4 * j + 2] = x.z; out[4 * j + 3] = x.w;
        }
        return;
      }
      case DT_I64: {
        const longlong2* q = (const longlong2*)((const long long*)p + row0);
#pragma unroll
        for (int j = 0; j < R / 2; ++j) {
          const longlong2 x = __ldg(q + j);
          out[2 * j] = x.x; out[2 * j + 1] = x.y;
        }
        return;
      }
      default: {
        uint32_t w[R / 4];
        const uint8_t* q = (const uint8_t*)p + row0;
        if constexpr (R == 8) {
          const uint2 x = __ldg((const uint2*)q);
          w[0] = x.x; w[1] = x.y;
        } else {
          w[0] = __ldg((const uint32_t*)q);
        }
#pragma unroll
        for (int i = 0; i < R; ++i) out[i] = (w[i / 4] >> (8 * (i % 4))) & 0xFFu;
        return;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = r < cnt ? load_ext(p, dt, row0 + r) : 0;
}

// compare j over the run, one bit a row: its operand is the key before the
// base subtract, the first value stream as loaded (before the value_bits
// mask), or a stream of its own
template <int R>
__device__ __forceinline__ unsigned pred_bits(const RangePred& q, long long row0, int cnt,
                                              bool vec, const int32_t (&gid)[R],
                                              const long long (&v0)[R]) {
  const int32_t lo = q.lo, hi = q.hi;
  unsigned bits = 0;
  if (q.src == SRC_GID) {
#pragma unroll
    for (int r = 0; r < R; ++r) bits |= (unsigned)(gid[r] >= lo && gid[r] <= hi) << r;
  } else if (q.src == SRC_VALUE) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int32_t a = (int32_t)v0[r];
      bits |= (unsigned)(a >= lo && a <= hi) << r;
    }
  } else {
    long long own[R];
    load_run<R>(q.stream, q.dt, row0, cnt, vec, own);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int32_t a = (int32_t)own[r];
      bits |= (unsigned)(a >= lo && a <= hi) << r;
    }
  }
  return q.negate ? ~bits : bits;
}

// count and sums of one row into the block's table of 32-bit word pairs;
// `K` slots a plane
template <int S>
__device__ __forceinline__ void add_words(uint32_t* t32, int K, uint32_t bucket,
                                          const u64 (&v)[S > 0 ? S : 1]) {
  atomicAdd(&t32[2 * bucket], 1u);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    uint32_t* w = &t32[2 * ((1 + s) * K + bucket)];
    const uint32_t lo = (uint32_t)v[s];
    uint32_t hi = (uint32_t)(v[s] >> 32);
    if (lo) hi += (uint32_t)(atomicAdd(w, lo) + lo < lo);  // this add wrapped
    if (hi) atomicAdd(w + 1, hi);
  }
}

constexpr int threads_for(int S) { return S <= 2 ? 1024 : 512; }

template <int S, int R, bool SHARED>
__global__ void __launch_bounds__(threads_for(S)) agg_kernel(const AggParams p) {
  extern __shared__ u64 table[];
  const int K = p.K;
  const int slots = (1 + S) * K;
  if (SHARED) {
    for (int i = threadIdx.x; i < slots; i += blockDim.x) table[i] = 0ULL;
    __syncthreads();
  }

  const bool vec = p.vec != 0;
  const long long runs = (p.n + R - 1) / R;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long run = (long long)blockIdx.x * blockDim.x + threadIdx.x; run < runs;
       run += stride) {
    const long long row0 = run * R;
    const long long left = p.n - row0;
    const int cnt = left < R ? (int)left : R;

    long long tmp[R];
    int32_t gid[R];
    load_run<R>(p.gid, p.gid_dt, row0, cnt, vec, tmp);
#pragma unroll
    for (int r = 0; r < R; ++r) gid[r] = (int32_t)tmp[r];
    long long v[S > 0 ? S : 1][R];
#pragma unroll
    for (int s = 0; s < S; ++s) load_run<R>(p.val[s], p.val_dt[s], row0, cnt, vec, v[s]);

    unsigned keep = (1u << cnt) - 1u;
    if (p.mask) {
      load_run<R>(p.mask, DT_U8, row0, cnt, vec, tmp);
#pragma unroll
      for (int r = 0; r < R; ++r) keep &= ~((tmp[r] == 0 ? 1u : 0u) << r);
    }
    if (p.pred[0].src != SRC_NONE) {
      unsigned c = pred_bits<R>(p.pred[0], row0, cnt, vec, gid, v[0]);
      if (p.pred[1].src != SRC_NONE) {
        const unsigned c1 = pred_bits<R>(p.pred[1], row0, cnt, vec, gid, v[0]);
        c = p.combine_or ? (c | c1) : (c & c1);
      }
      keep &= c;
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t bucket = (uint32_t)gid[r] - (uint32_t)p.gid_base;
      if (!((keep >> r) & 1u) || bucket >= (uint32_t)K) continue;
      u64 add[S > 0 ? S : 1];
#pragma unroll
      for (int s = 0; s < S; ++s) add[s] = (u64)v[s][r] & p.val_mask[s];
      if (SHARED) {
        add_words<S>((uint32_t*)table, K, bucket, add);
      } else {
        atomicAdd(&p.out[bucket], 1ULL);
#pragma unroll
        for (int s = 0; s < S; ++s) atomicAdd(&p.out[(size_t)(1 + s) * K + bucket], add[s]);
      }
    }
  }

  if (SHARED) {
    __syncthreads();
    // a word pair lies as one little-endian 64-bit slot
    for (int i = threadIdx.x; i < slots; i += blockDim.x) {
      const u64 t = table[i];
      if (t) atomicAdd(&p.out[i], t);
    }
  }
}

namespace {

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// `operand <op> thr` as a closed range and a negate flag
RangePred range_pred(const void* stream, int dt, int src, int op, int32_t thr) {
  RangePred q = {stream, dt, src, INT_MIN, INT_MAX, 0};
  const RangePred never = {stream, dt, src, 0, -1, 0};
  switch (op) {
    case OP_LT: if (thr == INT_MIN) return never; q.hi = thr - 1; break;
    case OP_LE: q.hi = thr; break;
    case OP_GT: if (thr == INT_MAX) return never; q.lo = thr + 1; break;
    case OP_GE: q.lo = thr; break;
    case OP_NE: q.negate = 1;  // fall through: not (thr <= operand <= thr)
    default: q.lo = q.hi = thr; break;
  }
  return q;
}

template <int S, int R, bool SHARED>
int launch_form(const AggParams& p, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;

  auto kernel = agg_kernel<S, R, SHARED>;
  const int threads = threads_for(S);
  const size_t smem = SHARED ? (size_t)(1 + S) * (size_t)p.K * sizeof(u64) : 0;
  if (smem > 48 * 1024) {
    // more than the device lets a block opt in to is refused here
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;

  // two runs a thread, or as many blocks as the card holds at once
  const long long per_block = (long long)threads * R * 2;
  const long long want = (p.n + per_block - 1) / per_block;
  const long long cap = (long long)sms * per_sm;
  const long long blocks = want < cap ? want : cap;
  // a block's 32-bit count words must not wrap
  if (p.n / blocks >= (1LL << 32)) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int S>
int launch(AggParams p, int shared, cudaStream_t stream) {
  if (p.n <= 0 || p.K <= 0) return 0;
  constexpr int R = S <= 2 ? 8 : 4;
  bool vec = aligned16(p.gid) && aligned16(p.mask) && aligned16(p.pred[0].stream) &&
             aligned16(p.pred[1].stream);
  for (int s = 0; s < S; ++s) vec = vec && aligned16(p.val[s]);
  p.vec = vec ? 1 : 0;
  return shared ? launch_form<S, R, true>(p, stream) : launch_form<S, R, false>(p, stream);
}

int launch_s(int nsums, const AggParams& p, int shared, cudaStream_t st) {
  switch (nsums) {
    case 0: return launch<0>(p, shared, st);
    case 1: return launch<1>(p, shared, st);
    case 2: return launch<2>(p, shared, st);
    case 3: return launch<3>(p, shared, st);
    case 4: return launch<4>(p, shared, st);
    case 5: return launch<5>(p, shared, st);
    case 6: return launch<6>(p, shared, st);
    case 7: return launch<7>(p, shared, st);
    case 8: return launch<8>(p, shared, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The shared memory one block of the current device may opt in to, in bytes:
// what the wrapper's choice of the table form rests on.
extern "C" int evql_groupby_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// count (+ one sum) with up to two in-kernel compares: the fused route.
// values == nullptr selects the count-only form. `out` is a zeroed
// u64[(1 + has_values) * K] table on the device; `shared` != 0 keeps each
// block's table in shared memory, which (1 + has_values) * K * 8 bytes must fit.
extern "C" int evql_groupby_agg(
    const void* gid, int gid_dt, const void* mask,
    const void* pred1, int pred1_dt, int pred1_src, int pred1_op, int thr1,
    const void* pred2, int pred2_dt, int pred2_src, int pred2_op, int thr2,
    int combine_or,
    const void* values, int values_dt, unsigned long long values_mask,
    int gid_base, long long n, int K, int shared, void* out, void* stream) {
  AggParams p = {};
  p.gid = gid;
  p.gid_dt = gid_dt;
  p.mask = (const uint8_t*)mask;
  p.pred[0] = range_pred(pred1, pred1_dt, pred1_src, pred1_op, thr1);
  p.pred[1] = range_pred(pred2, pred2_dt, pred2_src, pred2_op, thr2);
  p.combine_or = combine_or;
  p.val[0] = values; p.val_dt[0] = values_dt; p.val_mask[0] = values_mask;
  p.gid_base = gid_base;
  p.n = n;
  p.K = K;
  p.out = (u64*)out;
  return launch_s(values ? 1 : 0, p, shared, (cudaStream_t)stream);
}

// count + S sums under one pass, rows selected by a byte mask: the
// multi-sum route. `out` is a zeroed u64[(1 + nsums) * K] table.
extern "C" int evql_groupby_multi_agg(
    const void* gid, int gid_dt, const void* mask,
    int nsums, const void* const* vals, const int* val_dts,
    const unsigned long long* val_masks,
    long long n, int K, int shared, void* out, void* stream) {
  if (nsums < 1 || nsums > EVQL_MAX_SUMS) return (int)cudaErrorInvalidValue;
  AggParams p = {};
  p.gid = gid;
  p.gid_dt = gid_dt;
  p.mask = (const uint8_t*)mask;
  for (int s = 0; s < nsums; ++s) {
    p.val[s] = vals[s];
    p.val_dt[s] = val_dts[s];
    p.val_mask[s] = val_masks[s];
  }
  p.n = n;
  p.K = K;
  p.out = (u64*)out;
  return launch_s(nsums, p, shared, (cudaStream_t)stream);
}
