// The kernels of the repository's TPU probes (scripts/probe_*.py), for
// Hopper (sm_90a).
//
// Replaces two TPU kernels of scripts/:
//   probe_radix.py    _placement_kernel (placement, :162, call :181) -> evql_place_runs
//   probe_int8_ops.py the five bodies run_case launches (:17, call :20) -> evql_int8_form
// The third probe kernel, probe_groupby_i8.py's _agg_kernel_i8, computes B1's
// contract; its counterpart is evql_groupby_agg (groupby_agg.cu).
//
// evql_place_runs: for each run i < nruns, rows [src_off[i], src_off[i] + rows)
// of src (rows of 128 32-bit words, 512 bytes) are copied to rows
// [dst_off[i], dst_off[i] + rows) of out. A run whose source or destination
// range leaves its array is not copied; rows that no run writes keep their
// values. Bound: bytes. Each copied word is read once and written once, plus
// 8 bytes of offsets a run: (8 * 128 * rows + 8) * nruns / HBM bandwidth.
// Design: the TPU kernel stages each run through VMEM in a serial grid, one
// DMA in and one out a run. Here a warp copies one run of up to kSegRows rows
// (a longer run is cut into pieces of kSegRows rows, one warp each), every
// lane one 16-byte word of each row, all kSegRows loads in flight before the
// first store. Enough warps are in flight to fill the 132 SMs whatever the
// run's length. The offsets live in device memory, so nruns has no cap (the
// TPU's lived in SMEM: at most 65536). Not done: a copy through TMA or
// cp.async.bulk.
//
// evql_int8_form: out[i] = one of five int8 forms of a[i] and b[i], widened
// back to int32, with int8 wrapping as JAX's astype(int8) does:
//   0 select_i8_const  a == b ? 1 : 0
//   1 muli_i8          i8(i8(a) * i8(b))
//   2 convert_i32_i8   i8(a)
//   3 select_i8_value  a == b ? i8(b) : 0
//   4 mul_i32_then_i8  i8(b * (a == b ? 1 : 0))
// Bound: bytes, 12 a element (a and b read, out written; 8 for form 2, which
// reads only a: its load of b is dead code). Design: one
// grid-stride pass, four elements a thread from 16-byte loads when the three
// arrays start on a 16-byte boundary (scalar loads otherwise), the case a
// template parameter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowWords = 128;             // 32-bit words a row
constexpr int kRowVecs = kRowWords / 4;    // 16-byte words a row: one a lane
constexpr int kSegRows = 8;                // rows a warp copies: 4 KB
constexpr int kMaxBlocks = 132 * 32;       // grid-stride cap of the elementwise kernel

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
place_runs_kernel(const int32_t* __restrict__ src, long long src_rows,
                  const int32_t* __restrict__ src_off, const int32_t* __restrict__ dst_off,
                  long long nruns, int rows, int segs, int32_t* __restrict__ out,
                  long long out_rows) {
  const long long task = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (task >= nruns * segs) return;
  const long long run = task / segs;
  const int r0 = (int)(task - run * segs) * kSegRows;
  const long long s = src_off[run];
  const long long d = dst_off[run];
  // the same for every lane of the warp
  if (s < 0 || d < 0 || s + rows > src_rows || d + rows > out_rows) return;
  const int nr = rows - r0 < kSegRows ? rows - r0 : kSegRows;
  const int lane = threadIdx.x & 31;
  if (kVec) {
    const uint4* from = reinterpret_cast<const uint4*>(src + (s + r0) * kRowWords) + lane;
    uint4* to = reinterpret_cast<uint4*>(out + (d + r0) * kRowWords) + lane;
    uint4 buf[kSegRows];
#pragma unroll
    for (int r = 0; r < kSegRows; ++r)
      if (r < nr) buf[r] = __ldg(from + r * kRowVecs);
#pragma unroll
    for (int r = 0; r < kSegRows; ++r)
      if (r < nr) to[r * kRowVecs] = buf[r];
  } else {
    const int32_t* from = src + (s + r0) * kRowWords + lane;
    int32_t* to = out + (d + r0) * kRowWords + lane;
    for (int r = 0; r < nr; ++r) {
      int32_t buf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) buf[j] = __ldg(from + r * kRowWords + 32 * j);
#pragma unroll
      for (int j = 0; j < 4; ++j) to[r * kRowWords + 32 * j] = buf[j];
    }
  }
}

__device__ __forceinline__ int32_t wrap8(int32_t x) { return (int32_t)(int8_t)(x & 0xFF); }

template <int kCase>
__device__ __forceinline__ int32_t form(int32_t a, int32_t b) {
  if (kCase == 0) return a == b ? 1 : 0;
  if (kCase == 1) return wrap8(wrap8(a) * wrap8(b));
  if (kCase == 2) return wrap8(a);
  if (kCase == 3) return a == b ? wrap8(b) : 0;
  return wrap8(b * (a == b ? 1 : 0));
}

template <int kCase, bool kVec>
__global__ void __launch_bounds__(kThreads)
int8_form_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                 int32_t* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;
  if (kVec) {
    const long long nvec = n / 4;
    const int4* a4 = reinterpret_cast<const int4*>(a);
    const int4* b4 = reinterpret_cast<const int4*>(b);
    int4* o4 = reinterpret_cast<int4*>(out);
    for (long long i = tid; i < nvec; i += stride) {
      const int4 x = __ldg(a4 + i);
      const int4 y = __ldg(b4 + i);
      o4[i] = make_int4(form<kCase>(x.x, y.x), form<kCase>(x.y, y.y),
                        form<kCase>(x.z, y.z), form<kCase>(x.w, y.w));
    }
    done = nvec * 4;
  }
  for (long long i = done + tid; i < n; i += stride) out[i] = form<kCase>(a[i], b[i]);
}

template <int kCase>
cudaError_t launch_form(const int32_t* a, const int32_t* b, int32_t* out, long long n,
                        cudaStream_t st) {
  const bool vec = aligned16(a) && aligned16(b) && aligned16(out);
  const long long items = vec ? (n + 3) / 4 : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (vec)
    int8_form_kernel<kCase, true><<<(unsigned)blocks, kThreads, 0, st>>>(a, b, out, n);
  else
    int8_form_kernel<kCase, false><<<(unsigned)blocks, kThreads, 0, st>>>(a, b, out, n);
  return cudaGetLastError();
}

}  // namespace

// src: int32[src_rows, 128]; src_off, dst_off: int32[nruns]; out:
// int32[out_rows, 128], not overlapping src. rows >= 1. Returns the CUDA
// error of the launch, 0 when fine (nruns == 0 launches nothing).
extern "C" int evql_place_runs(const void* src, long long src_rows, const void* src_off,
                               const void* dst_off, long long nruns, int rows, void* out,
                               long long out_rows, void* stream) {
  if (rows < 1 || nruns < 0 || src_rows < 0 || out_rows < 0) return (int)cudaErrorInvalidValue;
  if (nruns == 0) return 0;
  const int segs = (rows + kSegRows - 1) / kSegRows;
  const long long blocks = (nruns * segs + kWarps - 1) / kWarps;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* s = (const int32_t*)src;
  int32_t* o = (int32_t*)out;
  if (aligned16(src) && aligned16(out))
    place_runs_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(
        s, src_rows, (const int32_t*)src_off, (const int32_t*)dst_off, nruns, rows, segs, o,
        out_rows);
  else
    place_runs_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(
        s, src_rows, (const int32_t*)src_off, (const int32_t*)dst_off, nruns, rows, segs, o,
        out_rows);
  return (int)cudaGetLastError();
}

// a, b, out: int32[n]; kase 0..4 (the table above). Returns the CUDA error
// of the launch, 0 when fine (n == 0 launches nothing).
extern "C" int evql_int8_form(const void* a, const void* b, void* out, long long n, int kase,
                              void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int32_t* x = (const int32_t*)a;
  const int32_t* y = (const int32_t*)b;
  int32_t* o = (int32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kase) {
    case 0: return (int)launch_form<0>(x, y, o, n, st);
    case 1: return (int)launch_form<1>(x, y, o, n, st);
    case 2: return (int)launch_form<2>(x, y, o, n, st);
    case 3: return (int)launch_form<3>(x, y, o, n, st);
    case 4: return (int)launch_form<4>(x, y, o, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
