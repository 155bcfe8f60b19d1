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
// reads only a). Design: an exact grid, no grid-stride loop: a block takes
// kFormBlock elements, each thread kFormVecs groups of four neighbouring
// elements (neighbouring threads on neighbouring groups), and starts all
// its loads of a (and of b, except in form 2) before the first compare,
// then stores as many groups: with the three arrays on a 16-byte boundary
// a group is one 16-byte load or store, 64 bytes of loads a stream in
// flight a thread; a group that runs past n, or any group when an array
// lies off the boundary, goes as masked scalars. Offsets inside a block
// are 32-bit. Loads take the read-only path (__ldg); stores carry the
// streaming hint (__stcs: nothing is read back). With streaming loads as
// well, its speed depended on where the output lay; with these hints it
// does not. The case is a template parameter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowWords = 128;             // 32-bit words a row
constexpr int kRowVecs = kRowWords / 4;    // 16-byte words a row: one a lane
constexpr int kSegRows = 8;                // rows a warp copies: 4 KB
constexpr int kFormThreads = 128;                      // int8_form's block
constexpr int kFormVecs = 4;                           // groups of 4 elements a thread
constexpr int kFormBlock = 4 * kFormThreads * kFormVecs;  // elements a block: 2048

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

// Elements [e, e + 4) of p, those below `here`: one 16-byte load when `vec`
// and all four are there, else masked scalars (0 where there is none).
__device__ __forceinline__ int4 load4(const int32_t* p, int e, int here, bool vec) {
  if (vec && e + 4 <= here) return __ldg(reinterpret_cast<const int4*>(p + e));
  int4 v = make_int4(0, 0, 0, 0);
  if (e < here) v.x = __ldg(p + e);
  if (e + 1 < here) v.y = __ldg(p + e + 1);
  if (e + 2 < here) v.z = __ldg(p + e + 2);
  if (e + 3 < here) v.w = __ldg(p + e + 3);
  return v;
}

__device__ __forceinline__ void store4(int32_t* p, int e, int here, bool vec, int4 v) {
  if (vec && e + 4 <= here) {
    __stcs(reinterpret_cast<int4*>(p + e), v);
    return;
  }
  if (e < here) __stcs(p + e, v.x);
  if (e + 1 < here) __stcs(p + e + 1, v.y);
  if (e + 2 < here) __stcs(p + e + 2, v.z);
  if (e + 3 < here) __stcs(p + e + 3, v.w);
}

// vec: a, b and out all lie on a 16-byte boundary
template <int kCase>
__global__ void __launch_bounds__(kFormThreads)
int8_form_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                 int32_t* __restrict__ out, long long n, bool vec) {
  constexpr bool kReadsB = kCase != 2;
  const long long e0 = (long long)blockIdx.x * kFormBlock;
  const int here = n - e0 < kFormBlock ? (int)(n - e0) : kFormBlock;
  a += e0;
  b += e0;
  out += e0;
  int4 x[kFormVecs], y[kFormVecs];
#pragma unroll
  for (int k = 0; k < kFormVecs; ++k) {
    const int e = 4 * (threadIdx.x + k * kFormThreads);
    x[k] = load4(a, e, here, vec);
    if (kReadsB) y[k] = load4(b, e, here, vec);
  }
#pragma unroll
  for (int k = 0; k < kFormVecs; ++k) {
    const int e = 4 * (threadIdx.x + k * kFormThreads);
    const int4 yk = kReadsB ? y[k] : x[k];
    store4(out, e, here, vec,
           make_int4(form<kCase>(x[k].x, yk.x), form<kCase>(x[k].y, yk.y),
                     form<kCase>(x[k].z, yk.z), form<kCase>(x[k].w, yk.w)));
  }
}

template <int kCase>
cudaError_t launch_form(const int32_t* a, const int32_t* b, int32_t* out, long long n,
                        cudaStream_t st) {
  const long long blocks = (n + kFormBlock - 1) / kFormBlock;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const bool vec = aligned16(a) && aligned16(b) && aligned16(out);
  int8_form_kernel<kCase><<<(unsigned)blocks, kFormThreads, 0, st>>>(a, b, out, n, vec);
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

// Elements a block of evql_int8_form takes.
extern "C" int evql_int8_form_block_elements() { return kFormBlock; }
