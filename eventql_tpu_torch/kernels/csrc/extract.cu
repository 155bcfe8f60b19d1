// Stream compaction of flagged rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel of eventql_tpu/kernels/extract.py:
//   _extract_kernel (extract_ge)  -> evql_extract_ge
//
// What is computed: the ascending indices of the rows < n whose int32 value
// is >= threshold; the first `cap` of them (by row) are written to out[0..),
// the rest of out[0..cap) is -1.
//
// Bound: bytes. The values are read once (4 * n bytes) and cap indices are
// written, so the least time is (4 * n + 4 * cap) / HBM bandwidth; the
// compare is one operation per row.
//
// Design: three launches on one stream, nothing of the TPU design (a
// sequential grid with a cursor, an any?-skip and one argmin per match) is
// carried over.
//   1. count_kernel:   every block counts the matches among its kRowsPerBlock
//                      rows (one int32 per block);
//   2. scan_kernel:    one block turns the nb counts into exclusive offsets
//                      (warp-shuffle scan of per-thread partial sums) and fills
//                      out[0..cap) with -1;
//   3. scatter_kernel: every block that holds a match and whose offset is
//                      below cap reads its rows again, ranks its matches in row
//                      order (ballot + popcount of the lower lanes + the counts
//                      of the lower warps) and writes row at offset + rank while
//                      that is < cap.
// The values are therefore read up to twice; blocks without a match, and
// blocks past the cap, skip the second read. Row order is kept exactly: a
// match's position is the number of matches before it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 16;
constexpr int kRowsPerBlock = kThreads * kIters;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

inline long long num_blocks(long long n) {
  return (n + kRowsPerBlock - 1) / kRowsPerBlock;
}

}  // namespace

__global__ void __launch_bounds__(kThreads)
count_kernel(const int32_t* __restrict__ values, long long n, int32_t threshold,
             int32_t* __restrict__ counts) {
  __shared__ int warp_sum[kWarps];
  const long long start = (long long)blockIdx.x * kRowsPerBlock;
  int c = 0;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const long long row = start + it * kThreads + threadIdx.x;
    if (row < n) c += values[row] >= threshold ? 1 : 0;
  }
  c = __reduce_add_sync(kFull, c);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sum[w];
    counts[blockIdx.x] = total;
  }
}

// offsets[i] = counts[0] + ... + counts[i - 1] for i in [0, nb]; one block.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int32_t* __restrict__ counts, int32_t* __restrict__ offsets,
            int nb, int32_t* __restrict__ out, int cap) {
  __shared__ int warp_total[kScanThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < cap; i += kScanThreads) out[i] = -1;

  // thread t owns the counts [lo, hi)
  const int per = (nb + kScanThreads - 1) / kScanThreads;
  const long long lo_ll = (long long)tid * per;
  const int lo = lo_ll < nb ? (int)lo_ll : nb;
  const int hi = lo + per < nb ? lo + per : nb;
  int own = 0;
  for (int i = lo; i < hi; ++i) own += counts[i];

  int incl = own;  // inclusive scan over the warp's threads
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_total[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += up;
    }
    warp_total[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int base = incl - own + (warp > 0 ? warp_total[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    offsets[i] = base;
    base += counts[i];
  }
  if (tid == kScanThreads - 1) offsets[nb] = base;  // the number of matches
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int32_t* __restrict__ values, long long n, int32_t threshold,
               const int32_t* __restrict__ counts,
               const int32_t* __restrict__ offsets, int32_t* __restrict__ out,
               int cap) {
  __shared__ int warp_count[kWarps];
  int base = offsets[blockIdx.x];
  if (counts[blockIdx.x] == 0 || base >= cap) return;  // the whole block leaves
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long start = (long long)blockIdx.x * kRowsPerBlock;
  for (int it = 0; it < kIters; ++it) {
    const long long row = start + it * kThreads + threadIdx.x;
    const bool match = row < n && values[row] >= threshold;
    const unsigned ballot = __ballot_sync(kFull, match);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int x = warp_count[w];
      if (w < warp) before += x;
      total += x;
    }
    if (match) {
      const int pos = base + before + __popc(ballot & ((1u << lane) - 1u));
      if (pos < cap) out[pos] = (int32_t)row;
    }
    base += total;
    __syncthreads();
    if (base >= cap) break;  // same value in every thread of the block
  }
}

// int32 slots of scratch memory evql_extract_ge needs for n rows: the block
// counts, then one offset per block and the total.
extern "C" long long evql_extract_scratch_ints(long long n) {
  return 2 * num_blocks(n) + 1;
}

// values: int32[>= n]; out: int32[cap]; scratch: int32[evql_extract_scratch_ints(n)].
// 0 < n < 2^31, cap > 0. Returns the CUDA error of the launches, 0 when fine.
extern "C" int evql_extract_ge(const void* values, long long n, int threshold,
                               int cap, void* out, void* scratch, void* stream) {
  if (n <= 0 || n > 0x7FFFFFFFLL || cap <= 0) return (int)cudaErrorInvalidValue;
  const long long nb = num_blocks(n);
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* counts = (int32_t*)scratch;
  int32_t* offsets = counts + nb;
  const int32_t* v = (const int32_t*)values;
  count_kernel<<<(unsigned)nb, kThreads, 0, st>>>(v, n, threshold, counts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_kernel<<<1, kScanThreads, 0, st>>>(counts, offsets, (int)nb, (int32_t*)out, cap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scatter_kernel<<<(unsigned)nb, kThreads, 0, st>>>(v, n, threshold, counts, offsets,
                                                    (int32_t*)out, cap);
  return (int)cudaGetLastError();
}
