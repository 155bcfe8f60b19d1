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
// Design: one launch, one pass over the values, with decoupled look-back
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016). Each block claims the next tile of kTileRows rows from
// an atomic tile counter (so a tile only ever waits on tiles that are
// already running) and loads it with kVecs 16-byte loads a thread, all in
// flight before the first compare. It ranks its matches in row order: each
// thread's count in each of its kVecs strips (__popc of a 4-bit compare
// mask) is an 8-bit field, four strips a word, so one shuffle scan of two
// words ranks a warp's rows in every strip at once, and one pass over the
// warps' sums in shared memory does the rest (three __syncthreads a tile:
// the claim, the warp sums, the prefix). The tile publishes its count in
// its 64-bit status word; its first warp reads the status words of the 32
// tiles before it and adds their counts back to the nearest inclusive
// prefix (going 32 tiles further back while there is none), waiting only
// on the tiles up to that prefix. The tile then publishes its own
// inclusive prefix and writes each match at prefix + rank while that is
// < cap, from the registers: no second read. The last tile writes the -1
// padding of out[total..cap), so every output word is written once.
//
// The state (the tile counter and one status word a tile) outlives the
// call, so that no launch has to reset it: the counter only grows, and the
// caller passes its value at the call (`base`, the tiles of the earlier
// calls on this state); every status word carries the call's `epoch` (30
// bits, never 0), and a word of another epoch reads as unpublished. Calls
// that share a state run in stream order.
//
// The values' base may lie off a 16-byte boundary: the tiles are cut from
// the 16-byte-aligned address at or below it, and the vectors that hold
// rows outside [0, n) (the head before row 0, the ragged tail) are read
// as masked scalars. Counts at or above cap are published as cap: a tile
// whose prefix is already >= cap writes nothing, and one that finds its
// predecessor's inclusive prefix >= cap on arrival publishes cap without
// reading its values. Row order is kept exactly: a match's position is the
// number of matches before it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 6;                  // blocks an SM: at most 40 registers a thread
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 8;                       // 16-byte loads a thread
constexpr int kStripRows = kThreads * 4;       // one load of every thread
constexpr int kTileRows = kStripRows * kVecs;  // 8192 rows a tile
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kMaxEpoch = (1u << 30) - 1;

// a tile's status word: (epoch << 2 | flag) in the high 32 bits, a count in
// the low 32; flag 0 (or another epoch): not published yet
constexpr unsigned kAggregate = 1;  // the count of the tile's own matches
constexpr unsigned kInclusive = 2;  // the count up to and with the tile

// tiles for n rows whose first row lies `skew` int32 past a 16-byte boundary
inline long long num_tiles(long long n, int skew) {
  return (n + skew + kTileRows - 1) / kTileRows;
}

__device__ __forceinline__ unsigned long long status_word(unsigned epoch, unsigned flag,
                                                          unsigned count) {
  return (unsigned long long)(epoch << 2 | flag) << 32 | count;
}

// the word's flag if it belongs to this epoch, else 0
__device__ __forceinline__ unsigned flag_of(unsigned long long s, unsigned epoch) {
  const unsigned hi = (unsigned)(s >> 32);
  return hi >> 2 == epoch ? hi & 3u : 0u;
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// strip k's 16-bit field of the per-warp sums (see compact_kernel)
__device__ __forceinline__ unsigned field16(const unsigned (&w)[4], int k) {
  return (w[(k >> 2) * 2 + (k & 1)] >> (16 * ((k >> 1) & 1))) & 0xFFFFu;
}

// Start this thread's loads of tile `tile` into v: 16-byte loads where the
// word's four rows lie in [0, n), masked scalars elsewhere (the head
// before row 0 of a base off a 16-byte boundary, the ragged tail); bit
// 4 k + j of the returned mask: element j of strip k is a row.
__device__ __forceinline__ unsigned load_tile(const int32_t* __restrict__ values, long long n,
                                              int skew, unsigned tile, int4 (&v)[kVecs]) {
  const long long first = (long long)tile * kTileRows - skew;
  const int4* vec = reinterpret_cast<const int4*>(values - skew) +
                    (long long)tile * (kTileRows / 4) + threadIdx.x;
  if (first >= 0 && first + kTileRows <= n) {
#pragma unroll
    for (int k = 0; k < kVecs; ++k) v[k] = __ldg(vec + k * kThreads);
    return kFull;
  }
  unsigned valid = 0;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long r = first + k * kStripRows + 4 * threadIdx.x;
    if (r >= 0 && r + 4 <= n) {
      v[k] = __ldg(vec + k * kThreads);
      valid |= 0xFu << (4 * k);
    } else {
      int e[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (r + j >= 0 && r + j < n) {
          e[j] = __ldg(values + r + j);
          valid |= 1u << (4 * k + j);
        }
      }
      v[k] = make_int4(e[0], e[1], e[2], e[3]);
    }
  }
  return valid;
}

// The exclusive prefix of tile `tile` > 0, read by one warp: lane i reads
// the status word of the tile i + 1 places back (a tile before 0 counts as
// an inclusive prefix of 0); the warp adds the counts from the nearest
// predecessor to the nearest inclusive prefix, rereading while one of
// those is unpublished, and goes 32 tiles further back while there is no
// inclusive prefix. The sum is at most cap plus the counts of fewer than
// n rows, so below 2^32.
__device__ __forceinline__ unsigned look_back(const unsigned long long* status, unsigned tile,
                                              unsigned epoch, int lane) {
  unsigned excl = 0;
  long long pred = (long long)tile - 1 - lane;
  while (true) {
    unsigned long long s;
    unsigned found;
    int stop;
    while (true) {
      s = pred >= 0 ? load_status(status + pred) : status_word(epoch, kInclusive, 0);
      const unsigned flag = flag_of(s, epoch);
      found = __ballot_sync(kFull, flag == kInclusive);
      stop = found ? __ffs(found) - 1 : 31;  // the nearest lane holding one
      if (!__any_sync(kFull, lane <= stop && flag == 0)) break;
    }
    excl += __reduce_add_sync(kFull, lane <= stop ? (unsigned)s : 0u);
    if (found) return excl;
    pred -= 32;
  }
}

}  // namespace

// state[0]: the tile counter (base at the call); state[1 + t]: tile t's
// status word. tiles = num_tiles(n, skew).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
compact_kernel(const int32_t* __restrict__ values, long long n, int skew,
               int32_t threshold, unsigned long long* __restrict__ state,
               unsigned long long base, unsigned epoch, unsigned tiles,
               int32_t* __restrict__ out, unsigned cap) {
  __shared__ unsigned sh_tile, sh_skip, sh_excl, sh_pad;
  __shared__ unsigned warp_sums[kWarps][2];
  unsigned long long* status = state + 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) {
    const unsigned t = (unsigned)(atomicAdd(state, 1ull) - base);
    unsigned skip = 0;
    if (t > 0) {
      const unsigned long long p = load_status(status + t - 1);
      skip = flag_of(p, epoch) == kInclusive && (unsigned)p >= cap;
    }
    sh_tile = t;
    sh_skip = skip;
  }
  __syncthreads();
  const unsigned tile = sh_tile;
  if (tile >= tiles) return;  // a claim past this call's tiles: the state is out of step
  if (sh_skip) {  // the cap was reached before this tile
    if (tid == 0) store_status(status + tile, status_word(epoch, kInclusive, cap));
    return;
  }
  int4 v[kVecs];
  const unsigned valid = load_tile(values, n, skew, tile, v);
  unsigned bits = 0;  // bit 4 k + j: element j of strip k matches
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    bits |= (v[k].x >= threshold ? 1u : 0u) << (4 * k);
    bits |= (v[k].y >= threshold ? 2u : 0u) << (4 * k);
    bits |= (v[k].z >= threshold ? 4u : 0u) << (4 * k);
    bits |= (v[k].w >= threshold ? 8u : 0u) << (4 * k);
  }
  bits &= valid;

  // per strip, the thread's count (0..4) in an 8-bit field: strips 0-3 in
  // own[0], 4-7 in own[1]; a warp's inclusive scan stays below 129 a field
  unsigned own[2] = {0, 0};
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
    own[k >> 2] |= (unsigned)__popc((bits >> (4 * k)) & 0xFu) << (8 * (k & 3));
  unsigned incl[2] = {own[0], own[1]};
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned u0 = __shfl_up_sync(kFull, incl[0], d);
    const unsigned u1 = __shfl_up_sync(kFull, incl[1], d);
    if (lane >= d) {
      incl[0] += u0;
      incl[1] += u1;
    }
  }
  if (lane == 31) {
    warp_sums[warp][0] = incl[0];
    warp_sums[warp][1] = incl[1];
  }
  __syncthreads();

  // the strips' counts over the lower warps and over all warps, widened to
  // 16-bit fields (at most 1024 a strip): word 2 h + p holds the strips
  // 4 h + p (low half) and 4 h + p + 2 (high half)
  unsigned before[4] = {0, 0, 0, 0}, total[4] = {0, 0, 0, 0};
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned x = warp_sums[w][h];
      const unsigned lo = x & 0x00FF00FFu, hi = (x >> 8) & 0x00FF00FFu;
      total[2 * h] += lo;
      total[2 * h + 1] += hi;
      if (w < warp) {
        before[2 * h] += lo;
        before[2 * h + 1] += hi;
      }
    }
  }
  if (warp == 0) {
    unsigned agg = 0;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) agg += field16(total, k);
    unsigned excl = 0;
    if (tile > 0) {
      if (lane == 0) store_status(status + tile, status_word(epoch, kAggregate, agg));
      excl = look_back(status, tile, epoch, lane);
    }
    const unsigned upto = excl + agg < cap ? excl + agg : cap;
    if (lane == 0) {
      store_status(status + tile, status_word(epoch, kInclusive, upto));
      sh_excl = excl;
      sh_pad = upto;  // the last tile's: where the -1 padding starts
    }
  }
  __syncthreads();
  const unsigned excl = sh_excl;
  if (tile == tiles - 1)
    for (unsigned i = sh_pad + tid; i < cap; i += kThreads) out[i] = -1;
  if (excl >= cap) return;

  const long long first = (long long)tile * kTileRows - skew;
  unsigned strip_base = excl;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    unsigned m = (bits >> (4 * k)) & 0xFu;
    if (m) {
      unsigned pos = strip_base + field16(before, k) +
                     (((incl[k >> 2] - own[k >> 2]) >> (8 * (k & 3))) & 0xFFu);
      const int row = (int)(first + k * kStripRows + 4 * tid);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((m >> j) & 1u) {
          if (pos < cap) out[pos] = row + j;
          ++pos;
        }
      }
    }
    strip_base += field16(total, k);
  }
}

// 64-bit words of state evql_extract_ge needs for n rows: the tile counter
// and one status word a tile, for a base at any skew.
extern "C" long long evql_extract_state_words(long long n) { return 1 + num_tiles(n, 3); }

// The largest epoch a call may pass; past it the caller zeroes the state.
extern "C" unsigned evql_extract_max_epoch() { return kMaxEpoch; }

// Rows a tile (a block's claim) holds.
extern "C" int evql_extract_tile_rows() { return kTileRows; }

// values: int32[>= n], 4-byte aligned; out: int32[cap]; state: 8-byte
// aligned, at least evql_extract_state_words(n) words, zeroed before its
// first call, its counter `base` now (the sum of what the earlier calls on
// it returned); 0 < epoch <= evql_extract_max_epoch(), none of the earlier
// calls' since the state was zeroed. 0 < n < 2^31, cap > 0. Returns the
// number of tiles the call claims, or minus the CUDA error of the launch;
// an error pending from an earlier call also reads so, with the kernel
// enqueued all the same, so after any error the caller zeroes the state.
extern "C" long long evql_extract_ge(const void* values, long long n, int threshold, int cap,
                                     void* out, void* state, unsigned long long base,
                                     unsigned epoch, void* stream) {
  if (n <= 0 || n > 0x7FFFFFFFLL || cap <= 0 || ((uintptr_t)values & 3) ||
      ((uintptr_t)state & 7) || epoch == 0 || epoch > kMaxEpoch)
    return -(long long)cudaErrorInvalidValue;
  const int skew = (int)(((uintptr_t)values >> 2) & 3);
  const long long nb = num_tiles(n, skew);
  compact_kernel<<<(unsigned)nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)values, n, skew, threshold, (unsigned long long*)state, base, epoch,
      (unsigned)nb, (int32_t*)out, (unsigned)cap);
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? nb : -(long long)e;
}
