// Fact-dim join probes for Hopper (sm_90a): per fact key, the int32 bucket of
// the dimension row with the equal 64-bit key, or -1.
//
// Replaces the two TPU kernels of eventql_tpu/kernels/join.py:
//   _join_kernel         (pallas_dim_join_gid)                  -> evql_dim_join_gid
//   _window_join_kernel  (_window_join_pallas, merge_join_gid)  -> evql_probe_join_gid
//
// What is computed, per row < n: load the fact key at its stored width
// (u16 / u32 / u64, zero-extended), find the dimension key that is equal in
// all 64 bits, write that dimension row's bucket as int32, or -1 when no
// dimension key is equal. Among duplicate dimension keys the lowest dimension
// row wins (evql_dim_join_gid) or the first in the sorted order
// (evql_probe_join_gid); the SQL route never passes duplicates.
//
// Bound: bytes. The fact key is read once and one int32 is written per row,
// the dimension table is read once: n * (key width + 4) + D * 12 bytes over
// the HBM bandwidth.
//
// Design. Both are gather-and-compare kernels over a table that is small
// beside the fact stream, so the table is kept where a gather is cheap and the
// fact stream is covered by a grid-stride loop of coalesced loads.
//
//   evql_dim_join_gid, D <= 8192: every block builds an open-addressed hash
//   table of the whole dimension side in its dynamic shared memory (a power of
//   two of slots, at least 2 * D, 12 bytes a slot: at most 16384 slots =
//   192 KB, under the 227 KB a block may opt in to) straight from the unsorted
//   dimension rows, then probes it: about 1.5 shared-memory reads for a hit
//   at a load of one half, against 13 dependent steps of a binary search over
//   a sorted array of the same size. The build is D inserts a block and is
//   repeated by every block; with a few hundred blocks that is a few million
//   inserts beside 2^26 probes. A table built in the kernel also means the
//   wrapper sorts nothing. Nothing of the TPU design (fingerprints, the
//   (D, B) compare matrix, int8 payload planes and limb recovery) is carried
//   over, and colliding fingerprints are an ordinary input.
//
//   evql_probe_join_gid, any D: the dimension keys arrive sorted (ascending as
//   unsigned 64-bit) with their buckets in the same order, and stay in global
//   memory, where 2^18 x 12 B = 3 MB is resident in the 50 MB L2. Each block
//   copies up to 4096 evenly spaced keys into shared memory; a thread finds
//   its key's interval there (12 steps in shared memory) and finishes the
//   lower-bound search inside that interval in global memory
//   (log2(D / 4096) steps). Facts are probed in row order: the TPU kernel's
//   sorted-facts contract, its windows, its overflow branch and its
//   double-buffered copies have no counterpart. A hash table in global memory
//   built by a kernel of its own would cut the dependent loads further.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

// fact key stream kinds (unsigned payloads; the wrapper passes the signed
// torch tensor of the same bits)
enum { DT_U16 = 1, DT_U32 = 2, DT_U64 = 3 };

#define EVQL_EMPTY_KEY 0xFFFFFFFFFFFFFFFFULL
#define EVQL_MAX_HASH_DIMS 8192
#define EVQL_PROBE_SAMPLES 4096

typedef unsigned long long u64;

__device__ __forceinline__ u64 load_key(const void* p, int dt, long long i) {
  switch (dt) {
    case DT_U16: return (u64)((const uint16_t*)p)[i];
    case DT_U32: return (u64)((const uint32_t*)p)[i];
    default: return ((const u64*)p)[i];
  }
}

// the 64-bit finaliser of MurmurHash3
__device__ __forceinline__ uint32_t slot_hash(u64 k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return (uint32_t)k;
}

// `slots` is a power of two, >= 2 * D. Shared memory: u64 keys[slots], then
// int32 vals[slots]. A slot's value is the dimension row while the table is
// built (atomicMin: the lowest row of a duplicate key wins) and its bucket
// afterwards. The key with all 64 bits set marks an empty slot, so a
// dimension row with that very key lives in a slot of its own.
__global__ void __launch_bounds__(1024)
dim_join_kernel(const void* fact, int fact_dt, long long n, const u64* dim_keys,
                const int32_t* dim_bucket, int D, int slots, int32_t* out) {
  extern __shared__ u64 table_keys[];
  int32_t* table_vals = (int32_t*)(table_keys + slots);
  __shared__ int32_t all_ones_val;
  const uint32_t wrap = (uint32_t)slots - 1u;

  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    table_keys[i] = EVQL_EMPTY_KEY;
    table_vals[i] = INT_MAX;
  }
  if (threadIdx.x == 0) all_ones_val = INT_MAX;
  __syncthreads();

  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const u64 k = dim_keys[d];
    if (k == EVQL_EMPTY_KEY) {
      atomicMin(&all_ones_val, d);
      continue;
    }
    uint32_t s = slot_hash(k) & wrap;
    while (true) {
      const u64 prev = atomicCAS(&table_keys[s], EVQL_EMPTY_KEY, k);
      if (prev == EVQL_EMPTY_KEY || prev == k) {
        atomicMin(&table_vals[s], d);
        break;
      }
      s = (s + 1u) & wrap;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    const int32_t row = table_vals[i];
    if (row != INT_MAX) table_vals[i] = dim_bucket[row];
  }
  if (threadIdx.x == 0) {
    all_ones_val = all_ones_val == INT_MAX ? -1 : dim_bucket[all_ones_val];
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x; row < n;
       row += stride) {
    const u64 k = load_key(fact, fact_dt, row);
    int32_t g = -1;
    if (k == EVQL_EMPTY_KEY) {
      g = all_ones_val;
    } else {
      uint32_t s = slot_hash(k) & wrap;
      while (true) {
        const u64 t = table_keys[s];
        if (t == k) {
          g = table_vals[s];
          break;
        }
        if (t == EVQL_EMPTY_KEY) break;  // the load is at most one half
        s = (s + 1u) & wrap;
      }
    }
    out[row] = g;
  }
}

// `step` dimension rows lie between two samples, `m` = ceil(D / step) samples
// (<= EVQL_PROBE_SAMPLES): sample i is sorted_keys[i * step].
__global__ void __launch_bounds__(512)
probe_join_kernel(const void* fact, int fact_dt, long long n, const u64* sorted_keys,
                  const int32_t* sorted_bucket, int D, int step, int m, int32_t* out) {
  __shared__ u64 samples[EVQL_PROBE_SAMPLES];
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    samples[i] = sorted_keys[(long long)i * step];
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x; row < n;
       row += stride) {
    const u64 k = load_key(fact, fact_dt, row);
    // j = the number of samples below k: the lower bound of k lies in
    // ((j - 1) * step, j * step]
    int lo = 0, hi = m;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (samples[mid] < k) lo = mid + 1; else hi = mid;
    }
    long long a = lo == 0 ? 0 : (long long)(lo - 1) * step + 1;
    long long b = (long long)lo * step;
    if (b > D) b = D;
    while (a < b) {
      const long long mid = (a + b) >> 1;
      if (sorted_keys[mid] < k) a = mid + 1; else b = mid;
    }
    out[row] = (a < D && sorted_keys[a] == k) ? sorted_bucket[a] : -1;
  }
}

namespace {

// blocks that cover the card once at the kernel's own occupancy, or fewer
// when n rows need fewer (four rows a thread)
template <typename Kernel>
int grid_for(Kernel kernel, int threads, size_t smem, long long n, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const long long want = (n + (long long)threads * 4 - 1) / ((long long)threads * 4);
  const long long cap = (long long)sms * per_sm;
  *blocks = (int)(want < cap ? want : cap);
  if (*blocks < 1) *blocks = 1;
  return 0;
}

bool bad_dt(int dt) { return dt != DT_U16 && dt != DT_U32 && dt != DT_U64; }

}  // namespace

// Bucket of the equal dimension key, table in shared memory. dim_keys is
// u64[D] in any order, dim_bucket int32[D], 0 < D <= 8192; out is int32[n].
extern "C" int evql_dim_join_gid(const void* fact, int fact_dt, long long n,
                                 const void* dim_keys, const void* dim_bucket, int D,
                                 void* out, void* stream) {
  if (n <= 0) return 0;
  if (D < 1 || D > EVQL_MAX_HASH_DIMS || bad_dt(fact_dt)) return (int)cudaErrorInvalidValue;
  int slots = 32;
  while (slots < 2 * D) slots <<= 1;
  const size_t smem = (size_t)slots * (sizeof(u64) + sizeof(int32_t));
  // few slots: more, smaller blocks share an SM; many: one block fills it
  const int threads = smem > 64 * 1024 ? 1024 : 512;
  cudaError_t e = cudaFuncSetAttribute(
      dim_join_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  int rc = grid_for(dim_join_kernel, threads, smem, n, &blocks);
  if (rc) return rc;
  dim_join_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      fact, fact_dt, n, (const u64*)dim_keys, (const int32_t*)dim_bucket, D, slots,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

// Bucket of the equal dimension key, sorted table in global memory.
// sorted_keys is u64[D] ascending as unsigned, sorted_bucket int32[D] in the
// same order, D >= 1; out is int32[n].
extern "C" int evql_probe_join_gid(const void* fact, int fact_dt, long long n,
                                   const void* sorted_keys, const void* sorted_bucket,
                                   int D, void* out, void* stream) {
  if (n <= 0) return 0;
  if (D < 1 || bad_dt(fact_dt)) return (int)cudaErrorInvalidValue;
  const int step = (D + EVQL_PROBE_SAMPLES - 1) / EVQL_PROBE_SAMPLES;
  const int m = (D + step - 1) / step;
  const int threads = 512;
  int blocks = 0;
  int rc = grid_for(probe_join_kernel, threads, 0, n, &blocks);
  if (rc) return rc;
  probe_join_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      fact, fact_dt, n, (const u64*)sorted_keys, (const int32_t*)sorted_bucket, D, step,
      m, (int32_t*)out);
  return (int)cudaGetLastError();
}
