// Fact-dim join probes for Hopper (sm_90a): per fact key, the int32 bucket of
// the dimension row with the equal 64-bit key, or -1.
//
// Replaces the two TPU kernels of eventql_tpu/kernels/join.py:
//   _join_kernel         (pallas_dim_join_gid)                  -> evql_dim_join_gid
//   _window_join_kernel  (_window_join_pallas, merge_join_gid)  -> evql_build_join_table
//                                                                  + evql_probe_join_table
//
// What is computed, per row < n: load the fact key at its stored width
// (u16 / u32 / u64, zero-extended), find the dimension key that is equal in
// all 64 bits, write that dimension row's bucket as int32, or -1 when no
// dimension key is equal. The dimension rows come in any order; among
// duplicate dimension keys the lowest dimension row wins (the SQL route never
// passes duplicates).
//
// Bound: bytes. The fact key is read once and one int32 is written per row,
// the dimension table is read once: n * (key width + 4) + D * 12 bytes over
// the HBM bandwidth.
//
// Design. Both are gather-and-compare kernels over a table that is small
// beside the fact stream, so the table is an open-addressed hash table (a
// power of two of slots, at least 2 * D, linear probing) kept where a gather
// is cheap, and built on the card from the unsorted dimension rows: atomicCAS
// claims a slot's key, atomicMin keeps the lowest row of a duplicate key, and
// a last pass turns rows into buckets. The key with all 64 bits set marks an
// empty slot, so a dimension row with that very key lives in a slot of its
// own. The wrapper sorts nothing. Nothing of the TPU designs (fingerprints,
// the (D, B) compare matrix, int8 payload planes and limb recovery; sorted
// facts, windows, the overflow branch, double-buffered copies) is carried
// over, and colliding fingerprints are an ordinary input.
//
//   evql_dim_join_gid, D <= 8192: every block builds the table of the whole
//   dimension side in its dynamic shared memory (12 bytes a slot: at most
//   16384 slots = 192 KB, under the 227 KB a block may opt in to), then probes
//   it: about 1.5 shared-memory reads for a hit at a load of one half. The
//   build is D inserts a block and is repeated by every block; with a few
//   hundred blocks that is a few million inserts beside 2^26 probes.
//
//   evql_build_join_table + evql_probe_join_table, any D: the table lies in
//   global memory, 16 bytes a slot {u64 key, int32 bucket, pad} so that key
//   and bucket arrive in one aligned 16-byte load, inside one 32-byte sector;
//   2^18 dimension rows make 2^19 slots = 8 MB, resident in the 50 MB L2.
//   Three small kernels build it (fill, insert, rows to buckets); the probe
//   is a launch of its own on the same stream, so it never reads a half-built
//   table. What bounds the probe is not HBM but random sectors from the L2
//   and their latency: a row costs about 1.25 sectors (a collision's next
//   slot shares the sector every other time) against the eight of a binary
//   search, and what is left is to keep many of them in flight. So a thread
//   takes 8 rows per loop turn: their keys arrive as 16-byte vectors
//   (coalesced: consecutive threads read consecutive vectors), the first
//   probe of all eight is started before any is looked at, and the buckets
//   leave as vector stores. A fact stream that does not start on a 16-byte
//   boundary and the last, ragged tile take scalar loads in the same kernel.
//   A table beyond the L2 (D >= 2^22: 128 MB) turns each probe into an HBM
//   sector, still one or two a row.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

// fact key stream kinds (unsigned payloads; the wrapper passes the signed
// torch tensor of the same bits)
enum { DT_U16 = 1, DT_U32 = 2, DT_U64 = 3 };

#define EVQL_EMPTY_KEY 0xFFFFFFFFFFFFFFFFULL
#define EVQL_MAX_HASH_DIMS 8192

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

// -- the table in global memory ----------------------------------------------
//
// table[0 .. slots) are the hash slots, table[slots] holds the bucket of the
// all-ones key (or -1). While the table is built a slot's value is a
// dimension row (INT_MAX: none yet), afterwards its bucket.

struct __align__(16) Slot {
  u64 key;
  int32_t val;
  int32_t pad;
};

__global__ void table_fill_kernel(Slot* table, long long slots) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i <= slots;
       i += stride) {
    table[i] = Slot{EVQL_EMPTY_KEY, INT_MAX, 0};
  }
}

__global__ void table_insert_kernel(Slot* table, long long slots, const u64* dim_keys,
                                    int D) {
  const uint32_t wrap = (uint32_t)(slots - 1);
  const int stride = gridDim.x * blockDim.x;
  for (long long d = (long long)blockIdx.x * blockDim.x + threadIdx.x; d < D; d += stride) {
    const u64 k = dim_keys[d];
    if (k == EVQL_EMPTY_KEY) {
      atomicMin(&table[slots].val, (int32_t)d);
      continue;
    }
    uint32_t s = slot_hash(k) & wrap;
    while (true) {
      const u64 prev = atomicCAS(&table[s].key, EVQL_EMPTY_KEY, k);
      if (prev == EVQL_EMPTY_KEY || prev == k) {
        atomicMin(&table[s].val, (int32_t)d);
        break;
      }
      s = (s + 1u) & wrap;
    }
  }
}

__global__ void table_buckets_kernel(Slot* table, long long slots,
                                     const int32_t* dim_bucket) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i <= slots;
       i += stride) {
    const int32_t row = table[i].val;
    table[i].val = row == INT_MAX ? -1 : dim_bucket[row];
  }
}

#define EVQL_PROBE_ROWS 8  // rows a thread takes per loop turn

// one aligned 16-byte load: the slot's key and, in the low word of .y, its
// value. Through the read-only path (ld.global.nc): the same gather as a
// cached-in-L2-only load (__ldcg) took four times as long on the H100.
__device__ __forceinline__ ulonglong2 load_slot(const Slot* table, uint32_t s) {
  return __ldg((const ulonglong2*)table + s);
}

// keys -> buckets for EVQL_PROBE_ROWS rows: every first probe is in flight
// before the first is looked at
__device__ __forceinline__ void probe_rows(const Slot* table, uint32_t wrap,
                                           int32_t all_ones_val,
                                           const u64 (&k)[EVQL_PROBE_ROWS],
                                           int32_t (&g)[EVQL_PROBE_ROWS]) {
  uint32_t s[EVQL_PROBE_ROWS];
  ulonglong2 e[EVQL_PROBE_ROWS];
#pragma unroll
  for (int i = 0; i < EVQL_PROBE_ROWS; ++i) {
    s[i] = slot_hash(k[i]) & wrap;
    e[i] = load_slot(table, s[i]);
  }
#pragma unroll
  for (int i = 0; i < EVQL_PROBE_ROWS; ++i) {
    if (k[i] == EVQL_EMPTY_KEY) {
      g[i] = all_ones_val;
      continue;
    }
    // the load is at most one half: an empty slot ends every search
    while (e[i].x != k[i] && e[i].x != EVQL_EMPTY_KEY) {
      s[i] = (s[i] + 1u) & wrap;
      e[i] = load_slot(table, s[i]);
    }
    g[i] = e[i].x == k[i] ? (int32_t)(uint32_t)e[i].y : -1;
  }
}

// T is the stored key type; 16 / sizeof(T) keys make one vector, and a thread
// takes EVQL_PROBE_ROWS * sizeof(T) / 16 vectors a turn, each a block's width
// away from the next so that a warp's loads are consecutive.
template <typename T>
__global__ void __launch_bounds__(256)
probe_table_kernel(const T* fact, long long n, int aligned, const Slot* table,
                   long long slots, int32_t* out) {
  constexpr int R = EVQL_PROBE_ROWS;
  constexpr int VEC = 16 / (int)sizeof(T);  // keys a vector
  constexpr int NV = R / VEC;               // vectors a thread and turn
  const uint32_t wrap = (uint32_t)(slots - 1);
  const int32_t all_ones_val = table[slots].val;
  const long long tile = (long long)blockDim.x * R;
  const long long tiles = (n + tile - 1) / tile;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = t * tile;
    u64 k[R];
    int32_t g[R];
    if (aligned && base + tile <= n) {
      const uint4* vin = (const uint4*)(fact + base);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const uint4 x = __ldg(vin + j * blockDim.x + threadIdx.x);
        const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          if constexpr (sizeof(T) == 8) {
            k[j * VEC + i] = (u64)w[2 * i] | ((u64)w[2 * i + 1] << 32);
          } else if constexpr (sizeof(T) == 4) {
            k[j * VEC + i] = w[i];
          } else {
            k[j * VEC + i] = (w[i / 2] >> (16 * (i % 2))) & 0xFFFFu;
          }
        }
      }
      probe_rows(table, wrap, all_ones_val, k, g);
      // row of k[j * VEC + i]: base + (j * blockDim.x + threadIdx.x) * VEC + i
      int4* vout = (int4*)(out + base);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const long long v = (long long)j * blockDim.x + threadIdx.x;
        if constexpr (VEC == 2) {
          ((int2*)vout)[v] = make_int2(g[2 * j], g[2 * j + 1]);
        } else {
#pragma unroll
          for (int q = 0; q < VEC / 4; ++q) {
            vout[v * (VEC / 4) + q] = make_int4(g[j * VEC + 4 * q], g[j * VEC + 4 * q + 1],
                                                g[j * VEC + 4 * q + 2], g[j * VEC + 4 * q + 3]);
          }
        }
      }
    } else {
      // scalar loads, consecutive threads on consecutive rows; rows >= n
      // probe the key 0 and are not stored
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const long long row = base + (long long)i * blockDim.x + threadIdx.x;
        k[i] = row < n ? (u64)fact[row] : 0ULL;
      }
      probe_rows(table, wrap, all_ones_val, k, g);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const long long row = base + (long long)i * blockDim.x + threadIdx.x;
        if (row < n) out[row] = g[i];
      }
    }
  }
}

namespace {

// blocks that cover the card once at the kernel's own occupancy, or fewer
// when n rows need fewer at `rows` rows a thread
template <typename Kernel>
int grid_for(Kernel kernel, int threads, size_t smem, long long n, int rows, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const long long per_block = (long long)threads * rows;
  const long long want = (n + per_block - 1) / per_block;
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
  int rc = grid_for(dim_join_kernel, threads, smem, n, 4, &blocks);
  if (rc) return rc;
  dim_join_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      fact, fact_dt, n, (const u64*)dim_keys, (const int32_t*)dim_bucket, D, slots,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

namespace {

template <typename T>
int launch_probe(const void* fact, long long n, const Slot* table, long long slots,
                 int32_t* out, cudaStream_t stream) {
  const int threads = 256;
  int blocks = 0;
  const int rc = grid_for(probe_table_kernel<T>, threads, 0, n, EVQL_PROBE_ROWS, &blocks);
  if (rc) return rc;
  const int aligned = (((uintptr_t)fact | (uintptr_t)out) & 15u) == 0;
  probe_table_kernel<T><<<blocks, threads, 0, stream>>>((const T*)fact, n, aligned, table,
                                                        slots, out);
  return (int)cudaGetLastError();
}

bool bad_slots(long long slots) {
  return slots < 2 || slots > (1LL << 32) || (slots & (slots - 1)) != 0;
}

}  // namespace

// Build the hash table of the dimension side in global memory. dim_keys is
// u64[D] in any order, dim_bucket int32[D], D >= 1; `slots` is a power of two
// >= 2 * D (at most 2^32); table is uninitialised device memory of
// (slots + 1) * 16 bytes on a 16-byte boundary.
extern "C" int evql_build_join_table(const void* dim_keys, const void* dim_bucket, int D,
                                     long long slots, void* table, void* stream) {
  if (D < 1 || bad_slots(slots) || slots < 2LL * D || ((uintptr_t)table & 15u) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  Slot* t = (Slot*)table;
  const int threads = 256;
  auto blocks_for = [](long long items) {
    const long long b = (items + threads - 1) / threads;
    return (int)(b < 4096 ? b : 4096);
  };
  const int fill_blocks = blocks_for(slots + 1);
  table_fill_kernel<<<fill_blocks, threads, 0, st>>>(t, slots);
  table_insert_kernel<<<blocks_for(D), threads, 0, st>>>(t, slots, (const u64*)dim_keys, D);
  table_buckets_kernel<<<fill_blocks, threads, 0, st>>>(t, slots, (const int32_t*)dim_bucket);
  return (int)cudaGetLastError();
}

// Bucket of the equal dimension key for n fact keys, against a table built by
// evql_build_join_table with the same `slots`; out is int32[n].
extern "C" int evql_probe_join_table(const void* fact, int fact_dt, long long n,
                                     const void* table, long long slots, void* out,
                                     void* stream) {
  if (n <= 0) return 0;
  if (bad_slots(slots) || bad_dt(fact_dt)) return (int)cudaErrorInvalidValue;
  const Slot* t = (const Slot*)table;
  cudaStream_t st = (cudaStream_t)stream;
  switch (fact_dt) {
    case DT_U16: return launch_probe<uint16_t>(fact, n, t, slots, (int32_t*)out, st);
    case DT_U32: return launch_probe<uint32_t>(fact, n, t, slots, (int32_t*)out, st);
    default: return launch_probe<u64>(fact, n, t, slots, (int32_t*)out, st);
  }
}
