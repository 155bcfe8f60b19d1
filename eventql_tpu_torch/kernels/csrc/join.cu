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
// a last pass turns rows into buckets. The key with all bits set marks an
// empty slot, so a dimension row with that very key lives in a slot of its
// own. The wrapper sorts nothing. Nothing of the TPU designs (fingerprints,
// the (D, B) compare matrix, int8 payload planes and limb recovery; sorted
// facts, windows, the overflow branch, double-buffered copies) is carried
// over, and colliding fingerprints are an ordinary input.
//
//   evql_dim_join_gid, D <= 8192 (B4): every block builds the table of the
//   whole dimension side in its dynamic shared memory, then probes it. The
//   table is shaped by D and the fact stream's width:
//   - a u16 or u32 stream can only equal a dimension key below 2^16 / 2^32,
//     so the table holds only those, in 8-byte slots {u32 key, int32 bucket}:
//     one 64-bit shared load a probe, and MurmurHash3's 32-bit finaliser;
//   - a u64 stream keeps 64-bit keys, u64 keys[slots] then int32
//     buckets[slots] (12 bytes a slot; 16-byte slots would not fit 16384 of
//     them into the 227 KB a block may use);
//   - slots: 8 a row for 8-byte slots, 4 for 12-byte ones (the loads that
//     measured fastest), halved, but not below 2 a row, while the table is
//     above 224 KB. At 1024 threads the kernel's 64 registers a thread leave
//     room for one block an SM anyway, so a table may take the SM's shared
//     memory; a miss (half the rows of the join query) costs about 2.5
//     probes at a load of 1/2 and 1.1 at 1/8. The launcher's dim_slots is
//     the rule; join.dim_table mirrors it for the CPU tests, and the card's
//     tests hold the two together through evql_dim_table_slots.
//   The probe is B5's: a thread takes DIM_ROWS rows a loop turn, their keys
//   arrive as 16-byte vectors (consecutive threads on consecutive vectors),
//   every first probe is read before any is compared, and the buckets leave
//   as 16-byte (u64: 8-byte) vector stores; a stream off a 16-byte boundary
//   and the last, ragged tile take scalar loads. The grid is one wave at
//   the kernel's occupancy, so each block builds its table once. The build
//   is one insert a dimension row: atomicCAS claims a slot, atomicMin keeps
//   the lowest row of a duplicate key. The launcher keeps the occupancy it
//   queried per (kernel, threads, shared bytes, device), so a launch costs
//   no attribute call or occupancy query after the first.
//   Measured (chip_smoke.py phase 5, H100 80GB HBM3 at 700 W, 2^26 rows):
//   0.196 ms at the join query's shape (u32 keys, D = 1024, half the rows
//   miss; bound 0.160) where one row a thread over 64-bit slots at load 1/2
//   took 0.404; u64 keys 0.290 at D = 1024 (0.437 before; bound 0.240) and
//   0.371 at D = 8192 (0.514; bound 0.240). The build is under 1 % of the
//   kernel at D = 1024 and under 4 % at D = 8192: less than a table built
//   once in global memory costs (B5's build of the same rows), so every
//   block builds its own. Slower, and not kept (PERF.md): 16 rows a thread,
//   256 or 512 threads, two blocks an SM, the next tile's keys loaded
//   ahead, the 64-bit table for narrow streams, a build with eight loads in
//   flight a thread, other loads.

//   evql_build_join_table + evql_probe_join_table, any D (B5): the table lies
//   in global memory, 16 bytes a slot {u64 key, int32 bucket, pad} so that
//   key and bucket arrive in one aligned 16-byte load, inside one 32-byte
//   sector; 2^18 dimension rows make 2^19 slots = 8 MB, resident in the 50 MB
//   L2. Three small kernels build it (fill, insert, rows to buckets); the
//   probe is a launch of its own on the same stream, so it never reads a
//   half-built table. What bounds the probe is not HBM but random sectors
//   from the L2 and their latency: a row costs about 1.25 sectors (a
//   collision's next slot shares the sector every other time) against the
//   eight of a binary search, and what is left is to keep many of them in
//   flight. So a thread takes 8 rows per loop turn, loaded and stored as B4
//   does. A table beyond the L2 (D >= 2^22: 128 MB) turns each probe into an
//   HBM sector, still one or two a row.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <mutex>
#include <vector>

// fact key stream kinds (unsigned payloads; the wrapper passes the signed
// torch tensor of the same bits)
enum { DT_U16 = 1, DT_U32 = 2, DT_U64 = 3 };

#define EVQL_EMPTY_KEY 0xFFFFFFFFFFFFFFFFULL
#define EVQL_MAX_HASH_DIMS 8192

typedef unsigned long long u64;

// the 64-bit finaliser of MurmurHash3
__device__ __forceinline__ uint32_t slot_hash(u64 k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return (uint32_t)k;
}

// the 32-bit finaliser of MurmurHash3
__device__ __forceinline__ uint32_t slot_hash32(uint32_t k) {
  k ^= k >> 16;
  k *= 0x85ebca6bu;
  k ^= k >> 13;
  k *= 0xc2b2ae35u;
  k ^= k >> 16;
  return k;
}

// Unpack one 16-byte vector of fact keys stored as T into out[0 .. 16 / sizeof(T)).
template <typename T, typename K>
__device__ __forceinline__ void unpack_keys(const uint4 x, K* out) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) {
    if constexpr (sizeof(T) == 8) {
      out[i] = (K)((u64)w[2 * i] | ((u64)w[2 * i + 1] << 32));
    } else if constexpr (sizeof(T) == 4) {
      out[i] = (K)w[i];
    } else {
      out[i] = (K)((w[i / 2] >> (16 * (i % 2))) & 0xFFFFu);
    }
  }
}

// Store R buckets g, produced from NV vectors of VEC keys each, where key
// j * VEC + i came from row (j * blockDim.x + threadIdx.x) * VEC + i of out.
template <int VEC, int R>
__device__ __forceinline__ void store_buckets(int32_t* out, const int32_t (&g)[R]) {
  constexpr int NV = R / VEC;
  int4* vout = (int4*)out;
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
}

// -- B4: the dimension table in each block's shared memory --------------------

constexpr int DIM_ROWS = 8;        // rows a thread takes per loop turn
constexpr int DIM_THREADS = 1024;  // threads a block
// the most bytes a table may take: under the 227 KB of shared memory the
// kernel's one block an SM may opt in to
constexpr long long DIM_TABLE_BYTES = 224 * 1024;

// A u16 or u32 fact stream's table: 8-byte slots {u32 key, int32 value}; one
// 64-bit load brings both.
struct NarrowTable {
  typedef uint32_t Key;
  typedef uint2 Entry;
  static constexpr Key EMPTY = 0xFFFFFFFFu;
  static constexpr size_t SLOT_BYTES = 8;
  uint2* slot;
  __device__ NarrowTable(void* smem, uint32_t) : slot((uint2*)smem) {}
  __device__ static uint32_t hash(Key k) { return slot_hash32(k); }
  __device__ Key* key_at(uint32_t s) { return &slot[s].x; }
  __device__ int32_t* val_at(uint32_t s) { return (int32_t*)&slot[s].y; }
  __device__ Entry read(uint32_t s) const { return slot[s]; }
  __device__ static Key key_of(Entry e) { return e.x; }
  __device__ int32_t val_of(Entry e, uint32_t) const { return (int32_t)e.y; }
};

// A u64 fact stream's table: u64 keys[slots], then int32 values[slots]; the
// value is read only for a hit.
struct WideTable {
  typedef u64 Key;
  typedef u64 Entry;
  static constexpr Key EMPTY = EVQL_EMPTY_KEY;
  static constexpr size_t SLOT_BYTES = 12;
  u64* key;
  int32_t* val;
  __device__ WideTable(void* smem, uint32_t slots)
      : key((u64*)smem), val((int32_t*)((u64*)smem + slots)) {}
  __device__ static uint32_t hash(Key k) { return slot_hash(k); }
  __device__ Key* key_at(uint32_t s) { return &key[s]; }
  __device__ int32_t* val_at(uint32_t s) { return &val[s]; }
  __device__ Entry read(uint32_t s) const { return key[s]; }
  __device__ static Key key_of(Entry e) { return e; }
  __device__ int32_t val_of(Entry, uint32_t s) const { return val[s]; }
};

// Build the table of dimension rows d < D whose key fits the fact stream's
// width T (no other can equal a fact key) in the block's shared memory. A
// slot's value is a dimension row while the table is built (atomicMin: the
// lowest row of a duplicate key wins) and its bucket afterwards; `all_ones`
// ends as the bucket of the key Table::EMPTY, or -1.
template <typename T, typename Table>
__device__ __forceinline__ void build_dim_table(Table& tab, uint32_t slots,
                                                const u64* __restrict__ dim_keys,
                                                const int32_t* __restrict__ dim_bucket,
                                                int D, int32_t& all_ones) {
  typedef typename Table::Key Key;
  const uint32_t wrap = slots - 1u;
  for (uint32_t i = threadIdx.x; i < slots; i += blockDim.x) {
    *tab.key_at(i) = Table::EMPTY;
    *tab.val_at(i) = INT_MAX;
  }
  if (threadIdx.x == 0) all_ones = INT_MAX;
  __syncthreads();

  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const u64 k = __ldg(dim_keys + d);
    if constexpr (sizeof(T) < 8) {
      if ((k >> (8 * sizeof(T))) != 0) continue;
    }
    const Key key = (Key)k;
    if (key == Table::EMPTY) {
      atomicMin(&all_ones, d);
      continue;
    }
    uint32_t s = Table::hash(key) & wrap;
    while (true) {
      const Key prev = atomicCAS(tab.key_at(s), Table::EMPTY, key);
      if (prev == Table::EMPTY || prev == key) {
        atomicMin(tab.val_at(s), d);
        break;
      }
      s = (s + 1u) & wrap;
    }
  }
  __syncthreads();

  for (uint32_t i = threadIdx.x; i < slots; i += blockDim.x) {
    const int32_t row = *tab.val_at(i);
    if (row != INT_MAX) *tab.val_at(i) = __ldg(dim_bucket + row);
  }
  if (threadIdx.x == 0) all_ones = all_ones == INT_MAX ? -1 : __ldg(dim_bucket + all_ones);
  __syncthreads();
}

// keys -> buckets for R rows: every first probe is read before the first is
// compared. The load is at most one half, so an empty slot ends every search;
// a key equal to the empty mark ends at the first empty slot and takes
// `all_ones` instead.
template <typename Table, int R>
__device__ __forceinline__ void probe_dim_rows(const Table& tab, uint32_t wrap,
                                               int32_t all_ones,
                                               const typename Table::Key (&k)[R],
                                               int32_t (&g)[R]) {
  uint32_t s[R];
  typename Table::Entry e[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    s[i] = Table::hash(k[i]) & wrap;
    e[i] = tab.read(s[i]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    while (Table::key_of(e[i]) != k[i] && Table::key_of(e[i]) != Table::EMPTY) {
      s[i] = (s[i] + 1u) & wrap;
      e[i] = tab.read(s[i]);
    }
    g[i] = k[i] == Table::EMPTY               ? all_ones
           : Table::key_of(e[i]) == k[i]      ? tab.val_of(e[i], s[i])
                                              : -1;
  }
}

// T is the stored fact key type. Shared memory: the table of `slots` slots
// (Table::SLOT_BYTES each). A thread takes R rows a turn as R / VEC vectors,
// each a block's width away from the next, so that a warp's loads are
// consecutive.
template <typename T, typename Table>
__global__ void __launch_bounds__(DIM_THREADS)
dim_join_kernel(const T* __restrict__ fact, long long n, int aligned,
                const u64* __restrict__ dim_keys, const int32_t* __restrict__ dim_bucket,
                int D, uint32_t slots, int32_t* __restrict__ out) {
  typedef typename Table::Key Key;
  constexpr int R = DIM_ROWS;
  constexpr int VEC = 16 / (int)sizeof(T);  // keys a vector
  constexpr int NV = R / VEC;               // vectors a thread and turn
  extern __shared__ __align__(16) unsigned char dim_smem[];
  __shared__ int32_t all_ones;
  Table tab(dim_smem, slots);
  build_dim_table<T>(tab, slots, dim_keys, dim_bucket, D, all_ones);
  const int32_t ones = all_ones;
  const uint32_t wrap = slots - 1u;

  const long long tile = (long long)blockDim.x * R;
  const long long tiles = (n + tile - 1) / tile;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = t * tile;
    Key k[R];
    int32_t g[R];
    if (aligned && base + tile <= n) {
      const uint4* vin = (const uint4*)(fact + base);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        unpack_keys<T>(__ldg(vin + j * blockDim.x + threadIdx.x), k + j * VEC);
      }
      probe_dim_rows(tab, wrap, ones, k, g);
      store_buckets<VEC>(out + base, g);
    } else {
      // scalar loads, consecutive threads on consecutive rows; rows >= n
      // probe the key 0 and are not stored
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const long long row = base + (long long)i * blockDim.x + threadIdx.x;
        k[i] = row < n ? (Key)fact[row] : (Key)0;
      }
      probe_dim_rows(tab, wrap, ones, k, g);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const long long row = base + (long long)i * blockDim.x + threadIdx.x;
        if (row < n) out[row] = g[i];
      }
    }
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
        unpack_keys<T>(__ldg(vin + j * blockDim.x + threadIdx.x), k + j * VEC);
      }
      probe_rows(table, wrap, all_ones_val, k, g);
      store_buckets<VEC>(out + base, g);
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

// What a launch needs to know of a kernel on a device, queried once: the
// attribute call and the occupancy query cost more host time than the launch.
struct Occupancy {
  const void* kernel;
  int dev, threads;
  size_t smem;
  int per_sm, sms;
};

std::mutex occupancy_mu;
std::vector<Occupancy> occupancy_seen;

int occupancy_of(const void* kernel, int threads, size_t smem, int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(occupancy_mu);
  bool attribute_set = false;
  for (const Occupancy& o : occupancy_seen) {
    if (o.kernel == kernel && o.dev == dev) {
      if (o.threads == threads && o.smem == smem) {
        *per_sm = o.per_sm;
        *sms = o.sms;
        return 0;
      }
      attribute_set = true;
    }
  }
  if (smem > 0 && !attribute_set) {
    // once per kernel and device, to the most any launch of it may ask for
    int optin = 0;
    cudaFuncAttributes fa;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)fa.sharedSizeBytes);
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (*per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  occupancy_seen.push_back(Occupancy{kernel, dev, threads, smem, *per_sm, *sms});
  return 0;
}

// blocks that cover the card once at the kernel's own occupancy, or fewer
// when n rows need fewer at `rows` rows a thread
int grid_for(const void* kernel, int threads, size_t smem, long long n, int rows,
             int* blocks) {
  int per_sm = 0, sms = 0;
  const int rc = occupancy_of(kernel, threads, smem, &per_sm, &sms);
  if (rc) return rc;
  const long long per_block = (long long)threads * rows;
  const long long want = (n + per_block - 1) / per_block;
  const long long cap = (long long)sms * per_sm;
  *blocks = (int)(want < cap ? want : cap);
  if (*blocks < 1) *blocks = 1;
  return 0;
}

bool bad_dt(int dt) { return dt != DT_U16 && dt != DT_U32 && dt != DT_U64; }

bool bad_slots(long long slots) {
  return slots < 2 || slots > (1LL << 32) || (slots & (slots - 1)) != 0;
}

bool misaligned(const void* fact, const void* out) {
  return (((uintptr_t)fact | (uintptr_t)out) & 15u) != 0;
}

long long pow2_at_least(long long x) {
  long long p = 1;
  while (p < x) p <<= 1;
  return p;
}

// The slots of B4's table for D dimension rows and a fact stream of
// key_bytes a key: a power of two at 8 a row for 8-byte slots (u16 / u32
// streams) and 4 a row for 12-byte ones (u64), halved while the table is
// above DIM_TABLE_BYTES, but never below 2 a row (a search ends at an empty
// slot). join.dim_table in Python mirrors it.
long long dim_slots(int D, int key_bytes) {
  const long long slot_bytes = key_bytes == 8 ? 12 : 8;
  const long long least = pow2_at_least(2LL * D);
  long long slots = pow2_at_least((slot_bytes == 8 ? 8LL : 4LL) * D);
  while (slots > least && slots * slot_bytes > DIM_TABLE_BYTES) slots /= 2;
  return slots;
}

template <typename T, typename Table>
int launch_dim(const void* fact, long long n, const void* dim_keys, const void* dim_bucket,
               int D, int32_t* out, cudaStream_t stream) {
  const long long slots = dim_slots(D, (int)sizeof(T));
  const size_t smem = (size_t)slots * Table::SLOT_BYTES;
  const void* kernel = (const void*)dim_join_kernel<T, Table>;
  int blocks = 0;
  const int rc = grid_for(kernel, DIM_THREADS, smem, n, DIM_ROWS, &blocks);
  if (rc) return rc;
  dim_join_kernel<T, Table><<<blocks, DIM_THREADS, smem, stream>>>(
      (const T*)fact, n, !misaligned(fact, out), (const u64*)dim_keys,
      (const int32_t*)dim_bucket, D, (uint32_t)slots, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_probe(const void* fact, long long n, const Slot* table, long long slots,
                 int32_t* out, cudaStream_t stream) {
  const int threads = 256;
  int blocks = 0;
  const int rc = grid_for((const void*)probe_table_kernel<T>, threads, 0, n,
                          EVQL_PROBE_ROWS, &blocks);
  if (rc) return rc;
  probe_table_kernel<T><<<blocks, threads, 0, stream>>>(
      (const T*)fact, n, !misaligned(fact, out), table, slots, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Bucket of the equal dimension key, table in shared memory (B4). dim_keys is
// u64[D] in any order, dim_bucket int32[D], 0 < D <= 8192; out is int32[n].
extern "C" int evql_dim_join_gid(const void* fact, int fact_dt, long long n,
                                 const void* dim_keys, const void* dim_bucket, int D,
                                 void* out, void* stream) {
  if (n <= 0) return 0;
  if (D < 1 || D > EVQL_MAX_HASH_DIMS || bad_dt(fact_dt)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* o = (int32_t*)out;
  switch (fact_dt) {
    case DT_U16:
      return launch_dim<uint16_t, NarrowTable>(fact, n, dim_keys, dim_bucket, D, o, st);
    case DT_U32:
      return launch_dim<uint32_t, NarrowTable>(fact, n, dim_keys, dim_bucket, D, o, st);
    default:
      return launch_dim<u64, WideTable>(fact, n, dim_keys, dim_bucket, D, o, st);
  }
}

// The slots of the table evql_dim_join_gid builds for D dimension rows and a
// fact stream of key_bytes (2, 4 or 8) a key; -1 for arguments it refuses.
extern "C" long long evql_dim_table_slots(int D, int key_bytes) {
  if (D < 1 || D > EVQL_MAX_HASH_DIMS ||
      (key_bytes != 2 && key_bytes != 4 && key_bytes != 8)) {
    return -1;
  }
  return dim_slots(D, key_bytes);
}

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
