// The general GROUP BY as a hash aggregate, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes this with lax.sort and
// associative_scan (eventql_tpu/kernels/groupby.py: masked_grouped_aggregate,
// masked_grouped_count_distinct), because the TPU has no per-lane scatter.
// Hopper has global 64-bit atomics, so the groups come from a hash table and
// the aggregates from atomics on them, with no sort.
//
// What is computed, over the rows i < n that the byte mask keeps (all when
// there is none):
//   * group ids (evql_hash_group_ids): a group is a distinct tuple of up to
//     MAX_KEYS key words, each read at its stored width as a 64-bit pattern;
//     row_slot[i] is the table slot of its group (-1: masked out), and after
//     the call table[slot] is the group's dense id in [0, G), G written to
//     *num_groups. Ids come in no particular order.
//   * aggregates by group (evql_hash_aggregate), into out[(2 + j) * G + g]:
//     row 0 the count, row 1 the smallest row index, then per value stream j
//       SUM_I   u64 add of the value's bits (exact mod 2^64)
//       MIN_U / MAX_U, MIN_I / MAX_I   unsigned / signed 64-bit order
//       MIN_F / MAX_F   float64: -0.0 reads as +0.0, NaN wins (written as
//                       0x7FF8000000000000)
//       SUM_F / MEAN_F  float64 add (in no fixed order), MEAN_F / count
//   * count_distinct by group (evql_hash_count_distinct): the number of
//     distinct 64-bit payloads of one stream among a group's rows.
//
// Bound: bytes. The least time reads each key, value and mask stream once
// at its stored width; the output is O(groups). This design moves more:
// the table (2n int32 slots) is filled and probed, and row_slot (4 B a
// row) is written once and read once per aggregate call.
//
// Design, simple first:
//   Table. Open addressing with linear probing over a power-of-two number of
//   int32 slots, at least twice the rows, so it never fills. A row claims an
//   empty slot with atomicCAS of its own index; a row that finds a slot taken
//   compares its key tuple with that of the row that holds it (a gather of
//   nk words) and moves on to the next slot when they differ. A slot never
//   changes hands, so a row that read it once may use it.
//   Dense ids. One pass over the slots; each warp takes its occupied slots'
//   ids from one atomicAdd on a counter (ballot + popc).
//   Aggregates. 64-bit atomics into the [2 + nv, G] output in global memory:
//   atomicAdd for counts and integer sums, atomicMin / atomicMax on unsigned
//   long long and long long, atomicAdd(double*) for float sums. A float min /
//   max runs on the value's order-keeping bits (the IEEE total-order trick)
//   with a NaN mapped to the key no number has at that end (0 for min, all
//   ones for max), so that it wins and finalize writes NaN. A min / max / the
//   first row reads its slot first and skips the atomic when the row cannot
//   improve it: slots only move one way, so a stale read never skips a row
//   that would have won.
//   count_distinct. A second table of row indices keyed by (slot, payload);
//   the row that claims an empty slot adds one to its group's count.
//
// One hot key puts every row's atomics on one address; nothing here spreads
// them (warp aggregation is later work). Float sums and means follow the
// order the atomics land in, which changes from run to run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef unsigned long long u64;

#define MAX_KEYS 9     // 8 key columns and one word of NULL tags
#define MAX_VALUES 16  // value streams of one evql_hash_aggregate call

enum { DT_I16 = 0, DT_U16 = 1, DT_I32 = 2, DT_U32 = 3, DT_I64 = 4, DT_F64 = 5, DT_U8 = 6 };
enum {
  OP_SUM_I = 0, OP_MIN_U = 1, OP_MAX_U = 2, OP_MIN_I = 3, OP_MAX_I = 4,
  OP_MIN_F = 5, OP_MAX_F = 6, OP_SUM_F = 7, OP_MEAN_F = 8
};

constexpr u64 SIGN = 0x8000000000000000ULL;
constexpr long long NAN_BITS = 0x7FF8000000000000LL;
constexpr int THREADS = 256;

struct Keys {
  const void* p[MAX_KEYS];
  int dt[MAX_KEYS];
  int nk;
};

struct Values {
  const void* p[MAX_VALUES];
  int dt[MAX_VALUES];
  int op[MAX_VALUES];
  int nv;
};

__device__ __forceinline__ long long load64(const void* p, int dt, long long i) {
  switch (dt) {
    case DT_I16: return (long long)__ldg((const short*)p + i);
    case DT_U16: return (long long)__ldg((const unsigned short*)p + i);
    case DT_I32: return (long long)__ldg((const int*)p + i);
    case DT_U32: return (long long)__ldg((const unsigned int*)p + i);
    case DT_U8: return (long long)__ldg((const unsigned char*)p + i);
    default: return __ldg((const long long*)p + i);  // i64, and f64 as its bits
  }
}

__device__ __forceinline__ u64 mix64(u64 h) {  // MurmurHash3's finalizer
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdULL;
  h ^= h >> 33;
  h *= 0xc4ceb9fe1a85ec53ULL;
  h ^= h >> 33;
  return h;
}

__device__ __forceinline__ int read_slot(const int* t, u64 s) {
  return *((const volatile int*)(t + s));
}

// ---- group ids ---------------------------------------------------------------

__global__ void insert_kernel(Keys keys, const unsigned char* mask, long long n, int* table,
                              u64 cap_mask, int* row_slot) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (mask != nullptr && mask[i] == 0) {
      row_slot[i] = -1;
      continue;
    }
    long long k[MAX_KEYS];
    u64 h = 0x9E3779B97F4A7C15ULL;
#pragma unroll
    for (int j = 0; j < MAX_KEYS; ++j) {
      if (j < keys.nk) {
        k[j] = load64(keys.p[j], keys.dt[j], i);
        h = mix64(h ^ (u64)k[j]);
      }
    }
    u64 s = h & cap_mask;
    for (;;) {
      int cur = read_slot(table, s);
      if (cur < 0) {
        cur = atomicCAS(table + s, -1, (int)i);
        if (cur < 0) break;  // claimed: this row holds the slot
      }
      bool same = true;
#pragma unroll
      for (int j = 0; j < MAX_KEYS; ++j) {
        if (j < keys.nk && same) same = load64(keys.p[j], keys.dt[j], cur) == k[j];
      }
      if (same) break;
      s = (s + 1) & cap_mask;
    }
    row_slot[i] = (int)s;
  }
}

// occupied slot -> dense id, unoccupied stays -1; every thread of a warp
// runs the same turns, so the ballot is over the whole warp
__global__ void assign_kernel(int* table, long long cap, u64* counter) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < cap; base += stride) {
    const long long s = base + threadIdx.x;
    const bool occupied = s < cap && table[s] >= 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, occupied);
    if (ballot == 0) continue;
    const int leader = __ffs(ballot) - 1;
    u64 first = 0;
    if (lane == leader) first = atomicAdd(counter, (u64)__popc(ballot));
    first = __shfl_sync(0xffffffffu, first, leader);
    if (occupied) table[s] = (int)(first + __popc(ballot & ((1u << lane) - 1)));
  }
}

// ---- aggregates --------------------------------------------------------------

__device__ __forceinline__ long long identity(int op) {
  switch (op) {
    case OP_MIN_U: case OP_MIN_F: return -1;  // u64 all ones
    case OP_MIN_I: return 0x7FFFFFFFFFFFFFFFLL;
    case OP_MAX_I: return (long long)SIGN;
    default: return 0;  // counts, sums (0 bits = +0.0), u64 / float max
  }
}

__global__ void init_kernel(Values vals, long long* out, long long G) {
  const long long total = (2LL + vals.nv) * G;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x; x < total; x += stride) {
    const long long r = x / G;
    out[x] = r == 0 ? 0 : r == 1 ? 0x7FFFFFFFFFFFFFFFLL : identity(vals.op[r - 2]);
  }
}

__device__ __forceinline__ void min_u(long long* slot, u64 v) {
  if (v < *((volatile u64*)slot)) atomicMin((u64*)slot, v);
}
__device__ __forceinline__ void max_u(long long* slot, u64 v) {
  if (v > *((volatile u64*)slot)) atomicMax((u64*)slot, v);
}
__device__ __forceinline__ void min_i(long long* slot, long long v) {
  if (v < *((volatile long long*)slot)) atomicMin(slot, v);
}
__device__ __forceinline__ void max_i(long long* slot, long long v) {
  if (v > *((volatile long long*)slot)) atomicMax(slot, v);
}

// the float's key in the unsigned order of float values; -0.0 as +0.0, NaN
// at the end the op looks for
__device__ __forceinline__ u64 float_key(long long bits, bool is_min) {
  double x = __longlong_as_double(bits);
  if (isnan(x)) return is_min ? 0ULL : ~0ULL;
  if (x == 0.0) bits = 0;
  return bits < 0 ? ~(u64)bits : (u64)bits ^ SIGN;
}

__global__ void accumulate_kernel(const int* row_slot, const int* table, long long n,
                                  Values vals, long long* out, long long G) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int s = row_slot[i];
    if (s < 0) continue;
    const long long g = table[s];
    atomicAdd((u64*)(out + g), 1ULL);
    min_i(out + G + g, i);
#pragma unroll
    for (int j = 0; j < MAX_VALUES; ++j) {
      if (j >= vals.nv) break;
      long long* slot = out + (2 + j) * G + g;
      const long long v = load64(vals.p[j], vals.dt[j], i);
      switch (vals.op[j]) {
        case OP_SUM_I: atomicAdd((u64*)slot, (u64)v); break;
        case OP_MIN_U: min_u(slot, (u64)v); break;
        case OP_MAX_U: max_u(slot, (u64)v); break;
        case OP_MIN_I: min_i(slot, v); break;
        case OP_MAX_I: max_i(slot, v); break;
        case OP_MIN_F: min_u(slot, float_key(v, true)); break;
        case OP_MAX_F: max_u(slot, float_key(v, false)); break;
        default: atomicAdd((double*)slot, __longlong_as_double(v)); break;  // sum, mean
      }
    }
  }
}

__global__ void finalize_kernel(Values vals, long long* out, long long G) {
  const long long total = (long long)vals.nv * G;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x; x < total; x += stride) {
    const int op = vals.op[x / G];
    const long long g = x % G;
    long long* slot = out + 2 * G + x;
    if (op == OP_MIN_F || op == OP_MAX_F) {
      const u64 key = (u64)*slot;
      if (key == (op == OP_MIN_F ? 0ULL : ~0ULL)) {
        *slot = NAN_BITS;
      } else {
        *slot = (long long)((key & SIGN) ? key ^ SIGN : ~key);
      }
    } else if (op == OP_MEAN_F) {
      *slot = __double_as_longlong(__longlong_as_double(*slot) / (double)out[g]);
    }
  }
}

// ---- count_distinct ----------------------------------------------------------

__global__ void distinct_kernel(const int* row_slot, const int* table, const void* vp, int dt,
                                long long n, int* set, u64 cap_mask, long long* out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int s = row_slot[i];
    if (s < 0) continue;
    const long long v = load64(vp, dt, i);
    u64 p = mix64(mix64(0x9E3779B97F4A7C15ULL ^ (u64)s) ^ (u64)v) & cap_mask;
    for (;;) {
      int cur = read_slot(set, p);
      if (cur < 0) {
        cur = atomicCAS(set + p, -1, (int)i);
        if (cur < 0) {  // the first row of this (group, payload)
          atomicAdd((u64*)(out + table[s]), 1ULL);
          break;
        }
      }
      if (row_slot[cur] == s && load64(vp, dt, cur) == v) break;
      p = (p + 1) & cap_mask;
    }
  }
}

// ---- launchers ---------------------------------------------------------------

static int grid_for(long long work, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long want = (work + THREADS - 1) / THREADS;
  const long long most = 8LL * sms;  // 2048 threads an SM
  *blocks = (int)(want < 1 ? 1 : want < most ? want : most);
  return 0;
}

static bool power_of_two(long long x) { return x > 0 && (x & (x - 1)) == 0; }

// keys: nk pointers and width codes; mask: bytes or null; table: cap int32
// slots (a power of two >= 2n, filled here); row_slot: n int32; num_groups:
// one u64 on the device.
extern "C" int evql_hash_group_ids(const void* const* key_ptrs, const int* key_dts, int nk,
                                   const void* mask, long long n, int* table, long long cap,
                                   int* row_slot, u64* num_groups, void* stream) {
  if (nk < 0 || nk > MAX_KEYS || n < 0 || n >= (1LL << 30) || !power_of_two(cap) ||
      cap < 2 * n)
    return (int)cudaErrorInvalidValue;
  Keys keys = {};
  for (int j = 0; j < nk; ++j) {
    if (key_dts[j] < DT_I16 || key_dts[j] > DT_U8) return (int)cudaErrorInvalidValue;
    keys.p[j] = key_ptrs[j];
    keys.dt[j] = key_dts[j];
  }
  keys.nk = nk;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(table, 0xFF, (size_t)cap * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(num_groups, 0, sizeof(u64), st);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  int rc = grid_for(n, &blocks);
  if (rc) return rc;
  if (n > 0) {
    insert_kernel<<<blocks, THREADS, 0, st>>>(keys, (const unsigned char*)mask, n, table,
                                              (u64)(cap - 1), row_slot);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  rc = grid_for(cap, &blocks);
  if (rc) return rc;
  assign_kernel<<<blocks, THREADS, 0, st>>>(table, cap, num_groups);
  return (int)cudaGetLastError();
}

// row_slot / table as evql_hash_group_ids left them; nv value streams with
// width codes and ops; out: (2 + nv) x G int64, filled here.
extern "C" int evql_hash_aggregate(const int* row_slot, const int* table, long long n, int nv,
                                   const void* const* ptrs, const int* dts, const int* ops,
                                   long long* out, long long G, void* stream) {
  if (nv < 0 || nv > MAX_VALUES || n < 0 || G < 0) return (int)cudaErrorInvalidValue;
  Values vals = {};
  for (int j = 0; j < nv; ++j) {
    const bool fop = ops[j] >= OP_MIN_F && ops[j] <= OP_MEAN_F;
    if (ops[j] < OP_SUM_I || ops[j] > OP_MEAN_F || dts[j] < DT_I16 || dts[j] > DT_U8 ||
        fop != (dts[j] == DT_F64))
      return (int)cudaErrorInvalidValue;
    vals.p[j] = ptrs[j];
    vals.dt[j] = dts[j];
    vals.op[j] = ops[j];
  }
  vals.nv = nv;
  if (G == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int blocks = 0;
  int rc = grid_for((2LL + nv) * G, &blocks);
  if (rc) return rc;
  init_kernel<<<blocks, THREADS, 0, st>>>(vals, out, G);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rc = grid_for(n, &blocks);
  if (rc) return rc;
  accumulate_kernel<<<blocks, THREADS, 0, st>>>(row_slot, table, n, vals, out, G);
  e = cudaGetLastError();
  if (e != cudaSuccess || nv == 0) return (int)e;
  rc = grid_for((long long)nv * G, &blocks);
  if (rc) return rc;
  finalize_kernel<<<blocks, THREADS, 0, st>>>(vals, out, G);
  return (int)cudaGetLastError();
}

// one stream's distinct payloads per group; set: cap int32 slots (filled
// here), out: G int64 (zeroed here).
extern "C" int evql_hash_count_distinct(const int* row_slot, const int* table, long long n,
                                        const void* values, int dt, int* set, long long cap,
                                        long long* out, long long G, void* stream) {
  if (n < 0 || n >= (1LL << 30) || !power_of_two(cap) || cap < 2 * n || G < 0 ||
      dt < DT_I16 || dt > DT_U8 || dt == DT_F64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)G * sizeof(long long), st);
  if (e != cudaSuccess || G == 0) return (int)e;
  e = cudaMemsetAsync(set, 0xFF, (size_t)cap * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  int rc = grid_for(n, &blocks);
  if (rc) return rc;
  distinct_kernel<<<blocks, THREADS, 0, st>>>(row_slot, table, values, dt, n, set,
                                              (u64)(cap - 1), out);
  return (int)cudaGetLastError();
}
