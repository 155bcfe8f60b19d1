// The general GROUP BY as a grouped aggregate, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes this with lax.sort and
// associative_scan (eventql_tpu/kernels/groupby.py: masked_grouped_aggregate,
// masked_grouped_count_distinct), because the TPU has no per-lane scatter.
// Hopper has shared and global atomics, so the groups come from slots and
// the aggregates from atomics on them, with no sort.
//
// What is computed, over the rows i < n that the byte mask keeps (all when
// there is none), into out[(2 + j) * G + g] for G slots:
//   row 0 the count, row 1 the smallest row index, then per value stream j
//     SUM_I   u64 add of the value's bits (exact mod 2^64)
//     MIN_U / MAX_U, MIN_I / MAX_I   unsigned / signed 64-bit order
//     MIN_F / MAX_F   float64: -0.0 reads as +0.0, NaN wins (written as
//                     0x7FF8000000000000)
//     SUM_F / MEAN_F  float64 add (in no fixed order), MEAN_F / count
// and per count_distinct stream the number of distinct 64-bit payloads of
// one stream among a slot's rows.
//
// Bound: bytes. The least time reads each key, value and mask stream once
// at its stored width; the output is O(groups).
//
// Three tiers; the caller picks one from the key spans alone
// (evql_hash_tier, mirrored by kernels/hash_groupby.py:tier_of), and a
// launcher refuses any other. None retries another.
//
//   Direct tiers. Every key j lies in [base_j, base_j + span_j), which the
//   caller knows before the launch (a dictionary size, a column's min / max,
//   a join's bucket count). A row's slot is then the mixed-radix number
//   sum_j (key_j - base_j) * stride_j, computed in registers: no table, no
//   compare of keys, nothing written per row. G is the product of the spans
//   and empty slots (count 0) are no group. A key outside its span is the
//   caller's fault: its row is dropped (the plain version raises).
//     Shared tier: when one copy of the slots (a 32-bit count, a 32-bit
//     first row and a 64-bit word per value stream: 8 + 8 nv bytes a slot)
//     fits the shared memory a block may opt in to. Each block of 1024
//     threads keeps up to 32 copies (one per warp at most), each warp
//     adding into its own, and adds every occupied slot to the global words
//     once, at its end. As in groupby_agg.cu a 64-bit integer sum goes in as
//     two 32-bit words with a carry, since a 64-bit atomicAdd on shared
//     memory is a compare-and-swap loop on this card.
//     Direct global tier: when the span is larger but its (2 + nv) x G
//     words take no more device memory than the hash tier's table and row
//     slots would: one fused pass, atomics straight to the global words.
//   Hash tier (a key without a span: a computed key, a u64 key such as a
//   timestamp). Open addressing with linear probing over a power-of-two
//   number of int32 slots, at least twice the rows. A row claims an empty
//   slot with atomicCAS of its own index; a row that finds a slot taken
//   compares its key tuple with that of the row that holds it (a gather of
//   nk words) and moves on when they differ. A slot never changes hands.
//   Then one pass gives the occupied slots dense ids (ballot + popc), and
//   the aggregates go to a [2 + nv, G] table with global atomics, through
//   the 4-byte slot each row wrote.
//
// Reading. A thread takes runs of 8 consecutive rows and reads each stream
// with 16-byte loads (scalar loads off a 16-byte boundary and on the ragged
// last run), as groupby_agg.cu does.
//
// Hot keys. Equal slots are combined before any atomic: when all the kept
// rows of a thread's run share one slot, the run is reduced in registers;
// when every busy lane of a warp holds such a run on the same slot, the
// warp reduces with shuffles and one lane adds. One key thus costs one
// atomic per word per 256 rows in the direct tiers.
//
// Min / max. A float min / max runs on the value's order-keeping bits (the
// IEEE total-order trick) with a NaN mapped to the key no number has at
// that end (0 for min, all ones for max), so that it wins and finalize
// writes NaN. A min / max / first row reads its word first and skips the
// atomic when the row cannot improve it: words only move one way, so a
// stale read never skips a row that would have won.
//
// count_distinct. Where the payload has a span too and slots x payload span
// bits fit, a bitmap: one bit per (slot, payload) set with atomicOr (per
// block in shared memory when it fits, merged into the global bitmap at the
// block's end; else in global memory), then a popcount per slot. Otherwise
// a second hash table keyed by (slot, payload), whose first insert counts.
//
// Float sums and means follow the order the atomics land in, which changes
// from run to run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef unsigned long long u64;

#define MAX_KEYS 9     // 8 key columns and one word of NULL tags
#define MAX_VALUES 16  // value streams of one aggregate call
#define MAX_COPIES 32  // shared copies of the slots a block keeps
#define MAX_DIRECT_SLOTS (1LL << 40)  // keeps every size product below 2^63

enum { DT_I16 = 0, DT_U16 = 1, DT_I32 = 2, DT_U32 = 3, DT_I64 = 4, DT_F64 = 5, DT_U8 = 6 };
enum {
  OP_SUM_I = 0, OP_MIN_U = 1, OP_MAX_U = 2, OP_MIN_I = 3, OP_MAX_I = 4,
  OP_MIN_F = 5, OP_MAX_F = 6, OP_SUM_F = 7, OP_MEAN_F = 8
};
enum { TIER_SHARED = 0, TIER_GLOBAL = 1, TIER_HASH = 2 };
enum { DISTINCT_BITMAP_SHARED = 0, DISTINCT_BITMAP_GLOBAL = 1, DISTINCT_SET = 2 };

constexpr u64 SIGN = 0x8000000000000000ULL;
constexpr long long NAN_BITS = 0x7FF8000000000000LL;
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;          // hash tier
constexpr int DIRECT_THREADS = 1024;  // direct tiers and bitmaps
constexpr int R = 8;                  // rows of a run

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

// the rows and key spans of a direct-tier launch
struct Direct {
  const void* key[MAX_KEYS];
  int key_dt[MAX_KEYS];  // U16 / U32 for a narrow unsigned key: zero-extended
  u64 base[MAX_KEYS];
  u64 span[MAX_KEYS];
  u64 stride[MAX_KEYS];
  int nk;
  const unsigned char* mask;
  long long n;
  long long slots;
  int vec;  // every stream starts on a 16-byte boundary
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

// R consecutive rows of one stream from row0 on, extended as load64 does.
// `vec` (uniform over the grid) and a whole run take 16-byte loads;
// otherwise rows >= cnt read as 0 and are dropped by the caller's keep bits.
__device__ __forceinline__ void load_run(const void* p, int dt, long long row0, int cnt,
                                         bool vec, long long (&out)[R]) {
  if (vec && cnt == R) {
    switch (dt) {
      case DT_I16:
      case DT_U16: {
        const uint4 x = __ldg((const uint4*)((const unsigned short*)p + row0));
        const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          out[2 * i] = dt == DT_I16 ? (long long)(short)(w[i] & 0xFFFFu) : (w[i] & 0xFFFFu);
          out[2 * i + 1] = dt == DT_I16 ? (long long)(short)(w[i] >> 16) : (w[i] >> 16);
        }
        return;
      }
      case DT_I32:
      case DT_U32: {
        const uint4* q = (const uint4*)((const unsigned*)p + row0);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint4 x = __ldg(q + j);
          const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            out[4 * j + i] = dt == DT_I32 ? (long long)(int)w[i] : (long long)w[i];
        }
        return;
      }
      case DT_U8: {
        const uint2 x = __ldg((const uint2*)((const unsigned char*)p + row0));
#pragma unroll
        for (int i = 0; i < R; ++i) out[i] = ((i < 4 ? x.x : x.y) >> (8 * (i % 4))) & 0xFFu;
        return;
      }
      default: {
        const longlong2* q = (const longlong2*)((const long long*)p + row0);
#pragma unroll
        for (int j = 0; j < R / 2; ++j) {
          const longlong2 x = __ldg(q + j);
          out[2 * j] = x.x;
          out[2 * j + 1] = x.y;
        }
        return;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = r < cnt ? load64(p, dt, row0 + r) : 0;
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

// ---- words and their atomics -------------------------------------------------

__device__ __forceinline__ long long identity(int op) {
  switch (op) {
    case OP_MIN_U: case OP_MIN_F: return -1;  // u64 all ones
    case OP_MIN_I: return 0x7FFFFFFFFFFFFFFFLL;
    case OP_MAX_I: return (long long)SIGN;
    default: return 0;  // counts, sums (0 bits = +0.0), u64 / float max
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

// Rows combine in "key space": sums as their u64 / float64 bits, a min /
// max as an unsigned key (signed values with the sign bit flipped, floats
// by float_key), so that one unsigned min / max serves every type.
__device__ __forceinline__ bool is_min_op(int op) {
  return op == OP_MIN_U || op == OP_MIN_I || op == OP_MIN_F;
}

__device__ __forceinline__ u64 key_identity(int op) { return is_min_op(op) ? ~0ULL : 0ULL; }

__device__ __forceinline__ u64 to_key(int op, long long v) {
  switch (op) {
    case OP_MIN_I: case OP_MAX_I: return (u64)v ^ SIGN;
    case OP_MIN_F: return float_key(v, true);
    case OP_MAX_F: return float_key(v, false);
    default: return (u64)v;  // sums, u64 min / max
  }
}

// a word as stored (in out, and in the shared copies) -> key space
__device__ __forceinline__ u64 stored_to_key(int op, long long w) {
  return (op == OP_MIN_I || op == OP_MAX_I) ? (u64)w ^ SIGN : (u64)w;
}

__device__ __forceinline__ u64 combine(int op, u64 a, u64 b) {
  switch (op) {
    case OP_SUM_I: return a + b;
    case OP_SUM_F: case OP_MEAN_F:
      return (u64)__double_as_longlong(__longlong_as_double((long long)a) +
                                       __longlong_as_double((long long)b));
    default: return is_min_op(op) ? (a < b ? a : b) : (a > b ? a : b);
  }
}

__device__ __forceinline__ u64 warp_combine(int op, u64 a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a = combine(op, a, __shfl_xor_sync(FULL, a, o));
  return a;
}

// one key-space value into a 64-bit word of global memory
__device__ __forceinline__ void apply_global(long long* w, int op, u64 k) {
  switch (op) {
    case OP_SUM_I: atomicAdd((u64*)w, k); break;
    case OP_SUM_F: case OP_MEAN_F: atomicAdd((double*)w, __longlong_as_double((long long)k)); break;
    case OP_MIN_I: min_i(w, (long long)(k ^ SIGN)); break;
    case OP_MAX_I: max_i(w, (long long)(k ^ SIGN)); break;
    case OP_MIN_U: case OP_MIN_F: min_u(w, k); break;
    default: max_u(w, k); break;  // MAX_U, MAX_F
  }
}

// the same into a 64-bit word of shared memory: an integer sum as two
// 32-bit words with a carry (a 64-bit shared atomicAdd is a CAS loop)
__device__ __forceinline__ void apply_shared(long long* w, int op, u64 k) {
  if (op == OP_SUM_I) {
    unsigned* w32 = (unsigned*)w;
    const unsigned lo = (unsigned)k;
    unsigned hi = (unsigned)(k >> 32);
    if (lo) hi += (unsigned)(atomicAdd(w32, lo) + lo < lo);  // this add wrapped
    if (hi) atomicAdd(w32 + 1, hi);
    return;
  }
  apply_global(w, op, k);
}

// ---- hash tier: group ids ----------------------------------------------------

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
    const unsigned ballot = __ballot_sync(FULL, occupied);
    if (ballot == 0) continue;
    const int leader = __ffs(ballot) - 1;
    u64 first = 0;
    if (lane == leader) first = atomicAdd(counter, (u64)__popc(ballot));
    first = __shfl_sync(FULL, first, leader);
    if (occupied) table[s] = (int)(first + __popc(ballot & ((1u << lane) - 1)));
  }
}

// ---- every tier: the output words --------------------------------------------

__global__ void init_kernel(Values vals, long long* out, long long G) {
  const long long total = (2LL + vals.nv) * G;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x; x < total; x += stride) {
    const long long r = x / G;
    out[x] = r == 0 ? 0 : r == 1 ? 0x7FFFFFFFFFFFFFFFLL : identity(vals.op[r - 2]);
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

// ---- hash tier: aggregates and count_distinct ---------------------------------

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
      apply_global(out + (2 + j) * G + g, vals.op[j],
                   to_key(vals.op[j], load64(vals.p[j], vals.dt[j], i)));
    }
  }
}

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

// ---- direct tiers ------------------------------------------------------------

// the slots of a run's rows; returns the keep bits (masked in, every key in
// its span)
__device__ __forceinline__ unsigned run_slots(const Direct& d, long long row0, int cnt,
                                              u64 (&slot)[R]) {
  const bool vec = d.vec != 0;
  unsigned keep = (1u << cnt) - 1u;
  long long k[R];
  if (d.mask) {
    load_run(d.mask, DT_U8, row0, cnt, vec, k);
#pragma unroll
    for (int r = 0; r < R; ++r) keep &= ~((k[r] == 0 ? 1u : 0u) << r);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) slot[r] = 0;
  for (int j = 0; j < d.nk; ++j) {
    load_run(d.key[j], d.key_dt[j], row0, cnt, vec, k);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const u64 x = (u64)k[r] - d.base[j];
      if (x >= d.span[j]) keep &= ~(1u << r);
      slot[r] += x * d.stride[j];
    }
  }
  return keep;
}

// one row's slot (scalar loads); false when a key lies outside its span
__device__ __forceinline__ bool row_slot_of(const Direct& d, long long i, u64* slot) {
  u64 s = 0;
  for (int j = 0; j < d.nk; ++j) {
    const u64 x = (u64)load64(d.key[j], d.key_dt[j], i) - d.base[j];
    if (x >= d.span[j]) return false;
    s += x * d.stride[j];
  }
  *slot = s;
  return true;
}

// A shared copy of the slots: u32 count[S], u32 first[S], then one 64-bit
// word per slot and value stream.
__host__ __device__ __forceinline__ size_t copy_bytes(long long S, int nv) {
  return (size_t)S * (8 + 8 * (size_t)nv);
}

template <bool SHARED>
__global__ void __launch_bounds__(DIRECT_THREADS) direct_kernel(const Direct d, const Values vals,
                                                                long long* out, int copies) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long S = d.slots;
  const size_t cb = copy_bytes(S, vals.nv);
  if (SHARED) {
    for (int c = 0; c < copies; ++c) {
      unsigned* cnt32 = (unsigned*)(smem + c * cb);
      long long* val = (long long*)(smem + c * cb + 8 * S);
      for (long long s = threadIdx.x; s < S; s += blockDim.x) {
        cnt32[s] = 0;
        cnt32[S + s] = 0xFFFFFFFFu;
      }
      for (long long x = threadIdx.x; x < (long long)vals.nv * S; x += blockDim.x)
        val[x] = identity(vals.op[x / S]);
    }
    __syncthreads();
  }
  unsigned char* mine = smem + (size_t)((threadIdx.x >> 5) & (copies - 1)) * cb;
  unsigned* count32 = (unsigned*)mine;
  unsigned* first32 = count32 + S;
  long long* val = (long long*)(mine + 8 * S);

  // count and first row of `c` rows of slot s, the first of them `row`
  auto add_count_first = [&](u64 s, unsigned c, long long row) {
    if (SHARED) {
      atomicAdd(count32 + s, c);
      if ((unsigned)row < *((volatile unsigned*)(first32 + s))) atomicMin(first32 + s, (unsigned)row);
    } else {
      atomicAdd((u64*)(out + s), (u64)c);
      min_i(out + S + s, row);
    }
  };
  auto apply = [&](int j, u64 s, int op, u64 k) {
    if (SHARED) apply_shared(val + j * S + s, op, k);
    else apply_global(out + (2 + j) * S + s, op, k);
  };

  const bool vec = d.vec != 0;
  const int lane = threadIdx.x & 31;
  const long long runs = (d.n + R - 1) / R;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // warps walk the runs together, so that the shuffles see every lane
  for (long long wbase = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31); wbase < runs;
       wbase += stride) {
    const long long row0 = (wbase + lane) * R;
    const long long left = d.n - row0;
    const int cnt = left <= 0 ? 0 : left < R ? (int)left : R;
    u64 slot[R];
    const unsigned keep = run_slots(d, row0, cnt, slot);
    const int r0 = keep ? __ffs(keep) - 1 : 0;
    const u64 s0 = slot[r0];
    bool one = keep != 0;  // every kept row of the run on slot s0
#pragma unroll
    for (int r = 0; r < R; ++r) one = one && (!((keep >> r) & 1u) || slot[r] == s0);
    const unsigned busy = __ballot_sync(FULL, keep != 0);
    if (busy == 0) continue;
    const int leader = __ffs(busy) - 1;
    const u64 ls = __shfl_sync(FULL, s0, leader);
    const bool warp_one = __all_sync(FULL, keep == 0 || (one && s0 == ls));

    if (warp_one) {  // lanes ascend with their runs: the leader's row is the first
      const unsigned c = __reduce_add_sync(FULL, (unsigned)__popc(keep));
      if (lane == leader) add_count_first(s0, c, row0 + r0);
    } else if (one) {
      add_count_first(s0, (unsigned)__popc(keep), row0 + r0);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if ((keep >> r) & 1u) add_count_first(slot[r], 1u, row0 + r);
    }
    for (int j = 0; j < vals.nv; ++j) {
      const int op = vals.op[j];
      long long v[R];
      load_run(vals.p[j], vals.dt[j], row0, cnt, vec, v);
      if (warp_one || one) {
        u64 acc = key_identity(op);
#pragma unroll
        for (int r = 0; r < R; ++r)
          if ((keep >> r) & 1u) acc = combine(op, acc, to_key(op, v[r]));
        if (warp_one) {
          acc = warp_combine(op, acc);
          if (lane == leader) apply(j, s0, op, acc);
        } else {
          apply(j, s0, op, acc);
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r)
          if ((keep >> r) & 1u) apply(j, slot[r], op, to_key(op, v[r]));
      }
    }
  }

  if (SHARED) {
    __syncthreads();
    // each occupied slot: its copies combined, then one atomic per word
    for (long long s = threadIdx.x; s < S; s += blockDim.x) {
      u64 c = 0;
      unsigned f = 0xFFFFFFFFu;
      for (int k = 0; k < copies; ++k) {
        const unsigned* t = (const unsigned*)(smem + k * cb);
        c += t[s];
        f = t[S + s] < f ? t[S + s] : f;
      }
      if (c == 0) continue;
      atomicAdd((u64*)(out + s), c);
      min_i(out + S + s, (long long)f);
      for (int j = 0; j < vals.nv; ++j) {
        const int op = vals.op[j];
        u64 acc = key_identity(op);
        for (int k = 0; k < copies; ++k) {
          const long long* w = (const long long*)(smem + k * cb + 8 * S);
          acc = combine(op, acc, stored_to_key(op, w[j * S + s]));
        }
        apply_global(out + (2 + j) * S + s, op, acc);
      }
    }
  }
}

// count_distinct by bitmap: bit (slot * wps * 32 + payload - pbase)
template <bool SHARED>
__global__ void __launch_bounds__(DIRECT_THREADS) bitmap_kernel(const Direct d, const void* pay,
                                                                int pdt, u64 pbase, u64 pspan,
                                                                long long wps, unsigned* bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* sh = (unsigned*)smem;
  const long long W = d.slots * wps;
  if (SHARED) {
    for (long long w = threadIdx.x; w < W; w += blockDim.x) sh[w] = 0;
    __syncthreads();
  }
  unsigned* dst = SHARED ? sh : bits;
  const long long runs = (d.n + R - 1) / R;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long run = (long long)blockIdx.x * blockDim.x + threadIdx.x; run < runs;
       run += stride) {
    const long long row0 = run * R;
    const long long left = d.n - row0;
    const int cnt = left < R ? (int)left : R;
    u64 slot[R];
    const unsigned keep = run_slots(d, row0, cnt, slot);
    if (!keep) continue;
    long long v[R];
    load_run(pay, pdt, row0, cnt, d.vec != 0, v);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const u64 x = (u64)v[r] - pbase;
      if (!((keep >> r) & 1u) || x >= pspan) continue;
      const u64 b = slot[r] * (u64)wps * 32 + x;
      const unsigned m = 1u << (b & 31);
      unsigned* w = dst + (b >> 5);
      if (!(*((volatile unsigned*)w) & m)) atomicOr(w, m);
    }
  }
  if (SHARED) {
    __syncthreads();
    for (long long w = threadIdx.x; w < W; w += blockDim.x) {
      const unsigned m = sh[w];
      if (m && (*((volatile unsigned*)(bits + w)) | m) != *((volatile unsigned*)(bits + w)))
        atomicOr(bits + w, m);
    }
  }
}

__global__ void popcount_kernel(const unsigned* bits, long long wps, long long S, long long* out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x; s < S; s += stride) {
    long long c = 0;
    for (long long k = 0; k < wps; ++k) c += __popc(bits[s * wps + k]);
    out[s] = c;
  }
}

// count_distinct of a payload without a span: a table of row indices keyed
// by (slot, payload); the row that claims an empty entry counts
__global__ void distinct_set_kernel(const Direct d, const void* vp, int dt, int* set,
                                    u64 cap_mask, long long* out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < d.n; i += stride) {
    if (d.mask != nullptr && d.mask[i] == 0) continue;
    u64 s;
    if (!row_slot_of(d, i, &s)) continue;
    const long long v = load64(vp, dt, i);
    u64 p = mix64(mix64(0x9E3779B97F4A7C15ULL ^ s) ^ (u64)v) & cap_mask;
    for (;;) {
      int cur = read_slot(set, p);
      if (cur < 0) {
        cur = atomicCAS(set + p, -1, (int)i);
        if (cur < 0) {
          atomicAdd((u64*)(out + s), 1ULL);
          break;
        }
      }
      u64 cs;
      if (row_slot_of(d, cur, &cs) && cs == s && load64(vp, dt, cur) == v) break;
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

static int smem_optin(long long* bytes) {
  int dev = 0, v = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *bytes = v;
  return (int)e;
}

// the hash tier's table: a power of two, at least 2n and 2
static long long table_slots(long long n) {
  long long p = 2;
  while (p < 2 * n) p <<= 1;
  return p;
}

// device memory a direct tier may take: what the hash tier's table and row
// slots would
static long long direct_limit(long long n) { return 4 * table_slots(n) + 4 * n; }

// The tier of a call: spans[j] < 1 is a key without a span; nv value
// streams; n rows; smem the shared memory a block may opt in to.
extern "C" int evql_hash_tier(const long long* spans, int nk, int nv, long long n,
                              long long smem) {
  long long slots = 1;
  for (int j = 0; j < nk; ++j) {
    if (spans[j] < 1 || slots > MAX_DIRECT_SLOTS / spans[j]) return TIER_HASH;
    slots *= spans[j];
  }
  if ((long long)copy_bytes(slots, nv) <= smem) return TIER_SHARED;
  if (slots * 8 * (2 + nv) <= direct_limit(n)) return TIER_GLOBAL;
  return TIER_HASH;
}

// The form of one count_distinct in a direct tier of `slots` slots, for a
// payload span (< 1: none).
extern "C" int evql_hash_distinct_form(long long slots, long long pspan, long long n,
                                       long long smem) {
  if (pspan < 1 || slots < 1 || pspan > MAX_DIRECT_SLOTS) return DISTINCT_SET;
  const long long wps = (pspan + 31) / 32;
  if (slots > MAX_DIRECT_SLOTS / wps) return DISTINCT_SET;
  const long long bytes = slots * wps * 4;
  if (bytes <= smem) return DISTINCT_BITMAP_SHARED;
  if (bytes <= direct_limit(n)) return DISTINCT_BITMAP_GLOBAL;
  return DISTINCT_SET;
}

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

static int values_of(int nv, const void* const* ptrs, const int* dts, const int* ops,
                     Values* vals) {
  if (nv < 0 || nv > MAX_VALUES) return (int)cudaErrorInvalidValue;
  *vals = Values{};
  for (int j = 0; j < nv; ++j) {
    const bool fop = ops[j] >= OP_MIN_F && ops[j] <= OP_MEAN_F;
    if (ops[j] < OP_SUM_I || ops[j] > OP_MEAN_F || dts[j] < DT_I16 || dts[j] > DT_U8 ||
        fop != (dts[j] == DT_F64))
      return (int)cudaErrorInvalidValue;
    vals->p[j] = ptrs[j];
    vals->dt[j] = dts[j];
    vals->op[j] = ops[j];
  }
  vals->nv = nv;
  return 0;
}

static int init_out(const Values& vals, long long* out, long long G, cudaStream_t st) {
  int blocks = 0;
  int rc = grid_for((2LL + vals.nv) * G, &blocks);
  if (rc) return rc;
  init_kernel<<<blocks, THREADS, 0, st>>>(vals, out, G);
  return (int)cudaGetLastError();
}

static int finalize_out(const Values& vals, long long* out, long long G, cudaStream_t st) {
  if (vals.nv == 0) return 0;
  int blocks = 0;
  int rc = grid_for((long long)vals.nv * G, &blocks);
  if (rc) return rc;
  finalize_kernel<<<blocks, THREADS, 0, st>>>(vals, out, G);
  return (int)cudaGetLastError();
}

// row_slot / table as evql_hash_group_ids left them; nv value streams with
// width codes and ops; out: (2 + nv) x G int64, filled here.
extern "C" int evql_hash_aggregate(const int* row_slot, const int* table, long long n, int nv,
                                   const void* const* ptrs, const int* dts, const int* ops,
                                   long long* out, long long G, void* stream) {
  Values vals;
  int rc = values_of(nv, ptrs, dts, ops, &vals);
  if (rc) return rc;
  if (n < 0 || G < 0) return (int)cudaErrorInvalidValue;
  if (G == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  rc = init_out(vals, out, G, st);
  if (rc) return rc;
  int blocks = 0;
  rc = grid_for(n, &blocks);
  if (rc) return rc;
  accumulate_kernel<<<blocks, THREADS, 0, st>>>(row_slot, table, n, vals, out, G);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return finalize_out(vals, out, G, st);
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

static bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// keys with spans -> Direct (slots = the spans' product, strides)
static int direct_of(const void* const* key_ptrs, const int* key_dts, const long long* bases,
                     const long long* spans, int nk, const void* mask, long long n,
                     Direct* d) {
  if (nk < 0 || nk > MAX_KEYS || n < 0 || n >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  *d = Direct{};
  long long slots = 1;
  bool vec = aligned16(mask);
  for (int j = 0; j < nk; ++j) {
    if (key_dts[j] < DT_I16 || key_dts[j] > DT_U8 || spans[j] < 1 ||
        slots > MAX_DIRECT_SLOTS / spans[j])
      return (int)cudaErrorInvalidValue;
    d->key[j] = key_ptrs[j];
    d->key_dt[j] = key_dts[j];
    d->base[j] = (u64)bases[j];
    d->span[j] = (u64)spans[j];
    d->stride[j] = (u64)slots;
    slots *= spans[j];
    vec = vec && aligned16(key_ptrs[j]);
  }
  d->nk = nk;
  d->mask = (const unsigned char*)mask;
  d->n = n;
  d->slots = slots;
  d->vec = vec ? 1 : 0;
  return 0;
}

// one block of 1024 threads per SM it fits on, two runs a thread at most
template <typename K>
static int launch_blocks(K kernel, size_t smem, long long n, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, DIRECT_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const long long per_block = (long long)DIRECT_THREADS * R * 2;
  const long long want = (n + per_block - 1) / per_block;
  const long long cap = (long long)sms * per_sm;
  *blocks = (int)(want < 1 ? 1 : want < cap ? want : cap);
  return 0;
}

// The direct tiers: keys with bases and spans (the key dts say how a narrow
// key extends), nv value streams, out: (2 + nv) x slots int64, filled here.
// `tier` is the caller's choice, which must be evql_hash_tier's.
extern "C" int evql_hash_direct(const void* const* key_ptrs, const int* key_dts,
                                const long long* bases, const long long* spans, int nk,
                                const void* mask, long long n, int nv, const void* const* ptrs,
                                const int* dts, const int* ops, long long* out, int tier,
                                void* stream) {
  Direct d;
  int rc = direct_of(key_ptrs, key_dts, bases, spans, nk, mask, n, &d);
  if (rc) return rc;
  Values vals;
  rc = values_of(nv, ptrs, dts, ops, &vals);
  if (rc) return rc;
  long long optin = 0;
  rc = smem_optin(&optin);
  if (rc) return rc;
  if (tier == TIER_HASH || tier != evql_hash_tier(spans, nk, nv, n, optin))
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < nv; ++j) d.vec = d.vec && aligned16(ptrs[j]);
  cudaStream_t st = (cudaStream_t)stream;
  const long long S = d.slots;
  rc = init_out(vals, out, S, st);
  if (rc) return rc;
  if (n > 0) {
    int blocks = 0;
    if (tier == TIER_SHARED) {
      const size_t cb = copy_bytes(S, nv);
      int copies = 1;
      while (copies < MAX_COPIES && (size_t)(2 * copies) * cb <= (size_t)optin) copies *= 2;
      const size_t smem = copies * cb;
      rc = launch_blocks(direct_kernel<true>, smem, n, &blocks);
      if (rc) return rc;
      direct_kernel<true><<<blocks, DIRECT_THREADS, smem, st>>>(d, vals, out, copies);
    } else {
      rc = launch_blocks(direct_kernel<false>, 0, n, &blocks);
      if (rc) return rc;
      direct_kernel<false><<<blocks, DIRECT_THREADS, 0, st>>>(d, vals, out, 1);
    }
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return finalize_out(vals, out, S, st);
}

// One count_distinct in a direct tier: keys as for evql_hash_direct, the
// payload with its width code, base and span (< 1: none), `form` the
// caller's choice (evql_hash_distinct_form's), scratch: the bitmap (slots x
// ceil(pspan / 32) u32) or the table (table_slots(n) int32), both filled
// here; out: slots int64.
extern "C" int evql_hash_distinct_direct(const void* const* key_ptrs, const int* key_dts,
                                         const long long* bases, const long long* spans, int nk,
                                         const void* mask, long long n, const void* payload,
                                         int pdt, long long pbase, long long pspan, int form,
                                         void* scratch, long long scratch_words, long long* out,
                                         void* stream) {
  Direct d;
  int rc = direct_of(key_ptrs, key_dts, bases, spans, nk, mask, n, &d);
  if (rc) return rc;
  if (pdt < DT_I16 || pdt > DT_U8 || pdt == DT_F64) return (int)cudaErrorInvalidValue;
  long long optin = 0;
  rc = smem_optin(&optin);
  if (rc) return rc;
  const long long S = d.slots;
  if (form != evql_hash_distinct_form(S, pspan, n, optin)) return (int)cudaErrorInvalidValue;
  d.vec = d.vec && aligned16(payload);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  int blocks = 0;
  if (form == DISTINCT_SET) {
    const long long cap = table_slots(n);
    if (scratch_words < cap) return (int)cudaErrorInvalidValue;
    e = cudaMemsetAsync(out, 0, (size_t)S * sizeof(long long), st);
    if (e != cudaSuccess) return (int)e;
    e = cudaMemsetAsync(scratch, 0xFF, (size_t)cap * sizeof(int), st);
    if (e != cudaSuccess || n == 0) return (int)e;
    rc = grid_for(n, &blocks);
    if (rc) return rc;
    distinct_set_kernel<<<blocks, THREADS, 0, st>>>(d, payload, pdt, (int*)scratch,
                                                    (u64)(cap - 1), out);
    return (int)cudaGetLastError();
  }
  const long long wps = (pspan + 31) / 32;
  const long long W = S * wps;
  if (scratch_words < W) return (int)cudaErrorInvalidValue;
  unsigned* bits = (unsigned*)scratch;
  e = cudaMemsetAsync(bits, 0, (size_t)W * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  if (n > 0) {
    if (form == DISTINCT_BITMAP_SHARED) {
      const size_t smem = (size_t)W * sizeof(unsigned);
      rc = launch_blocks(bitmap_kernel<true>, smem, n, &blocks);
      if (rc) return rc;
      bitmap_kernel<true><<<blocks, DIRECT_THREADS, smem, st>>>(d, payload, pdt, (u64)pbase,
                                                                (u64)pspan, wps, bits);
    } else {
      rc = launch_blocks(bitmap_kernel<false>, 0, n, &blocks);
      if (rc) return rc;
      bitmap_kernel<false><<<blocks, DIRECT_THREADS, 0, st>>>(d, payload, pdt, (u64)pbase,
                                                              (u64)pspan, wps, bits);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  rc = grid_for(S, &blocks);
  if (rc) return rc;
  popcount_kernel<<<blocks, THREADS, 0, st>>>(bits, wps, S, out);
  return (int)cudaGetLastError();
}
