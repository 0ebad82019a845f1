// Hand-written Hopper kernels for the joins of the torch port's walk:
// query-RHS compares and `.%var` key interpolation
// (guard_tpu_torch/ops/kernels.py). All tensors are row-major and
// batched over documents: a (D, N) column holds one document per row,
// padded to the node bucket N.
//
//   K4 set_count_rows      out[d,i] = #{j : s_mask[d,j], s_org[d,j] >= 0,
//                                      (s_org, s_key)[d,j] == (q_org, q_key)[d,i]}
//                          for q_mask[d,i] and q_org[d,i] >= 0, else 0
//       Replaces _runs (guard_tpu/ops/kernels.py:914), _set_count_sorted
//       (:926) and _in_set_sorted (:967), which join by one lexicographic
//       sort per document. Here an open-addressing hash table of the
//       set's 64-bit (org, key) pairs with their counts (atomicCAS on the
//       key, atomicAdd on the count) is built per row, then every query
//       entry probes it. Bound by bytes: 9 B per set and query entry
//       read, 4 B per output written. Counts are exact in any order. The
//       table holds a power of two of at least twice the set's entries,
//       12 B a slot. The first design ran one 256-thread block per row
//       on every shape, three block barriers for about 2 KB of input at
//       the main shape (D 48,694 x Nq 64, Ns 128), and one block alone
//       for a one-row 65,536-node bucket. Three forms now, chosen by
//       table_form from (D, Ns):
//       - warp: a warp per row, 8 rows a block at a time, each warp
//         with its own table in shared memory, synchronised by
//         __syncwarp alone; a grid of one wave of resident blocks
//         strides over the rows. Taken while 8 tables fit 24 KB (Ns <=
//         128).
//       - block: the same kernel with one row a block at a time (block
//         barriers), while the table leaves room for two blocks an SM
//         (Ns <= 4,096) and there are at least as many rows as SMs.
//       - global: every other shape, e.g. the one-document 65,536-node
//         bucket. Tables in global scratch, one per row for as many rows
//         as 256 MB holds at a time, and per batch of rows three steps
//         on the stream: one cudaMemsetAsync clears the tables, an insert
//         grid of (set chunks, rows) fills them, a probe grid of (query
//         chunks, rows) reads them, so the grid fills the card whatever
//         D is. A count slot starts at -1 (the memset's 0xFF bytes) and
//         reads back plus one.
//       The thresholds are chip_smoke.py --design-sweep's (see
//       kWarpTableSmem). Measured there and dropped: a hash-free form (a
//       warp a row, set pairs in registers, each query sent round the
//       warp by shuffle) lost to the warp's table at every Ns from 32 to
//       256; loading four entries a lane before inserting any lost too;
//       so did a 32-bit multiplicative hash in place of splitmix64.
//
//   K5 distinct_first_rows out[d,i] = entry i is the lowest index of its
//                          (org, key) among entries with mask and org >= 0
//       Replaces _distinct_first_sorted (:978), whose stable three-key
//       sort puts the lowest index first. K4's table holds, per pair, an
//       atomicMin of the entry index (unsigned, so the empty slot's
//       0xFFFFFFFF is above every index); an entry is first when its
//       pair's slot holds its own index. Bound by bytes: 9 B read, 1 B
//       written per entry. The minimum does not depend on the order of
//       the atomics, so the output is deterministic. The first design was
//       K4's first: a 256-thread block per row, three block barriers for
//       64 entries at the main shape (D 48,694 x N 64), and for the
//       one-document bucket one block that cleared, filled and read a
//       1.5 MB table in global memory on one SM. Now K4's three forms,
//       chosen by distinct_first_form from (D, N):
//       - warp: a warp per row with its own table of keys and lowest
//         indices in shared memory, while 8 tables fit 24 KB (N <= 128).
//       - block: a row a block at a time, while the table leaves room for
//         two blocks an SM (N <= 4,096) and there are at least as many
//         rows as SMs or at most 1,024 entries a row.
//       - global: every other shape, e.g. the one-document 65,536-node
//         bucket: one cudaMemsetAsync to 0xFF clears the keys and the
//         index slots at once, then an insert grid and a probe grid of
//         (entry chunks, rows).
//       From chip_smoke.py --design-sweep on an H100 (device ms): at N 64
//       a warp's table 0.041 against a block's 0.075 (D 48,694), at N 256
//       a block's 0.063 against a warp's 0.078 (D 16,842); at N 1,024 a
//       block's table beats global tables at every D measured (D 1 0.0072
//       against 0.0079, D 528 0.014 against 0.030); at N 2,048 and 4,096
//       global tables win at D 1 and 16 (D 1 0.0088 against 0.0123, and
//       0.0087 against 0.0191) and lose from D 132.
//
//   K6 seg_min_max_rows    per-segment signed lexicographic (hi, lo) min
//                          and max over masked entries
//       Replaces _seg_min_max_keys (:993). Bound by bytes: 13 B read per
//       entry, 16 B written per segment. Two forms, chosen by
//       seg_min_max_form from (D, S):
//       - block: one block per row, the row's segment table (16 B a
//         segment) in shared memory. (hi, lo) packs into one int64 as
//         hi << 32 | (uint32)(lo ^ 0x80000000), whose signed order is the
//         lexicographic one, and folds with 64-bit atomicMin/atomicMax
//         into slots initialised to INT64_MAX/INT64_MIN; those unpack to
//         the reference's empty-segment sentinels (INT32_MAX, INT32_MAX)
//         and (INT32_MIN, INT32_MIN). Taken while the table fits a block
//         (S <= 14,528) and there are at least as many rows as SMs or at
//         most 5,125 segments a row.
//       - grid: every other shape, e.g. the one-document 65,536-node
//         bucket at S 327,685, where the first design had one block fold
//         into a 5.2 MB table in global memory on one SM. Tables in
//         global scratch, one per row for as many rows as 256 MB holds,
//         two unsigned 64-bit slots a segment: the minimum of u and the
//         minimum of ~u (the complement of the maximum), where u = ((hi ^
//         1<<31) << 32) | (lo ^ 1<<31) orders unsigned as (hi, lo) orders
//         signed. So one cudaMemsetAsync to 0xFF clears both, and those
//         bytes unpack to exactly the two sentinels. Per batch of rows a
//         fold grid of (entry chunks, rows) and an unpack grid of
//         (segment chunks, rows) that writes the four int32 outputs
//         coalesced. A shared query RHS labels every entry of a document
//         with one origin, so its entries fall in five segments: the
//         fold therefore folds a block's 512 entries into a table of
//         segments in shared memory first (seg_min_max_fold_kernel) and
//         adds one pair of global atomics a segment a block. Measured and
//         dropped: one pair of global atomics an entry, which queued on
//         those few L2 addresses and lost several times over wherever few
//         segments take the entries (it won, by little, only where nearly
//         every entry has a segment of its own); and a warp step before
//         the block's table (__match_any_sync, then __reduce_min_sync over
//         each group of lanes), whose groups ran one after another.
//       Integer atomics are exact in any order. From chip_smoke.py
//       --design-sweep on an H100 (device ms): at S 325 the block form
//       wins at every D (D 1 0.0024 against 0.0048, D 48,694 0.138
//       against 0.389); at S 5,125 it ties at D 1 (0.0056 against
//       0.0057) and wins from D 16; at S 7,685 the grid wins at D 1
//       (0.0057 against 0.0074) and D 16, at S 10,245 too (D 1 0.0058
//       against 0.0093), and loses at D 132 (0.028 against 0.015). At
//       1 x 65,536, S 327,685 the grid takes 0.010 to 0.014 with 5, 40 or
//       nearly 65,536 segments, scatter_reduce_ amin and amax 0.060 to
//       0.195.
//
// Each launcher takes raw device pointers, global scratch (null where
// the form keeps its tables in shared memory) and the caller's stream
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
// The *_branch functions name the form a launcher takes for a shape; the
// *_scratch functions give the scratch bytes of the global and grid
// forms, which the wrapper allocates only where those forms run. The
// *_as entries launch a given form, to measure where one overtakes the
// next.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// shared memory a block may opt into on sm_90 (227 KB)
constexpr long long kMaxSmem = 232448;
constexpr unsigned long long kEmpty = ~0ull;
constexpr unsigned int kNoIndex = ~0u;
constexpr int kSlotBytes = 12;  // 8 B key + 4 B value

// a valid pair has org >= 0, so its key never equals kEmpty
__device__ __forceinline__ unsigned long long pair_key(int32_t org, int32_t key) {
  return ((unsigned long long)(uint32_t)org << 32) | (uint32_t)key;
}

// splitmix64 finaliser
__device__ __forceinline__ unsigned int slot_of(unsigned long long k,
                                                unsigned int mask) {
  k ^= k >> 30;
  k *= 0xbf58476d1ce4e5b9ull;
  k ^= k >> 27;
  k *= 0x94d049bb133111ebull;
  k ^= k >> 31;
  return (unsigned int)k & mask;
}

// slot of k, claiming an empty one if k is not in the table yet
__device__ __forceinline__ unsigned int insert_slot(unsigned long long* keys,
                                               unsigned int mask,
                                               unsigned long long k) {
  unsigned int s = slot_of(k, mask);
  while (true) {
    unsigned long long prev = atomicCAS(&keys[s], kEmpty, k);
    if (prev == kEmpty || prev == k) return s;
    s = (s + 1) & mask;
  }
}

// Reads of what atomics wrote go through volatile loads, so the compiler
// keeps no earlier copy of a slot in a register.
template <typename T>
__device__ __forceinline__ T volatile_load(const T* p) {
  return *(const volatile T*)p;
}

// slot of k, or -1 when absent (no insert runs concurrently)
__device__ __forceinline__ int find_slot(const unsigned long long* keys,
                                    unsigned int mask, unsigned long long k) {
  unsigned int s = slot_of(k, mask);
  while (true) {
    unsigned long long got = volatile_load(&keys[s]);
    if (got == k) return (int)s;
    if (got == kEmpty) return -1;
    s = (s + 1) & mask;
  }
}

// hash-table slots for `entries` pairs: a power of two >= 2 * entries
long long table_slots(long long entries) {
  long long t = 32;
  while (t < 2 * entries) t <<= 1;
  return t;
}

// wait for the lanes that share a row's table: a warp's lanes, or the block
template <int G>
__device__ __forceinline__ void group_sync() {
  if (G <= 32) __syncwarp(); else __syncthreads();
}

// G lanes per row (32 or kThreads), kThreads / G rows a block at a time,
// each group with its own t-slot table in shared memory
template <int G>
__global__ void set_count_rows_kernel(const int32_t* __restrict__ q_org,
                                      const int32_t* __restrict__ q_key,
                                      const uint8_t* __restrict__ q_mask,
                                      const int32_t* __restrict__ s_org,
                                      const int32_t* __restrict__ s_key,
                                      const uint8_t* __restrict__ s_mask,
                                      int32_t* __restrict__ out, int d,
                                      int nq, int ns, int t) {
  extern __shared__ unsigned long long tables[];
  constexpr int kGroups = kThreads / G;
  const int group = threadIdx.x / G;
  const int lane = threadIdx.x % G;
  unsigned long long* keys = tables + (size_t)group * t;
  int32_t* cnt = (int32_t*)(tables + (size_t)kGroups * t) + (size_t)group * t;
  const unsigned int mask = (unsigned int)t - 1;
  // block-uniform loop: every lane reaches every group_sync
  for (long long base = (long long)blockIdx.x * kGroups; base < d;
       base += (long long)gridDim.x * kGroups) {
    long long row = base + group;
    bool live = row < d;
    if (live) {
      for (int k = lane; k < t; k += G) {
        keys[k] = kEmpty;
        cnt[k] = 0;
      }
    }
    group_sync<G>();
    if (live) {
      const int32_t* so = s_org + row * ns;
      const int32_t* sk = s_key + row * ns;
      const uint8_t* sm = s_mask + row * ns;
      for (int j = lane; j < ns; j += G) {
        int32_t o = so[j];
        if (sm[j] && o >= 0) atomicAdd(&cnt[insert_slot(keys, mask, pair_key(o, sk[j]))], 1);
      }
    }
    group_sync<G>();
    if (live) {
      const int32_t* qo = q_org + row * nq;
      const int32_t* qk = q_key + row * nq;
      const uint8_t* qm = q_mask + row * nq;
      int32_t* o_row = out + row * nq;
      for (int i = lane; i < nq; i += G) {
        int32_t o = qo[i];
        int32_t c = 0;
        if (qm[i] && o >= 0) {
          int s = find_slot(keys, mask, pair_key(o, qk[i]));
          if (s >= 0) c = volatile_load(&cnt[s]);
        }
        o_row[i] = c;
      }
    }
    group_sync<G>();  // the next row clears the table
  }
}

// global form: tables for `rows` rows from row0, slot counts from -1
__global__ void set_count_insert_kernel(const int32_t* __restrict__ s_org,
                                        const int32_t* __restrict__ s_key,
                                        const uint8_t* __restrict__ s_mask,
                                        unsigned long long* keys,
                                        int32_t* cnt, long long row0,
                                        int rows, int ns, int t) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ns) return;
  const unsigned int mask = (unsigned int)t - 1;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    long long at = (row0 + r) * ns + j;
    int32_t o = s_org[at];
    if (s_mask[at] && o >= 0) {
      unsigned long long* k = keys + (size_t)r * t;
      atomicAdd(&cnt[(size_t)r * t + insert_slot(k, mask, pair_key(o, s_key[at]))], 1);
    }
  }
}

__global__ void set_count_probe_kernel(const int32_t* __restrict__ q_org,
                                       const int32_t* __restrict__ q_key,
                                       const uint8_t* __restrict__ q_mask,
                                       const unsigned long long* keys,
                                       const int32_t* cnt,
                                       int32_t* __restrict__ out,
                                       long long row0, int rows, int nq, int t) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const unsigned int mask = (unsigned int)t - 1;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    long long at = (row0 + r) * nq + i;
    int32_t o = q_org[at];
    int32_t c = 0;
    if (q_mask[at] && o >= 0) {
      int s = find_slot(keys + (size_t)r * t, mask, pair_key(o, q_key[at]));
      if (s >= 0) c = cnt[(size_t)r * t + s] + 1;
    }
    out[at] = c;
  }
}

// G lanes per row (32 or kThreads), kThreads / G rows a block at a time,
// each group with its own t-slot table of keys and lowest indices in
// shared memory
template <int G>
__global__ void distinct_first_rows_kernel(const int32_t* __restrict__ org,
                                           const int32_t* __restrict__ key,
                                           const uint8_t* __restrict__ msk,
                                           uint8_t* __restrict__ out, int d,
                                           int n, int t) {
  extern __shared__ unsigned long long tables[];
  constexpr int kGroups = kThreads / G;
  const int group = threadIdx.x / G;
  const int lane = threadIdx.x % G;
  unsigned long long* keys = tables + (size_t)group * t;
  unsigned int* first =
      (unsigned int*)(tables + (size_t)kGroups * t) + (size_t)group * t;
  const unsigned int mask = (unsigned int)t - 1;
  // block-uniform loop: every lane reaches every group_sync
  for (long long base = (long long)blockIdx.x * kGroups; base < d;
       base += (long long)gridDim.x * kGroups) {
    long long row = base + group;
    bool live = row < d;
    if (live) {
      for (int k = lane; k < t; k += G) {
        keys[k] = kEmpty;
        first[k] = kNoIndex;
      }
    }
    group_sync<G>();
    // a row past D takes row 0's offset and touches nothing
    const long long at = live ? row * n : 0;
    const int32_t* o_in = org + at;
    const int32_t* k_in = key + at;
    const uint8_t* m_in = msk + at;
    if (live) {
      for (int i = lane; i < n; i += G) {
        int32_t o = o_in[i];
        if (m_in[i] && o >= 0)
          atomicMin(&first[insert_slot(keys, mask, pair_key(o, k_in[i]))], (unsigned int)i);
      }
    }
    group_sync<G>();
    if (live) {
      uint8_t* o_row = out + at;
      for (int i = lane; i < n; i += G) {
        int32_t o = o_in[i];
        uint8_t f = 0;
        if (m_in[i] && o >= 0)
          f = volatile_load(&first[find_slot(keys, mask, pair_key(o, k_in[i]))]) ==
              (unsigned int)i;
        o_row[i] = f;
      }
    }
    group_sync<G>();  // the next row clears the table
  }
}

// global form: tables for `rows` rows from row0, cleared to 0xFF bytes
__global__ void distinct_first_insert_kernel(const int32_t* __restrict__ org,
                                             const int32_t* __restrict__ key,
                                             const uint8_t* __restrict__ msk,
                                             unsigned long long* keys,
                                             unsigned int* first,
                                             long long row0, int rows, int n,
                                             int t) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned int mask = (unsigned int)t - 1;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    long long at = (row0 + r) * n + i;
    int32_t o = org[at];
    if (msk[at] && o >= 0) {
      unsigned int s = insert_slot(keys + (size_t)r * t, mask, pair_key(o, key[at]));
      atomicMin(&first[(size_t)r * t + s], (unsigned int)i);
    }
  }
}

__global__ void distinct_first_probe_kernel(const int32_t* __restrict__ org,
                                            const int32_t* __restrict__ key,
                                            const uint8_t* __restrict__ msk,
                                            const unsigned long long* keys,
                                            const unsigned int* first,
                                            uint8_t* __restrict__ out,
                                            long long row0, int rows, int n,
                                            int t) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned int mask = (unsigned int)t - 1;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    long long at = (row0 + r) * n + i;
    int32_t o = org[at];
    uint8_t f = 0;
    if (msk[at] && o >= 0) {
      int s = find_slot(keys + (size_t)r * t, mask, pair_key(o, key[at]));
      f = first[(size_t)r * t + s] == (unsigned int)i;
    }
    out[at] = f;
  }
}

__device__ __forceinline__ long long pack_key(int32_t hi, int32_t lo) {
  return (long long)(((unsigned long long)(uint32_t)hi << 32) |
                     ((uint32_t)lo ^ 0x80000000u));
}

// block form: one block per row, the row's table in shared memory
__global__ void seg_min_max_kernel(const int32_t* __restrict__ seg,
                                   const uint8_t* __restrict__ msk,
                                   const int32_t* __restrict__ hi,
                                   const int32_t* __restrict__ lo,
                                   int32_t* __restrict__ min_hi,
                                   int32_t* __restrict__ min_lo,
                                   int32_t* __restrict__ max_hi,
                                   int32_t* __restrict__ max_lo, int n,
                                   int s) {
  extern __shared__ long long smem_seg[];
  long long* tmin = smem_seg;
  long long* tmax = tmin + s;
  long long row = blockIdx.x;
  for (int k = threadIdx.x; k < s; k += blockDim.x) {
    tmin[k] = 0x7fffffffffffffffll;
    tmax[k] = (long long)0x8000000000000000ull;
  }
  __syncthreads();
  const int32_t* g = seg + row * n;
  const uint8_t* m = msk + row * n;
  const int32_t* h = hi + row * n;
  const int32_t* l = lo + row * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int b = g[i];
    if (m[i] && b >= 0 && b < s) {
      long long p = pack_key(h[i], l[i]);
      atomicMin(&tmin[b], p);
      atomicMax(&tmax[b], p);
    }
  }
  __syncthreads();
  long long base = row * (long long)s;
  for (int k = threadIdx.x; k < s; k += blockDim.x) {
    unsigned long long a = (unsigned long long)volatile_load(&tmin[k]);
    unsigned long long z = (unsigned long long)volatile_load(&tmax[k]);
    min_hi[base + k] = (int32_t)(uint32_t)(a >> 32);
    min_lo[base + k] = (int32_t)((uint32_t)a ^ 0x80000000u);
    max_hi[base + k] = (int32_t)(uint32_t)(z >> 32);
    max_lo[base + k] = (int32_t)((uint32_t)z ^ 0x80000000u);
  }
}

// a key whose unsigned order is the signed lexicographic (hi, lo) order
__device__ __forceinline__ unsigned long long order_key(int32_t hi, int32_t lo) {
  return ((unsigned long long)((uint32_t)hi ^ 0x80000000u) << 32) |
         ((uint32_t)lo ^ 0x80000000u);
}

// a block of the fold takes kFoldPerThread entries a thread and folds
// them into kFoldSlots segment slots in shared memory
constexpr int kFoldPerThread = 2;
constexpr int kFoldSlotBits = 10;
constexpr int kFoldSlots = 1 << kFoldSlotBits;
constexpr int kFoldProbes = 8;

// segment b's slot in the block's table, claimed if b has none yet; -1
// when the kFoldProbes slots it may take hold other segments
__device__ __forceinline__ int fold_slot(int* ids, int b) {
  unsigned int h = ((unsigned int)b * 0x9e3779b1u) >> (32 - kFoldSlotBits);
  for (int probe = 0; probe < kFoldProbes; ++probe) {
    int got = volatile_load(&ids[h]);
    if (got == -1) got = atomicCAS(&ids[h], -1, b);
    if (got == -1 || got == b) return (int)h;
    h = (h + 1) & (kFoldSlots - 1);
  }
  return -1;
}

__device__ __forceinline__ unsigned long long join_words(unsigned int h, unsigned int l) {
  return ((unsigned long long)h << 32) | l;
}

// grid form: per segment the minimum of u = order_key(hi, lo) and the
// minimum of ~u (the complement of the maximum), in tables for `rows`
// rows from row0 cleared to 0xFF bytes. A shared RHS puts a document's
// entries in a handful of segments, where one global atomic an entry
// would queue on a few L2 addresses; so a block first folds its entries
// into a table in shared memory (the 32-bit high words, then the low
// words of the entries that hold the high minimum, as _seg_min_max_keys
// does, all native 32-bit atomics), then adds each segment it holds into
// the global table with one pair of 64-bit atomics.
__global__ void seg_min_max_fold_kernel(const int32_t* __restrict__ seg,
                                        const uint8_t* __restrict__ msk,
                                        const int32_t* __restrict__ hi,
                                        const int32_t* __restrict__ lo,
                                        unsigned long long* table,
                                        long long row0, int rows, int n,
                                        int s) {
  __shared__ int ids[kFoldSlots];
  // high and low words of min u (0, 1) and of min ~u (2, 3) per slot
  __shared__ unsigned int words[4][kFoldSlots];
  const long long begin = (long long)blockIdx.x * kThreads * kFoldPerThread;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    for (int k = threadIdx.x; k < kFoldSlots; k += kThreads) {
      ids[k] = -1;
      for (int w = 0; w < 4; ++w) words[w][k] = ~0u;
    }
    __syncthreads();
    unsigned long long* row_table = table + 2 * (size_t)r * s;
    int slot[kFoldPerThread];
    unsigned long long key[kFoldPerThread];
#pragma unroll
    for (int p = 0; p < kFoldPerThread; ++p) {
      slot[p] = -1;
      key[p] = 0;
      long long i = begin + p * kThreads + threadIdx.x;
      if (i >= n) continue;
      long long at = (row0 + r) * n + i;
      int b = seg[at];
      if (!msk[at] || b < 0 || b >= s) continue;
      unsigned long long u = order_key(hi[at], lo[at]);
      int k = fold_slot(ids, b);
      if (k < 0) {
        atomicMin(&row_table[2 * (size_t)b], u);
        atomicMin(&row_table[2 * (size_t)b + 1], ~u);
        continue;
      }
      slot[p] = k;
      key[p] = u;
      atomicMin(&words[0][k], (unsigned int)(u >> 32));
      atomicMin(&words[2][k], ~(unsigned int)(u >> 32));
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kFoldPerThread; ++p) {
      int k = slot[p];
      if (k < 0) continue;
      unsigned int h = (unsigned int)(key[p] >> 32);
      unsigned int l = (unsigned int)key[p];
      if (h == words[0][k]) atomicMin(&words[1][k], l);
      if (~h == words[2][k]) atomicMin(&words[3][k], ~l);
    }
    __syncthreads();
    for (int k = threadIdx.x; k < kFoldSlots; k += kThreads) {
      int b = ids[k];
      if (b < 0) continue;
      atomicMin(&row_table[2 * (size_t)b], join_words(words[0][k], words[1][k]));
      atomicMin(&row_table[2 * (size_t)b + 1], join_words(words[2][k], words[3][k]));
    }
    __syncthreads();  // the next row clears the slots
  }
}

__device__ __forceinline__ int32_t high_word(unsigned long long u) {
  return (int32_t)((uint32_t)(u >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ int32_t low_word(unsigned long long u) {
  return (int32_t)((uint32_t)u ^ 0x80000000u);
}

__global__ void seg_min_max_unpack_kernel(const ulonglong2* __restrict__ table,
                                          int32_t* __restrict__ min_hi,
                                          int32_t* __restrict__ min_lo,
                                          int32_t* __restrict__ max_hi,
                                          int32_t* __restrict__ max_lo,
                                          long long row0, int rows, int s) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= s) return;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    ulonglong2 v = table[(size_t)r * s + k];
    unsigned long long z = ~v.y;
    long long at = (row0 + r) * s + k;
    min_hi[at] = high_word(v.x);
    min_lo[at] = low_word(v.x);
    max_hi[at] = high_word(z);
    max_lo[at] = low_word(z);
  }
}

// The forms of a launcher (guard_*_branch): lanes per row of a table in
// shared memory (a warp, or the block), 0 for tables in global scratch
enum { kWarpForm = 32, kBlockForm = kThreads, kGlobalForm = 0 };
// K4's thresholds (K5 takes them with one more rule, distinct_first_form),
// from chip_smoke.py --design-sweep on an H100:
// a warp a row while 8 tables fit kWarpTableSmem bytes (K4: Ns <= 128; at
// Ns 256 a block a row wins, 0.058 against 0.074 ms at D 16,842), a block
// a row while its table leaves room for a second block on the SM (Ns <=
// 4,096) and there are at least as many rows as SMs; global tables
// otherwise (K4 at Ns 8,192: they win at every D measured from 1 to 528,
// at Ns 2,048 they win at D 1 and lose from D 528)
constexpr long long kWarpTableSmem = 24 * 1024;
// global scratch the tables of a global or grid form may take at a time
constexpr long long kScratchBytes = 256ll << 20;
int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// K4's and K5's form for D rows of tables of `entries` pairs
int table_form(int d, int entries) {
  long long table = table_slots(entries) * kSlotBytes;
  if (table * (kThreads / kWarpForm) <= kWarpTableSmem) return kWarpForm;
  if (2 * table <= kMaxSmem && d >= sm_count()) return kBlockForm;
  return kGlobalForm;
}

// rows whose tables of per_row bytes share the scratch at a time
int batch_rows(int d, long long per_row) {
  long long rows = kScratchBytes / per_row;
  if (rows > d) rows = d;
  if (rows > 65535) rows = 65535;
  return rows < 1 ? 1 : (int)rows;
}

long long table_scratch(int d, int entries) {
  if (d == 0) return 0;
  long long per_row = table_slots(entries) * kSlotBytes;
  return (long long)batch_rows(d, per_row) * per_row;
}

// opt a kernel into smem bytes of dynamic shared memory where that
// exceeds the default 48 KB
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// blocks of kThreads for D rows, kGroups rows a block at a time: at most
// one wave of resident blocks, which strides over the rows
template <typename Kernel>
unsigned int one_wave(Kernel kernel, long long smem, int d, int groups) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, (size_t)smem);
  long long blocks = ((long long)d + groups - 1) / groups;
  long long cap = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
  return (unsigned int)(blocks > cap ? cap : blocks);
}

template <int G>
int launch_set_count(const int32_t* q_org, const int32_t* q_key,
                     const uint8_t* q_mask, const int32_t* s_org,
                     const int32_t* s_key, const uint8_t* s_mask,
                     int32_t* out, int d, int nq, int ns,
                     cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  int t = (int)table_slots(ns);
  long long smem = (long long)kGroups * t * kSlotBytes;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(set_count_rows_kernel<G>, smem);
  if (e != cudaSuccess) return (int)e;
  unsigned int blocks = one_wave(set_count_rows_kernel<G>, smem, d, kGroups);
  set_count_rows_kernel<G><<<blocks, kThreads, (size_t)smem, stream>>>(
      q_org, q_key, q_mask, s_org, s_key, s_mask, out, d, nq, ns, t);
  return (int)cudaGetLastError();
}

template <int G>
int launch_distinct_first(const int32_t* org, const int32_t* key,
                          const uint8_t* msk, uint8_t* out, int d, int n,
                          cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  int t = (int)table_slots(n);
  long long smem = (long long)kGroups * t * kSlotBytes;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(distinct_first_rows_kernel<G>, smem);
  if (e != cudaSuccess) return (int)e;
  unsigned int blocks = one_wave(distinct_first_rows_kernel<G>, smem, d, kGroups);
  distinct_first_rows_kernel<G><<<blocks, kThreads, (size_t)smem, stream>>>(
      org, key, msk, out, d, n, t);
  return (int)cudaGetLastError();
}

// grid of (chunks of `width` entries, rows), at most 65,535 rows high
dim3 row_grid(int width, int rows) {
  return dim3((width + kThreads - 1) / kThreads, rows < 65535 ? rows : 65535);
}

// K5's form: K4's, but a block's table also for fewer rows than SMs while
// a row holds at most kDistinctFewRowsN entries
constexpr int kDistinctFewRowsN = 1024;
int distinct_first_form(int d, int n) {
  int form = table_form(d, n);
  return form == kGlobalForm && n <= kDistinctFewRowsN ? kBlockForm : form;
}

// K6's block form while the table fits a block, and there are at least as
// many rows as SMs or at most kSegFewRowsS segments a row (the query-RHS
// width (N + 1) * 5 of a 1,024-node bucket)
constexpr int kSegFewRowsS = 5125;
int seg_min_max_form(int d, int s) {
  bool fits = (long long)s * 16 <= kMaxSmem;
  return fits && (d >= sm_count() || s <= kSegFewRowsS) ? kBlockForm : kGlobalForm;
}

}  // namespace

extern "C" {

// the form guard_set_count_rows takes for D rows of ns set entries
int guard_set_count_branch(int d, int ns) { return table_form(d, ns); }

// global scratch bytes K4's global form needs for (D, Ns): the tables
// of the rows that share it at a time
long long guard_set_count_scratch(int d, int ns) { return table_scratch(d, ns); }

// K4 on a given form (the one guard_set_count_branch picks, or another,
// to measure where one overtakes the next); scratch of
// guard_set_count_scratch's size for the global form, else null
int guard_set_count_rows_as(int branch, const void* q_org, const void* q_key,
                            const void* q_mask, const void* s_org,
                            const void* s_key, const void* s_mask, void* out,
                            void* scratch, int d, int nq, int ns,
                            void* stream) {
  if (d == 0 || nq == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* qo = (const int32_t*)q_org;
  const int32_t* qk = (const int32_t*)q_key;
  const uint8_t* qm = (const uint8_t*)q_mask;
  const int32_t* so = (const int32_t*)s_org;
  const int32_t* sk = (const int32_t*)s_key;
  const uint8_t* sm = (const uint8_t*)s_mask;
  int32_t* o = (int32_t*)out;
  switch (branch) {
    case kWarpForm: return launch_set_count<kWarpForm>(qo, qk, qm, so, sk, sm, o, d, nq, ns, st);
    case kBlockForm: return launch_set_count<kBlockForm>(qo, qk, qm, so, sk, sm, o, d, nq, ns, st);
    case kGlobalForm: break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  int t = (int)table_slots(ns);
  int rows = batch_rows(d, t * (long long)kSlotBytes);
  unsigned long long* keys = (unsigned long long*)scratch;
  int32_t* cnt = (int32_t*)(keys + (size_t)rows * t);
  for (long long row0 = 0; row0 < d; row0 += rows) {
    int n_rows = d - row0 < rows ? (int)(d - row0) : rows;
    cudaError_t e = cudaMemsetAsync(scratch, 0xff, (size_t)rows * t * kSlotBytes, st);
    if (e != cudaSuccess) return (int)e;
    if (ns > 0) {
      set_count_insert_kernel<<<row_grid(ns, n_rows), kThreads, 0, st>>>(
          so, sk, sm, keys, cnt, row0, n_rows, ns, t);
    }
    set_count_probe_kernel<<<row_grid(nq, n_rows), kThreads, 0, st>>>(
        qo, qk, qm, keys, cnt, o, row0, n_rows, nq, t);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

int guard_set_count_rows(const void* q_org, const void* q_key,
                         const void* q_mask, const void* s_org,
                         const void* s_key, const void* s_mask, void* out,
                         void* scratch, int d, int nq, int ns, void* stream) {
  return guard_set_count_rows_as(guard_set_count_branch(d, ns), q_org, q_key,
                                 q_mask, s_org, s_key, s_mask, out, scratch, d,
                                 nq, ns, stream);
}

// the form guard_distinct_first_rows takes for D rows of n entries
int guard_distinct_first_branch(int d, int n) { return distinct_first_form(d, n); }

// global scratch bytes K5's global form needs for (D, N)
long long guard_distinct_first_scratch(int d, int n) { return table_scratch(d, n); }

// K5 on a given form; scratch of guard_distinct_first_scratch's size for
// the global form, else null
int guard_distinct_first_rows_as(int branch, const void* org, const void* key,
                                 const void* mask, void* out, void* scratch,
                                 int d, int n, void* stream) {
  if (d == 0 || n == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* o = (const int32_t*)org;
  const int32_t* k = (const int32_t*)key;
  const uint8_t* m = (const uint8_t*)mask;
  uint8_t* f = (uint8_t*)out;
  switch (branch) {
    case kWarpForm: return launch_distinct_first<kWarpForm>(o, k, m, f, d, n, st);
    case kBlockForm: return launch_distinct_first<kBlockForm>(o, k, m, f, d, n, st);
    case kGlobalForm: break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  int t = (int)table_slots(n);
  int rows = batch_rows(d, t * (long long)kSlotBytes);
  unsigned long long* keys = (unsigned long long*)scratch;
  unsigned int* first = (unsigned int*)(keys + (size_t)rows * t);
  for (long long row0 = 0; row0 < d; row0 += rows) {
    int n_rows = d - row0 < rows ? (int)(d - row0) : rows;
    cudaError_t e = cudaMemsetAsync(scratch, 0xff, (size_t)rows * t * kSlotBytes, st);
    if (e != cudaSuccess) return (int)e;
    distinct_first_insert_kernel<<<row_grid(n, n_rows), kThreads, 0, st>>>(
        o, k, m, keys, first, row0, n_rows, n, t);
    distinct_first_probe_kernel<<<row_grid(n, n_rows), kThreads, 0, st>>>(
        o, k, m, keys, first, f, row0, n_rows, n, t);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

int guard_distinct_first_rows(const void* org, const void* key,
                              const void* mask, void* out, void* scratch,
                              int d, int n, void* stream) {
  return guard_distinct_first_rows_as(guard_distinct_first_branch(d, n), org, key,
                                      mask, out, scratch, d, n, stream);
}

// the form guard_seg_min_max_rows takes for (D, N, S): kBlockForm for a
// table in shared memory, kGlobalForm for the grid over global tables
int guard_seg_min_max_branch(int d, int n, int s) {
  (void)n;
  return seg_min_max_form(d, s);
}

// global scratch bytes K6's grid form needs for (D, S): 16 B a segment
// for the rows that share it at a time
long long guard_seg_min_max_scratch(int d, int s) {
  if (d == 0 || s == 0) return 0;
  return (long long)batch_rows(d, (long long)s * 16) * s * 16;
}

// K6 on a given form; scratch of guard_seg_min_max_scratch's size for the
// grid form, else null
int guard_seg_min_max_rows_as(int branch, const void* seg, const void* mask,
                              const void* hi, const void* lo, void* min_hi,
                              void* min_lo, void* max_hi, void* max_lo,
                              void* scratch, int d, int n, int s,
                              void* stream) {
  if (d == 0 || s == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* g = (const int32_t*)seg;
  const uint8_t* m = (const uint8_t*)mask;
  const int32_t* h = (const int32_t*)hi;
  const int32_t* l = (const int32_t*)lo;
  int32_t* mnh = (int32_t*)min_hi;
  int32_t* mnl = (int32_t*)min_lo;
  int32_t* mxh = (int32_t*)max_hi;
  int32_t* mxl = (int32_t*)max_lo;
  if (branch == kBlockForm) {
    long long smem = (long long)s * 16;
    if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_smem(seg_min_max_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    seg_min_max_kernel<<<d, kThreads, (size_t)smem, st>>>(g, m, h, l, mnh, mnl, mxh,
                                                          mxl, n, s);
    return (int)cudaGetLastError();
  }
  if (branch != kGlobalForm || scratch == nullptr) return (int)cudaErrorInvalidValue;
  int rows = batch_rows(d, (long long)s * 16);
  unsigned long long* table = (unsigned long long*)scratch;
  for (long long row0 = 0; row0 < d; row0 += rows) {
    int n_rows = d - row0 < rows ? (int)(d - row0) : rows;
    cudaError_t e = cudaMemsetAsync(scratch, 0xff, (size_t)n_rows * s * 16, st);
    if (e != cudaSuccess) return (int)e;
    if (n > 0) {
      seg_min_max_fold_kernel<<<row_grid((n + kFoldPerThread - 1) / kFoldPerThread, n_rows),
                                kThreads, 0, st>>>(g, m, h, l, table, row0, n_rows, n, s);
    }
    seg_min_max_unpack_kernel<<<row_grid(s, n_rows), kThreads, 0, st>>>(
        (const ulonglong2*)table, mnh, mnl, mxh, mxl, row0, n_rows, s);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

int guard_seg_min_max_rows(const void* seg, const void* mask, const void* hi,
                           const void* lo, void* min_hi, void* min_lo,
                           void* max_hi, void* max_lo, void* scratch, int d,
                           int n, int s, void* stream) {
  return guard_seg_min_max_rows_as(guard_seg_min_max_branch(d, n, s), seg, mask, hi,
                                   lo, min_hi, min_lo, max_hi, max_lo, scratch, d,
                                   n, s, stream);
}

}  // extern "C"
