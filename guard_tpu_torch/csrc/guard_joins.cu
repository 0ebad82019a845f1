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
//       for a one-row 65,536-node bucket. Three geometries now, chosen by
//       the launcher from (D, Ns):
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
//       kSetWarpSmem). Measured there and dropped: a hash-free form (a
//       warp a row, set pairs in registers, each query sent round the
//       warp by shuffle) lost to the warp's table at every Ns from 32 to
//       256; loading four entries a lane before inserting any lost too;
//       so did a 32-bit multiplicative hash in place of splitmix64.
//
//   K5 distinct_first_rows out[d,i] = entry i is the lowest index of its
//                          (org, key) among entries with mask and org >= 0
//       Replaces _distinct_first_sorted (:978), whose stable three-key
//       sort puts the lowest index first. The same table holds an
//       atomicMin of the entry index per pair; an entry is first when it
//       holds the minimum. Bound by bytes: 9 B read, 1 B written per entry.
//
//   K6 seg_min_max_rows    per-segment signed lexicographic (hi, lo) min
//                          and max over masked entries
//       Replaces _seg_min_max_keys (:993). (hi, lo) packs into one int64
//       as hi << 32 | (uint32)(lo ^ 0x80000000), whose signed order is
//       the lexicographic one, and folds with 64-bit atomicMin/atomicMax
//       into a per-row segment table initialised to INT64_MAX/INT64_MIN;
//       those unpack to the reference's empty-segment sentinels
//       (INT32_MAX, INT32_MAX) and (INT32_MIN, INT32_MIN). The table
//       (16 B a segment) is in shared memory while it fits (S <= 14,528,
//       node buckets up to 2,048 at S = (N+1)*5), in global scratch
//       otherwise. Bound by bytes: 13 B read per entry, 16 B written per
//       segment.
//
// Each launcher takes raw device pointers, global scratch (null on the
// shared-memory branch) and the caller's stream (PyTorch's current
// stream), does not synchronise, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch. The *_scratch functions
// tell the wrapper how many scratch bytes the launch needs: K5 and K6 per
// block, 0 when their shared-memory branch runs; K4 for its global
// branch's tables, which the wrapper allocates where that branch runs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// shared memory a block may opt into on sm_90 (227 KB)
constexpr long long kMaxSmem = 232448;
constexpr unsigned long long kEmpty = ~0ull;
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

// Reads of what atomics wrote go through volatile loads: in the global
// branch the atomics resolve in L2, and a plain load could hit a line
// that L1 kept from the previous row.
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

// global branch: tables for `rows` rows from row0, slot counts from -1
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

template <bool kShared>
__global__ void distinct_first_kernel(const int32_t* __restrict__ org,
                                      const int32_t* __restrict__ key,
                                      const uint8_t* __restrict__ msk,
                                      uint8_t* __restrict__ out,
                                      unsigned char* __restrict__ scratch,
                                      int d, int n, int t) {
  extern __shared__ unsigned long long smem_keys[];
  unsigned long long* keys =
      kShared ? smem_keys
              : (unsigned long long*)(scratch +
                                      (size_t)blockIdx.x * t * kSlotBytes);
  int32_t* first = (int32_t*)(keys + t);
  const unsigned int mask = (unsigned int)t - 1;
  for (long long row = blockIdx.x; row < d; row += gridDim.x) {
    for (int k = threadIdx.x; k < t; k += blockDim.x) {
      keys[k] = kEmpty;
      first[k] = 0x7fffffff;
    }
    __syncthreads();
    const int32_t* o_in = org + row * n;
    const int32_t* k_in = key + row * n;
    const uint8_t* m_in = msk + row * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      int32_t o = o_in[i];
      if (m_in[i] && o >= 0) atomicMin(&first[insert_slot(keys, mask, pair_key(o, k_in[i]))], i);
    }
    __syncthreads();
    uint8_t* o_row = out + row * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      int32_t o = o_in[i];
      uint8_t f = 0;
      if (m_in[i] && o >= 0) f = volatile_load(&first[find_slot(keys, mask, pair_key(o, k_in[i]))]) == i;
      o_row[i] = f;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ long long pack_key(int32_t hi, int32_t lo) {
  return (long long)(((unsigned long long)(uint32_t)hi << 32) |
                     ((uint32_t)lo ^ 0x80000000u));
}

template <bool kShared>
__global__ void seg_min_max_kernel(const int32_t* __restrict__ seg,
                                   const uint8_t* __restrict__ msk,
                                   const int32_t* __restrict__ hi,
                                   const int32_t* __restrict__ lo,
                                   int32_t* __restrict__ min_hi,
                                   int32_t* __restrict__ min_lo,
                                   int32_t* __restrict__ max_hi,
                                   int32_t* __restrict__ max_lo,
                                   unsigned char* __restrict__ scratch, int d,
                                   int n, int s) {
  extern __shared__ long long smem_seg[];
  long long* tmin =
      kShared ? smem_seg : (long long*)(scratch + (size_t)blockIdx.x * s * 16);
  long long* tmax = tmin + s;
  for (long long row = blockIdx.x; row < d; row += gridDim.x) {
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
    __syncthreads();
  }
}

// launch on the shared-memory branch (grid = one block per row) when
// smem bytes fit, else on the global branch with `blocks` blocks
template <typename SharedK, typename GlobalK, typename... Args>
int launch(SharedK shared_k, GlobalK global_k, long long smem, int d,
           int blocks, cudaStream_t stream, Args... args) {
  if (smem <= kMaxSmem) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          shared_k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    shared_k<<<d, kThreads, (size_t)smem, stream>>>(args...);
  } else {
    global_k<<<blocks, kThreads, 0, stream>>>(args...);
  }
  return (int)cudaGetLastError();
}

// K4's geometries (guard_set_count_branch): lanes per row of a table in
// shared memory (a warp, or the block), 0 for tables in global scratch
enum { kSetWarp = 32, kSetBlock = kThreads, kSetGlobal = 0 };
// K4's thresholds, from chip_smoke.py --design-sweep on an H100: a warp a
// row while 8 tables fit kSetWarpSmem bytes (Ns <= 128; at Ns 256 a
// block a row wins, 0.058 against 0.074 ms at D 16,842), a block a row
// while its table leaves room for a second block on the SM (Ns <= 4,096)
// and there are at least as many rows as SMs; global tables otherwise
// (at Ns 8,192 they win at every D measured from 1 to 528, at Ns 2,048
// they win at D 1 and lose from D 528)
constexpr long long kSetWarpSmem = 24 * 1024;
// global scratch the global branch's tables may take at a time
constexpr long long kSetScratchBytes = 256ll << 20;
int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// rows of the global branch whose tables share the scratch at a time
int set_count_batch_rows(int d, int ns) {
  long long per_row = table_slots(ns) * kSlotBytes;
  long long rows = kSetScratchBytes / per_row;
  if (rows > d) rows = d;
  if (rows > 65535) rows = 65535;
  return rows < 1 ? 1 : (int)rows;
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
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(set_count_rows_kernel<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // one wave of resident blocks strides over the rows
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, set_count_rows_kernel<G>,
                                                kThreads, (size_t)smem);
  long long blocks = ((long long)d + kGroups - 1) / kGroups;
  long long cap = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
  if (blocks > cap) blocks = cap;
  set_count_rows_kernel<G><<<(unsigned)blocks, kThreads, (size_t)smem, stream>>>(
      q_org, q_key, q_mask, s_org, s_key, s_mask, out, d, nq, ns, t);
  return (int)cudaGetLastError();
}

long long scratch_or_zero(long long bytes) { return bytes <= kMaxSmem ? 0 : bytes; }

}  // namespace

extern "C" {

// the geometry guard_set_count_rows takes for D rows of ns set entries
int guard_set_count_branch(int d, int ns) {
  long long table = table_slots(ns) * kSlotBytes;
  if (table * (kThreads / kSetWarp) <= kSetWarpSmem) return kSetWarp;
  if (2 * table <= kMaxSmem && d >= sm_count()) return kSetBlock;
  return kSetGlobal;
}

// global scratch bytes K4's global branch needs for (D, Ns): the tables
// of the rows that share it at a time
long long guard_set_count_scratch(int d, int ns) {
  if (d == 0) return 0;
  return (long long)set_count_batch_rows(d, ns) * table_slots(ns) * kSlotBytes;
}

long long guard_distinct_first_scratch(int n) {
  return scratch_or_zero(table_slots(n) * kSlotBytes);
}

long long guard_seg_min_max_scratch(int s) {
  return scratch_or_zero((long long)s * 16);
}

// K4 on a given geometry (the one guard_set_count_branch picks, or another,
// to measure where one overtakes the next); scratch of
// guard_set_count_scratch's size for the global branch, else null
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
    case kSetWarp: return launch_set_count<kSetWarp>(qo, qk, qm, so, sk, sm, o, d, nq, ns, st);
    case kSetBlock: return launch_set_count<kSetBlock>(qo, qk, qm, so, sk, sm, o, d, nq, ns, st);
    case kSetGlobal: break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  int t = (int)table_slots(ns);
  int rows = set_count_batch_rows(d, ns);
  unsigned long long* keys = (unsigned long long*)scratch;
  int32_t* cnt = (int32_t*)(keys + (size_t)rows * t);
  for (long long row0 = 0; row0 < d; row0 += rows) {
    int n_rows = d - row0 < rows ? (int)(d - row0) : rows;
    cudaError_t e = cudaMemsetAsync(scratch, 0xff, (size_t)rows * t * kSlotBytes, st);
    if (e != cudaSuccess) return (int)e;
    if (ns > 0) {
      set_count_insert_kernel<<<dim3((ns + kThreads - 1) / kThreads, n_rows), kThreads, 0, st>>>(
          so, sk, sm, keys, cnt, row0, n_rows, ns, t);
    }
    set_count_probe_kernel<<<dim3((nq + kThreads - 1) / kThreads, n_rows), kThreads, 0, st>>>(
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

int guard_distinct_first_rows(const void* org, const void* key,
                              const void* mask, void* out, void* scratch,
                              int d, int n, int blocks, void* stream) {
  if (d == 0 || n == 0) return (int)cudaGetLastError();
  int t = (int)table_slots(n);
  if (scratch == nullptr && guard_distinct_first_scratch(n) != 0)
    return (int)cudaErrorInvalidValue;
  return launch(distinct_first_kernel<true>, distinct_first_kernel<false>,
                (long long)t * kSlotBytes, d, blocks, (cudaStream_t)stream,
                (const int32_t*)org, (const int32_t*)key,
                (const uint8_t*)mask, (uint8_t*)out, (unsigned char*)scratch,
                d, n, t);
}

int guard_seg_min_max_rows(const void* seg, const void* mask, const void* hi,
                           const void* lo, void* min_hi, void* min_lo,
                           void* max_hi, void* max_lo, void* scratch, int d,
                           int n, int s, int blocks, void* stream) {
  if (d == 0 || s == 0) return (int)cudaGetLastError();
  if (scratch == nullptr && guard_seg_min_max_scratch(s) != 0)
    return (int)cudaErrorInvalidValue;
  return launch(seg_min_max_kernel<true>, seg_min_max_kernel<false>,
                (long long)s * 16, d, blocks, (cudaStream_t)stream,
                (const int32_t*)seg, (const uint8_t*)mask,
                (const int32_t*)hi, (const int32_t*)lo, (int32_t*)min_hi,
                (int32_t*)min_lo, (int32_t*)max_hi, (int32_t*)max_lo,
                (unsigned char*)scratch, d, n, s);
}

}  // extern "C"
