// Hand-written Hopper kernels for the torch port's evaluation walk.
//
// Three kernels carry every gather and scatter of the walk
// (guard_tpu_torch/ops/kernels.py) and the rim behind it; a fourth (K7)
// counts the statuses per rule for DeviceBatchEvaluator.with_summary.
// All tensors are row-major and batched over documents: a (D, N) int32
// column holds one document per row, padded to the node bucket N.
//
//   K1 gather_rows       out[d,i] = 0 <= idx[d,i] < S ? vec[d, idx[d,i]] : 0
//       Replaces _parent_select (guard_tpu/ops/kernels.py:208) and
//       _select_at (:349), and the jnp.take reads of per-origin and
//       per-segment vectors in the query-RHS compares (:1080-1087,
//       :1533-1538, :1568): vec is (D, S) for any S, idx and out (D, N).
//       Bound by bytes: 12 B per element (read vec and idx, write out).
//       One thread per element; the index read is coalesced, the vec
//       read stays inside one row, so it hits L1/L2.
//
//   K2 segment_sum_rows  out[d,s] = sum of val[d,i] over i with seg[d,i] == s
//       Replaces _count_children (:218), _segment_count/_agg (:233, :247)
//       and _UnresAcc.finalize (:287). Lanes with seg outside [0, S)
//       add nothing (root and padding lanes carry seg -1), and lanes with
//       val 0 are skipped before any atomic. Bound by bytes: 8 B per
//       element read plus 4 B per output bin written. Integer atomics
//       make the sum exact in any order. The first design ran one
//       256-thread block per row on every shape: at the main shape (D
//       65,536 x N 64, S 65) three quarters of its threads had no lane
//       and every row paid two block barriers, so block scheduling, not
//       bytes, bound it; a one-row 65,536-node bucket ran on one SM.
//       Three geometries now, chosen by the launcher from (D, N, S):
//       - group: a lane group of G = 8, 16 or 32 lanes per row (the
//         fewest that give each lane one load of the row and at most 8
//         bins to write), 256 / G rows a block at a time, each group
//         with its own S bins in shared memory, synchronised by
//         __syncwarp alone; a grid of one wave of resident blocks
//         strides over the rows. Rows are read as 16-byte loads where
//         N % 4 == 0 and both columns start on a 16-byte boundary. A
//         group writes its bins out coalesced and clears them in the same
//         pass. Taken for N <= 512 while the block's bins fit 48 KB.
//       - block: the same kernel with G = 256 (one row a block at a
//         time, block barriers), for wider rows whose S bins fit the
//         227 KB a block may opt into.
//       - split: S * 4 bytes beyond shared memory (the one-document
//         65,536-node bucket), or a few long rows (N > 4,096 and D * N <=
//         262,144). The output is zeroed on the stream (cudaMemsetAsync,
//         which a CUDA graph captures) and a grid of (row chunks, rows)
//         adds with global atomics, so the grid fills the card whatever
//         D is.
//       The thresholds are chip_smoke.py --design-sweep's (see below).
//
//   K3 rim_reduce        six rim blocks from (D, R) statuses in one launch
//       Replaces segment_doc_status (:1966), segment_any (:1994) and
//       rim_reduce (:2015) as run by parallel/mesh.py _rim_device (:362).
//       Statuses map to the priority FAIL(2) > PASS(1) > SKIP(0) and are
//       folded by a segment max; empty segments come out SKIP, an empty
//       OR comes out false. Bound by bytes: 2 B per (doc, rule) read,
//       3 B per (doc, group) and (doc, file) written. A segment max over
//       three priorities is decided by two bits (some rule PASS, some rule
//       FAIL), so the thread and warp forms fold bitsets, with no atomic
//       per rule; both drop a group or file id outside its range (the
//       block form needs every id in range, as the rim spec gives them).
//       Three forms, chosen by the launcher from (D, R, G, F):
//       - block, the first design: one 256-thread block a row, the
//         accumulators in shared memory. Up to 1,024 rows, where one
//         launch of small blocks beats the others' table set-up (0.0022
//         ms at D 1), and wherever the warp form's tables do not fit. At
//         65,536 rows of 4 rules it took 0.063 ms: 65,536 blocks of
//         mostly idle threads for 1.5 MB.
//       - thread: a thread a row folds six 64-bit masks (group and file
//         PASS, FAIL, unsure) in registers, reading its row 16, 4 or 1
//         bytes a load; the block then writes the tile's six output
//         blocks four neighbouring bytes a thread (one 32-bit store,
//         four mask bits spread into four bytes by one multiply), so
//         every write is coalesced. From 16,384 rows while G and F <= 64
//         and R <= 256: 0.0049 ms at 65,536 x 4 x 4 x 1.
//       - warp: a warp folds four rows at a time. Its lanes ballot three
//         words of rule bits per 32 rules and row into the warp's shared
//         memory; lane k ANDs them with group k's rule mask (kept in
//         shared memory with the range of words it spans, empty words
//         skipped), so there is no barrier per row, and a warp writes 32
//         neighbouring bytes at a time. Everything else while its tables
//         fit.
//       The thresholds are chip_smoke.py --design-sweep's on an H100
//       (block against warp at D 1,024, warp against thread at D 8,192
//       and 16,842, thread against warp at R 256 and 1,024). Tried and
//       dropped: the thread form indexing its six outputs at run time (a
//       stack frame, 0.0059 ms at D 1), and the warp form loading four
//       chunks of 32 rules at once (slower at R 64). The wide shapes stay
//       at 3 to 4 times their bound (1,048,576 x 64 x 41 x 1, 262,144 x
//       256 x 130 x 4, 65,536 x 512 x 512 x 64): PERF.md.
//
//   K7 rule_summary      counts[k, j] = #{rows d < n_valid : statuses[d, j] == k}
//       Replaces the per-rule (PASS, FAIL, SKIP) counts of
//       parallel/mesh.py _shared_evaluator_fns.summarize (:338-349),
//       reached through ShardedBatchEvaluator.with_summary (:540). The
//       valid rows are the first n_valid of a row-major (D, R) int8
//       matrix; a status outside 0..2 counts nowhere. Bound by bytes: 1 B
//       per (valid doc, rule) read, 12 B per rule written. The valid rows
//       are read as one run of bytes in whole W-byte words: P = W /
//       gcd(R, W) rows make a period of P * R bytes, a whole number of
//       words, so a thread that reads the same word of every period
//       always counts the same W columns, whatever R is (the first design
//       read a byte a load where R % 4 != 0: 0.863 ms at 1,048,576 x
//       1,028). A word is counted four bytes at a time with 12 integer
//       operations into packed byte counters, flushed into registers
//       every 255 words; the bytes before the first word boundary and
//       after the last whole period go byte by byte through block (0, 0).
//       Forms, chosen from the rows each thread would read:
//       - one block (D 1, the entry point's 8 x 2): writes every counter,
//         so nothing is zeroed first.
//       - one cluster of 16 blocks (up to 64 periods a thread, R <= 256:
//         the summary's 65,536 x 4 bucket): each block counts into its
//         shared memory, adds it into block 0's through distributed
//         shared memory, and block 0 writes every counter: no memset and
//         no global atomic, 0.0048 ms against the first design's 0.0054.
//       - a grid of 8- or 16-byte words (16 above 32 MB of statuses): a
//         tile of words across the period (grid x) over chunks of
//         periods (grid y), one wave of resident blocks; the output is
//         zeroed on the stream (cudaMemsetAsync, which a CUDA graph
//         captures) and each block adds its non-zero counters with one
//         atomicAdd each. 4-byte words lost at every width measured (they
//         held the first design at 63 % of its bound at R 512 and 1,024).
//       Integer atomics are exact in any order, so the counts are
//       deterministic.
//
// Each launcher takes raw device pointers and the caller's stream
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
// shared memory a block may opt into on sm_90 (227 KB)
constexpr int kMaxSmem = 232448;

__global__ void gather_rows_kernel(const int32_t* __restrict__ vec,
                                   const int32_t* __restrict__ idx,
                                   int32_t* __restrict__ out,
                                   long long total, int n, int s) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  long long row = t / n;
  int j = idx[t];
  out[t] = (j >= 0 && j < s) ? vec[row * s + j] : 0;
}

// wait for the lanes that share a row's bins: a warp's lanes, or the block
template <int G>
__device__ __forceinline__ void group_sync() {
  if (G <= 32) __syncwarp(); else __syncthreads();
}

__device__ __forceinline__ void bin_add(int32_t* hist, int s, int b, int x) {
  if (x != 0 && (unsigned)b < (unsigned)s) atomicAdd(&hist[b], x);
}

// G lanes per row, kThreads / G rows a block at a time; V elements a
// load (4: one 16-byte load of val and one of seg)
template <int G, int V>
__global__ void segment_sum_rows_kernel(const int32_t* __restrict__ val,
                                        const int32_t* __restrict__ seg,
                                        int32_t* __restrict__ out,
                                        int d, int n, int s) {
  extern __shared__ int32_t bins[];
  constexpr int kGroups = kThreads / G;
  const int group = threadIdx.x / G;
  const int lane = threadIdx.x % G;
  int32_t* hist = bins + (size_t)group * s;
  for (int k = lane; k < s; k += G) hist[k] = 0;
  group_sync<G>();
  // block-uniform loop: every lane reaches every group_sync
  for (long long base = (long long)blockIdx.x * kGroups; base < d;
       base += (long long)gridDim.x * kGroups) {
    long long row = base + group;
    bool live = row < d;
    if (live) {
      const int32_t* v = val + row * n;
      const int32_t* g = seg + row * n;
      if (V == 4) {
        for (int i = lane * 4; i < n; i += G * 4) {
          int4 x = *(const int4*)(v + i);
          int4 b = *(const int4*)(g + i);
          bin_add(hist, s, b.x, x.x);
          bin_add(hist, s, b.y, x.y);
          bin_add(hist, s, b.z, x.z);
          bin_add(hist, s, b.w, x.w);
        }
      } else {
        for (int i = lane; i < n; i += G) bin_add(hist, s, g[i], v[i]);
      }
    }
    group_sync<G>();
    if (live) {
      int32_t* o = out + row * s;
      for (int k = lane; k < s; k += G) {
        o[k] = hist[k];
        hist[k] = 0;
      }
    }
    group_sync<G>();
  }
}

// grid (chunks of kSplitThreads * V lanes, rows); out zeroed beforehand
template <int V>
__global__ void segment_sum_split_kernel(const int32_t* __restrict__ val,
                                         const int32_t* __restrict__ seg,
                                         int32_t* __restrict__ out,
                                         int d, int n, int s) {
  long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (i >= n) return;
  for (long long row = blockIdx.y; row < d; row += gridDim.y) {
    const int32_t* v = val + row * n + i;
    const int32_t* g = seg + row * n + i;
    int32_t* o = out + row * s;
    if (V == 4) {
      int4 x = *(const int4*)v;
      int4 b = *(const int4*)g;
      bin_add(o, s, b.x, x.x);
      bin_add(o, s, b.y, x.y);
      bin_add(o, s, b.z, x.z);
      bin_add(o, s, b.w, x.w);
    } else {
      bin_add(o, s, *g, *v);
    }
  }
}

// status code -> fold priority: PASS(0) -> 1, FAIL(1) -> 2, SKIP(2) -> 0
__device__ __forceinline__ int status_prio(int8_t st) {
  return st == 1 ? 2 : (st == 0 ? 1 : 0);
}

// fold priority -> status code: 0 -> SKIP(2), 1 -> PASS(0), 2 -> FAIL(1)
__device__ __forceinline__ int8_t prio_status(int p) {
  return p == 2 ? 1 : (p == 1 ? 0 : 2);
}

// K3's arguments: the (D, R) statuses and unsure bits (or null), the
// (R,) group and file ids, the (G,) last ids, and the six outputs in
// kernels.rim_reduce order
struct RimArgs {
  const int8_t* st;
  const uint8_t* un;
  const int32_t* gid;
  const int32_t* fid;
  const int32_t* last;
  // name_status, name_unsure, doc_status, any_fail, any_unsure, name_last
  int8_t* out[6];
  long long d;
  int r, g, f;
};

// the status of rule k of row `row` that name_last reports; an id
// outside [0, R) reads SKIP
__device__ __forceinline__ int8_t last_status(const int8_t* st, int r, long long row, int k) {
  return (unsigned)k < (unsigned)r ? st[row * r + k] : (int8_t)2;
}

// block form (the first design): one block per row, the per-group and
// per-file accumulators in shared memory
__global__ void rim_reduce_kernel(const int8_t* __restrict__ statuses,
                                  const uint8_t* __restrict__ unsure,
                                  const int32_t* __restrict__ group_ids,
                                  const int32_t* __restrict__ file_ids,
                                  const int32_t* __restrict__ last_ids,
                                  int8_t* __restrict__ name_status,
                                  uint8_t* __restrict__ name_unsure,
                                  int8_t* __restrict__ doc_status,
                                  uint8_t* __restrict__ any_fail,
                                  uint8_t* __restrict__ any_unsure,
                                  int8_t* __restrict__ name_last,
                                  int r, int g, int f) {
  extern __shared__ int32_t acc[];
  int32_t* g_prio = acc;          // (G,) segment max of priorities
  int32_t* g_un = acc + g;        // (G,) OR of unsure
  int32_t* f_prio = acc + 2 * g;  // (F,)
  int32_t* f_fail = f_prio + f;   // (F,)
  int32_t* f_un = f_fail + f;     // (F,)
  long long row = blockIdx.x;
  for (int k = threadIdx.x; k < 2 * g + 3 * f; k += blockDim.x) acc[k] = 0;
  __syncthreads();
  const int8_t* st = statuses + row * r;
  const uint8_t* un = unsure ? unsure + row * r : nullptr;
  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    int8_t s = st[i];
    int p = status_prio(s);
    int gi = group_ids[i];
    int fi = file_ids[i];
    if (p) {
      atomicMax(&g_prio[gi], p);
      atomicMax(&f_prio[fi], p);
    }
    if (s == 1) atomicOr(&f_fail[fi], 1);
    if (un && un[i]) {
      atomicOr(&g_un[gi], 1);
      atomicOr(&f_un[fi], 1);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < g; k += blockDim.x) {
    name_status[row * g + k] = prio_status(g_prio[k]);
    name_unsure[row * g + k] = g_un[k] ? 1 : 0;
    name_last[row * g + k] = st[last_ids[k]];
  }
  for (int k = threadIdx.x; k < f; k += blockDim.x) {
    doc_status[row * f + k] = prio_status(f_prio[k]);
    any_fail[row * f + k] = f_fail[k] ? 1 : 0;
    any_unsure[row * f + k] = f_un[k] ? 1 : 0;
  }
}

// V bytes read as one load (1, 4 or 16)
template <int V>
struct Bytes {
  uint32_t w[V >= 4 ? V / 4 : 1];
  __device__ __forceinline__ int at(int k) const {
    return V == 1 ? (int)w[0] : (int)((w[k >> 2] >> (8 * (k & 3))) & 0xFF);
  }
};

template <int V>
__device__ __forceinline__ Bytes<V> load_bytes(const void* p) {
  Bytes<V> b;
  if constexpr (V == 16) {
    uint4 x = __ldg((const uint4*)p);
    b.w[0] = x.x;
    b.w[1] = x.y;
    b.w[2] = x.z;
    b.w[3] = x.w;
  } else if constexpr (V == 4) {
    b.w[0] = __ldg((const uint32_t*)p);
  } else {
    b.w[0] = __ldg((const uint8_t*)p);
  }
  return b;
}

// rows a block of the thread form folds at a time, one a thread
constexpr int kRimTile = kThreads;
// groups and files the thread form's 64-bit masks hold
constexpr int kRimMaskBits = 64;

// bits 0-3 of x as bytes 0-3 (each 0 or 1): x << 7i puts bit i at 8i,
// and the four shifted copies do not overlap
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return (x * 0x00204081u) & 0x01010101u;
}

// one tile row's masks as output block B (kernels.rim_reduce order)
// reads them: group masks 0-2 and file masks 3-5 (PASS, FAIL, unsure);
// name_last reads the row's statuses
template <int B>
struct RimRow {
  unsigned long long pass, fail;  // the flag blocks keep their mask in fail
  long long row;

  __device__ __forceinline__ void load(const unsigned long long* masks, long long row0,
                                       int rr) {
    constexpr int m = B <= 1 ? 0 : 3;
    row = row0 + rr;
    if constexpr (B == 0 || B == 2) {
      pass = masks[m * kRimTile + rr];
      fail = masks[(m + 1) * kRimTile + rr];
    } else if constexpr (B == 1 || B == 4) {
      fail = masks[(m + 2) * kRimTile + rr];
    } else if constexpr (B == 3) {
      fail = masks[(m + 1) * kRimTile + rr];
    }
  }

  __device__ __forceinline__ int value(const int32_t* last, const int8_t* st, int r,
                                       int k) const {
    if constexpr (B == 5) {
      return (uint8_t)last_status(st, r, row, last[k]);
    } else if constexpr (B == 0 || B == 2) {
      return (fail >> k) & 1 ? 1 : ((pass >> k) & 1 ? 0 : 2);
    } else {
      return (int)((fail >> k) & 1);
    }
  }

  // the values at k .. k + 3 as the bytes of one word (not name_last)
  __device__ __forceinline__ uint32_t four(int k) const {
    uint32_t f = spread4((uint32_t)(fail >> k) & 15);
    if constexpr (B == 0 || B == 2) {
      uint32_t p = spread4((uint32_t)(pass >> k) & 15);
      return f | ((~(f | p) & 0x01010101u) << 1);  // FAIL 1, else PASS 0, else SKIP 2
    } else {
      return f;
    }
  }
};

// output block B of a tile: rows x w bytes from out + row0 * w, four
// neighbouring bytes a thread and step (one 32-bit store where the block
// starts on a 4-byte boundary), built from the masks four at a time
// where w >= 4 (name_last reads its statuses a byte at a time)
template <int B>
__device__ __forceinline__ void write_rim_block(int8_t* out, int w,
                                                const unsigned long long* masks,
                                                const int32_t* last, const int8_t* st, int r,
                                                long long row0, int rows) {
  if (w == 0) return;
  int8_t* base = out + row0 * w;
  const int n = rows * w;
  const bool word = ((uintptr_t)base & 3) == 0;
  const int step = 4 * kRimTile, dr = step / w, dk = step % w;
  int j = 4 * threadIdx.x, rr = j / w, k = j % w;
  RimRow<B> row;
  for (; j < n; j += step) {
    uint32_t v = 0;
    int cnt = n - j < 4 ? n - j : 4;
    int r2 = rr, k2 = k;
    row.load(masks, row0, r2);
    if (B != 5 && cnt == 4 && w >= 4) {
      v = row.four(k);
      if (k + 4 > w) {
        // the word ends in the next row: its first w - k bytes are this
        // row's (the masks hold no bit at w or beyond)
        int here = 8 * (w - k);
        row.load(masks, row0, r2 + 1);
        v = (v & ((1u << here) - 1)) | (row.four(0) << here);
      }
    } else {
      for (int e = 0; e < cnt; ++e) {
        v |= (uint32_t)row.value(last, st, r, k2) << (8 * e);
        if (++k2 == w && e + 1 < cnt) {
          k2 = 0;
          row.load(masks, row0, ++r2);
        }
      }
    }
    if (word && cnt == 4) {
      *(uint32_t*)(base + j) = v;
    } else {
      for (int e = 0; e < cnt; ++e) base[j + e] = (int8_t)(v >> (8 * e));
    }
    rr += dr;
    k += dk;
    if (k >= w) {
      k -= w;
      ++rr;
    }
  }
}

// thread form: a thread folds its row into six 64-bit masks over the
// groups and the files (some rule PASS, some rule FAIL, some unsure), in
// registers, reading the row V bytes a load; then the block writes the
// tile's six output blocks from the masks, coalesced
template <int V>
__global__ void rim_rows_kernel(RimArgs a) {
  extern __shared__ unsigned long long rim_sm[];
  unsigned long long* masks = rim_sm;                 // (6, kRimTile)
  unsigned long long* gbit = masks + 6 * kRimTile;   // (R,) each rule's group bit
  unsigned long long* fbit = gbit + a.r;             // (R,) its file bit
  int32_t* last = (int32_t*)(fbit + a.r);            // (G,)
  for (int i = threadIdx.x; i < a.r; i += blockDim.x) {
    int g = a.gid[i], f = a.fid[i];
    gbit[i] = (unsigned)g < (unsigned)a.g ? 1ull << g : 0ull;
    fbit[i] = (unsigned)f < (unsigned)a.f ? 1ull << f : 0ull;
  }
  for (int k = threadIdx.x; k < a.g; k += blockDim.x) last[k] = a.last[k];
  __syncthreads();
  for (long long row0 = (long long)blockIdx.x * kRimTile; row0 < a.d;
       row0 += (long long)gridDim.x * kRimTile) {
    int rows = a.d - row0 < kRimTile ? (int)(a.d - row0) : kRimTile;
    if ((int)threadIdx.x < rows) {
      long long row = row0 + threadIdx.x;
      const int8_t* st = a.st + row * a.r;
      const uint8_t* un = a.un ? a.un + row * a.r : nullptr;
      unsigned long long gp = 0, gf = 0, gu = 0, fp = 0, ff = 0, fu = 0;
      for (int i = 0; i < a.r; i += V) {
        Bytes<V> s = load_bytes<V>(st + i);
        Bytes<V> u = {};
        if (un) u = load_bytes<V>(un + i);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          int x = s.at(k);
          unsigned long long gb = gbit[i + k], fb = fbit[i + k];
          unsigned long long is0 = x == 0 ? ~0ull : 0ull, is1 = x == 1 ? ~0ull : 0ull;
          unsigned long long isu = u.at(k) ? ~0ull : 0ull;
          gp |= gb & is0;
          fp |= fb & is0;
          gf |= gb & is1;
          ff |= fb & is1;
          gu |= gb & isu;
          fu |= fb & isu;
        }
      }
      unsigned long long* m = masks + threadIdx.x;
      m[0] = gp;
      m[kRimTile] = gf;
      m[2 * kRimTile] = gu;
      m[3 * kRimTile] = fp;
      m[4 * kRimTile] = ff;
      m[5 * kRimTile] = fu;
    }
    __syncthreads();
    write_rim_block<0>(a.out[0], a.g, masks, last, a.st, a.r, row0, rows);
    write_rim_block<1>(a.out[1], a.g, masks, last, a.st, a.r, row0, rows);
    write_rim_block<2>(a.out[2], a.f, masks, last, a.st, a.r, row0, rows);
    write_rim_block<3>(a.out[3], a.f, masks, last, a.st, a.r, row0, rows);
    write_rim_block<4>(a.out[4], a.f, masks, last, a.st, a.r, row0, rows);
    write_rim_block<5>(a.out[5], a.g, masks, last, a.st, a.r, row0, rows);
    __syncthreads();
  }
}

// warps a block of the warp form, and rows a warp folds at a time
constexpr int kRimWarps = kThreads / 32;
constexpr int kRimWarpRows = 4;

// warp form: each warp takes kRimWarpRows neighbouring rows at a time.
// Its lanes read the rows coalesced, 32 rules a step (the rows' loads in
// flight together), and ballot three 32-bit words of rule bits a row
// (PASS, FAIL, unsure) into the warp's slice of shared memory; then
// lane k folds group k (and file k) of every row by ANDing those words
// with the group's rule mask, kept in shared memory with the range of
// words it touches, and writes the outputs (a warp writes 32 neighbouring
// bytes at a time). No atomic and no block barrier after the tables are
// built.
__global__ void rim_warp_kernel(RimArgs a) {
  extern __shared__ uint32_t rim_words[];
  const int nw = (a.r + 31) / 32;  // words of rule bits per row
  const int g = a.g, f = a.f, r = a.r;
  uint32_t* gm = rim_words;                 // (W, G): group k's rules in word w
  uint32_t* fm = gm + (size_t)nw * g;       // (W, F)
  int32_t* glo = (int32_t*)(fm + (size_t)nw * f);  // (G,) first word with a rule
  int32_t* ghi = glo + g;                   // (G,) last word with a rule
  int32_t* flo = ghi + g;                   // (F,)
  int32_t* fhi = flo + f;                   // (F,)
  int32_t* last = fhi + f;                  // (G,)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this warp's rows: (kRimWarpRows, 3, W) words
  uint32_t* bits = (uint32_t*)(last + g) + (size_t)warp * kRimWarpRows * 3 * nw;
  for (long long k = threadIdx.x; k < (long long)nw * (g + f); k += blockDim.x) gm[k] = 0;
  for (int k = threadIdx.x; k < g; k += blockDim.x) {
    glo[k] = INT_MAX;
    ghi[k] = -1;
    last[k] = a.last[k];
  }
  for (int k = threadIdx.x; k < f; k += blockDim.x) {
    flo[k] = INT_MAX;
    fhi[k] = -1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    int gi = a.gid[i], fi = a.fid[i], w = i / 32;
    uint32_t bit = 1u << (i % 32);
    if ((unsigned)gi < (unsigned)g) {
      atomicOr(&gm[(size_t)w * g + gi], bit);
      atomicMin(&glo[gi], w);
      atomicMax(&ghi[gi], w);
    }
    if ((unsigned)fi < (unsigned)f) {
      atomicOr(&fm[(size_t)w * f + fi], bit);
      atomicMin(&flo[fi], w);
      atomicMax(&fhi[fi], w);
    }
  }
  __syncthreads();
  for (long long row = ((long long)blockIdx.x * kRimWarps + warp) * kRimWarpRows; row < a.d;
       row += (long long)gridDim.x * kRimWarps * kRimWarpRows) {
    const int nr = a.d - row < kRimWarpRows ? (int)(a.d - row) : kRimWarpRows;
    for (int c = 0; c < nw; ++c) {
      int i = c * 32 + lane;
      int s[kRimWarpRows];
      bool u[kRimWarpRows];
#pragma unroll
      for (int t = 0; t < kRimWarpRows; ++t) {
        bool in = t < nr && i < r;
        s[t] = in ? a.st[(row + t) * r + i] : 2;
        u[t] = in && a.un && a.un[(row + t) * r + i];
      }
#pragma unroll
      for (int t = 0; t < kRimWarpRows; ++t) {
        uint32_t pass = __ballot_sync(0xFFFFFFFFu, s[t] == 0);
        uint32_t fail = __ballot_sync(0xFFFFFFFFu, s[t] == 1);
        uint32_t uns = __ballot_sync(0xFFFFFFFFu, u[t]);
        if (lane == 0) {
          uint32_t* b = bits + (size_t)t * 3 * nw;
          b[c] = pass;
          b[nw + c] = fail;
          b[2 * nw + c] = uns;
        }
      }
    }
    __syncwarp();
    for (int k = lane; k < g; k += 32) {
      uint32_t pass[kRimWarpRows] = {}, fail[kRimWarpRows] = {}, uns[kRimWarpRows] = {};
      for (int w = glo[k]; w <= ghi[k]; ++w) {
        uint32_t m = gm[(size_t)w * g + k];
        if (!m) continue;
#pragma unroll
        for (int t = 0; t < kRimWarpRows; ++t) {
          const uint32_t* b = bits + (size_t)t * 3 * nw;
          pass[t] |= b[w] & m;
          fail[t] |= b[nw + w] & m;
          uns[t] |= b[2 * nw + w] & m;
        }
      }
      int lk = last[k];
#pragma unroll
      for (int t = 0; t < kRimWarpRows; ++t) {
        if (t >= nr) break;
        long long o = (row + t) * g + k;
        a.out[0][o] = fail[t] ? 1 : (pass[t] ? 0 : 2);
        a.out[1][o] = uns[t] ? 1 : 0;
        a.out[5][o] = last_status(a.st, r, row + t, lk);
      }
    }
    for (int k = lane; k < f; k += 32) {
      uint32_t pass[kRimWarpRows] = {}, fail[kRimWarpRows] = {}, uns[kRimWarpRows] = {};
      for (int w = flo[k]; w <= fhi[k]; ++w) {
        uint32_t m = fm[(size_t)w * f + k];
        if (!m) continue;
#pragma unroll
        for (int t = 0; t < kRimWarpRows; ++t) {
          const uint32_t* b = bits + (size_t)t * 3 * nw;
          pass[t] |= b[w] & m;
          fail[t] |= b[nw + w] & m;
          uns[t] |= b[2 * nw + w] & m;
        }
      }
#pragma unroll
      for (int t = 0; t < kRimWarpRows; ++t) {
        if (t >= nr) break;
        long long o = (row + t) * f + k;
        a.out[2][o] = fail[t] ? 1 : (pass[t] ? 0 : 2);
        a.out[3][o] = fail[t] ? 1 : 0;
        a.out[4][o] = uns[t] ? 1 : 0;
      }
    }
    __syncwarp();
  }
}

// K7: 0x01 in each byte of c0, c1, c2 for each byte of x that is 0, 1,
// 2 (added up); any other byte adds nothing
__device__ __forceinline__ void count_word(uint32_t x, uint32_t& c0, uint32_t& c1,
                                           uint32_t& c2) {
  // bit 7 of a byte set iff the byte, unsigned, exceeds 3
  uint32_t big = ((x & 0x7C7C7C7Cu) + 0x7C7C7C7Cu) | x;
  uint32_t ok = ~(big >> 7) & 0x01010101u;
  uint32_t hi = x >> 1;  // bit 0 of each byte: the byte's bit 1
  c0 += ~(x | hi) & ok;
  c1 += x & ~hi & ok;
  c2 += hi & ~x & ok;
}

// K7's geometry over the first n_valid rows, read as a flat run of
// bytes: `head` bytes up to the first W-byte boundary, then whole
// periods of P = W / gcd(R, W) rows (P * R bytes, a whole number of
// W-byte words, so a word at a fixed place in a period always holds the
// same W columns), then a tail shorter than a period
struct SumGeom {
  long long total;  // n_valid * R bytes
  long long periods;
  long long chunk;  // periods a block of a column tile reads
  int head;
  int words;  // W-byte words a period
  int tiles;  // tiles of words across a period (grid x)
  int width;  // words a tile
  int lanes;  // periods a block reads at a time
};

// periods a thread reads, at least, before the grid adds a block
constexpr int kSummaryMinPeriods = 16;
// bytes of loads a thread keeps in flight
constexpr int kSummaryInFlight = 64;

template <int W>
__device__ __forceinline__ void load_word(const int8_t* p, uint32_t (&x)[W / 4]) {
  if constexpr (W == 16) {
    uint4 v = __ldg((const uint4*)p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else if constexpr (W == 8) {
    uint2 v = __ldg((const uint2*)p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = __ldg((const uint32_t*)p);
  }
}

// K7's count of one block into its shared counters cnt (3, slots): the
// block reads a tile of `width` W-byte words of each period over a chunk
// of periods (grid y), `lanes` periods at a time, each thread one word a
// period with 64 bytes of loads in flight, counted per byte with packed
// byte counters flushed into 3 W registers every 255 words. The block
// folds the counts into cnt (by column when one tile spans the period,
// else by byte of the tile), lanes that share a word first summed by warp
// shuffles; block (0, 0) adds the head and the tail byte by byte (into
// out where the tiles are several). Ends on a block barrier.
template <int W>
__device__ __forceinline__ void summary_count(const int8_t* __restrict__ statuses,
                                              int32_t* __restrict__ out, int r,
                                              const SumGeom& m, int32_t* cnt) {
  constexpr int kSub = W / 4;  // 32-bit words a load
  constexpr int kUnroll = kSummaryInFlight / W;
  const int slots = m.tiles == 1 ? r : W * m.width;
  for (int k = threadIdx.x; k < 3 * slots; k += blockDim.x) cnt[k] = 0;
  __syncthreads();
  const int lane = threadIdx.x / m.width;
  const int q = blockIdx.x * m.width + threadIdx.x % m.width;  // word of the period
  const bool live = lane < m.lanes && q < m.words;
  uint32_t c[3][W] = {};
  if (live) {
    long long begin = (long long)blockIdx.y * m.chunk;
    long long end = begin + m.chunk < m.periods ? begin + m.chunk : m.periods;
    long long p = begin + lane;
    const long long step = m.lanes, stride = step * m.words * W;  // periods, bytes
    const int8_t* at = statuses + m.head + ((long long)q + p * m.words) * W;
    while (p < end) {
      uint32_t c0[kSub] = {}, c1[kSub] = {}, c2[kSub] = {};
      int n = 0;
      for (; n <= 255 - kUnroll && p + (kUnroll - 1) * step < end;
           n += kUnroll, p += kUnroll * step, at += kUnroll * stride) {
        uint32_t x[kUnroll][kSub];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) load_word<W>(at + u * stride, x[u]);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int k = 0; k < kSub; ++k) count_word(x[u][k], c0[k], c1[k], c2[k]);
      }
      for (; n < 255 && p < end; ++n, p += step, at += stride) {
        uint32_t x[kSub];
        load_word<W>(at, x);
#pragma unroll
        for (int k = 0; k < kSub; ++k) count_word(x[k], c0[k], c1[k], c2[k]);
      }
#pragma unroll
      for (int k = 0; k < kSub; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          c[0][4 * k + j] += (c0[k] >> (8 * j)) & 0xFF;
          c[1][4 * k + j] += (c1[k] >> (8 * j)) & 0xFF;
          c[2][4 * k + j] += (c2[k] >> (8 * j)) & 0xFF;
        }
    }
  }
  // a width of 1, 2, 4, 8 or 16 words: the lanes of a warp that read the
  // same word are lane % width apart, every thread live
  bool shuffled = m.width <= 16 && (m.width & (m.width - 1)) == 0;
  if (shuffled) {
    for (int off = m.width; off < 32; off <<= 1)
#pragma unroll
      for (int v = 0; v < 3; ++v)
#pragma unroll
        for (int j = 0; j < W; ++j) c[v][j] += __shfl_xor_sync(0xFFFFFFFFu, c[v][j], off);
  }
  if (live && (!shuffled || (int)(threadIdx.x % 32) < m.width)) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      int pos = W * q + j;  // byte of the period
      int slot = m.tiles == 1 ? (int)((m.head + pos) % r) : pos - W * blockIdx.x * m.width;
#pragma unroll
      for (int v = 0; v < 3; ++v)
        if (c[v][j]) atomicAdd(&cnt[v * slots + slot], (int)c[v][j]);
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    // the head before the first word boundary and the tail after the
    // last whole period
    long long tail = m.head + m.periods * m.words * (long long)W;
    long long extra = m.head + (m.total - tail);
    for (long long e = threadIdx.x; e < extra; e += blockDim.x) {
      long long o = e < m.head ? e : tail + (e - m.head);
      int s = statuses[o];
      if (s < 0 || s > 2) continue;
      int col = (int)(o % r);
      if (m.tiles == 1)
        atomicAdd(&cnt[s * slots + col], 1);
      else
        atomicAdd(&out[s * r + col], 1);
    }
  }
  __syncthreads();
}

// grid form (and kDirect, one block): summary_count, then the block adds
// each column's counts into the output the launcher zeroed (kDirect: the
// grid's one block writes every counter once)
template <int W, bool kDirect>
__global__ void rule_summary_kernel(const int8_t* __restrict__ statuses,
                                    int32_t* __restrict__ out, int r, SumGeom m) {
  extern __shared__ int32_t cnt[];  // (3, slots)
  summary_count<W>(statuses, out, r, m, cnt);
  const int slots = m.tiles == 1 ? r : W * m.width;
  for (int k = threadIdx.x; k < slots; k += blockDim.x) {
    int col = k;
    if (m.tiles != 1) {
      int pos = W * blockIdx.x * m.width + k;
      if (pos >= W * m.words) break;
      col = (int)((m.head + pos) % r);
    }
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      int x = cnt[v * slots + k];
      if (kDirect)
        out[v * r + col] = x;
      else if (x)
        atomicAdd(&out[v * r + col], x);
    }
  }
}

// blocks of the cluster form (a non-portable cluster size, which the
// launcher allows)
constexpr int kSumCluster = 16;

// cluster form: one cluster of kSumCluster blocks over the rows (one tile
// spans the period), each block's summary_count; the blocks add their
// counters into block 0's shared memory (distributed shared memory), and
// block 0 writes every counter once: no zeroed output, no global atomic
template <int W>
__global__ void __cluster_dims__(1, kSumCluster, 1)
    rule_summary_cluster_kernel(const int8_t* __restrict__ statuses,
                                int32_t* __restrict__ out, int r, SumGeom m) {
  extern __shared__ int32_t cnt[];  // (3, R)
  summary_count<W>(statuses, out, r, m, cnt);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() != 0) {
    int32_t* root = cluster.map_shared_rank(cnt, 0);
    for (int k = threadIdx.x; k < 3 * r; k += blockDim.x)
      if (cnt[k]) atomicAdd(&root[k], cnt[k]);
  }
  cluster.sync();
  if (cluster.block_rank() == 0)
    for (int k = threadIdx.x; k < 3 * r; k += blockDim.x) out[k] = cnt[k];
}

// K2's geometries (guard_segment_sum_branch): lanes per row for the
// group branch, 256 for block, 0 for split
enum { kSegGroup8 = 8, kSegGroup16 = 16, kSegGroup32 = 32, kSegBlock = 256,
       kSegSplit = 0 };

// K2's thresholds, from chip_smoke.py --design-sweep on an H100: rows up
// to kSegGroupMaxN nodes take a lane group while the block's bins fit
// kSegGroupSmem bytes (the group wins up to N 512, the block from N
// 1,024); rows longer than kSegSplitMinN take the split grid while the
// batch holds at most kSegSplitMaxElems elements (at N 8,192 split wins
// up to D 8 and loses at D 64, at N 16,384 it wins at D 16; at N 2,048
// one block a row wins at every D)
constexpr int kSegGroupMaxN = 512;
constexpr long long kSegGroupSmem = 48 * 1024;
constexpr int kSegSplitMinN = 4096;
constexpr long long kSegSplitMaxElems = 1 << 18;
// threads a block of K2's split branch
constexpr int kSplitThreads = 128;
// blocks of `kernel` (kThreads threads, smem bytes) the card holds at
// once, read from the card once per (device, kernel, smem)
template <typename Kernel>
long long one_wave(Kernel kernel, size_t smem) {
  struct Entry {
    int dev;
    const void* fn;
    size_t smem;
    long long blocks;
  };
  static std::mutex lock;
  static std::vector<Entry> seen;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> hold(lock);
  for (const Entry& e : seen)
    if (e.dev == dev && e.fn == (const void*)kernel && e.smem == smem) return e.blocks;
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  seen.push_back({dev, (const void*)kernel, smem, blocks});
  return blocks;
}

// opt a kernel into smem bytes of dynamic shared memory where that
// exceeds the default 48 KB
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int G>
int launch_segment_sum(bool vec4, const int32_t* val, const int32_t* seg,
                       int32_t* out, int d, int n, int s,
                       cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  size_t smem = (size_t)kGroups * s * 4;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = vec4 ? segment_sum_rows_kernel<G, 4> : segment_sum_rows_kernel<G, 1>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  // one wave of resident blocks strides over the rows
  long long blocks = ((long long)d + kGroups - 1) / kGroups;
  long long cap = one_wave(kernel, smem);
  if (blocks > cap) blocks = cap;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(val, seg, out, d, n, s);
  return (int)cudaGetLastError();
}

int blocks_for(long long total) {
  return (int)((total + kThreads - 1) / kThreads);
}

// K3's forms (guard_rim_reduce_branch): a thread a row, a warp a row, a
// block a row
enum { kRimThread = 1, kRimWarp = 32, kRimBlock = 256 };
// K3's thresholds, from chip_smoke.py --design-sweep on an H100: a
// block a row up to kRimBlockMaxD rows (one launch of D small blocks
// beats the other forms' table set-up there); the thread form from
// kRimThreadMinD rows while G and F fit its 64-bit masks and R <=
// kRimThreadMaxR; else the warp form while its tables fit, else the block
constexpr long long kRimBlockMaxD = 1024;
constexpr long long kRimThreadMinD = 16384;
constexpr int kRimThreadMaxR = 256;

size_t rim_thread_smem(long long r, long long g) {
  return (size_t)(6ll * kRimTile * 8 + 16 * r + 4 * g);
}

size_t rim_warp_smem(long long r, long long g, long long f) {
  long long nw = (r + 31) / 32;
  long long words = nw * (g + f) + 2 * (g + f) + g + 3 * nw * kRimWarps * kRimWarpRows;
  return words > kMaxSmem ? (size_t)kMaxSmem + 1 : (size_t)words * 4;
}

template <int V>
int launch_rim_rows(const RimArgs& a, size_t smem, cudaStream_t s) {
  cudaError_t e = allow_smem(rim_rows_kernel<V>, smem);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (a.d + kRimTile - 1) / kRimTile;
  long long cap = one_wave(rim_rows_kernel<V>, smem);
  rim_rows_kernel<V><<<(unsigned)(blocks < cap ? blocks : cap), kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// K7's forms (guard_rule_summary_branch): 1 one block that writes every
// counter, 2 one cluster of kSumCluster blocks whose block 0 writes every
// counter (both 4-byte words, one tile across the period); 8 or 16 a
// grid of words of that many bytes that adds into the zeroed output
enum { kSumDirect = 1, kSumCluster2 = 2, kSumGrid8 = 8, kSumGrid16 = 16 };
// K7's thresholds, from chip_smoke.py --design-sweep on an H100: where one
// tile spans the period, one block while each thread reads at most
// kSummaryDirectRounds periods, one cluster while each of its threads
// reads at most kSummaryClusterRounds and R <= kSummaryClusterMaxR (its
// blocks fold 3 R counters into block 0); else the grid, of 16-byte
// words above kSummaryGrid8Bytes of statuses, of 8-byte words up to it
constexpr long long kSummaryDirectRounds = 4;
constexpr long long kSummaryClusterRounds = 64;
constexpr int kSummaryClusterMaxR = 256;
constexpr long long kSummaryGrid8Bytes = 32ll << 20;

SumGeom summary_geom(uintptr_t base, int rows, int r, int w) {
  SumGeom m = {};
  m.total = (long long)rows * r;
  m.head = (int)((w - (base % w)) % w);
  if (m.head > m.total) m.head = (int)m.total;
  int g = 1;
  while (g < w && r % (2 * g) == 0) g *= 2;  // gcd(R, W), W a power of two
  long long period = (long long)(w / g) * r;
  m.words = (int)(period / w);
  m.periods = period ? (m.total - m.head) / period : 0;
  m.tiles = (m.words + kThreads - 1) / kThreads;
  if (m.tiles < 1) m.tiles = 1;
  m.width = (m.words + m.tiles - 1) / m.tiles;
  if (m.width < 1) m.width = 1;
  m.lanes = kThreads / m.width;
  return m;
}

int summary_form(uintptr_t base, int rows, int r) {
  SumGeom m = summary_geom(base, rows, r, 4);
  if (m.tiles == 1 && m.periods <= m.lanes * kSummaryDirectRounds) return kSumDirect;
  if (m.tiles == 1 && r <= kSummaryClusterMaxR &&
      m.periods <= m.lanes * kSumCluster * kSummaryClusterRounds)
    return kSumCluster2;
  return m.total > kSummaryGrid8Bytes ? kSumGrid16 : kSumGrid8;
}

template <int W>
int launch_summary_grid(const int8_t* st, int32_t* out, int rows, int r, cudaStream_t s) {
  SumGeom m = summary_geom((uintptr_t)st, rows, r, W);
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)12 * r, s);
  if (e != cudaSuccess) return (int)e;
  // more tiles where they leave fewer threads of a block idle
  if (m.tiles > 1 || m.width * m.lanes < kThreads) {
    int best = m.tiles, used = m.width * m.lanes;
    for (int t = m.tiles + 1; t < m.tiles + 8 && t <= m.words; ++t) {
      int w = (m.words + t - 1) / t;
      if (w * (kThreads / w) > used) {
        best = t;
        used = w * (kThreads / w);
      }
    }
    m.tiles = best;
    m.width = (m.words + best - 1) / best;
    m.lanes = kThreads / m.width;
  }
  size_t smem = (size_t)12 * (m.tiles == 1 ? r : W * m.width);
  cudaError_t a = allow_smem(rule_summary_kernel<W, false>, smem);
  if (a != cudaSuccess) return (int)a;
  long long per_tile = one_wave(rule_summary_kernel<W, false>, smem) / m.tiles;
  long long want = (m.periods + (long long)m.lanes * kSummaryMinPeriods - 1) /
                   ((long long)m.lanes * kSummaryMinPeriods);
  long long blocks = want < per_tile ? want : per_tile;
  if (blocks > 65535) blocks = 65535;
  if (blocks < 1) blocks = 1;
  m.chunk = (m.periods + blocks - 1) / blocks;
  if (m.chunk < 1) m.chunk = 1;
  blocks = m.periods > 0 ? (m.periods + m.chunk - 1) / m.chunk : 1;
  rule_summary_kernel<W, false><<<dim3(m.tiles, (unsigned)blocks), kThreads, smem, s>>>(
      st, out, r, m);
  return (int)cudaGetLastError();
}

// let the cluster form launch its kSumCluster blocks (more than the
// portable 8), once per device
cudaError_t allow_wide_cluster() {
  static std::mutex lock;
  static std::vector<int> allowed;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> hold(lock);
  for (int d : allowed)
    if (d == dev) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(rule_summary_cluster_kernel<4>,
                                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) allowed.push_back(dev);
  return e;
}

int launch_summary(int form, const int8_t* st, int32_t* out, int rows, int r,
                   cudaStream_t s) {
  switch (form) {
    case kSumDirect: {
      SumGeom m = summary_geom((uintptr_t)st, rows, r, 4);
      if (m.tiles != 1) return (int)cudaErrorInvalidValue;
      m.chunk = m.periods > 0 ? m.periods : 1;
      rule_summary_kernel<4, true><<<1, kThreads, (size_t)12 * r, s>>>(st, out, r, m);
      return (int)cudaGetLastError();
    }
    case kSumCluster2: {
      SumGeom m = summary_geom((uintptr_t)st, rows, r, 4);
      if (m.tiles != 1) return (int)cudaErrorInvalidValue;
      m.chunk = (m.periods + kSumCluster - 1) / kSumCluster;
      if (m.chunk < 1) m.chunk = 1;
      cudaError_t allowed = allow_wide_cluster();
      if (allowed != cudaSuccess) return (int)allowed;
      rule_summary_cluster_kernel<4><<<dim3(1, kSumCluster), kThreads, (size_t)12 * r, s>>>(
          st, out, r, m);
      return (int)cudaGetLastError();
    }
    case kSumGrid8: return launch_summary_grid<8>(st, out, rows, r, s);
    case kSumGrid16: return launch_summary_grid<16>(st, out, rows, r, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int guard_gather_rows(const void* vec, const void* idx, void* out, int d,
                      int n, int s, void* stream) {
  long long total = (long long)d * n;
  if (total == 0) return (int)cudaGetLastError();
  gather_rows_kernel<<<blocks_for(total), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)vec, (const int32_t*)idx, (int32_t*)out, total, n, s);
  return (int)cudaGetLastError();
}

// the geometry guard_segment_sum_rows takes for (D, N, S)
int guard_segment_sum_branch(int d, int n, int s) {
  long long bins = (long long)s * 4;
  // the fewest lanes that give each one load (16 bytes where N % 4 == 0)
  // and at most 8 bins to write out
  int loads = n % 4 == 0 ? n / 4 : n;
  int g = kSegGroup8;
  while (g < kSegGroup32 && (loads > g || s > 8 * g)) g *= 2;
  if (n <= kSegGroupMaxN && bins * (kThreads / g) <= kSegGroupSmem) return g;
  bool few_long_rows = n > kSegSplitMinN && (long long)d * n <= kSegSplitMaxElems;
  if (bins <= kMaxSmem && !few_long_rows) return kSegBlock;
  return kSegSplit;
}

// K2 on a given geometry (the one guard_segment_sum_branch picks, or
// another, to measure where one overtakes the next)
int guard_segment_sum_rows_as(int branch, const void* val, const void* seg,
                              void* out, int d, int n, int s, void* stream) {
  if (d == 0 || s == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* v = (const int32_t*)val;
  const int32_t* g = (const int32_t*)seg;
  int32_t* o = (int32_t*)out;
  bool vec4 = n % 4 == 0 && (((uintptr_t)val | (uintptr_t)seg) & 15) == 0;
  if (branch == kSegSplit) {
    cudaError_t e = cudaMemsetAsync(out, 0, (size_t)d * s * 4, st);
    if (e != cudaSuccess) return (int)e;
    if (n == 0) return (int)cudaGetLastError();
    int per_block = kSplitThreads * (vec4 ? 4 : 1);
    dim3 grid((n + per_block - 1) / per_block, d < 65535 ? d : 65535);
    if (vec4)
      segment_sum_split_kernel<4><<<grid, kSplitThreads, 0, st>>>(v, g, o, d, n, s);
    else
      segment_sum_split_kernel<1><<<grid, kSplitThreads, 0, st>>>(v, g, o, d, n, s);
    return (int)cudaGetLastError();
  }
  switch (branch) {
    case kSegGroup8: return launch_segment_sum<8>(vec4, v, g, o, d, n, s, st);
    case kSegGroup16: return launch_segment_sum<16>(vec4, v, g, o, d, n, s, st);
    case kSegGroup32: return launch_segment_sum<32>(vec4, v, g, o, d, n, s, st);
    case kSegBlock: return launch_segment_sum<256>(vec4, v, g, o, d, n, s, st);
  }
  return (int)cudaErrorInvalidValue;
}

int guard_segment_sum_rows(const void* val, const void* seg, void* out,
                           int d, int n, int s, void* stream) {
  return guard_segment_sum_rows_as(guard_segment_sum_branch(d, n, s), val,
                                   seg, out, d, n, s, stream);
}

// largest 2G + 3F accumulator count one block holds
int guard_rim_max_slots(void) { return kMaxSmem / 4; }

// the form guard_rim_reduce takes for (D, R, G, F)
int guard_rim_reduce_branch(int d, int r, int g, int f) {
  bool block_fits = 2ll * g + 3ll * f <= kMaxSmem / 4;
  if (d <= kRimBlockMaxD && block_fits) return kRimBlock;
  if (d >= kRimThreadMinD && g <= kRimMaskBits && f <= kRimMaskBits && r <= kRimThreadMaxR)
    return kRimThread;
  if (rim_warp_smem(r, g, f) <= (size_t)kMaxSmem) return kRimWarp;
  return kRimBlock;
}

// K3 on a given form (the one guard_rim_reduce_branch picks, or another,
// to measure where one overtakes the next); refuses a form whose tables
// do not fit
int guard_rim_reduce_as(int form, const void* statuses, const void* unsure,
                        const void* group_ids, const void* file_ids,
                        const void* last_ids, void* name_status,
                        void* name_unsure, void* doc_status, void* any_fail,
                        void* any_unsure, void* name_last, int d, int r, int g,
                        int f, void* stream) {
  if (d == 0) return (int)cudaGetLastError();
  RimArgs a = {(const int8_t*)statuses, (const uint8_t*)unsure,
               (const int32_t*)group_ids, (const int32_t*)file_ids,
               (const int32_t*)last_ids,
               {(int8_t*)name_status, (int8_t*)name_unsure, (int8_t*)doc_status,
                (int8_t*)any_fail, (int8_t*)any_unsure, (int8_t*)name_last},
               d, r, g, f};
  cudaStream_t s = (cudaStream_t)stream;
  if (form == kRimThread) {
    if (g > kRimMaskBits || f > kRimMaskBits) return (int)cudaErrorInvalidValue;
    size_t smem = rim_thread_smem(r, g);
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    uintptr_t at = (uintptr_t)statuses | (uintptr_t)unsure;
    if (r % 16 == 0 && (at & 15) == 0) return launch_rim_rows<16>(a, smem, s);
    if (r % 4 == 0 && (at & 3) == 0) return launch_rim_rows<4>(a, smem, s);
    return launch_rim_rows<1>(a, smem, s);
  }
  if (form == kRimWarp) {
    size_t smem = rim_warp_smem(r, g, f);
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_smem(rim_warp_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    long long rows = kRimWarps * kRimWarpRows;
    long long blocks = (d + rows - 1) / rows;
    long long cap = one_wave(rim_warp_kernel, smem);
    rim_warp_kernel<<<(unsigned)(blocks < cap ? blocks : cap), kThreads, smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  if (form == kRimBlock) {
    size_t smem = (size_t)(2ll * g + 3ll * f) * 4;
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_smem(rim_reduce_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    rim_reduce_kernel<<<d, kThreads, smem, s>>>(
        (const int8_t*)statuses, (const uint8_t*)unsure, (const int32_t*)group_ids,
        (const int32_t*)file_ids, (const int32_t*)last_ids, (int8_t*)name_status,
        (uint8_t*)name_unsure, (int8_t*)doc_status, (uint8_t*)any_fail,
        (uint8_t*)any_unsure, (int8_t*)name_last, r, g, f);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

int guard_rim_reduce(const void* statuses, const void* unsure,
                     const void* group_ids, const void* file_ids,
                     const void* last_ids, void* name_status,
                     void* name_unsure, void* doc_status, void* any_fail,
                     void* any_unsure, void* name_last, int d, int r, int g,
                     int f, void* stream) {
  return guard_rim_reduce_as(guard_rim_reduce_branch(d, r, g, f), statuses, unsure,
                             group_ids, file_ids, last_ids, name_status, name_unsure,
                             doc_status, any_fail, any_unsure, name_last, d, r, g, f,
                             stream);
}

// the form guard_rule_summary takes for the first n_valid rows of (D, R)
// statuses that start on a 4-byte boundary
int guard_rule_summary_branch(int d, int r, int n_valid) {
  int rows = n_valid < 0 ? 0 : (n_valid > d ? d : n_valid);
  return summary_form(0, rows, r);
}

// K7 on a given form; writes every counter of out (3, R), also where no
// row is valid
int guard_rule_summary_as(int form, const void* statuses, void* out, int d, int r,
                          int n_valid, void* stream) {
  int rows = n_valid < 0 ? 0 : (n_valid > d ? d : n_valid);
  cudaStream_t s = (cudaStream_t)stream;
  if (r == 0) return (int)cudaGetLastError();
  if (rows == 0) {
    cudaError_t e = cudaMemsetAsync(out, 0, (size_t)12 * r, s);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
  }
  return launch_summary(form, (const int8_t*)statuses, (int32_t*)out, rows, r, s);
}

int guard_rule_summary(const void* statuses, void* out, int d, int r, int n_valid,
                       void* stream) {
  int rows = n_valid < 0 ? 0 : (n_valid > d ? d : n_valid);
  int form = summary_form((uintptr_t)statuses, rows, r);
  return guard_rule_summary_as(form, statuses, out, d, r, n_valid, stream);
}

}  // extern "C"
