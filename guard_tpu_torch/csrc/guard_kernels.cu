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
//       OR comes out false. One block per document row, the per-group
//       and per-file accumulators in shared memory. Bound by bytes:
//       2 B per (doc, rule) read, 3 B per (doc, group) and (doc, file)
//       written.
//
//   K7 rule_summary      counts[k, j] = #{rows d < n_valid : statuses[d, j] == k}
//       Replaces the per-rule (PASS, FAIL, SKIP) counts of
//       parallel/mesh.py _shared_evaluator_fns.summarize (:338-349),
//       reached through ShardedBatchEvaluator.with_summary (:540). The
//       valid rows are the first n_valid of a row-major (D, R) int8
//       matrix; a status outside 0..2 counts nowhere. Bound by bytes: 1 B
//       per (valid doc, rule) read, 12 B per rule written. One kernel
//       for every R: a block covers a tile of rule columns (grid x) over a
//       contiguous chunk of rows (grid y), as many rows at a time as the
//       tile leaves threads, so a warp reads neighbouring bytes. A thread
//       counts one column, or four read as one 32-bit word where R is a
//       multiple of 4, in registers with several row loads in flight,
//       folds its counts into the block's (3, width) shared counters, and
//       the block adds each non-zero counter into the zeroed output with
//       one atomicAdd. The grid is one wave of resident blocks, two
//       when the rule columns take several tiles.
//       Integer atomics are exact in any order, so the counts are
//       deterministic.
//
// Each launcher takes raw device pointers and the caller's stream
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// rows one thread counts, at least
constexpr int kSummaryMinRows = 16;

__device__ __forceinline__ void count_statuses(uint32_t w, int v, int (&c)[3][4]) {
  int s = (int8_t)(w >> (8 * v));
  c[0][v] += s == 0;
  c[1][v] += s == 1;
  c[2][v] += s == 2;
}

// V columns a thread (1, or 4 read as one 32-bit word when R % 4 == 0);
// grid (column tiles, row blocks); width = min(R, V * blockDim.x)
// columns a tile; block y counts the rows [y * chunk, (y + 1) * chunk),
// and the blocks that run together cover whole rows
template <int V>
__global__ void rule_summary_kernel(const int8_t* __restrict__ statuses,
                                    int32_t* __restrict__ out,
                                    int rows, int r, int width, int chunk) {
  // independent row loads a thread keeps in flight
  constexpr int kUnroll = V == 4 ? 8 : 4;
  extern __shared__ int32_t cnt[];  // (3, width)
  for (int k = threadIdx.x; k < 3 * width; k += blockDim.x) cnt[k] = 0;
  __syncthreads();
  int per_row = width / V;  // threads across one row of the tile
  int lanes = blockDim.x / per_row;  // rows a block reads at a time
  int lane = threadIdx.x / per_row;
  int j = (threadIdx.x % per_row) * V;
  int col = blockIdx.x * width + j;
  if (lane < lanes && col < r) {
    int c[3][4] = {};
    long long begin = (long long)blockIdx.y * chunk;
    long long end = begin + chunk < rows ? begin + chunk : rows;
    long long row = begin + lane;
    const int8_t* at = statuses + col;
    auto load = [&](long long i) -> uint32_t {
      return V == 4 ? *(const uint32_t*)(at + i * r) : (uint8_t)at[i * r];
    };
    for (; row + (kUnroll - 1) * lanes < end; row += kUnroll * lanes) {
      uint32_t w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) w[u] = load(row + u * lanes);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int v = 0; v < V; ++v) count_statuses(w[u], v, c);
    }
    for (; row < end; row += lanes) {
      uint32_t w = load(row);
#pragma unroll
      for (int v = 0; v < V; ++v) count_statuses(w, v, c);
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (c[k][v]) atomicAdd(&cnt[k * width + j + v], c[k][v]);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 3 * width; k += blockDim.x) {
    int c = blockIdx.x * width + k % width;
    if (cnt[k] && c < r) atomicAdd(&out[(k / width) * r + c], cnt[k]);
  }
}

template <int V>
void launch_rule_summary(const int8_t* statuses, int32_t* out, int rows,
                         int r, cudaStream_t stream) {
  int width = r < V * kThreads ? r : V * kThreads;
  int lanes = kThreads / (width / V);
  int tiles = (r + width - 1) / width;
  size_t smem = (size_t)3 * width * 4;
  // one wave of resident blocks; two where several tiles share the card,
  // so that the blocks of a narrow last tile free their slots early
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rule_summary_kernel<V>,
                                                kThreads, smem);
  long long blocks = ((long long)rows + (long long)lanes * kSummaryMinRows - 1) /
                     ((long long)lanes * kSummaryMinRows);
  long long max_blocks = (long long)per_sm * sms * (tiles > 1 ? 2 : 1) / tiles;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  int chunk = (int)((rows + blocks - 1) / blocks);
  blocks = (rows + chunk - 1) / chunk;
  rule_summary_kernel<V><<<dim3(tiles, (unsigned)blocks), kThreads, smem, stream>>>(
      statuses, out, rows, r, width, chunk);
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
// blocks of `kernel` (kThreads threads, smem bytes) the card holds at once
template <typename Kernel>
long long one_wave(Kernel kernel, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  return (long long)sms * (per_sm > 0 ? per_sm : 1);
}

template <int G>
int launch_segment_sum(bool vec4, const int32_t* val, const int32_t* seg,
                       int32_t* out, int d, int n, int s,
                       cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  size_t smem = (size_t)kGroups * s * 4;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = vec4 ? segment_sum_rows_kernel<G, 4> : segment_sum_rows_kernel<G, 1>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
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

int guard_rim_reduce(const void* statuses, const void* unsure,
                     const void* group_ids, const void* file_ids,
                     const void* last_ids, void* name_status,
                     void* name_unsure, void* doc_status, void* any_fail,
                     void* any_unsure, void* name_last, int d, int r, int g,
                     int f, void* stream) {
  if (d == 0) return (int)cudaGetLastError();
  size_t smem = (size_t)(2 * g + 3 * f) * 4;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rim_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rim_reduce_kernel<<<d, kThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)statuses, (const uint8_t*)unsure,
      (const int32_t*)group_ids, (const int32_t*)file_ids,
      (const int32_t*)last_ids, (int8_t*)name_status,
      (uint8_t*)name_unsure, (int8_t*)doc_status, (uint8_t*)any_fail,
      (uint8_t*)any_unsure, (int8_t*)name_last, r, g, f);
  return (int)cudaGetLastError();
}

// out must hold (3, R) zeros; n_valid is clamped to [0, D]
int guard_rule_summary(const void* statuses, void* out, int d, int r,
                       int n_valid, void* stream) {
  int rows = n_valid < 0 ? 0 : (n_valid > d ? d : n_valid);
  if (rows == 0 || r == 0) return (int)cudaGetLastError();
  // four columns a load where every row starts on a 4-byte boundary
  if (r % 4 == 0 && ((uintptr_t)statuses & 3) == 0) {
    launch_rule_summary<4>((const int8_t*)statuses, (int32_t*)out, rows, r,
                           (cudaStream_t)stream);
  } else {
    launch_rule_summary<1>((const int8_t*)statuses, (int32_t*)out, rows, r,
                           (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
