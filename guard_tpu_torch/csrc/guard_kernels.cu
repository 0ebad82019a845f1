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
//       add nothing (root and padding lanes carry seg -1). Bound by
//       bytes: 8 B per element read plus 4 B per output bin. One block
//       per document row; the histogram lives in shared memory when
//       S * 4 bytes fit in the 227 KB a block may opt into (every bucket
//       up to 32,768 nodes), and is accumulated straight into the global
//       output row otherwise (the 65,536-node bucket). Integer atomics
//       make the sum exact in any order.
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

__global__ void segment_sum_shared_kernel(const int32_t* __restrict__ val,
                                          const int32_t* __restrict__ seg,
                                          int32_t* __restrict__ out,
                                          int n, int s) {
  extern __shared__ int32_t hist[];
  long long row = blockIdx.x;
  for (int k = threadIdx.x; k < s; k += blockDim.x) hist[k] = 0;
  __syncthreads();
  const int32_t* v = val + row * n;
  const int32_t* g = seg + row * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int b = g[i];
    int x = v[i];
    if (x != 0 && b >= 0 && b < s) atomicAdd(&hist[b], x);
  }
  __syncthreads();
  int32_t* o = out + row * s;
  for (int k = threadIdx.x; k < s; k += blockDim.x) o[k] = hist[k];
}

__global__ void segment_sum_global_kernel(const int32_t* __restrict__ val,
                                          const int32_t* __restrict__ seg,
                                          int32_t* __restrict__ out,
                                          int n, int s) {
  long long row = blockIdx.x;
  int32_t* o = out + row * s;
  for (int k = threadIdx.x; k < s; k += blockDim.x) o[k] = 0;
  __syncthreads();
  const int32_t* v = val + row * n;
  const int32_t* g = seg + row * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int b = g[i];
    int x = v[i];
    if (x != 0 && b >= 0 && b < s) atomicAdd(&o[b], x);
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

// 1 when (D, S) rows accumulate in shared memory, 0 when in global memory
int guard_segment_sum_uses_shared(int s) {
  return (long long)s * 4 <= kMaxSmem ? 1 : 0;
}

int guard_segment_sum_rows(const void* val, const void* seg, void* out,
                           int d, int n, int s, void* stream) {
  if (d == 0 || s == 0) return (int)cudaGetLastError();
  size_t smem = (size_t)s * 4;
  if (guard_segment_sum_uses_shared(s)) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          segment_sum_shared_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    segment_sum_shared_kernel<<<d, kThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)val, (const int32_t*)seg, (int32_t*)out, n, s);
  } else {
    segment_sum_global_kernel<<<d, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)val, (const int32_t*)seg, (int32_t*)out, n, s);
  }
  return (int)cudaGetLastError();
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
