// The tape kernel: one level of the walk's elementwise ops in one launch.
//
// ops/tape.py records the walk of a program once, puts each
// elementwise op at a dataflow level and encodes each level, for each
// node width, as a program of fixed-size instructions (kernels/plain.py
// names the instruction set and runs it op by op on the CPU). This kernel
// interprets one such program over (D, W) lanes, one thread a lane:
// lane (d, j) runs every instruction whose width exceeds j (width 0 is a
// per-document instruction, which every lane of the row computes, so its
// result is in each lane's registers). Registers are shared memory, one
// column a lane.
//
// An ALU instruction reads its three operands (registers, or immediates
// where flagged) and computes every class of result without a branch,
// then keeps the one its aux names and cuts it to its dtype: a walk's
// instructions are cheap, and a branch per operand mode and per op cost
// more than the arithmetic. LOAD, GROUP, STORE and the reductions move
// values between registers and memory: the launch's buffers, the walk's
// workspace, the literal ids or the column index.

#include <cuda_runtime.h>
#include <string.h>

#define TAPE_WORDS 8
#define TAPE_MAX_BUFS 1024  // 8 KB of kernel parameters (CUDA 12.1 and later)
#define TAPE_BLOCK 128
#define TAPE_CHUNK 256
#define TAPE_MAX_REGS 80

enum { I_ALU = 1, I_LOAD, I_GROUP, I_STORE, I_RED_SUM, I_RED_OR };
enum { DT_BOOL = 0, DT_I8 = 1, DT_I32 = 2 };
enum { IMM_A = 1 << 10, IMM_B = 1 << 11, IMM_C = 1 << 12 };
enum { ALU_ADD = 0, ALU_BIT, ALU_CMP, ALU_WHERE, ALU_MAX, ALU_MIN, ALU_MUL };
enum { ALU_NEG_B = 1 << 3 };
enum { M_NONE = 0, M_MEM, M_WS, M_LIT, M_IOTA };
enum { E_U8 = 0, E_I8 = 1, E_I32 = 2 };
enum { C_LANE = 0, C_FIXED = 1 };

struct TapeArgs {
  const int* prog;
  unsigned char* ws;
  const int* lits;
  int n_instr;
  int d;
  int w;
  long long bufs[TAPE_MAX_BUFS];
};

__device__ __forceinline__ unsigned char* tape_base(const TapeArgs& a, int mode, int x) {
  if ((mode & 0xFF) == M_WS) return a.ws + (long long)a.d * x;
  return reinterpret_cast<unsigned char*>(a.bufs[x]);
}

__device__ __forceinline__ int tape_load(const TapeArgs& a, int mode, int x, long long i) {
  const int et = (mode >> 8) & 0xFF;
  const unsigned char* base = tape_base(a, mode, x);
  if ((mode & 0xFF) == M_MEM) {
    // a launch's buffers are read-only while it runs (it writes only the
    // walk's outputs, which no instruction reads)
    if (et == E_I32) return __ldg(reinterpret_cast<const int*>(base) + i);
    if (et == E_I8) return (int)__ldg(reinterpret_cast<const signed char*>(base) + i);
    return (int)__ldg(base + i);
  }
  if (et == E_I32) return reinterpret_cast<const int*>(base)[i];
  if (et == E_I8) return (int)reinterpret_cast<const signed char*>(base)[i];
  return (int)base[i];
}

__device__ __forceinline__ void tape_store(unsigned char* base, int et, long long i, int v) {
  if (et == E_I32) reinterpret_cast<int*>(base)[i] = v;
  else if (et == E_I8) reinterpret_cast<signed char*>(base)[i] = (signed char)v;
  else base[i] = (unsigned char)v;
}

// The program is read in chunks of TAPE_CHUNK instructions into shared
// memory, where every lane of the block reads each as two 16-byte words;
// the registers follow the chunk.
__global__ void __launch_bounds__(TAPE_BLOCK)
guard_walk_tape_kernel(const __grid_constant__ TapeArgs a) {
  extern __shared__ int4 tape_smem[];
  int4* prog = tape_smem;
  int* my = reinterpret_cast<int*>(tape_smem + TAPE_CHUNK * (TAPE_WORDS / 4)) + threadIdx.x;
  const long long t = (long long)blockIdx.x * TAPE_BLOCK + threadIdx.x;
  const bool live = t < (long long)a.d * a.w;
  const int row = live ? (int)(t / a.w) : 0;
  const int j = live ? (int)(t - (long long)row * a.w) : 0;
  const int4* src = reinterpret_cast<const int4*>(a.prog);
  for (int c0 = 0; c0 < a.n_instr; c0 += TAPE_CHUNK) {
    const int n = min(TAPE_CHUNK, a.n_instr - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < n * (TAPE_WORDS / 4); i += TAPE_BLOCK)
      prog[i] = __ldg(src + (long long)c0 * (TAPE_WORDS / 4) + i);
    __syncthreads();
    if (!live) continue;
    for (int pc = 0; pc < n; ++pc) {
      // op | dtype << 8 | immediates, width, register, aux | a, b, c or
      // the memory's mode, x, y, z
      const int4 h = prog[2 * pc], o = prog[2 * pc + 1];
      if (h.y > 0 && j >= h.y) continue;
      const int kind = h.x & 0xFF;
      if (kind == I_ALU) {
        const int ra = my[((h.x & IMM_A) ? 0 : o.x) * TAPE_BLOCK];
        const int rb = my[((h.x & IMM_B) ? 0 : o.y) * TAPE_BLOCK];
        const int rc = my[((h.x & IMM_C) ? 0 : o.z) * TAPE_BLOCK];
        const int x = (h.x & IMM_A) ? o.x : ra;
        const int y = (h.x & IMM_B) ? o.y : rb;
        const int z = (h.x & IMM_C) ? o.z : rc;
        const int aux = h.w, cls = aux & 7;
        const unsigned uy = (aux & ALU_NEG_B) ? 0u - (unsigned)y : (unsigned)y;
        const int sum = (int)((unsigned)x + uy);
        const int bit = ((x & y) & -((aux >> 4) & 1)) | ((x | y) & -((aux >> 5) & 1)) |
                        ((x ^ y) & -((aux >> 6) & 1)) | (~x & -((aux >> 7) & 1));
        const int cmp = (aux >> (8 + ((x < y) << 1) + (x == y))) & 1;
        int r = cls == ALU_ADD ? sum
              : cls == ALU_BIT ? bit
              : cls == ALU_CMP ? cmp
              : cls == ALU_WHERE ? (x ? y : z)
              : cls == ALU_MAX ? max(x, y)
              : cls == ALU_MIN ? min(x, y)
              : (int)((unsigned)x * (unsigned)y);
        const int dt = (h.x >> 8) & 3;
        r = dt == DT_BOOL ? (r != 0) : dt == DT_I8 ? (int)(signed char)r : r;
        my[h.z * TAPE_BLOCK] = r;
        continue;
      }
      const int mode = o.x;
      const bool fixed = ((mode >> 16) & 0xFF) == C_FIXED;
      if (kind == I_LOAD) {
        const int m = mode & 0xFF;
        int v;
        if (m == M_LIT) v = __ldg(a.lits + o.y);
        else if (m == M_IOTA) v = j + o.y;
        else v = tape_load(a, mode, o.y, (long long)row * o.z + (fixed ? o.w : j + o.w));
        my[h.z * TAPE_BLOCK] = v;
      } else if (kind == I_GROUP) {
        // column j of a value read aux columns at a time (a (D, W, aux) view)
        unsigned s = 0;
        for (int m = 0; m < h.w; ++m)
          s += (unsigned)tape_load(a, mode, o.y, (long long)row * o.z + (long long)j * h.w + m);
        my[h.z * TAPE_BLOCK] = (int)s;
      } else {
        const int r = my[h.z * TAPE_BLOCK];
        unsigned char* base = tape_base(a, mode, o.y);
        const long long at = (long long)row * o.z + o.w;
        if (kind == I_RED_SUM) {
          if (r) atomicAdd(reinterpret_cast<int*>(base) + at, r);
        } else if (kind == I_RED_OR) {
          if (r) reinterpret_cast<int*>(base)[at] = 1;
        } else if (fixed) {
          if (j == 0) tape_store(base, (mode >> 8) & 0xFF, at, r);
        } else {
          tape_store(base, (mode >> 8) & 0xFF, at + j, r);
        }
      }
    }
  }
}

extern "C" int guard_walk_max_bufs() { return TAPE_MAX_BUFS; }

// One level: zero the first `zero_bytes` of the workspace where asked
// (the walk's reduction accumulators, before its first level), then
// launch the program over d * w lanes on `stream`.
extern "C" int guard_walk_segment(const int* prog, int n_instr, const long long* bufs,
                                  int n_bufs, unsigned char* ws, const int* lits, int d,
                                  int w, int n_regs, long long zero_bytes, void* stream) {
  if (n_bufs < 0 || n_bufs > TAPE_MAX_BUFS || n_regs < 0 || n_regs > TAPE_MAX_REGS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (zero_bytes > 0) {
    cudaError_t e = cudaMemsetAsync(ws, 0, (size_t)zero_bytes, s);
    if (e != cudaSuccess) return (int)e;
  }
  const long long lanes = (long long)d * w;
  if (lanes <= 0 || n_instr <= 0) return 0;
  TapeArgs a;
  memset(&a, 0, sizeof(a));
  a.prog = prog;
  a.ws = ws;
  a.lits = lits;
  a.n_instr = n_instr;
  a.d = d;
  a.w = w;
  if (n_bufs > 0) memcpy(a.bufs, bufs, sizeof(long long) * n_bufs);
  const long long grid = (lanes + TAPE_BLOCK - 1) / TAPE_BLOCK;
  const size_t smem = (size_t)TAPE_CHUNK * TAPE_WORDS * sizeof(int) +
                      (size_t)(n_regs > 0 ? n_regs : 1) * TAPE_BLOCK * sizeof(int);
  guard_walk_tape_kernel<<<(unsigned)grid, TAPE_BLOCK, smem, s>>>(a);
  return (int)cudaGetLastError();
}
