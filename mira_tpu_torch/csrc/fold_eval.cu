// Fused fold evaluator: P(W1 + j*W2) of the homogeneous compressed gate
// polynomial on a range of rows, for every fold point j of the call.
//
// Replaces mira_tpu/polynomial/pallas_evaluator.py
// `PallasFoldEvaluator._get_jit` (kernel body `_eval_one`).  The TPU kernel
// traces the expression tree into one Mosaic program over (16, B) row tiles;
// here one thread per row interprets the op list that
// polynomial/fold_evaluator.py compiles (the LOAD/ADD/MUL/NEG/OUTPUT row VM
// of mira_tpu's native evaluator, with registers compacted by liveness), so
// one build serves every circuit.  Static columns arrive pre-rotated and
// advice columns pre-rolled, as on the TPU, whole: a call on rows
// [row_lo, row_lo + row_count) reads those rows of them (a mesh rank's
// block, rotations included, needs no rows of another rank).
//
// Bound on the card: one Montgomery product per MUL op and per folded load,
// per row and fold point (80 at the k=17 step-folding circuit), so integer
// multiply throughput.  The design keeps everything else on chip:
// - the register file lives in shared memory, laid out [reg][word][thread]
//   so that a warp's 32 accesses to one word of one register hit 32 banks;
//   the block holds 128 rows, fewer for a program with many registers
//   (`mira_fold_eval_block`), with dynamic shared memory above 48 KB;
// - the op program is copied once per block into shared memory, and every
//   read of it is warp-uniform (a broadcast);
// - the fold points loop outside the program, so a row's columns are read
//   once per point, from L2 after the first (the block's rows of every
//   queried column, ~200 KB at the k=17 circuit): (n_j - 1) x the column
//   bytes, a quarter of the products' time even at device-memory rate.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace mira;

enum { OP_LOAD_STATIC = 0, OP_LOAD_FOLD = 1, OP_LOAD_CH = 2,
       OP_LOAD_CONST = 3, OP_ADD = 4, OP_MUL = 5, OP_NEG = 6,
       OP_OUTPUT = 7 };

constexpr int FE_MAX_T = 128;  // rows per block at most
constexpr int FE_SMEM_MAX = 232448;  // dynamic shared memory a block may use

// register r of this thread: words at regs[(r * 8 + w) * T]
__device__ __forceinline__ fe reg_get(const uint32_t* regs, int r, int T) {
  fe v;
#pragma unroll
  for (int w = 0; w < 8; w++) v.v[w] = regs[(r * 8 + w) * T];
  return v;
}

__device__ __forceinline__ void reg_set(uint32_t* regs, int r, int T,
                                        const fe& v) {
#pragma unroll
  for (int w = 0; w < 8; w++) regs[(r * 8 + w) * T] = v.v[w];
}

template <class F>
__global__ void __launch_bounds__(FE_MAX_T)
    fold_eval_kernel(const int4* ops, int n_ops, const uint32_t* stat,
                     const uint32_t* w1, const uint32_t* w2,
                     const uint32_t* ch, int n_ch, const uint32_t* jm, int n_j,
                     const uint32_t* consts, int nrow, int row_lo,
                     int row_count, uint32_t* out) {
  extern __shared__ uint4 smem[];
  int4* sops = reinterpret_cast<int4*>(smem);
  const int T = blockDim.x;
  for (int k = threadIdx.x; k < n_ops; k += T) sops[k] = ops[k];
  __syncthreads();
  const int r = blockIdx.x * T + threadIdx.x;
  if (r >= row_count) return;
  uint32_t* regs = reinterpret_cast<uint32_t*>(sops + n_ops) + threadIdx.x;
  const size_t row = (size_t)row_lo + r;
  const size_t rstride = (size_t)nrow * 8;
  for (int j = 0; j < n_j; j++) {
    const fe jv = fe_load_ro(jm + 8 * j);
    for (int k = 0; k < n_ops; k++) {
      const int4 o = sops[k];  // (op, a, b, dst)
      fe v;
      switch (o.x) {
        case OP_LOAD_STATIC:
          v = fe_load_v(stat + o.y * rstride + row * 8);
          break;
        case OP_LOAD_FOLD:
          v = fe_add<F>(fe_load_v(w1 + o.y * rstride + row * 8),
                        fe_mul<F>(jv, fe_load_v(w2 + o.y * rstride + row * 8)));
          break;
        case OP_LOAD_CH:
          v = fe_load_ro(ch + ((size_t)j * n_ch + o.y) * 8);
          break;
        case OP_LOAD_CONST:
          v = fe_load_ro(consts + (size_t)o.y * 8);
          break;
        case OP_ADD:
          v = fe_add<F>(reg_get(regs, o.y, T), reg_get(regs, o.z, T));
          break;
        case OP_MUL:
          v = fe_mul<F>(reg_get(regs, o.y, T), reg_get(regs, o.z, T));
          break;
        case OP_NEG:
          v = fe_neg<F>(reg_get(regs, o.y, T));
          break;
        default:  // OP_OUTPUT
          fe_store_v(out + ((size_t)j * row_count + r) * 8,
                     reg_get(regs, o.y, T));
          continue;
      }
      reg_set(regs, o.w, T, v);
    }
  }
}

// field 0: Fq, 1: Fr.  ops: (n_ops, 4) int32 (op, a, b, dst) over n_regs
// registers; stat: (n_sq, nrow, 8); w1, w2: (n_aq, nrow, 8); ch: (n_j, n_ch,
// shared memory a block of `block` rows takes: their registers and the
// op program
static size_t fold_eval_smem(int n_regs, int n_ops, int block) {
  return (size_t)n_ops * 16 + (size_t)n_regs * 32 * block;
}

// Rows per block: 128, halved down to 32 until the block's registers and
// its copy of the op program fit its shared memory; 0 where even 32 rows
// do not.
extern "C" int mira_fold_eval_block(int n_regs, int n_ops) {
  for (int block = FE_MAX_T; block >= 32; block /= 2)
    if (fold_eval_smem(n_regs, n_ops, block) <= FE_SMEM_MAX) return block;
  return 0;
}

// 8); jm: (n_j, 8); consts: (n_c, 8); out: (n_j, row_count, 8), the rows
// [row_lo, row_lo + row_count) of every column.  Returns a cudaError_t
// (cudaErrorInvalidValue for a range the kernel does not take, or a
// program whose registers do not fit one block: `mira_fold_eval_block`).
extern "C" int mira_fold_eval(int field, const void* ops, int n_ops,
                              int n_regs, const void* stat, const void* w1,
                              const void* w2, const void* ch, int n_ch,
                              const void* jm, int n_j, const void* consts,
                              int nrow, int row_lo, int row_count, void* out,
                              void* stream) {
  if (row_count <= 0 || n_j <= 0) return 0;
  int block = mira_fold_eval_block(n_regs, n_ops);
  if (block == 0 || row_lo < 0 || row_lo + row_count > nrow)
    return (int)cudaErrorInvalidValue;
  size_t smem = fold_eval_smem(n_regs, n_ops, block);
  int blocks = (row_count + block - 1) / block;
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto kernel) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<blocks, block, smem, s>>>(
        (const int4*)ops, n_ops, (const uint32_t*)stat, (const uint32_t*)w1,
        (const uint32_t*)w2, (const uint32_t*)ch, n_ch, (const uint32_t*)jm,
        n_j, (const uint32_t*)consts, nrow, row_lo, row_count,
        (uint32_t*)out);
    return (int)cudaGetLastError();
  };
  return field == 0 ? run(fold_eval_kernel<Fq>) : run(fold_eval_kernel<Fr>);
}
