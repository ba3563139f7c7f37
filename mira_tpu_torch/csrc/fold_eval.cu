// Fused fold evaluator: P(W1 + j*W2) of the homogeneous compressed gate
// polynomial on every row, for every fold point j of the call.
//
// Replaces mira_tpu/polynomial/pallas_evaluator.py
// `PallasFoldEvaluator._get_jit` (kernel body `_eval_one`).  The TPU kernel
// traces the expression tree into one Mosaic program over (16, B) row tiles;
// here one thread per row interprets the op list that
// polynomial/fold_evaluator.py compiles (the LOAD/ADD/MUL/NEG/OUTPUT row VM
// of mira_tpu's native evaluator, with registers compacted by liveness), so
// one build serves every circuit.  Static columns arrive pre-rotated and
// advice columns pre-rolled, as on the TPU.
//
// Bound on the card: each row reads its queried columns once per fold point
// (32 B per column) and does one field product per MUL op; for the k=17
// step-folding circuit the product count dominates, so the kernel is bound
// by integer multiply throughput.  The register file lives in a global
// scratch laid out [reg][row] so that a warp's accesses are contiguous.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace mira;

enum { OP_LOAD_STATIC = 0, OP_LOAD_FOLD = 1, OP_LOAD_CH = 2,
       OP_LOAD_CONST = 3, OP_ADD = 4, OP_MUL = 5, OP_NEG = 6,
       OP_OUTPUT = 7 };

template <class F>
__global__ void fold_eval_kernel(const int* ops, int n_ops,
                                 const uint32_t* stat, const uint32_t* w1,
                                 const uint32_t* w2, const uint32_t* ch,
                                 int n_ch, const uint32_t* jm, int n_j,
                                 const uint32_t* consts, int nrow,
                                 uint32_t* regs, uint32_t* out) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= nrow) return;
  const size_t rstride = (size_t)nrow * 8;
  uint32_t* myregs = regs + (size_t)row * 8;
  for (int j = 0; j < n_j; j++) {
    fe jv = fe_load(jm + 8 * j);
    for (int k = 0; k < n_ops; k++) {
      int op = ops[4 * k], a = ops[4 * k + 1], b = ops[4 * k + 2];
      int dst = ops[4 * k + 3];
      fe r;
      switch (op) {
        case OP_LOAD_STATIC:
          r = fe_load(stat + (size_t)a * rstride + (size_t)row * 8);
          break;
        case OP_LOAD_FOLD: {
          fe x = fe_load(w1 + (size_t)a * rstride + (size_t)row * 8);
          fe y = fe_load(w2 + (size_t)a * rstride + (size_t)row * 8);
          r = fe_add<F>(x, fe_mul<F>(jv, y));
          break;
        }
        case OP_LOAD_CH:
          r = fe_load(ch + ((size_t)j * n_ch + a) * 8);
          break;
        case OP_LOAD_CONST:
          r = fe_load(consts + (size_t)a * 8);
          break;
        case OP_ADD:
          r = fe_add<F>(fe_load(myregs + a * rstride),
                        fe_load(myregs + b * rstride));
          break;
        case OP_MUL:
          r = fe_mul<F>(fe_load(myregs + a * rstride),
                        fe_load(myregs + b * rstride));
          break;
        case OP_NEG:
          r = fe_neg<F>(fe_load(myregs + a * rstride));
          break;
        default:  // OP_OUTPUT
          fe_store(out + ((size_t)j * nrow + row) * 8,
                   fe_load(myregs + a * rstride));
          continue;
      }
      fe_store(myregs + dst * rstride, r);
    }
  }
}

// field 0: Fq, 1: Fr.  ops: (n_ops, 4) int32 (op, a, b, dst); stat:
// (n_sq, nrow, 8); w1, w2: (n_aq, nrow, 8); ch: (n_j, n_ch, 8); jm: (n_j, 8);
// consts: (n_c, 8); regs: scratch (n_regs, nrow, 8); out: (n_j, nrow, 8).
extern "C" int mira_fold_eval(int field, const void* ops, int n_ops,
                              const void* stat, const void* w1,
                              const void* w2, const void* ch, int n_ch,
                              const void* jm, int n_j, const void* consts,
                              int nrow, void* regs, void* out, void* stream) {
  if (nrow <= 0 || n_j <= 0) return 0;
  const int T = 128;
  int blocks = (nrow + T - 1) / T;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    fold_eval_kernel<Fq><<<blocks, T, 0, s>>>(
        (const int*)ops, n_ops, (const uint32_t*)stat, (const uint32_t*)w1,
        (const uint32_t*)w2, (const uint32_t*)ch, n_ch, (const uint32_t*)jm,
        n_j, (const uint32_t*)consts, nrow, (uint32_t*)regs, (uint32_t*)out);
  else
    fold_eval_kernel<Fr><<<blocks, T, 0, s>>>(
        (const int*)ops, n_ops, (const uint32_t*)stat, (const uint32_t*)w1,
        (const uint32_t*)w2, (const uint32_t*)ch, n_ch, (const uint32_t*)jm,
        n_j, (const uint32_t*)consts, nrow, (uint32_t*)regs, (uint32_t*)out);
  return (int)cudaGetLastError();
}
