// Row-wise field linear combination: K outputs
//     out_k[i] = sum_j c_kj * in_j[i] mod p,   i < n,
// over J input arrays of n Montgomery elements, in Montgomery form or, with
// the plain flag, in plain form, out_k[i] * R^-1 (what fields/limbs.py
// `LimbField.to_plain` gives; with K = J = 1 and c = 1, that is to_plain).
//
// Replaces no Pallas kernel: mira_tpu leaves this elementwise work to XLA,
// which fuses it into one program a call: `_combine_slices_sat_jit` and
// `_combine_slices_jit` (mira_tpu/nifs/vanilla.py), `_witness_fold_jit`
// (mira_tpu/plonk/structure.py) and the cross terms' `to_plain` before
// their MSMs (mira_tpu/ops/commitment.py).  In plain PyTorch on the lazy
// 16-bit limbs of fields/limbs.py, one product is ~130 launches and every
// canonicalisation waits on the host; here a whole combine is one launch.
//
// Bound on the card: J reads and K writes of 32 bytes a row, against K*J
// Montgomery products a row (and K Montgomery reductions for plain
// outputs).  The cross-term combine (J = 6, K = 5) is bound by the
// products, the witness fold (J = 2, K = 1: coefficients 1 and r) and
// to_plain by the bytes.
// The design:
// - one thread per row, 16-byte vector loads and stores;
// - the coefficients travel by value in the launch's parameters (one
//   __grid_constant__ struct), so no copy from the host precedes a launch
//   and a fold step's powers of r cost nothing to pass; every thread reads
//   the same coefficient at the same time, a broadcast from the constant
//   bank;
// - a zero coefficient skips its product and a coefficient of one (the
//   witness fold's W1 and E) is an addition: both branches are uniform;
// - a plain output is a product by the raw integer 1, which the compiler
//   folds to the reduction alone;
// - the loop over the outputs is the outer one, so one accumulator is live;
//   a row's inputs are read once per output, from L1 or L2 after the first.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace mira;

namespace {

constexpr int LC_MAX_J = 16;     // inputs of one launch
constexpr int LC_MAX_K = 16;     // outputs of one launch
constexpr int LC_MAX_COEFS = 96; // K * J of one launch

// The launch's parameters (3,352 bytes, under the 4 KiB a launch passes).
// ops/field_lincomb.py builds the same struct with ctypes.
struct LincombArgs {
  const uint32_t* in[LC_MAX_J];   // (n, 8) Montgomery words each
  uint32_t* out[LC_MAX_K];        // (n, 8) outputs
  uint32_t coef[LC_MAX_COEFS][8]; // c_kj at k * J + j, Montgomery form
  int64_t n;
  int32_t J, K;
  int32_t plain;                  // 1: the outputs in plain form
};

template <class F>
__global__ void __launch_bounds__(256)
    field_lincomb_kernel(const __grid_constant__ LincombArgs a) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)a.n) return;
  const fe one = fe_one<F>();
  fe raw_one = fe_zero();
  raw_one.v[0] = 1;
  for (int k = 0; k < a.K; k++) {
    fe acc = fe_zero();
    for (int j = 0; j < a.J; j++) {
      fe c = fe_load(a.coef[k * a.J + j]);
      if (fe_is_zero(c)) continue;
      fe x = fe_load_ro(a.in[j] + i * 8);
      if (fe_eq(c, one)) {
        acc = fe_add<F>(acc, x);
      } else {
        acc = fe_add<F>(acc, fe_mul<F>(c, x));
      }
    }
    if (a.plain) acc = fe_mul<F>(acc, raw_one);
    fe_store_v(a.out[k] + i * 8, acc);
  }
}

}  // namespace

// field 0: Fq, 1: Fr.  args: a host LincombArgs of `args_bytes` bytes (its
// size, checked against this build's), copied into the launch.  Inputs and
// outputs are 16-byte aligned (n, 8) word arrays; no output aliases an
// input.  Returns a cudaError_t (cudaErrorInvalidValue for arguments the
// kernel does not take).
extern "C" int mira_field_lincomb(int field, const void* args, int args_bytes,
                                  void* stream) {
  if (args_bytes != (int)sizeof(LincombArgs) || (field != 0 && field != 1))
    return (int)cudaErrorInvalidValue;
  const LincombArgs& a = *(const LincombArgs*)args;
  if (a.J < 1 || a.J > LC_MAX_J || a.K < 1 || a.K > LC_MAX_K ||
      a.J * a.K > LC_MAX_COEFS || a.n < 0)
    return (int)cudaErrorInvalidValue;
  if (a.n == 0) return 0;
  const int T = 256;
  unsigned blocks = (unsigned)((a.n + T - 1) / T);
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    field_lincomb_kernel<Fq><<<blocks, T, 0, s>>>(a);
  else
    field_lincomb_kernel<Fr><<<blocks, T, 0, s>>>(a);
  return (int)cudaGetLastError();
}
