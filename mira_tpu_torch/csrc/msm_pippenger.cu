// Shared-Horner Pippenger MSM: sum_i s_i * P_i over BN254 G1 or Grumpkin
// for bases that are used once (the generic-base commits of the mesh fold),
// with a multiples table built for the call.
//
// Replaces mira_tpu/ops/pallas_msm.py `_msm_pallas_pippenger_signed_jit`
// (kernel 4: signed 5-bit digits in [-16, 15], table 1P..16P, 52 windows)
// and `_msm_pallas_pippenger_jit` (kernel 5, "pippenger-u4": unsigned 4-bit
// digits in [0, 15], table 1P..15P, 64 windows), behind
// msm_pallas(method="pippenger" / "pippenger-u4") and the per-shard engine
// of mira_tpu/parallel/msm.py.  Same arithmetic: each base's multiples, per
// window the selected multiple (y negated for a negative digit) summed over
// all lanes, and Horner's rule over the window sums.  The TPU kernel keeps
// each lane's table and its 52 (64) window accumulators in VMEM across a
// sequential grid.  Here the MSM is four passes over chunks of at most
// `chunk` bases (ops/cuda_msm.py `pippenger_phases`), each pass a kernel
// that the fixed-base MSM already has:
//   table       the affine multiples 1P..16P of the chunk's bases
//               (fixed_table.cu at w = 5: an affine doubling, mixed
//               additions and one inversion per block of 128 lanes), into
//               scratch that the next chunk reuses;
//   recode      the chunk's scalars once, into int16 digits stored window
//               by window: signed 5-bit (msm_common.cuh `recode_digits`) or
//               unsigned 4-bit (`recode_u4` below, no carry);
//   accumulate  msm_fixed.cu's `fixed_acc<F, 5>`: one XYZZ accumulator in
//               registers per thread over a range of points of one window,
//               mixed additions of the looked-up affine entries, a grid of
//               one wave.  Kernel 5's digits index the first 15 entries of
//               the same 16-entry table.  Each chunk writes its partials
//               side by side in one (nwin, parts) array;
//   finish      one reduce over every chunk's partials (msm_common.cuh
//               `reduce_windows`) and one Horner (`finish_terms`, 5 or 4
//               doublings a window), whatever the number of chunks.
// The madd is the complete one (field.cuh), so duplicate and opposite
// bases, zero scalars and identity lanes (stored as (0, 0) in the table)
// are exact; the TPU kernel's precondition of distinct bases does not carry
// over.
//
// Bound on the card: what any generic-base MSM of N points needs (the
// bucket MSM's bound).  This design does ~238 products a base for the
// table and a mixed addition (10 products) per base and window, 52 or 64,
// so it is bound by the integer multiply rate; it reads 64 bytes of table
// per base and window and writes the table once (1 KiB a base), which the
// chunking keeps in a scratch of at most `chunk` bases.
#include <cuda_runtime.h>

#include "field.cuh"
#include "msm_common.cuh"

using namespace mira;

// Kernel 5's digits: window w is bits [4w, 4w + 4) of the scalar, in
// [0, 15], window-major int16 as recode_digits writes them (zero past bit
// 255).  The loops are unrolled so that the scalar stays in registers.
__global__ void recode_u4(const uint32_t* sc, int n, int nwin,
                          int16_t* digits) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fe s = fe_load_v(sc + 8 * (size_t)i);
#pragma unroll
  for (int k = 0; k < 8; k++) {
#pragma unroll
    for (int j = 0; j < 8; j++) {
      int w = 8 * k + j;
      if (w < nwin)
        digits[(size_t)w * n + i] = (int16_t)((s.v[k] >> (4 * j)) & 15u);
    }
  }
  for (int w = 64; w < nwin; w++) digits[(size_t)w * n + i] = 0;
}

// sc: (n, 8) plain scalar words (< 2^256); is_signed 1: kernel 4's signed
// 5-bit digits (nwin = 52 for 254-bit scalars, the last window takes the
// last carry), 0: kernel 5's unsigned 4-bit digits (nwin = 64); digits:
// (nwin, n) int16.  Returns a cudaError_t.
extern "C" int mira_msm_pippenger_recode(const void* sc, int n, int is_signed,
                                         int nwin, void* digits,
                                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_signed)
    recode_digits<<<(n + 255) / 256, 256, 0, s>>>(
        (const uint32_t*)sc, nullptr, n, 5, nwin, (int16_t*)digits);
  else
    recode_u4<<<(n + 255) / 256, 256, 0, s>>>((const uint32_t*)sc, n, nwin,
                                              (int16_t*)digits);
  return (int)cudaGetLastError();
}

// field 0: BN254 G1 (coordinates in Fq); field 1: Grumpkin (in Fr).
// partial: (nwin, nparts) XYZZ sums, every chunk's accumulate output side by
// side; window 5 (kernel 4) or 4 (kernel 5) doublings a window; tmp:
// reduce_tmp_points(nwin, nparts) XYZZ points (ops/cuda_msm.py), ws: nwin;
// out: (3, 8) canonical Jacobian Montgomery words.  Returns a cudaError_t.
extern "C" int mira_msm_pippenger_finish(int field, int window,
                                         const void* partial, int nwin,
                                         int nparts, void* tmp, void* ws,
                                         void* out, void* stream) {
  if (window != 5 && window != 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto tag) {
    using F = decltype(tag);
    int err = reduce_windows<F>((const xyzz*)partial, nwin, nparts, (xyzz*)tmp,
                                (xyzz*)ws, s);
    if (err) return err;
    return launch_finish<F>((const xyzz*)ws, nwin, window, (uint32_t*)out, s);
  };
  return field == 0 ? run(Fq{}) : run(Fr{});
}
