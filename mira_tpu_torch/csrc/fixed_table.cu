// Multiples table of the fixed-base MSM (msm_fixed.cu): for every base P
// the affine points 1P..NTAB*P, NTAB = 2^(W-1), as (x, y) Montgomery words
// in a (n, NTAB, 2, 8) array, so that one lookup is 64 contiguous bytes.
//
// Replaces mira_tpu/ops/pallas_msm.py `precompute_fixed_table` (an XLA
// build, `_table_step_jits`): Jacobian multiples by repeated addition, one
// batch inversion of their Z coordinates per lane, then x = X/Z^2,
// y = Y/Z^3.  One thread builds one lane: it writes the Jacobian X, Y of
// each multiple into the output as it goes, keeps the Z's and their prefix
// products, inverts the last prefix once (Fermat, fe_inv) and walks back to
// turn each entry affine in place.  An identity base (Z = 0) has every Z
// zero, so its inverse is 0 and its entries come out (0, 0), the identity
// marker of msm_fixed.cu.
//
// Bound on the card: per lane NTAB - 1 point additions, one 254-bit
// exponentiation (~380 Montgomery products) and ~5 * NTAB products: integer
// multiply throughput.  The per-lane arrays of Z's (2 * NTAB field elements)
// live in local memory; the table write, 64 * NTAB bytes per lane, is the
// only traffic to device memory.
#include <cuda_runtime.h>

#include <type_traits>

#include "field.cuh"

using namespace mira;

template <class F, int NTAB>
__global__ void fixed_table_k(const uint32_t* X, const uint32_t* Y,
                              const uint32_t* Z, int n, uint32_t* tab) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  jac P;
  P.X = fe_load(X + 8 * (size_t)i);
  P.Y = fe_load(Y + 8 * (size_t)i);
  P.Z = fe_load(Z + 8 * (size_t)i);
  uint32_t* row = tab + (size_t)i * NTAB * 16;
  fe zs[NTAB], pre[NTAB];
  jac acc = P;
  for (int v = 0; v < NTAB; v++) {
    if (v == 1) acc = jac_double<F>(P);
    else if (v > 1) acc = jac_add<F>(acc, P);
    fe_store(row + 16 * v, acc.X);
    fe_store(row + 16 * v + 8, acc.Y);
    zs[v] = acc.Z;
    pre[v] = v ? fe_mul<F>(pre[v - 1], acc.Z) : acc.Z;
  }
  fe run = fe_inv<F>(pre[NTAB - 1]);
  for (int v = NTAB - 1; v >= 0; v--) {
    fe zi = v ? fe_mul<F>(run, pre[v - 1]) : run;
    if (v) run = fe_mul<F>(run, zs[v]);
    fe zi2 = fe_sqr<F>(zi);
    fe x = fe_mul<F>(fe_load(row + 16 * v), zi2);
    fe y = fe_mul<F>(fe_load(row + 16 * v + 8), fe_mul<F>(zi2, zi));
    fe_store(row + 16 * v, x);
    fe_store(row + 16 * v + 8, y);
  }
}

// field 0: BN254 G1 (coordinates in Fq); field 1: Grumpkin (in Fr).
// X, Y, Z: (n, 8) Montgomery words of affine points (Z = R mod p) or the
// identity (Z = 0); window 5 or 6; tab: (n, 2^(window-1), 2, 8) output.
// Returns a cudaError_t (cudaErrorInvalidValue for another window).
extern "C" int mira_fixed_table(int field, const void* X, const void* Y,
                                const void* Z, int n, int window, void* tab,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int T = 128;
  auto run = [&](auto tag, auto ntag) {
    using F = decltype(tag);
    constexpr int NTAB = decltype(ntag)::value;
    fixed_table_k<F, NTAB><<<(n + T - 1) / T, T, 0, s>>>(
        (const uint32_t*)X, (const uint32_t*)Y, (const uint32_t*)Z, n,
        (uint32_t*)tab);
    return (int)cudaGetLastError();
  };
  using N16 = std::integral_constant<int, 16>;
  using N32 = std::integral_constant<int, 32>;
  if (window == 5) return field == 0 ? run(Fq{}, N16{}) : run(Fr{}, N16{});
  if (window == 6) return field == 0 ? run(Fq{}, N32{}) : run(Fr{}, N32{});
  return (int)cudaErrorInvalidValue;
}
