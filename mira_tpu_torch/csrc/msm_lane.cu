// Per-lane double-and-add MSM: sum_i s_i * P_i over BN254 G1 or Grumpkin,
// every lane computing s_i * P_i on its own, then a sum over the lanes.
//
// Replaces mira_tpu/ops/pallas_msm.py `_msm_pallas_window_jit` (kernel 6,
// msm_pallas(method="window"): a table 1P..15P per lane, then 64 windows of
// 4 doublings and one table addition) and `_msm_pallas_jit` (kernel 7, any
// other method name: bit-serial, 254 doublings and additions of P), both
// templated here on the window W (4, or 1 for bit-serial).  The TPU kernels
// write one point per lane and leave the sum to an XLA halving tree
// (mira_tpu/ops/msm.py `reduce_points`, 17-21 levels of additions); here the
// sum is on the card, in the same source:
//   kernel A  one thread per lane runs the double-and-add from the top window
//             down, then the block sums its lanes by a halving tree in shared
//             memory and writes one XYZZ point per block;
//   kernel B  one block sums the block points (a strided pass per thread,
//             then the same tree) and writes the Jacobian result.
// The TPU kernels select a table entry by masks over all 15 entries and add
// with masked selects; here a lane indexes its table (15 XYZZ points,
// 1.9 KiB, in local memory: in shared memory it would allow ~110 lanes per
// SM, too few warps to hide the product chains) and branches.  The
// accumulator is XYZZ with the complete formulas of field.cuh, so a digit
// that meets an equal accumulator (P + P) or an identity lane is exact.
// The point operations are out of line (__noinline__), for ptxas's sake, as
// in msm_pippenger.cu.
//
// Bound on the card: the MSM needs what the bucket MSM needs (the same
// function); this design does nbits doublings and up to nbits / W additions
// per lane (kernel 7: ~254 x (9 + 10) products per lane, ~36x the bucket
// kernel's work), all integer multiplies; the inputs are read once.
#include <cuda_runtime.h>

#include <type_traits>

#include "field.cuh"

using namespace mira;

#define LANE_T 128  // threads per block of kernel A, and of kernel B

template <class F>
__device__ __noinline__ void pt_add(xyzz& a, const xyzz& b) {
  a = xyzz_add<F>(a, b);
}

template <class F>
__device__ __noinline__ void pt_madd(xyzz& a, const fe& x, const fe& y) {
  xyzz_madd<F>(a, x, y);
}

template <class F>
__device__ __noinline__ void pt_double(xyzz& a) {
  a = xyzz_double<F>(a);
}

// Sum red[0..LANE_T) into red[0] by halving (lane t += lane t + half).
template <class F>
__device__ void block_tree(xyzz* red) {
  for (int half = LANE_T / 2; half > 0; half >>= 1) {
    __syncthreads();
    if (threadIdx.x < half) pt_add<F>(red[threadIdx.x], red[threadIdx.x + half]);
  }
  __syncthreads();
}

template <class F, int W>
__global__ void lane_acc(const uint32_t* sc, const uint32_t* X,
                         const uint32_t* Y, const uint32_t* Z, int n,
                         int nbits, xyzz* partial) {
  constexpr int NT = (1 << W) - 1;
  __shared__ xyzz red[LANE_T];
  int i = blockIdx.x * LANE_T + threadIdx.x;
  xyzz acc = xyzz_identity<F>();
  if (i < n && !fe_is_zero(fe_load(Z + 8 * i))) {
    uint32_t s[8];
#pragma unroll
    for (int k = 0; k < 8; k++) s[k] = sc[8 * i + k];
    fe x = fe_load(X + 8 * i);
    fe y = fe_load(Y + 8 * i);
    // tab[d] = (d + 1) P, as kernel 6 builds it: odd d by doubling tab[d/2],
    // even d by adding P to tab[d - 1]
    xyzz tab[NT];
    tab[0].X = x;
    tab[0].Y = y;
    tab[0].ZZ = fe_one<F>();
    tab[0].ZZZ = fe_one<F>();
    for (int d = 1; d < NT; d++) {
      if (d % 2) {
        tab[d] = tab[d / 2];
        pt_double<F>(tab[d]);
      } else {
        tab[d] = tab[d - 1];
        pt_madd<F>(tab[d], x, y);
      }
    }
    const int nwin = (nbits + W - 1) / W;
    for (int w = nwin - 1; w >= 0; w--) {
      for (int k = 0; k < W; k++) pt_double<F>(acc);
      int bit = W * w;  // W divides 32: a digit never straddles two words
      int d = (int)((s[bit >> 5] >> (bit & 31)) & ((1u << W) - 1u));
      if (d == 0) continue;
      if (d == 1) pt_madd<F>(acc, x, y);
      else pt_add<F>(acc, tab[d - 1]);
    }
  }
  red[threadIdx.x] = acc;
  block_tree<F>(red);
  if (threadIdx.x == 0) partial[blockIdx.x] = red[0];
}

// One block: the sum of partial[0..m), as (3, 8) canonical Jacobian words.
template <class F>
__global__ void lane_sum(const xyzz* partial, int m, uint32_t* out) {
  __shared__ xyzz red[LANE_T];
  xyzz acc = xyzz_identity<F>();
  for (int b = threadIdx.x; b < m; b += LANE_T) pt_add<F>(acc, partial[b]);
  red[threadIdx.x] = acc;
  block_tree<F>(red);
  if (threadIdx.x == 0) {
    jac r = xyzz_to_jac<F>(red[0]);
    fe_store(out, r.X);
    fe_store(out + 8, r.Y);
    fe_store(out + 16, r.Z);
  }
}

template <class F, int W>
static int launch(const uint32_t* sc, const uint32_t* X, const uint32_t* Y,
                  const uint32_t* Z, int n, int nbits, xyzz* partial,
                  uint32_t* out, cudaStream_t s) {
  int blocks = (n + LANE_T - 1) / LANE_T;
  lane_acc<F, W><<<blocks, LANE_T, 0, s>>>(sc, X, Y, Z, n, nbits, partial);
  int err = (int)cudaGetLastError();
  if (err) return err;
  lane_sum<F><<<1, LANE_T, 0, s>>>(partial, blocks, out);
  return (int)cudaGetLastError();
}

// field 0: BN254 G1 (coordinates in Fq); field 1: Grumpkin (in Fr).  window
// 4 (kernel 6) or 1 (kernel 7); nbits: the scalars' bit length (254), whose
// top window the lanes start from.  sc, X, Y, Z: (n, 8) words, n >= 1,
// bases affine or identity (Z in {0, R mod p}); partial: ceil(n / 128) XYZZ
// points (32 words each) of scratch; out: (3, 8) canonical Jacobian
// Montgomery words.  Returns a cudaError_t (cudaErrorInvalidValue for
// another window).
extern "C" int mira_msm_lane(int field, int window, const void* sc,
                             const void* X, const void* Y, const void* Z,
                             int n, int nbits, void* partial, void* out,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 1 || nbits < 1 || nbits > 256) return (int)cudaErrorInvalidValue;
  auto args = [&](auto tag, auto wtag) {
    using F = decltype(tag);
    return launch<F, decltype(wtag)::value>(
        (const uint32_t*)sc, (const uint32_t*)X, (const uint32_t*)Y,
        (const uint32_t*)Z, n, nbits, (xyzz*)partial, (uint32_t*)out, s);
  };
  using W4 = std::integral_constant<int, 4>;
  using W1 = std::integral_constant<int, 1>;
  if (window == 4) return field == 0 ? args(Fq{}, W4{}) : args(Fr{}, W4{});
  if (window == 1) return field == 0 ? args(Fq{}, W1{}) : args(Fr{}, W1{});
  return (int)cudaErrorInvalidValue;
}
