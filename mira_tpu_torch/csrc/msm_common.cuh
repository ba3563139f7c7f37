// Pieces shared by the two MSM kernels (msm_bucket.cu, msm_fixed.cu): the
// signed-digit recoding with closed-form carries, the reduction of
// per-(window, chunk) XYZZ sums across chunks, and Horner's rule over the
// windows.  Kernels live in an anonymous namespace: each .cu that includes
// this header gets its own copies.
#pragma once
#include <cuda_runtime.h>

#include "field.cuh"

namespace mira {
namespace {

// Digit of the window that starts at `bit` in the signed W-bit recoding of
// the 256-bit scalar s: raw bits [bit, bit + W) plus the incoming carry,
// which is [ (s mod 2^bit) > thr ] with thr = (2^(W-1) - 1) * (2^bit - 1) /
// (2^W - 1), the largest value the digits below can reach (clamped to
// 2^256 - 1 where it does not fit: no carry can arrive there).  Digits are
// in [-2^(W-1), 2^(W-1) - 1].
template <int W>
__device__ __forceinline__ int signed_digit(const uint32_t* s, int bit,
                                            const uint32_t* thr) {
  int wi = bit >> 5, off = bit & 31;
  uint32_t lo = wi < 8 ? s[wi] >> off : 0u;
  uint32_t hi = (off > 32 - W && wi + 1 < 8) ? s[wi + 1] << (32 - off) : 0u;
  int raw = (int)((lo | hi) & ((1u << W) - 1u));
  int carry = 0;
#pragma unroll
  for (int k = 7; k >= 0; k--) {
    uint32_t sk;
    if (32 * k + 32 <= bit) sk = s[k];
    else if (32 * k >= bit) sk = 0u;
    else sk = s[k] & ((1u << (bit - 32 * k)) - 1u);
    if (sk != thr[k]) {
      carry = sk > thr[k];
      break;
    }
  }
  int t = raw + carry;
  return t >= (1 << (W - 1)) ? t - (1 << W) : t;
}

// in: (nwin, nchunks, nb) XYZZ sums; out: (nwin, ceil(nchunks / group), nb),
// entry g the sum over chunks [g * group, (g + 1) * group).  One thread per
// output entry.
template <class F>
__global__ void chunk_reduce(const xyzz* in, int nwin, int nchunks, int nb,
                             int group, xyzz* out) {
  int ngroups = (nchunks + group - 1) / group;
  int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= nwin * ngroups * nb) return;
  int v = tid % nb;
  int g = (tid / nb) % ngroups;
  int w = tid / (nb * ngroups);
  int c1 = min(nchunks, (g + 1) * group);
  xyzz acc = xyzz_identity<F>();
  for (int c = g * group; c < c1; c++)
    acc = xyzz_add<F>(acc, in[(w * nchunks + c) * nb + v]);
  out[tid] = acc;
}

// Two launches of chunk_reduce: (nwin, nchunks, nb) -> groups -> (nwin, nb).
// A single pass would give each of the nwin * nb threads a chain of
// `nchunks` dependent additions.
template <class F>
int reduce_chunks(const xyzz* in, int nwin, int nchunks, int nb, int group,
                  xyzz* partial, xyzz* out, cudaStream_t s) {
  const int T = 128;
  int ng = (nchunks + group - 1) / group;
  int n1 = nwin * ng * nb;
  chunk_reduce<F><<<(n1 + T - 1) / T, T, 0, s>>>(in, nwin, nchunks, nb, group,
                                                 partial);
  int err = (int)cudaGetLastError();
  if (err) return err;
  int n2 = nwin * nb;
  chunk_reduce<F><<<(n2 + T - 1) / T, T, 0, s>>>(partial, nwin, ng, nb, ng,
                                                 out);
  return (int)cudaGetLastError();
}

// sum_w 2^(window * w) * ws[w] by Horner's rule in one thread; out: (3, 8)
// canonical Jacobian Montgomery words.
template <class F>
__global__ void horner(const xyzz* ws, int nwin, int window, uint32_t* out) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  xyzz acc = ws[nwin - 1];
  for (int w = nwin - 2; w >= 0; w--) {
    for (int k = 0; k < window; k++) acc = xyzz_double<F>(acc);
    acc = xyzz_add<F>(acc, ws[w]);
  }
  jac r = xyzz_to_jac<F>(acc);
  fe_store(out, r.X);
  fe_store(out + 8, r.Y);
  fe_store(out + 16, r.Z);
}

}  // namespace
}  // namespace mira
