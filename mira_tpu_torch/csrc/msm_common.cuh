// Pieces shared by the MSM kernels (msm_bucket.cu, msm_fixed.cu,
// msm_pippenger.cu): signed-digit recoding (a per-point pass), XYZZ
// points in shared memory and a block tree over them, the reduction of
// per-(window, part) sums to one sum per window, and the weighted sum over
// the windows (Horner's, as one doubling chain per window side by side).
// Kernels live in an anonymous namespace: each .cu that includes this
// header gets its own copies.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

namespace mira {
namespace {

// The recoding pass: one thread per point reads its 32-byte scalar once and
// writes its nwin signed c-bit digits (c <= 16), window-major, so that the
// passes after it read one window's digits coalesced: digit d_w in
// [-2^(c-1), 2^(c-1) - 1] is the raw bits [c*w, c*w + c) plus the carry
// threaded from the window below.  With Z given, a point whose Z row is
// zero (the identity) gets all-zero digits, so that it is never added.
__global__ void recode_digits(const uint32_t* sc, const uint32_t* Z, int n,
                              int c, int nwin, int16_t* digits) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fe s8 = fe_load_v(sc + 8 * (size_t)i);
  uint32_t s[9];
#pragma unroll
  for (int k = 0; k < 8; k++) s[k] = s8.v[k];
  s[8] = 0;
  bool ident = Z != nullptr && fe_is_zero(fe_load_v(Z + 8 * (size_t)i));
  const int half = 1 << (c - 1);
  const uint32_t mask = (1u << c) - 1u;
  int carry = 0;
  for (int w = 0; w < nwin; w++) {
    int bit = c * w, d = 0;
    if (!ident) {
      int wi = bit >> 5;
      uint32_t raw = 0;
      if (wi < 8) {
        uint64_t two = ((uint64_t)s[wi + 1] << 32) | s[wi];
        raw = (uint32_t)(two >> (bit & 31)) & mask;
      }
      int t = (int)raw + carry;
      carry = t >= half;
      d = t - (carry << c);
    }
    digits[(size_t)w * n + i] = (int16_t)d;
  }
}

// XYZZ points in global memory by 16-byte accesses (buffers of whole
// points, 128 bytes each, from the caller's torch.empty)
__device__ __forceinline__ xyzz xyzz_load(const xyzz* p) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
  xyzz r;
  r.X = fe_load_v(w);
  r.Y = fe_load_v(w + 8);
  r.ZZ = fe_load_v(w + 16);
  r.ZZZ = fe_load_v(w + 24);
  return r;
}

__device__ __forceinline__ void xyzz_store(xyzz* p, const xyzz& a) {
  uint32_t* w = reinterpret_cast<uint32_t*>(p);
  fe_store_v(w, a.X);
  fe_store_v(w + 8, a.Y);
  fe_store_v(w + 16, a.ZZ);
  fe_store_v(w + 24, a.ZZZ);
}

// XYZZ points in shared memory, word-major (word k of thread t at
// sm[k * ld + t]): a warp's accesses to one word fall in 32 banks, where a
// 128-byte point per thread would put all 32 lanes in one bank.
__device__ __forceinline__ void sm_put(uint32_t* sm, int ld, int t,
                                       const xyzz& p) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    sm[k * ld + t] = p.X.v[k];
    sm[(8 + k) * ld + t] = p.Y.v[k];
    sm[(16 + k) * ld + t] = p.ZZ.v[k];
    sm[(24 + k) * ld + t] = p.ZZZ.v[k];
  }
}

__device__ __forceinline__ xyzz sm_get(const uint32_t* sm, int ld, int t) {
  xyzz p;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    p.X.v[k] = sm[k * ld + t];
    p.Y.v[k] = sm[(8 + k) * ld + t];
    p.ZZ.v[k] = sm[(16 + k) * ld + t];
    p.ZZZ.v[k] = sm[(24 + k) * ld + t];
  }
  return p;
}

// Sum of one XYZZ point per thread over the block by a halving tree in
// shared memory (sm: 32 * blockDim.x words; blockDim.x a power of two);
// the sum is returned to thread 0.  log2(blockDim.x) dependent additions.
template <class F>
__device__ xyzz block_sum(xyzz v, uint32_t* sm) {
  const int T = blockDim.x, t = threadIdx.x;
  for (int h = T >> 1; h > 0; h >>= 1) {
    if (t >= h && t < 2 * h) sm_put(sm, T, t - h, v);
    __syncthreads();
    if (t < h) v = xyzz_add<F>(v, sm_get(sm, T, t));
    __syncthreads();
  }
  return v;
}

// Parts per block of window_reduce: RB_T threads, each adding RB_PER parts
// before the block tree.
constexpr int RB_T = 128;
constexpr int RB_PER = 8;
constexpr int RB_SPAN = RB_T * RB_PER;

// in: (nwin, nparts) XYZZ sums; out: (nwin, gridDim.x), entry g the sum of
// parts [g * RB_SPAN, (g + 1) * RB_SPAN) of its window.  Block (g, w).
template <class F>
__global__ void __launch_bounds__(RB_T) window_reduce(const xyzz* in,
                                                      int nparts, xyzz* out) {
  __shared__ uint32_t sm[32 * RB_T];
  int g = blockIdx.x, w = blockIdx.y;
  xyzz acc = xyzz_identity<F>();
#pragma unroll 1
  for (int k = 0; k < RB_PER; k++) {
    int j = g * RB_SPAN + k * RB_T + threadIdx.x;
    if (j < nparts) acc = xyzz_add<F>(acc, xyzz_load(in + (size_t)w * nparts + j));
  }
  acc = block_sum<F>(acc, sm);
  if (threadIdx.x == 0) xyzz_store(out + (size_t)w * gridDim.x + g, acc);
}

// (nwin, nparts) -> (nwin) sums: launches of window_reduce, each cutting the
// parts by RB_SPAN, the intermediate levels in tmp (reduce_tmp_points(nwin,
// nparts) points, ops/cuda_msm.py `reduce_tmp_points`).  Dependent
// additions: RB_PER + log2(RB_T) per level, one level up to RB_SPAN parts.
template <class F>
int reduce_windows(const xyzz* in, int nwin, int nparts, xyzz* tmp, xyzz* ws,
                   cudaStream_t s) {
  while (true) {
    int ng = (nparts + RB_SPAN - 1) / RB_SPAN;
    xyzz* dst = ng == 1 ? ws : tmp;
    window_reduce<F><<<dim3(ng, nwin), RB_T, 0, s>>>(in, nparts, dst);
    int err = (int)cudaGetLastError();
    if (err || ng == 1) return err;
    in = tmp;
    tmp += (size_t)nwin * ng;
    nparts = ng;
  }
}

// Jacobian points in shared memory, word-major as sm_put/sm_get.
__device__ __forceinline__ void sm_put_jac(uint32_t* sm, int ld, int t,
                                           const jac& p) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    sm[k * ld + t] = p.X.v[k];
    sm[(8 + k) * ld + t] = p.Y.v[k];
    sm[(16 + k) * ld + t] = p.Z.v[k];
  }
}

__device__ __forceinline__ jac sm_get_jac(const uint32_t* sm, int ld, int t) {
  jac p;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    p.X.v[k] = sm[k * ld + t];
    p.Y.v[k] = sm[(8 + k) * ld + t];
    p.Z.v[k] = sm[(16 + k) * ld + t];
  }
  return p;
}

constexpr int FIN_T = 128;  // threads of `finish_terms`: at most FIN_T windows

// sum_w 2^(window * w) * ws[w] over nwin <= FIN_T XYZZ window sums (Horner's
// sum).  Thread w doubles its own window's sum window * w times, so the
// chains run side by side, and a block tree adds them: the depth is
// window * (nwin - 1) doublings plus log2(FIN_T) additions, where Horner in
// one thread puts one addition per window into the chain.  The doublings
// are Jacobian (a = 0): 5.56 us a step in one thread on the H100 against
// 6.27 us for XYZZ.  out: (3, 8) canonical Jacobian Montgomery words,
// (0, 1, 0) for the identity.
template <class F>
__global__ void __launch_bounds__(FIN_T)
    finish_terms(const xyzz* ws, int nwin, int window, uint32_t* out) {
  __shared__ uint32_t sm[24 * (FIN_T / 2)];
  int t = threadIdx.x;
  jac p;
  p.X = fe_zero();
  p.Y = fe_one<F>();
  p.Z = fe_zero();
  if (t < nwin) {
    p = xyzz_to_jac<F>(xyzz_load(ws + t));
    for (int k = 0; k < window * t; k++) p = jac_double<F>(p);
  }
  for (int h = FIN_T >> 1; h > 0; h >>= 1) {
    if (t >= h && t < 2 * h) sm_put_jac(sm, FIN_T / 2, t - h, p);
    __syncthreads();
    if (t < h) p = jac_add<F>(p, sm_get_jac(sm, FIN_T / 2, t));
    __syncthreads();
  }
  if (t != 0) return;
  if (fe_is_zero(p.Z)) {
    p.X = fe_zero();
    p.Y = fe_one<F>();
  }
  fe_store(out, p.X);
  fe_store(out + 8, p.Y);
  fe_store(out + 16, p.Z);
}

template <class F>
int launch_finish(const xyzz* ws, int nwin, int window, uint32_t* out,
                  cudaStream_t s) {
  if (nwin > FIN_T) return (int)cudaErrorInvalidValue;
  finish_terms<F><<<1, FIN_T, 0, s>>>(ws, nwin, window, out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace mira
