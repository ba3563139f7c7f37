// Generic-base bucket MSM: sum_i s_i * P_i over BN254 G1 or Grumpkin.
//
// Replaces mira_tpu/ops/pallas_msm.py `_msm_pallas_bucket_jit`
// (acc_kernel, fin_kernel) behind msm_pallas(method="bucket").  Same
// arithmetic: signed 5-bit digits with closed-form carries, per-(window,
// magnitude) XYZZ buckets fed by mixed additions, a suffix-sum reduction
// sum_v v*B_v per window and Horner across windows.  The TPU grid (window
// groups visited in order, buckets revisited in the output buffer, an
// offset point R so that Mosaic's predicated madd never meets the doubling
// case) is not carried over:
//   kernel A  one thread per (window, chunk of points) recodes its digits
//             and accumulates into its own 16 XYZZ buckets (local memory);
//   kernel B  sums each (window, magnitude) bucket over the chunks in two
//             passes: one thread per (window, magnitude, group of chunks),
//             then one per (window, magnitude) over the groups;
//   kernel C  one thread per window forms sum_v v*B_v;
//   kernel D  one thread runs Horner over the windows and emits Jacobian.
// Every point operation is the complete one (field.cuh), so there is no
// offset point and no -K*R cancel.
//
// Precondition: scalars are canonical (< the group order, < 2^254) and
// bases are affine points or the identity (Z in {0, R mod p}).  Nothing is
// assumed about the bases otherwise: duplicates, opposite points, zero
// scalars and identity lanes are all exact.
//
// Bound on the card: kernel A does nwin * N mixed additions (~10 field
// products each); it is bound by integer multiply throughput, with the
// bucket read-modify-write in L1-cached local memory.  Kernel B does
// nwin * 16 * chunks additions; a single pass would give only nwin * 16
// threads a chain of `chunks` dependent additions each, so it reduces in
// two passes.  Kernels C and D are short serial chains (16 and
// 5 * nwin steps) and cost a few milliseconds whatever N is.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace mira;

#define WINDOW 5
#define NBUCKET 16  // magnitudes 1..16 of signed 5-bit digits

// digit of window w (bits [5w, 5w+5)) of the signed recoding, whose
// incoming carry is [ (s mod 2^(5w)) > thr ] with
// thr = 15 * (2^(5w) - 1) / 31, the largest value digits below w can reach
__device__ __forceinline__ int signed_digit(const uint32_t* s, int bit,
                                            const uint32_t* thr) {
  int wi = bit >> 5, off = bit & 31;
  uint32_t lo = wi < 8 ? s[wi] >> off : 0u;
  uint32_t hi = (off > 32 - WINDOW && wi + 1 < 8) ? s[wi + 1] << (32 - off) : 0u;
  int raw = (int)((lo | hi) & 31u);
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
  return t >= NBUCKET ? t - 2 * NBUCKET : t;
}

template <class F>
__global__ void bucket_acc(const uint32_t* sc, const uint32_t* X,
                           const uint32_t* Y, const uint32_t* Z, int n,
                           int nwin, int nchunks, const uint32_t* thr,
                           xyzz* buckets) {
  int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= nwin * nchunks) return;
  int w = tid / nchunks, c = tid % nchunks;
  uint32_t t8[8];
#pragma unroll
  for (int k = 0; k < 8; k++) t8[k] = thr[8 * w + k];
  xyzz b[NBUCKET];
  for (int v = 0; v < NBUCKET; v++) b[v] = xyzz_identity<F>();
  for (int i = c; i < n; i += nchunks) {
    uint32_t s[8];
#pragma unroll
    for (int k = 0; k < 8; k++) s[k] = sc[8 * i + k];
    int d = signed_digit(s, WINDOW * w, t8);
    if (d == 0) continue;
    fe z = fe_load(Z + 8 * i);
    if (fe_is_zero(z)) continue;
    fe x = fe_load(X + 8 * i);
    fe y = fe_load(Y + 8 * i);
    if (d < 0) {
      y = fe_neg<F>(y);
      d = -d;
    }
    xyzz_madd<F>(b[d - 1], x, y);
  }
  for (int v = 0; v < NBUCKET; v++) buckets[tid * NBUCKET + v] = b[v];
}

// in: (nwin, nchunks, 16) buckets; out: (nwin, ngroups, 16), entry g the
// sum over chunks [g * group, (g + 1) * group)
template <class F>
__global__ void bucket_reduce(const xyzz* in, int nwin, int nchunks,
                              int group, xyzz* out) {
  int ngroups = (nchunks + group - 1) / group;
  int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= nwin * ngroups * NBUCKET) return;
  int v = tid % NBUCKET;
  int g = (tid / NBUCKET) % ngroups;
  int w = tid / (NBUCKET * ngroups);
  int c1 = min(nchunks, (g + 1) * group);
  xyzz acc = xyzz_identity<F>();
  for (int c = g * group; c < c1; c++)
    acc = xyzz_add<F>(acc, in[(w * nchunks + c) * NBUCKET + v]);
  out[tid] = acc;
}

template <class F>
__global__ void window_sums(const xyzz* wb, int nwin, xyzz* ws) {
  int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= nwin) return;
  xyzz run = xyzz_identity<F>(), tot = xyzz_identity<F>();
  for (int v = NBUCKET - 1; v >= 0; v--) {
    run = xyzz_add<F>(run, wb[w * NBUCKET + v]);
    tot = xyzz_add<F>(tot, run);
  }
  ws[w] = tot;
}

template <class F>
__global__ void horner(const xyzz* ws, int nwin, uint32_t* out) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  xyzz acc = ws[nwin - 1];
  for (int w = nwin - 2; w >= 0; w--) {
    for (int k = 0; k < WINDOW; k++) acc = xyzz_double<F>(acc);
    acc = xyzz_add<F>(acc, ws[w]);
  }
  jac r = xyzz_to_jac<F>(acc);
  fe_store(out, r.X);
  fe_store(out + 8, r.Y);
  fe_store(out + 16, r.Z);
}

template <class F>
static int launch(const uint32_t* sc, const uint32_t* X, const uint32_t* Y,
                  const uint32_t* Z, int n, int nwin, int nchunks, int group,
                  const uint32_t* thr, xyzz* buckets, xyzz* partial, xyzz* wb,
                  xyzz* ws, uint32_t* out, cudaStream_t s) {
  const int T = 128;
  int na = nwin * nchunks;
  bucket_acc<F><<<(na + T - 1) / T, T, 0, s>>>(sc, X, Y, Z, n, nwin, nchunks,
                                               thr, buckets);
  int err = (int)cudaGetLastError();
  if (err) return err;
  int ng = (nchunks + group - 1) / group;
  int nb = nwin * ng * NBUCKET;
  bucket_reduce<F><<<(nb + T - 1) / T, T, 0, s>>>(buckets, nwin, nchunks,
                                                  group, partial);
  err = (int)cudaGetLastError();
  if (err) return err;
  nb = nwin * NBUCKET;
  bucket_reduce<F><<<(nb + T - 1) / T, T, 0, s>>>(partial, nwin, ng, ng, wb);
  err = (int)cudaGetLastError();
  if (err) return err;
  window_sums<F><<<(nwin + 63) / 64, 64, 0, s>>>(wb, nwin, ws);
  err = (int)cudaGetLastError();
  if (err) return err;
  horner<F><<<1, 1, 0, s>>>(ws, nwin, out);
  return (int)cudaGetLastError();
}

// field 0: BN254 G1 (coordinates in Fq); field 1: Grumpkin (in Fr).
// sc, X, Y, Z: (n, 8) words; thr: (nwin, 8); group: chunks per thread in
// kernel B's first pass; scratch sized by the caller in XYZZ points (32
// words each): buckets nwin*nchunks*16, partial nwin*ceil(nchunks/group)*16,
// wb nwin*16, ws nwin; out: (3, 8) canonical Jacobian Montgomery words.
extern "C" int mira_msm_bucket(int field, const void* sc, const void* X,
                               const void* Y, const void* Z, int n, int nwin,
                               int nchunks, int group, const void* thr,
                               void* buckets, void* partial, void* wb,
                               void* ws, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  auto args = [&](auto tag) {
    using F = decltype(tag);
    return launch<F>((const uint32_t*)sc, (const uint32_t*)X,
                     (const uint32_t*)Y, (const uint32_t*)Z, n, nwin, nchunks,
                     group, (const uint32_t*)thr, (xyzz*)buckets,
                     (xyzz*)partial, (xyzz*)wb, (xyzz*)ws, (uint32_t*)out, s);
  };
  return field == 0 ? args(Fq{}) : args(Fr{});
}
