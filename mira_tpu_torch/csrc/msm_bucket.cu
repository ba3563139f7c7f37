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
#include "msm_common.cuh"

using namespace mira;

#define WINDOW 5
#define NBUCKET 16  // magnitudes 1..16 of signed 5-bit digits

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
    int d = signed_digit<WINDOW>(s, WINDOW * w, t8);
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
  err = reduce_chunks<F>(buckets, nwin, nchunks, NBUCKET, group, partial, wb, s);
  if (err) return err;
  window_sums<F><<<(nwin + 63) / 64, 64, 0, s>>>(wb, nwin, ws);
  err = (int)cudaGetLastError();
  if (err) return err;
  horner<F><<<1, 1, 0, s>>>(ws, nwin, WINDOW, out);
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
