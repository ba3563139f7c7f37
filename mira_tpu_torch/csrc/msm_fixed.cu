// Fixed-base MSM: sum_i s_i * P_i over BN254 G1 or Grumpkin, with every
// base's multiples 1P..(2^(W-1))P precomputed as affine points
// (fixed_table.cu).
//
// Replaces mira_tpu/ops/pallas_msm.py `_msm_pallas_fixed_jit` behind
// msm_pallas_fixed.  Same arithmetic: signed W-bit digits (W = 5 or 6,
// nwin = ceil(254 / W) + 1 windows), a lookup of |d|*P with y negated for
// d < 0, per-window sums S_w accumulated by mixed XYZZ additions, and
// sum_w 2^(W*w) * S_w by Horner.  The TPU kernel keeps nwin XYZZ
// accumulators per lane in VMEM across a sequential grid over point blocks
// and reduces the lanes at the last grid step; the card has no sequential
// grid and a thread cannot hold 52 x 4 field elements, so:
//   kernel A  one thread per (window, chunk of points) recodes its digit of
//             each point (closed-form carries, msm_common.cuh), reads the
//             selected multiple (64 contiguous bytes) and madds it into its
//             one XYZZ accumulator;
//   kernel B  sums the accumulators of each window over the chunks in two
//             passes (msm_common.cuh);
//   kernel C  one thread runs Horner over the windows and emits Jacobian.
// The madd is the complete one (field.cuh), so the TPU kernel's precondition
// of distinct bases does not carry over: duplicate and opposite bases, zero
// scalars and identity lanes (stored as (0, 0) in the table) are exact.
// Precondition: scalars < 2^256 (canonical in the commitment layer).
//
// Bound on the card: kernel A does nwin * N mixed additions (~10 Montgomery
// products each, 13.6M at N = 2^18, W = 5) and reads N * nwin * 64 bytes of
// table (~870 MB at 2^18, mostly L2 misses); it is bound by integer
// multiply throughput, like the bucket kernel, with the table reads spread
// over it.  Each thread keeps one accumulator (32 registers) where the
// bucket kernel keeps sixteen, so more threads are in flight.
#include <cuda_runtime.h>

#include <type_traits>

#include "field.cuh"
#include "msm_common.cuh"

using namespace mira;

template <class F, int W>
__global__ void fixed_acc(const uint32_t* sc, const uint32_t* tab, int n,
                          int nwin, int nchunks, const uint32_t* thr,
                          xyzz* acc) {
  const int NTAB = 1 << (W - 1);
  int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= nwin * nchunks) return;
  int w = tid / nchunks, c = tid % nchunks;
  uint32_t t8[8];
#pragma unroll
  for (int k = 0; k < 8; k++) t8[k] = thr[8 * w + k];
  xyzz a = xyzz_identity<F>();
  for (int i = c; i < n; i += nchunks) {
    uint32_t s[8];
#pragma unroll
    for (int k = 0; k < 8; k++) s[k] = sc[8 * i + k];
    int d = signed_digit<W>(s, W * w, t8);
    if (d == 0) continue;
    int m = d < 0 ? -d : d;
    const uint32_t* e = tab + ((size_t)i * NTAB + (m - 1)) * 16;
    fe x = fe_load(e);
    fe y = fe_load(e + 8);
    if (fe_is_zero(x) && fe_is_zero(y)) continue;  // identity lane
    if (d < 0) y = fe_neg<F>(y);
    xyzz_madd<F>(a, x, y);
  }
  acc[tid] = a;
}

template <class F, int W>
static int launch(const uint32_t* sc, const uint32_t* tab, int n, int nwin,
                  int nchunks, int group, const uint32_t* thr, xyzz* acc,
                  xyzz* partial, xyzz* ws, uint32_t* out, cudaStream_t s) {
  const int T = 128;
  int na = nwin * nchunks;
  fixed_acc<F, W><<<(na + T - 1) / T, T, 0, s>>>(sc, tab, n, nwin, nchunks,
                                                  thr, acc);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = reduce_chunks<F>(acc, nwin, nchunks, 1, group, partial, ws, s);
  if (err) return err;
  horner<F><<<1, 1, 0, s>>>(ws, nwin, W, out);
  return (int)cudaGetLastError();
}

// field 0: BN254 G1 (coordinates in Fq); field 1: Grumpkin (in Fr).
// sc: (n, 8) plain scalar words; tab: (n, 2^(window-1), 2, 8) affine
// Montgomery multiples; window 5 or 6; thr: (nwin, 8); group: chunks per
// thread in kernel B's first pass; scratch sized by the caller in XYZZ
// points (32 words each): acc nwin*nchunks, partial
// nwin*ceil(nchunks/group), ws nwin; out: (3, 8) canonical Jacobian
// Montgomery words.  Returns a cudaError_t (cudaErrorInvalidValue for a
// window other than 5 or 6).
extern "C" int mira_msm_fixed(int field, const void* sc, const void* tab,
                              int n, int window, int nwin, int nchunks,
                              int group, const void* thr, void* acc,
                              void* partial, void* ws, void* out,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto tag, auto wtag) {
    using F = decltype(tag);
    constexpr int W = decltype(wtag)::value;
    return launch<F, W>((const uint32_t*)sc, (const uint32_t*)tab, n, nwin,
                        nchunks, group, (const uint32_t*)thr, (xyzz*)acc,
                        (xyzz*)partial, (xyzz*)ws, (uint32_t*)out, s);
  };
  using W5 = std::integral_constant<int, 5>;
  using W6 = std::integral_constant<int, 6>;
  if (window == 5) return field == 0 ? run(Fq{}, W5{}) : run(Fr{}, W5{});
  if (window == 6) return field == 0 ? run(Fq{}, W6{}) : run(Fr{}, W6{});
  return (int)cudaErrorInvalidValue;
}
