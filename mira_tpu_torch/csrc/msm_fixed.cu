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
// and reduces the lanes at the last grid step.  Here:
//   recode      one thread per point reads its scalar once and writes its
//               nwin digits as int16, window-major (msm_common.cuh);
//   accumulate  block (b, w) owns window w and a contiguous range of
//               points; its lanes read consecutive digits (coalesced), load
//               the selected 64-byte entry by 16-byte vector loads and madd
//               it into one XYZZ accumulator held in registers, stored at
//               the end.  The grid is one wave: as many blocks per window
//               as the occupancy that ptxas allows leaves room for.  (A
//               block tree at the end of this kernel made ptxas spill
//               registers in the madd loop, and the kernel slower);
//   finish      window_reduce sums each window's accumulators by trees, then
//               finish_terms forms sum_w 2^(W*w) S_w: one Jacobian doubling
//               chain per window, side by side, and a block tree
//               (msm_common.cuh).
// The madd is the complete one (field.cuh), so the TPU kernel's precondition
// of distinct bases does not carry over: duplicate and opposite bases, zero
// scalars and identity lanes (stored as (0, 0) in the table) are exact.
// Precondition: scalars < 2^256 (canonical in the commitment layer).
//
// Bound on the card: nwin * N mixed additions, ~10 Montgomery products each
// (12.9M at N = 248,533, W = 5), bound by the integer multiply rate; the
// table reads (64 bytes per point and window, ~830 MB there) come to a
// tenth of that time.  A thread per (window, chunk of points) with Horner
// in one thread at the end spends a third of its time on the H100 in that
// tail (two chunk-reduce passes of 32 dependent additions, 255 doublings and
// 51 additions in one thread) and rereads and recodes every scalar once per
// window.  The tail here is bound by the latency of W * (nwin - 1)
// Jacobian doublings in one thread (~5.6 us each), which no split of the
// sum can shorten.
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "field.cuh"
#include "msm_common.cuh"

using namespace mira;

// 128 threads and room for 5 blocks an SM (<= 102 registers, no spills):
// the best of four shapes for a madd loop on the H100 (2.73 G madd/s,
// against 2.56 at 128 registers and 256 threads).
constexpr int FIX_T = 128;  // threads of an accumulate block
constexpr int FIX_MINB = 5;  // blocks per SM that ptxas must leave room for

template <class F, int W>
__global__ void __launch_bounds__(FIX_T, FIX_MINB)
    fixed_acc(const int16_t* digits, const uint32_t* tab, int n, int per,
              xyzz* partial, int ldp) {
  constexpr int NTAB = 1 << (W - 1);
  int b = blockIdx.x, w = blockIdx.y;
  int i1 = min(n, (b + 1) * per);
  const int16_t* dw = digits + (size_t)w * n;
  xyzz a = xyzz_identity<F>();
  for (int i = b * per + threadIdx.x; i < i1; i += FIX_T) {
    int d = dw[i];
    if (d == 0) continue;
    int m = d < 0 ? -d : d;
    const uint32_t* e = tab + ((size_t)i * NTAB + (m - 1)) * 16;
    fe x = fe_load_v(e);
    fe y = fe_load_v(e + 8);
    if (fe_is_zero(x) && fe_is_zero(y)) continue;  // identity lane
    if (d < 0) y = fe_neg<F>(y);
    xyzz_madd<F>(a, x, y);
  }
  xyzz_store(partial + (size_t)w * ldp + b * FIX_T + threadIdx.x, a);
}

// Blocks per window: one wave of the card (the resident blocks over the
// windows), and no more than leaves every thread ~8 points.
template <class F, int W>
static int blocks_per_window(int n, int nwin) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fixed_acc<F, W>,
                                                FIX_T, 0);
  int wave = std::max(1, sms * per_sm / nwin);
  int useful = (n + FIX_T * 8 - 1) / (FIX_T * 8);
  return std::max(1, std::min(wave, useful));
}

// The three phases, each one C call so that the wrapper can time them.
template <class F, int W>
static int acc_phase(const int16_t* digits, const uint32_t* tab, int n,
                     int nwin, int nblk, xyzz* partial, int ldp,
                     cudaStream_t s) {
  int per = (n + nblk - 1) / nblk;
  fixed_acc<F, W><<<dim3(nblk, nwin), FIX_T, 0, s>>>(digits, tab, n, per,
                                                     partial, ldp);
  return (int)cudaGetLastError();
}

template <class F>
static int finish_phase(const xyzz* partial, int nwin, int nblk, int window,
                        xyzz* tmp, xyzz* ws, uint32_t* out, cudaStream_t s) {
  int err = reduce_windows<F>(partial, nwin, nblk * FIX_T, tmp, ws, s);
  if (err) return err;
  return launch_finish<F>(ws, nwin, window, out, s);
}

template <class Fn>
static int dispatch(int field, int window, Fn&& fn) {
  using W5 = std::integral_constant<int, 5>;
  using W6 = std::integral_constant<int, 6>;
  if (window == 5) return field == 0 ? fn(Fq{}, W5{}) : fn(Fr{}, W5{});
  if (window == 6) return field == 0 ? fn(Fq{}, W6{}) : fn(Fr{}, W6{});
  return (int)cudaErrorInvalidValue;
}

// field 0: BN254 G1 (coordinates in Fq); field 1: Grumpkin (in Fr).
// window 5 or 6 (else cudaErrorInvalidValue).  The wrapper
// (ops/cuda_msm.py) calls the four in order:
//   mira_msm_fixed_blocks  -> blocks per window nblk (not a launch);
//   mira_msm_fixed_recode  sc (n, 8) plain words -> digits (nwin, n) int16;
//   mira_msm_fixed_acc     digits, tab (n, 2^(window-1), 2, 8) affine
//                          Montgomery multiples -> partial (nwin, nblk *
//                          FIX_T) XYZZ, one per thread, rows ldp points
//                          apart (nblk * FIX_T here; the Pippenger MSM,
//                          msm_pippenger.cu, puts its chunks of points side
//                          by side in one wider row);
//   mira_msm_fixed_finish  partial -> out (3, 8) canonical Jacobian
//                          Montgomery words, through tmp
//                          (reduce_tmp_points(nwin, nblk * FIX_T) XYZZ) and
//                          ws (nwin).
// Each returns a cudaError_t.
extern "C" int mira_msm_fixed_blocks(int field, int window, int n, int nwin) {
  return dispatch(field, window, [&](auto tag, auto wtag) {
    return blocks_per_window<decltype(tag), decltype(wtag)::value>(n, nwin);
  });
}

extern "C" int mira_msm_fixed_recode(const void* sc, int n, int window,
                                     int nwin, void* digits, void* stream) {
  recode_digits<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)sc, nullptr, n, window, nwin, (int16_t*)digits);
  return (int)cudaGetLastError();
}

extern "C" int mira_msm_fixed_acc(int field, int window, const void* digits,
                                  const void* tab, int n, int nwin, int nblk,
                                  void* partial, int ldp, void* stream) {
  return dispatch(field, window, [&](auto tag, auto wtag) {
    return acc_phase<decltype(tag), decltype(wtag)::value>(
        (const int16_t*)digits, (const uint32_t*)tab, n, nwin, nblk,
        (xyzz*)partial, ldp, (cudaStream_t)stream);
  });
}

extern "C" int mira_msm_fixed_finish(int field, int window, const void* partial,
                                     int nwin, int nblk, void* tmp, void* ws,
                                     void* out, void* stream) {
  if (window != 5 && window != 6) return (int)cudaErrorInvalidValue;
  auto run = [&](auto tag) {
    return finish_phase<decltype(tag)>((const xyzz*)partial, nwin, nblk,
                                       window, (xyzz*)tmp, (xyzz*)ws,
                                       (uint32_t*)out, (cudaStream_t)stream);
  };
  return field == 0 ? run(Fq{}) : run(Fr{});
}
