// Shared-Horner Pippenger MSM: sum_i s_i * P_i over BN254 G1 or Grumpkin,
// with a per-lane table of multiples and one accumulator per window.
//
// Replaces mira_tpu/ops/pallas_msm.py `_msm_pallas_pippenger_signed_jit`
// (kernel 4: signed 5-bit digits in [-16, 15], table 1P..16P, 52 windows)
// and `_msm_pallas_pippenger_jit` (kernel 5, "pippenger-u4": unsigned 4-bit
// digits, table 1P..15P, 64 windows), behind msm_pallas(method="pippenger")
// and the per-shard engine of mira_tpu/parallel/msm.py.  Same arithmetic:
// each base's table of multiples, then per window the selected multiple
// (y negated for a negative digit) added into that window's accumulator,
// the accumulators summed over all lanes, and Horner's rule over the window
// sums.  What the TPU kernel does and this one does not:
//   - it carries its 52 (64) per-window accumulators in VMEM across a grid
//     that runs in order and reduces them in the last step; blocks here run
//     in no order, so each thread walks its own chunk of points (a loop in
//     place of the sequential grid) and keeps its window accumulators in a
//     scratch buffer of the caller's, (nwin, nchunks) XYZZ points, which
//     msm_common.cuh's window_reduce sums across chunks by block trees and
//     finish_terms joins over the windows;
//   - it selects a table entry by a masked select over all 16 entries (Mosaic
//     has no data-dependent gather); here a thread indexes its table.  The
//     table, 16 XYZZ points = 2 KiB per thread, is in local memory: in shared
//     memory it would allow ~100 threads per SM, too few warps to hide the
//     product chains; local memory is cached in L1/L2 and each thread reads
//     only its own entries;
//   - it uses incomplete Jacobian additions and requires distinct,
//     non-identity bases; every addition here is the complete XYZZ one
//     (field.cuh), so duplicate and opposite bases, identity lanes and zero
//     scalars are exact.
// Digits: kernel 4 reuses msm_common.cuh's signed_digit<5> (closed-form
// carries, one extra window for the last carry); kernel 5 reads raw 4-bit
// digits.  The point operations are out of line (__noinline__): inlined, the
// table build and the window loop would be dozens of copies of an addition
// for ptxas to schedule, four times over (two fields, two digit schemes).
//
// Bound on the card: the MSM needs what the bucket MSM needs (the same
// function); this design does ~15 point operations per base for its table
// and one full XYZZ addition (14 products) per base and window, about 6x the
// bucket kernel's mixed additions, so it is bound by integer multiplies, with
// the accumulator read-modify-writes (128 B per base and window, coalesced
// across a warp) spread over them.
#include <cuda_runtime.h>

#include <type_traits>

#include "field.cuh"
#include "msm_common.cuh"

using namespace mira;

template <class F>
__device__ __noinline__ void pt_add(xyzz& a, const xyzz& b) {
  a = xyzz_add<F>(a, b);
}

template <class F>
__device__ __noinline__ void pt_double(xyzz& a) {
  a = xyzz_double<F>(a);
}

// One thread per chunk c: points c, c + nchunks, ...; acc[w * nchunks + c]
// is the chunk's sum of window w's selected multiples.
template <class F, bool SIGNED>
__global__ void pippenger_acc(const uint32_t* sc, const uint32_t* X,
                              const uint32_t* Y, const uint32_t* Z, int n,
                              int nwin, int nchunks, const uint32_t* thr,
                              xyzz* acc) {
  constexpr int W = SIGNED ? 5 : 4;
  constexpr int NT = SIGNED ? 16 : 15;
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nchunks) return;
  for (int w = 0; w < nwin; w++) acc[(size_t)w * nchunks + c] = xyzz_identity<F>();
  xyzz tab[NT];
  for (int i = c; i < n; i += nchunks) {
    uint32_t s[8], any = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) {
      s[k] = sc[8 * i + k];
      any |= s[k];
    }
    if (any == 0 || fe_is_zero(fe_load(Z + 8 * i))) continue;
    tab[0].X = fe_load(X + 8 * i);
    tab[0].Y = fe_load(Y + 8 * i);
    tab[0].ZZ = fe_one<F>();
    tab[0].ZZZ = fe_one<F>();
    tab[1] = tab[0];
    pt_double<F>(tab[1]);
    if constexpr (SIGNED) {
      // odd v from (v - 2)P + 2P, even v by doubling v/2
      for (int v = 3; v <= 15; v += 2) {
        tab[v - 1] = tab[v - 3];
        pt_add<F>(tab[v - 1], tab[1]);
      }
      for (int v = 4; v <= 16; v += 2) {
        tab[v - 1] = tab[v / 2 - 1];
        pt_double<F>(tab[v - 1]);
      }
    } else {
      for (int d = 2; d < NT; d++) {
        tab[d] = tab[d - 1];
        pt_add<F>(tab[d], tab[0]);
      }
    }
    for (int w = 0; w < nwin; w++) {
      int d;
      if constexpr (SIGNED) {
        d = signed_digit<W>(s, W * w, thr + 8 * w);
      } else {
        int bit = W * w;
        d = bit < 256 ? (int)((s[bit >> 5] >> (bit & 31)) & 15u) : 0;
      }
      if (d == 0) continue;
      xyzz q = tab[(d < 0 ? -d : d) - 1];
      if (d < 0) q.Y = fe_neg<F>(q.Y);
      xyzz a = acc[(size_t)w * nchunks + c];
      pt_add<F>(a, q);
      acc[(size_t)w * nchunks + c] = a;
    }
  }
}

template <class F, bool SIGNED>
static int launch(const uint32_t* sc, const uint32_t* X, const uint32_t* Y,
                  const uint32_t* Z, int n, int nwin, int nchunks,
                  const uint32_t* thr, xyzz* acc, xyzz* partial, xyzz* ws,
                  uint32_t* out, cudaStream_t s) {
  const int T = 128;
  pippenger_acc<F, SIGNED><<<(nchunks + T - 1) / T, T, 0, s>>>(
      sc, X, Y, Z, n, nwin, nchunks, thr, acc);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = reduce_windows<F>(acc, nwin, nchunks, partial, ws, s);
  if (err) return err;
  return launch_finish<F>(ws, nwin, SIGNED ? 5 : 4, out, s);
}

// field 0: BN254 G1 (coordinates in Fq); field 1: Grumpkin (in Fr).  signed
// 1: kernel 4 (nwin = 52 for 254-bit scalars; thr: (nwin, 8) carry
// thresholds of the 5-bit recoding), 0: kernel 5 (nwin = 64; thr unused).
// sc, X, Y, Z: (n, 8) words, bases affine or identity (Z in {0, R mod p});
// scratch sized by the caller in XYZZ points (32 words each): acc
// nwin*nchunks, partial reduce_tmp_points(nwin, nchunks) (ops/cuda_msm.py),
// ws nwin; out: (3, 8) canonical Jacobian Montgomery words.
extern "C" int mira_msm_pippenger(int field, int is_signed, const void* sc,
                                  const void* X, const void* Y, const void* Z,
                                  int n, int nwin, int nchunks,
                                  const void* thr, void* acc, void* partial,
                                  void* ws, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto tag, auto sgn) {
    using F = decltype(tag);
    return launch<F, decltype(sgn)::value>(
        (const uint32_t*)sc, (const uint32_t*)X, (const uint32_t*)Y,
        (const uint32_t*)Z, n, nwin, nchunks, (const uint32_t*)thr,
        (xyzz*)acc, (xyzz*)partial, (xyzz*)ws, (uint32_t*)out, s);
  };
  using S1 = std::integral_constant<bool, true>;
  using S0 = std::integral_constant<bool, false>;
  if (is_signed) return field == 0 ? run(Fq{}, S1{}) : run(Fr{}, S1{});
  return field == 0 ? run(Fq{}, S0{}) : run(Fr{}, S0{});
}
