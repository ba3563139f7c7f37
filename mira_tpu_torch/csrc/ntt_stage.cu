// One radix-2 butterfly stage of an NTT over the whole array:
// (u, v) -> (u + t*v, u - t*v) for every pair (i, i + half) inside blocks of
// 2*half elements, t = tw[k * n/(2*half)] for the pair's offset k.
//
// Replaces mira_tpu/ops/ntt.py `_butterfly_pallas` (driven by
// `_ntt_pallas_jit`).  The TPU kernel gets u, v and the twiddles as three
// limbs-major (16, n/2) arrays that XLA reshapes pair up outside the kernel;
// here the pairing and the twiddle stride are index arithmetic, one thread
// per butterfly, so a transform is log n launches and nothing else.  The
// first stage can gather its inputs through the bit reversal and the last
// can multiply by the inverse transform's 1/n, so neither is a pass of its
// own.  A stage may run in place (each thread owns its pair) unless it
// gathers.  A batch of transforms of one size is one launch: thread b of
// the grid is butterfly b mod n/2 of transform b div n/2, whose n elements
// lie at offset (b div n/2) * n.
//
// Bound on the card: a stage reads and writes every element once (64 B per
// element) and does one Montgomery product per pair; at 2^20 elements that is
// 64 MiB of traffic against 2^19 products, so the stage is bound by memory
// bytes, not by integer multiplies.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace mira;

template <class F>
__global__ void ntt_stage_kernel(const uint32_t* in, uint32_t* out,
                                 const uint32_t* tw, int log_n, int log_half,
                                 int gather, const uint32_t* scale,
                                 size_t total) {
  size_t b = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= total) return;
  size_t pairs = (size_t)1 << (log_n - 1);
  size_t off = (b >> (log_n - 1)) << log_n;  // the transform's first element
  in += off * 8;
  out += off * 8;
  b &= pairs - 1;
  size_t half = (size_t)1 << log_half;
  size_t k = b & (half - 1);
  size_t i = ((b >> log_half) << (log_half + 1)) + k;
  size_t j = i + half;
  size_t si = i, sj = j;
  if (gather) {
    si = (size_t)(__brev((unsigned)i) >> (32 - log_n));
    sj = (size_t)(__brev((unsigned)j) >> (32 - log_n));
  }
  fe u = fe_load_v(in + si * 8);
  fe v = fe_load_v(in + sj * 8);
  size_t t = k << (log_n - 1 - log_half);
  fe p = t == 0 ? v : fe_mul<F>(v, fe_load_ro(tw + t * 8));
  fe x = fe_add<F>(u, p);
  fe y = fe_sub<F>(u, p);
  if (scale != nullptr) {
    fe s = fe_load_ro(scale);
    x = fe_mul<F>(x, s);
    y = fe_mul<F>(y, s);
  }
  fe_store_v(out + i * 8, x);
  fe_store_v(out + j * 8, y);
}

// field 0: Fq, 1: Fr.  in, out: (batch, 2^log_n, 8) Montgomery words (the
// same buffer unless gather != 0); tw: (2^(log_n-1), 8) twiddle powers;
// scale: one element or null.
extern "C" int mira_ntt_stage(int field, const void* in, void* out,
                              const void* tw, int log_n, int log_half,
                              int gather, const void* scale, int batch,
                              void* stream) {
  if (log_n < 1 || log_n > 30 || log_half < 0 || log_half >= log_n) return 1;
  if (gather && in == out) return 1;
  if (batch < 1) return 1;
  const int T = 256;
  size_t total = (size_t)batch << (log_n - 1);
  unsigned blocks = (unsigned)((total + T - 1) / T);
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    ntt_stage_kernel<Fq><<<blocks, T, 0, s>>>(
        (const uint32_t*)in, (uint32_t*)out, (const uint32_t*)tw, log_n,
        log_half, gather, (const uint32_t*)scale, total);
  else
    ntt_stage_kernel<Fr><<<blocks, T, 0, s>>>(
        (const uint32_t*)in, (uint32_t*)out, (const uint32_t*)tw, log_n,
        log_half, gather, (const uint32_t*)scale, total);
  return (int)cudaGetLastError();
}
