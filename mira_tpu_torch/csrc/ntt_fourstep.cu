// Four-step radix-2 NTT: a size-n transform as n = n1 * n2 with
// l1 = log n / 2 (rounded down) and l2 = log n - l1.
//
// Replaces mira_tpu/ops/ntt.py `_fourstep_kernels` (`run1`, `run2`, driven by
// `_ntt_fourstep_jit`).  With i = i1 + n1*i2 and k = k1*n2 + k2,
//
//   X[k1*n2 + k2] = sum_i1 (w^n2)^(i1 k1) * w^(i1 k2)
//                          * sum_i2 (w^n1)^(i2 k2) * a[i1 + n1*i2]
//
// so the first kernel runs, for every i1, all l2 stages of the size-n2
// transform over i2 and multiplies by the mid twiddle w^(i1 k2); the second
// runs, for every k2, all l1 stages of the size-n1 transform over i1.  The
// TPU version keeps (16, m, 128) tiles in VMEM, packs chunk pairs into one
// multiply and moves data with sublane rolls and masks; none of that has a
// counterpart here.  One block owns one column: it loads the m elements into
// shared memory through the bit reversal, runs the stages there with one
// butterfly per thread per pass and a barrier between stages, and writes the
// column back.  The transpose between the two kernels, which the TPU version
// leaves to XLA, is folded into the strides: kernel 1 writes its column
// contiguously as row i1 of an (n1, n2) matrix, kernel 2 reads column k2 of
// that matrix and writes X[k1*n2 + k2] at stride n2.  Strided accesses move
// whole 32-byte elements, one DRAM sector each.
//
// The mid twiddle w^e, e = i1*k2 < n, is not a table of the input's size:
// it is the product of two entries of tables of n2 and n1 powers,
// w^(e mod n2) and (w^n2)^(e div n2), 2*sqrt(n) elements in all.
//
// A batch of transforms of one size (the row transforms of the distributed
// NTT, parallel/ntt.py) is one launch pair: the batch index is the grid's
// second dimension, and transform b reads and writes its n elements at
// offset b*n of the input, scratch and output.
//
// Shared memory holds the column word-major (word w of element e at
// w*m + e), so that a warp's accesses to consecutive elements fall in
// consecutive banks.  m = 4096 elements take 128 KiB, above the 48 KiB a
// kernel gets unasked, hence cudaFuncSetAttribute.
//
// Bound on the card: the transform must read its input and write its output
// once (1 GiB at 2^24; this design moves the array twice) and does
// n/2 * log n + 2n Montgomery products; at 2^24 that is 2.3e8 products of
// 272 int32 multiply-adds each, which puts the operations bound (3.8 ms)
// above the bytes bound (0.32 ms): bound by integer multiplies.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace mira;

__device__ __forceinline__ fe sm_load(const uint32_t* sm, int m, int e) {
  fe r;
#pragma unroll
  for (int w = 0; w < 8; w++) r.v[w] = sm[w * m + e];
  return r;
}

__device__ __forceinline__ void sm_store(uint32_t* sm, int m, int e,
                                         const fe& a) {
#pragma unroll
  for (int w = 0; w < 8; w++) sm[w * m + e] = a.v[w];
}

// Column c of a matrix whose element (r, c) lies at in[c + r*in_rs]: all
// log_m stages of its size-m transform, then out[c*out_cs + r*out_rs].
// With mid_a != null the result is first multiplied by w^(c*r), taken as
// mid_a[e & (2^log_a - 1)] * mid_b[e >> log_a]; with scale != null, by it.
// Transform blockIdx.y of a batch works at offset blockIdx.y * bstride
// elements of in and out.
template <class F>
__global__ void ntt_columns_kernel(const uint32_t* in, uint32_t* out,
                                   int log_m, size_t in_rs, size_t out_cs,
                                   size_t out_rs, const uint32_t* tw,
                                   const uint32_t* mid_a,
                                   const uint32_t* mid_b, int log_a,
                                   const uint32_t* scale, size_t bstride) {
  extern __shared__ uint32_t sm[];
  const int m = 1 << log_m;
  const size_t c = blockIdx.x;
  in += blockIdx.y * bstride * 8;
  out += blockIdx.y * bstride * 8;
  for (int r = threadIdx.x; r < m; r += blockDim.x) {
    int e = (int)(__brev((unsigned)r) >> (32 - log_m));
    sm_store(sm, m, e, fe_load_v(in + (c + (size_t)r * in_rs) * 8));
  }
  __syncthreads();
  for (int s = 0; s < log_m; s++) {
    const int half = 1 << s;
    for (int b = threadIdx.x; b < m / 2; b += blockDim.x) {
      int k = b & (half - 1);
      int i = ((b >> s) << (s + 1)) + k;
      int j = i + half;
      fe u = sm_load(sm, m, i);
      fe v = sm_load(sm, m, j);
      int t = k << (log_m - 1 - s);
      fe p = t == 0 ? v : fe_mul<F>(v, fe_load_ro(tw + (size_t)t * 8));
      sm_store(sm, m, i, fe_add<F>(u, p));
      sm_store(sm, m, j, fe_sub<F>(u, p));
    }
    __syncthreads();
  }
  for (int r = threadIdx.x; r < m; r += blockDim.x) {
    fe x = sm_load(sm, m, r);
    if (mid_a != nullptr) {
      size_t e = c * (size_t)r;
      size_t lo = e & (((size_t)1 << log_a) - 1), hi = e >> log_a;
      if (lo) x = fe_mul<F>(x, fe_load_ro(mid_a + lo * 8));
      if (hi) x = fe_mul<F>(x, fe_load_ro(mid_b + hi * 8));
    }
    if (scale != nullptr) x = fe_mul<F>(x, fe_load_ro(scale));
    fe_store_v(out + (c * out_cs + (size_t)r * out_rs) * 8, x);
  }
}

template <class F>
static int launch_fourstep(const uint32_t* in, uint32_t* tmp, uint32_t* out,
                           int l1, int l2, const uint32_t* tw1,
                           const uint32_t* tw2, const uint32_t* mid_a,
                           const uint32_t* mid_b, const uint32_t* scale,
                           int batch, cudaStream_t s) {
  const size_t n1 = (size_t)1 << l1, n2 = (size_t)1 << l2;
  const size_t smem1 = 32 * n2, smem2 = 32 * n1;
  cudaError_t err = cudaFuncSetAttribute(
      ntt_columns_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return (int)err;
  auto threads = [](size_t m) {
    size_t t = m / 2;
    return (unsigned)(t < 32 ? 32 : (t > 512 ? 512 : t));
  };
  // columns i1 of the (n2, n1) view of the input -> rows of tmp (n1, n2)
  ntt_columns_kernel<F><<<dim3((unsigned)n1, batch), threads(n2), smem1, s>>>(
      in, tmp, l2, n1, n2, 1, tw1, mid_a, mid_b, l2, nullptr, n1 * n2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // columns k2 of tmp (n1, n2) -> X[k1*n2 + k2]
  ntt_columns_kernel<F><<<dim3((unsigned)n2, batch), threads(n1), smem2, s>>>(
      tmp, out, l1, n2, 1, n2, tw2, nullptr, nullptr, 0, scale, n1 * n2);
  return (int)cudaGetLastError();
}

// field 0: Fq, 1: Fr.  in, tmp, out: (batch, 2^log_n, 8) Montgomery words,
// three different buffers, batch in 1..65535; tw1: (n2/2, 8) powers of w^n1; tw2: (max(n1/2, 1), 8)
// powers of w^n2; mid_a: (n2, 8) powers of w; mid_b: (n1, 8) powers of
// w^n2; scale: one element (the inverse's 1/n) or null.
extern "C" int mira_ntt_fourstep(int field, const void* in, void* tmp,
                                 void* out, int log_n, const void* tw1,
                                 const void* tw2, const void* mid_a,
                                 const void* mid_b, const void* scale,
                                 int batch, void* stream) {
  // a column of 2^12 elements is the most that fits in shared memory
  if (log_n < 2 || log_n > 24 || batch < 1 || batch > 65535) return 1;
  const int l1 = log_n / 2, l2 = log_n - l1;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    return launch_fourstep<Fq>(
        (const uint32_t*)in, (uint32_t*)tmp, (uint32_t*)out, l1, l2,
        (const uint32_t*)tw1, (const uint32_t*)tw2, (const uint32_t*)mid_a,
        (const uint32_t*)mid_b, (const uint32_t*)scale, batch, s);
  return launch_fourstep<Fr>(
      (const uint32_t*)in, (uint32_t*)tmp, (uint32_t*)out, l1, l2,
      (const uint32_t*)tw1, (const uint32_t*)tw2, (const uint32_t*)mid_a,
      (const uint32_t*)mid_b, (const uint32_t*)scale, batch, s);
}
