// Microbenchmarks of the MSM kernels' building blocks (csrc/field.cuh), run
// by bench/msm_micro.py: the Montgomery product as the library writes it
// (C++ on 64-bit temporaries) against a carry-chain PTX version (its SASS
// and its throughput over many threads); the latency in one thread of an
// XYZZ doubling, a Jacobian doubling and a full XYZZ addition (the chains of
// Horner's rule); the mixed-addition rate of a register-resident madd loop
// at four block shapes.  The PTX product lives here only, as the measured
// alternative: the library keeps one product.  And the Poseidon sponge's
// thread route (csrc/poseidon.cuh) with its product inlined, for t = 3 over
// BN254 Fr only, to time against the library's out-of-line product.
#include <cuda_runtime.h>
#include <stdint.h>
#include "../csrc/field.cuh"
#define POSEIDON_MUL_ATTR __forceinline__
#include "../csrc/poseidon.cuh"
using namespace mira;

#define CHAIN_LO(T, A, B)                                                     \
  asm("mad.lo.cc.u32 %0, %9, %17, %0;\n\t"                                   \
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"                                 \
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"                                 \
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"                                 \
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"                                 \
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"                                 \
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"                                 \
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"                                 \
      "addc.u32 %8, %8, 0;"                                                  \
      : "+r"(T[0]), "+r"(T[1]), "+r"(T[2]), "+r"(T[3]), "+r"(T[4]),          \
        "+r"(T[5]), "+r"(T[6]), "+r"(T[7]), "+r"(T[8])                       \
      : "r"(A[0]), "r"(A[1]), "r"(A[2]), "r"(A[3]), "r"(A[4]), "r"(A[5]),    \
        "r"(A[6]), "r"(A[7]), "r"(B))
#define CHAIN_HI(T, A, B)                                                     \
  asm("mad.hi.cc.u32 %1, %9, %17, %1;\n\t"                                   \
      "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"                                 \
      "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"                                 \
      "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"                                 \
      "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"                                 \
      "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"                                 \
      "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"                                 \
      "madc.hi.u32 %8, %16, %17, %8;"                                        \
      : "+r"(T[0]), "+r"(T[1]), "+r"(T[2]), "+r"(T[3]), "+r"(T[4]),          \
        "+r"(T[5]), "+r"(T[6]), "+r"(T[7]), "+r"(T[8])                       \
      : "r"(A[0]), "r"(A[1]), "r"(A[2]), "r"(A[3]), "r"(A[4]), "r"(A[5]),    \
        "r"(A[6]), "r"(A[7]), "r"(B))

template <class F>
__device__ __forceinline__ fe fe_mul_ptx(const fe& a, const fe& b) {
  uint32_t t[9], P[8];
#pragma unroll
  for (int i = 0; i < 9; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) P[i] = F::p(i);
#pragma unroll
  for (int i = 0; i < 8; i++) {
    CHAIN_LO(t, a.v, b.v[i]);
    CHAIN_HI(t, a.v, b.v[i]);
    uint32_t m = t[0] * F::n0;
    CHAIN_LO(t, P, m);
    CHAIN_HI(t, P, m);
#pragma unroll
    for (int j = 0; j < 8; j++) t[j] = t[j + 1];
    t[8] = 0;
  }
  fe r, d;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = t[i];
  return sub_p<F>(d, r) ? r : d;
}

extern "C" __global__ void one_mul_cpp(const fe* a, const fe* b, fe* c) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  c[i] = fe_mul<Fq>(a[i], b[i]);
}
extern "C" __global__ void one_mul_ptx(const fe* a, const fe* b, fe* c) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  c[i] = fe_mul_ptx<Fq>(a[i], b[i]);
}

template <int V>
__global__ void __launch_bounds__(256) chain_mul(const fe* a, const fe* b, fe* c, int n, int iters) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fe x = a[i], y = b[i];
  for (int k = 0; k < iters; k++) x = V ? fe_mul_ptx<Fq>(x, y) : fe_mul<Fq>(x, y);
  c[i] = x;
}

// one thread: `iters` doublings, XYZZ (V=0) or Jacobian (V=1)
template <int V>
__global__ void dbl_latency(const fe* a, fe* c, int iters) {
  if (V == 0) {
    xyzz p;
    p.X = a[0]; p.Y = a[1]; p.ZZ = a[2]; p.ZZZ = a[3];
    for (int k = 0; k < iters; k++) p = xyzz_double<Fq>(p);
    c[0] = p.X; c[1] = p.Y; c[2] = p.ZZ; c[3] = p.ZZZ;
  } else {
    jac p;
    p.X = a[0]; p.Y = a[1]; p.Z = a[2];
    for (int k = 0; k < iters; k++) p = jac_double<Fq>(p);
    c[0] = p.X; c[1] = p.Y; c[2] = p.Z;
  }
}

// one thread: `iters` full XYZZ additions (p = p + q), for Horner's adds
__global__ void add_latency(const fe* a, fe* c, int iters) {
  xyzz p, q;
  p.X = a[0]; p.Y = a[1]; p.ZZ = a[2]; p.ZZZ = a[3];
  q.X = a[4]; q.Y = a[5]; q.ZZ = a[6]; q.ZZZ = a[7];
  for (int k = 0; k < iters; k++) p = xyzz_add<Fq>(p, q);
  c[0] = p.X; c[1] = p.Y; c[2] = p.ZZ; c[3] = p.ZZZ;
}

// madd throughput: every thread madds `iters` affine points (from a table
// of 1024 entries, indexed by a hash) into one register accumulator.
template <int BLK, int MINB>
__global__ void __launch_bounds__(BLK, MINB) madd_tput(const uint32_t* tab, fe* c, int iters) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  xyzz acc = xyzz_identity<Fq>();
  uint32_t h = i * 2654435761u;
  for (int k = 0; k < iters; k++) {
    h = h * 1664525u + 1013904223u;
    const uint32_t* e = tab + (h >> 22) * 16;
    fe x = fe_load_v(e), y = fe_load_v(e + 8);
    xyzz_madd<Fq>(acc, x, y);
  }
  c[i] = acc.X;
}

extern "C" int run_chain(int v, const void* a, const void* b, void* c, int n, int iters) {
  int T = 256;
  if (v) chain_mul<1><<<(n + T - 1) / T, T>>>((const fe*)a, (const fe*)b, (fe*)c, n, iters);
  else chain_mul<0><<<(n + T - 1) / T, T>>>((const fe*)a, (const fe*)b, (fe*)c, n, iters);
  return (int)cudaGetLastError();
}
extern "C" int run_one(int v, const void* a, const void* b, void* c, int n) {
  int T = 256;
  if (v) one_mul_ptx<<<n / T, T>>>((const fe*)a, (const fe*)b, (fe*)c);
  else one_mul_cpp<<<n / T, T>>>((const fe*)a, (const fe*)b, (fe*)c);
  return (int)cudaGetLastError();
}
extern "C" int run_dbl(int v, const void* a, void* c, int iters) {
  if (v == 0) dbl_latency<0><<<1, 1>>>((const fe*)a, (fe*)c, iters);
  else if (v == 1) dbl_latency<1><<<1, 1>>>((const fe*)a, (fe*)c, iters);
  else add_latency<<<1, 1>>>((const fe*)a, (fe*)c, iters);
  return (int)cudaGetLastError();
}
extern "C" int run_madd(int cfg, const void* tab, void* c, int nblocks, int iters) {
  switch (cfg) {
    case 0: madd_tput<256, 1><<<nblocks, 256>>>((const uint32_t*)tab, (fe*)c, iters); break;
    case 1: madd_tput<256, 2><<<nblocks, 256>>>((const uint32_t*)tab, (fe*)c, iters); break;
    case 2: madd_tput<256, 3><<<nblocks, 256>>>((const uint32_t*)tab, (fe*)c, iters); break;
    case 3: madd_tput<128, 5><<<nblocks, 128>>>((const uint32_t*)tab, (fe*)c, iters); break;
  }
  return (int)cudaGetLastError();
}
extern "C" int occupancy(int cfg) {
  int nb = 0;
  switch (cfg) {
    case 0: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, madd_tput<256, 1>, 256, 0); break;
    case 1: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, madd_tput<256, 2>, 256, 0); break;
    case 2: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, madd_tput<256, 3>, 256, 0); break;
    case 3: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, madd_tput<128, 5>, 128, 0); break;
  }
  return nb;
}
extern "C" int run_poseidon_inline(const void* in, void* out, int n, int len,
                                   int r_f, int r_p, const void* consts,
                                   int n_consts) {
  const uint32_t* c = (const uint32_t*)consts;
  poseidon::thread_kernel<Fr, 3><<<(n + 127) / 128, 128>>>(
      (const uint32_t*)in, (uint32_t*)out, n, len, r_f, r_p, c,
      c + (size_t)(n_consts - 1) * 8);
  return (int)cudaGetLastError();
}
