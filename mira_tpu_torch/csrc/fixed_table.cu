// Multiples table of the fixed-base MSM (msm_fixed.cu): for every base P
// the affine points 1P..NTAB*P, NTAB = 2^(W-1), as (x, y) Montgomery words
// in a (n, NTAB, 2, 8) array, so that one lookup is 64 contiguous bytes.
//
// Replaces mira_tpu/ops/pallas_msm.py `precompute_fixed_table` (an XLA
// build, `_table_step_jits`): Jacobian multiples by repeated addition, one
// batch inversion of their Z coordinates, then x = X/Z^2, y = Y/Z^3.
//
// Bound on the card: integer multiply throughput (Montgomery products); the
// table write, 64 * NTAB bytes per lane, is the only traffic that has to
// reach device memory.  One thread builds one lane, in three steps:
//
// 1. The chain.  Every base is affine (Z = 1) or the identity (Z = 0), so
//    2P is an affine doubling (6 products) and each further multiple a
//    mixed addition (P affine, 11 products): Z_{e+1} = Z_e * H_e.  The
//    thread writes each multiple's Jacobian X, Y into its output slot and
//    H_e into a scratch array laid out [e][lane] (coalesced), so it keeps
//    no per-thread array: the Z's are the prefix products of the H's, and
//    only the last one, Z_last, needs inverting.
// 2. One inversion per block (Montgomery's trick across the block): the
//    lanes' Z_last go into a product tree in shared memory, one thread
//    inverts the root, and the tree walks back down, each node's inverse
//    times its sibling's product giving its child's.  An identity lane puts
//    1 into the tree, not its Z (0), which would zero every lane of its
//    block; its entries are written (0, 0), the identity marker of
//    msm_fixed.cu.  The blocks of a wave reach their inversion together,
//    so its latency idles the card once a wave: the root is inverted by
//    the binary extended Euclidean algorithm (`inv_binary`), whose word
//    operations take a fraction of the latency of fe_inv's ~380 dependent
//    Montgomery products.
// 3. The walk back: from 1/Z_last, entry e takes x = X zi^2, y = Y zi^3 and
//    1/Z_{e-1} = zi * H_{e-1} (5 products an entry).
//
// ~238 products a lane at w=5 and ~494 at w=6, against ~656 and ~1,099 when
// every lane did full Jacobian additions and its own inversion.  A lane
// whose chain met the identity (impossible for a point of the prime-order
// group: 2y = 0 or eP = +-P) is treated as an identity lane, so that it
// cannot zero its block.
#include <cuda_runtime.h>

#include <type_traits>

#include "field.cuh"

using namespace mira;

constexpr int TAB_T = 128;  // lanes per block (ops/cuda_msm.py TABLE_BLOCK)

// 2(x, y) of an affine point (mdbl-2007-bl with Z1 = 1, a = 0): Z3 = 2y.
template <class F>
__device__ __forceinline__ jac affine_double(const fe& x, const fe& y) {
  fe A = fe_sqr<F>(x);
  fe B = fe_sqr<F>(y);
  fe C = fe_sqr<F>(B);
  fe t = fe_sqr<F>(fe_add<F>(x, B));
  fe D = fe_double<F>(fe_sub<F>(fe_sub<F>(t, A), C));
  fe E = fe_add<F>(fe_double<F>(A), A);
  jac r;
  r.X = fe_sub<F>(fe_sqr<F>(E), fe_double<F>(D));
  fe C8 = fe_double<F>(fe_double<F>(fe_double<F>(C)));
  r.Y = fe_sub<F>(fe_mul<F>(E, fe_sub<F>(D, r.X)), C8);
  r.Z = fe_double<F>(y);
  return r;
}

// acc + (x, y) affine, acc != +-(x, y) and not the identity (the chain
// never meets those): 8 products and 3 squares.  H, with Z3 = Z1 * H, is
// returned through h.
template <class F>
__device__ __forceinline__ jac jac_madd(const jac& a, const fe& x, const fe& y,
                                        fe& h) {
  fe Z1Z1 = fe_sqr<F>(a.Z);
  fe U2 = fe_mul<F>(x, Z1Z1);
  fe S2 = fe_mul<F>(y, fe_mul<F>(a.Z, Z1Z1));
  h = fe_sub<F>(U2, a.X);
  fe R = fe_sub<F>(S2, a.Y);
  fe HH = fe_sqr<F>(h);
  fe HHH = fe_mul<F>(h, HH);
  fe V = fe_mul<F>(a.X, HH);
  jac r;
  r.X = fe_sub<F>(fe_sub<F>(fe_sqr<F>(R), HHH), fe_double<F>(V));
  r.Y = fe_sub<F>(fe_mul<F>(R, fe_sub<F>(V, r.X)), fe_mul<F>(a.Y, HHH));
  r.Z = fe_mul<F>(a.Z, h);
  return r;
}

// R^3 mod p: a Montgomery product with it turns (aR)^-1, the plain inverse
// of a's word image, into a^-1 R, the image of a^-1.
template <class F>
__device__ __forceinline__ fe r_cubed() {
  const uint32_t q[8] = {0xda1530dfu, 0xb1cd6dafu, 0xa7283db6u, 0x62f210e6u,
                         0x0ada0afbu, 0xef7f0b0cu, 0x2d592544u, 0x20fd6e90u};
  const uint32_t r[8] = {0xb4bf0040u, 0x5e94d8e1u, 0x1cfbb6b8u, 0x2a489cbeu,
                         0xa19fcfedu, 0x893cc664u, 0x7fcc657cu, 0x0cf8594bu};
  fe v;
#pragma unroll
  for (int i = 0; i < 8; i++) v.v[i] = std::is_same<F, Fq>::value ? q[i] : r[i];
  return v;
}

__device__ __forceinline__ fe shr1(const fe& a) {
  fe r;
#pragma unroll
  for (int i = 0; i < 7; i++) r.v[i] = __funnelshift_r(a.v[i], a.v[i + 1], 1);
  r.v[7] = a.v[7] >> 1;
  return r;
}

// a + p (a < p < 2^254, so no carry leaves the top word)
template <class F>
__device__ __forceinline__ fe add_p(const fe& a) {
  fe r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)a.v[i] + F::p(i);
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  return r;
}

// x / 2 mod p
template <class F>
__device__ __forceinline__ fe half_mod(const fe& x) {
  return shr1((x.v[0] & 1) ? add_p<F>(x) : x);
}

__device__ __forceinline__ bool is_one_plain(const fe& a) {
  uint32_t acc = a.v[0] ^ 1u;
#pragma unroll
  for (int i = 1; i < 8; i++) acc |= a.v[i];
  return acc == 0;
}

// a >= b as 256-bit integers
__device__ __forceinline__ bool geq(const fe& a, const fe& b) {
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t d = (uint64_t)a.v[i] - b.v[i] - borrow;
    borrow = (d >> 63) & 1;
  }
  return !borrow;
}

// The inverse of a Montgomery image (0 for 0) by the binary extended
// Euclidean algorithm: u, v from (aR, p) with x1 aR = u and x2 aR = v mod p
// kept through ~540 halvings and subtractions of 8-word integers, then one
// product by R^3.
template <class F>
__device__ fe inv_binary(const fe& a) {
  if (fe_is_zero(a)) return a;
  fe u = a, v, x1 = fe_zero(), x2 = fe_zero();
#pragma unroll
  for (int i = 0; i < 8; i++) v.v[i] = F::p(i);
  x1.v[0] = 1;
  while (!is_one_plain(u) && !is_one_plain(v)) {
    while (!(u.v[0] & 1)) {
      u = shr1(u);
      x1 = half_mod<F>(x1);
    }
    while (!(v.v[0] & 1)) {
      v = shr1(v);
      x2 = half_mod<F>(x2);
    }
    if (geq(u, v)) {
      u = fe_sub<F>(u, v);  // u, v < p: a plain subtraction
      x1 = fe_sub<F>(x1, x2);
    } else {
      v = fe_sub<F>(v, u);
      x2 = fe_sub<F>(x2, x1);
    }
  }
  return fe_mul<F>(is_one_plain(u) ? x1 : x2, r_cubed<F>());
}

template <class F, int NTAB>
__global__ void __launch_bounds__(TAB_T)
    fixed_table_k(const uint32_t* X, const uint32_t* Y, const uint32_t* Z,
                  int n, uint32_t* tab, uint32_t* hs) {
  // the product tree: node k has children 2k, 2k + 1; lane t is leaf TAB_T + t
  __shared__ fe tree[2 * TAB_T];
  const int t = threadIdx.x;
  const int i = blockIdx.x * TAB_T + t;
  const bool in = i < n;
  uint32_t* row = tab + (size_t)i * NTAB * 16;
  bool live = false;
  fe x, y, zlast = fe_one<F>();
  if (in) {
    x = fe_load_v(X + 8 * (size_t)i);
    y = fe_load_v(Y + 8 * (size_t)i);
    live = !fe_is_zero(fe_load_v(Z + 8 * (size_t)i));
  }
  if (live) {
    fe_store_v(row, x);
    fe_store_v(row + 8, y);
    jac acc = affine_double<F>(x, y);
    fe_store_v(row + 16, acc.X);
    fe_store_v(row + 24, acc.Y);
#pragma unroll 1
    for (int e = 2; e < NTAB; e++) {
      fe h;
      acc = jac_madd<F>(acc, x, y, h);
      fe_store_v(hs + ((size_t)(e - 2) * n + i) * 8, h);
      fe_store_v(row + 16 * e, acc.X);
      fe_store_v(row + 16 * e + 8, acc.Y);
    }
    if (fe_is_zero(acc.Z)) live = false;
    else zlast = acc.Z;
  }
  tree[TAB_T + t] = zlast;
  __syncthreads();
#pragma unroll 1
  for (int half = TAB_T / 2; half >= 1; half >>= 1) {
    if (t < half) tree[half + t] = fe_mul<F>(tree[2 * (half + t)],
                                             tree[2 * (half + t) + 1]);
    __syncthreads();
  }
  if (t == 0) tree[1] = inv_binary<F>(tree[1]);
  __syncthreads();
#pragma unroll 1
  for (int half = 1; half < TAB_T; half <<= 1) {
    if (t < half) {
      const int k = half + t;
      fe inv = tree[k], a = tree[2 * k], b = tree[2 * k + 1];
      tree[2 * k] = fe_mul<F>(inv, b);
      tree[2 * k + 1] = fe_mul<F>(inv, a);
    }
    __syncthreads();
  }
  if (!in) return;
  if (!live) {
    const fe z = fe_zero();
#pragma unroll 1
    for (int e = 0; e < 2 * NTAB; e++) fe_store_v(row + 8 * e, z);
    return;
  }
  fe zi = tree[TAB_T + t];
#pragma unroll 1
  for (int e = NTAB - 1; e >= 1; e--) {
    fe zi2 = fe_sqr<F>(zi);
    fe xa = fe_mul<F>(fe_load_v(row + 16 * e), zi2);
    fe ya = fe_mul<F>(fe_load_v(row + 16 * e + 8), fe_mul<F>(zi2, zi));
    fe_store_v(row + 16 * e, xa);
    fe_store_v(row + 16 * e + 8, ya);
    if (e > 1) zi = fe_mul<F>(zi, fe_load_v(hs + ((size_t)(e - 2) * n + i) * 8));
  }
}

// field 0: BN254 G1 (coordinates in Fq); field 1: Grumpkin (in Fr).
// X, Y, Z: (n, 8) Montgomery words of affine points (Z = R mod p) or the
// identity (Z = 0); window 5 or 6; tab: (n, 2^(window-1), 2, 8) output;
// hs: scratch of (2^(window-1) - 2, n, 8) words.  Returns a cudaError_t
// (cudaErrorInvalidValue for another window).
extern "C" int mira_fixed_table(int field, const void* X, const void* Y,
                                const void* Z, int n, int window, void* tab,
                                void* hs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto tag, auto ntag) {
    using F = decltype(tag);
    constexpr int NTAB = decltype(ntag)::value;
    fixed_table_k<F, NTAB><<<(n + TAB_T - 1) / TAB_T, TAB_T, 0, s>>>(
        (const uint32_t*)X, (const uint32_t*)Y, (const uint32_t*)Z, n,
        (uint32_t*)tab, (uint32_t*)hs);
    return (int)cudaGetLastError();
  };
  using N16 = std::integral_constant<int, 16>;
  using N32 = std::integral_constant<int, 32>;
  if (window == 5) return field == 0 ? run(Fq{}, N16{}) : run(Fr{}, N16{});
  if (window == 6) return field == 0 ? run(Fq{}, N32{}) : run(Fr{}, N32{});
  return (int)cudaErrorInvalidValue;
}
