// Batched Poseidon sponge: N independent fixed-length hashes, bit-exact with
// the host sponge of ops/poseidon.py (the optimized-constant schedule of the
// reference, src/poseidon/poseidon_hash.rs:174-254).
//
// Replaces mira_tpu/ops/pallas_poseidon.py `_poseidon_pallas_jit` (body
// `_sponge`).  The TPU kernel rides N states on the vector lanes and keeps
// the t state elements concatenated along them so that one CIOS instance
// serves a whole round; here one thread owns one hash, its t-element state
// lives in registers (t is a template parameter, 2..5), and the rounds are
// plain loops.  The constants sit in one device tensor, read through the
// read-only path (every thread of a warp reads the same address):
//
//   start   (r_f/2 + 1, t)   pre-round constants and the first full rounds
//   partial (r_p)            one constant per partial round
//   end     (r_f/2 - 1, t)   the last full rounds but one
//   mds     (t, t)
//   pre     (t, t)           pre-sparse MDS, after the first half
//   rows    (r_p, t)         sparse matrices' first rows
//   cols    (r_p, t - 1)     sparse matrices' first columns
//   iv      (1)              2^64, the capacity element's start value
//
// The Montgomery product is kept out of line: the sponge has some 2 t^2
// call sites, and inlining 272 multiply-adds into each would cost minutes of
// ptxas time for nothing.
//
// Bound on the card: a 2-to-1 hash (t = 3, r_f = r_p = 10, two permutations)
// reads 64 B and writes 32 B and does 520 Montgomery products, so the
// kernel is bound by integer multiplies by three orders of magnitude.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace mira;

// by value: a reference would force both operands through local memory
template <class F>
__device__ __noinline__ fe mul_call(fe a, fe b) {
  return fe_mul<F>(a, b);
}

template <class F>
__device__ __forceinline__ fe pow5(const fe& x) {
  fe s = mul_call<F>(x, x);
  return mul_call<F>(mul_call<F>(s, s), x);
}

// state <- m * state for a dense (T, T) matrix at `m`
template <class F, int T>
__device__ __forceinline__ void mat_vec(fe (&st)[T], const uint32_t* m) {
  fe out[T];
#pragma unroll
  for (int i = 0; i < T; i++) {
    fe acc = mul_call<F>(st[0], fe_load_ro(m + (size_t)(i * T) * 8));
#pragma unroll
    for (int j = 1; j < T; j++)
      acc = fe_add<F>(acc, mul_call<F>(st[j],
                                       fe_load_ro(m + (size_t)(i * T + j) * 8)));
    out[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < T; i++) st[i] = out[i];
}

// state <- pow5(state) + consts
template <class F, int T>
__device__ __forceinline__ void sbox_full(fe (&st)[T], const uint32_t* consts) {
#pragma unroll
  for (int i = 0; i < T; i++) {
    fe x = pow5<F>(st[i]);
    st[i] = consts == nullptr ? x
                              : fe_add<F>(x, fe_load_ro(consts + (size_t)i * 8));
  }
}

template <class F, int T>
__device__ void permutation(fe (&st)[T], const uint32_t* in, int k, int r_f,
                            int r_p, const uint32_t* c) {
  const int half = r_f / 2;
  const uint32_t* c_start = c;
  const uint32_t* c_partial = c_start + (size_t)(half + 1) * T * 8;
  const uint32_t* c_end = c_partial + (size_t)r_p * 8;
  const uint32_t* mds = c_end + (size_t)(half - 1) * T * 8;
  const uint32_t* pre = mds + (size_t)T * T * 8;
  const uint32_t* rows = pre + (size_t)T * T * 8;
  const uint32_t* cols = rows + (size_t)r_p * T * 8;

  // pre-round: first start constants, the chunk at slots 1..k, and the `1`
  // pad marker in the first unused slot
#pragma unroll
  for (int i = 0; i < T; i++) {
    st[i] = fe_add<F>(st[i], fe_load_ro(c_start + (size_t)i * 8));
    if (i >= 1 && i <= k)
      st[i] = fe_add<F>(st[i], fe_load_v(in + (size_t)(i - 1) * 8));
    if (i == k + 1) st[i] = fe_add<F>(st[i], fe_one<F>());
  }
  for (int r = 1; r < half; r++) {
    sbox_full<F, T>(st, c_start + (size_t)r * T * 8);
    mat_vec<F, T>(st, mds);
  }
  sbox_full<F, T>(st, c_start + (size_t)half * T * 8);
  mat_vec<F, T>(st, pre);
  for (int r = 0; r < r_p; r++) {
    st[0] = fe_add<F>(pow5<F>(st[0]), fe_load_ro(c_partial + (size_t)r * 8));
    const uint32_t* row = rows + (size_t)r * T * 8;
    const uint32_t* col = cols + (size_t)r * (T - 1) * 8;
    fe new0 = mul_call<F>(st[0], fe_load_ro(row));
#pragma unroll
    for (int j = 1; j < T; j++) {
      new0 = fe_add<F>(new0, mul_call<F>(st[j], fe_load_ro(row + (size_t)j * 8)));
      st[j] = fe_add<F>(
          st[j], mul_call<F>(st[0], fe_load_ro(col + (size_t)(j - 1) * 8)));
    }
    st[0] = new0;
  }
  for (int r = 0; r < half - 1; r++) {
    sbox_full<F, T>(st, c_end + (size_t)r * T * 8);
    mat_vec<F, T>(st, mds);
  }
  sbox_full<F, T>(st, nullptr);
  mat_vec<F, T>(st, mds);
}

template <class F, int T>
__global__ void poseidon_kernel(const uint32_t* in, uint32_t* out, int n, int len,
                                int r_f, int r_p, const uint32_t* c,
                                const uint32_t* iv) {
  int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= n) return;
  const int rate = T - 1;
  fe st[T];
  st[0] = fe_load_ro(iv);
#pragma unroll
  for (int i = 1; i < T; i++) st[i] = fe_zero();
  const uint32_t* mine = in + (size_t)h * len * 8;
  for (int i = 0; i < len; i += rate) {
    int k = len - i < rate ? len - i : rate;
    permutation<F, T>(st, mine + (size_t)i * 8, k, r_f, r_p, c);
  }
  if (len % rate == 0) permutation<F, T>(st, mine, 0, r_f, r_p, c);
  fe_store_v(out + (size_t)h * 8, st[1]);
}

template <class F, int T>
static int launch_poseidon(const void* in, void* out, int n, int len, int r_f,
                           int r_p, const void* consts, size_t iv_at,
                           cudaStream_t s) {
  const int B = 128;
  const uint32_t* c = (const uint32_t*)consts;
  poseidon_kernel<F, T><<<(n + B - 1) / B, B, 0, s>>>(
      (const uint32_t*)in, (uint32_t*)out, n, len, r_f, r_p, c, c + iv_at * 8);
  return (int)cudaGetLastError();
}

template <class F>
static int dispatch_t(int t, const void* in, void* out, int n, int len, int r_f,
                      int r_p, const void* consts, size_t iv_at,
                      cudaStream_t s) {
  switch (t) {
    case 2: return launch_poseidon<F, 2>(in, out, n, len, r_f, r_p, consts, iv_at, s);
    case 3: return launch_poseidon<F, 3>(in, out, n, len, r_f, r_p, consts, iv_at, s);
    case 4: return launch_poseidon<F, 4>(in, out, n, len, r_f, r_p, consts, iv_at, s);
    case 5: return launch_poseidon<F, 5>(in, out, n, len, r_f, r_p, consts, iv_at, s);
    default: return 1;
  }
}

// field 0: Fq, 1: Fr.  in: (n, len, 8) Montgomery words; out: (n, 8), each
// hash's state[1], untruncated; consts: the table described above, whose
// last element (index n_consts - 1) is the IV.  t in 2..5, r_f even and >= 2.
extern "C" int mira_poseidon(int field, const void* in, void* out, int n,
                             int len, int t, int r_f, int r_p,
                             const void* consts, int n_consts, void* stream) {
  if (n <= 0) return 0;
  if (len < 0 || r_f < 2 || (r_f & 1) || r_p < 0) return 1;
  const int half = r_f / 2;
  const int expect = (half + 1) * t + r_p + (half - 1) * t + 2 * t * t +
                     r_p * t + r_p * (t - 1) + 1;
  if (n_consts != expect) return 1;
  cudaStream_t s = (cudaStream_t)stream;
  size_t iv_at = (size_t)n_consts - 1;
  if (field == 0)
    return dispatch_t<Fq>(t, in, out, n, len, r_f, r_p, consts, iv_at, s);
  return dispatch_t<Fr>(t, in, out, n, len, r_f, r_p, consts, iv_at, s);
}
