// The batched Poseidon sponge's two routes, as device code that
// csrc/poseidon.cu launches (and bench/msm_micro.cu instantiates with the
// product inlined, to time that against the call).  See poseidon.cu.
#pragma once
#include "field.cuh"

// The thread route's Montgomery product is kept out of line: the sponge has
// some 2 t^2 call sites, and inlining 272 multiply-adds into each costs
// minutes of ptxas time.  bench/msm_micro.cu defines this as
// __forceinline__ for one instantiation.
#ifndef POSEIDON_MUL_ATTR
#define POSEIDON_MUL_ATTR __noinline__
#endif

namespace mira {
namespace poseidon {

// by value: a reference would force both operands through local memory
template <class F>
__device__ POSEIDON_MUL_ATTR fe mul_call(fe a, fe b) {
  return fe_mul<F>(a, b);
}

template <class F>
__device__ __forceinline__ fe pow5(const fe& x) {
  fe s = mul_call<F>(x, x);
  return mul_call<F>(mul_call<F>(s, s), x);
}

// Where the spec's constants sit in the table (ops/cuda_poseidon.py
// `_constants`): start (r_f/2 + 1, T), partial (r_p), end (r_f/2 - 1, T), mds
// (T, T), pre (T, T), rows (r_p, T), cols (r_p, T - 1), then the IV.
template <int T>
struct Table {
  const uint32_t *start, *partial, *end, *mds, *pre, *rows, *cols;
  __device__ Table(const uint32_t* c, int r_f, int r_p) {
    const int half = r_f / 2;
    start = c;
    partial = start + (size_t)(half + 1) * T * 8;
    end = partial + (size_t)r_p * 8;
    mds = end + (size_t)(half - 1) * T * 8;
    pre = mds + (size_t)T * T * 8;
    rows = pre + (size_t)T * T * 8;
    cols = rows + (size_t)r_p * T * 8;
  }
};

// ---------------------------------------------------------------------------
// thread route: one thread owns a hash, its T-element state in registers

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
  const Table<T> tb(c, r_f, r_p);
  // pre-round: first start constants, the chunk at slots 1..k, and the `1`
  // pad marker in the first unused slot
#pragma unroll
  for (int i = 0; i < T; i++) {
    st[i] = fe_add<F>(st[i], fe_load_ro(tb.start + (size_t)i * 8));
    if (i >= 1 && i <= k)
      st[i] = fe_add<F>(st[i], fe_load_v(in + (size_t)(i - 1) * 8));
    if (i == k + 1) st[i] = fe_add<F>(st[i], fe_one<F>());
  }
  for (int r = 1; r < half; r++) {
    sbox_full<F, T>(st, tb.start + (size_t)r * T * 8);
    mat_vec<F, T>(st, tb.mds);
  }
  sbox_full<F, T>(st, tb.start + (size_t)half * T * 8);
  mat_vec<F, T>(st, tb.pre);
  for (int r = 0; r < r_p; r++) {
    st[0] = fe_add<F>(pow5<F>(st[0]), fe_load_ro(tb.partial + (size_t)r * 8));
    const uint32_t* row = tb.rows + (size_t)r * T * 8;
    const uint32_t* col = tb.cols + (size_t)r * (T - 1) * 8;
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
    sbox_full<F, T>(st, tb.end + (size_t)r * T * 8);
    mat_vec<F, T>(st, tb.mds);
  }
  sbox_full<F, T>(st, nullptr);
  mat_vec<F, T>(st, tb.mds);
}

template <class F, int T>
__global__ void thread_kernel(const uint32_t* in, uint32_t* out, int n, int len,
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

// ---------------------------------------------------------------------------
// lane route: a hash on L = 2^ceil(log2 T) lanes of one warp, lane i holding
// state element i (lanes T..L-1 hold zero and idle through the arithmetic).
// The products are inlined: a permutation has few call sites here, and a
// row's T products are independent, so they overlap.

template <int L>
__device__ __forceinline__ fe shfl(const fe& a, int src) {
  fe r;
#pragma unroll
  for (int w = 0; w < 8; w++) r.v[w] = __shfl_sync(0xffffffffu, a.v[w], src, L);
  return r;
}

template <int L>
__device__ __forceinline__ fe shfl_xor(const fe& a, int mask) {
  fe r;
#pragma unroll
  for (int w = 0; w < 8; w++)
    r.v[w] = __shfl_xor_sync(0xffffffffu, a.v[w], mask, L);
  return r;
}

template <class F>
__device__ __forceinline__ fe pow5_inline(const fe& x) {
  fe s = fe_mul<F>(x, x);
  return fe_mul<F>(fe_mul<F>(s, s), x);
}

// a full round: every lane's S-box (plus its constant), then lane i's row of
// the (T, T) matrix `m` against the T S-boxed elements
template <class F, int T, int L>
__device__ __forceinline__ fe full_round(const fe& st, int lane,
                                         const uint32_t* consts,
                                         const uint32_t* m) {
  const int li = lane < T ? lane : 0;
  fe x = pow5_inline<F>(st);
  if (consts != nullptr) x = fe_add<F>(x, fe_load_ro(consts + (size_t)li * 8));
  fe xs[T];
#pragma unroll
  for (int j = 0; j < T; j++) xs[j] = shfl<L>(x, j);
  fe acc = fe_mul<F>(xs[0], fe_load_ro(m + (size_t)(li * T) * 8));
#pragma unroll
  for (int j = 1; j < T; j++)
    acc = fe_add<F>(acc, fe_mul<F>(xs[j], fe_load_ro(m + (size_t)(li * T + j) * 8)));
  return lane < T ? acc : fe_zero();
}

// out of line (by value), so that its inlined products are compiled once
template <class F, int T, int L>
__device__ __noinline__ fe permutation_lanes(fe st, int lane, const uint32_t* in,
                                             int k, int r_f, int r_p,
                                             const uint32_t* c) {
  const int half = r_f / 2;
  const Table<T> tb(c, r_f, r_p);
  const int li = lane < T ? lane : 0;
  if (lane < T) st = fe_add<F>(st, fe_load_ro(tb.start + (size_t)lane * 8));
  if (lane >= 1 && lane <= k)
    st = fe_add<F>(st, fe_load_v(in + (size_t)(lane - 1) * 8));
  if (lane == k + 1 && lane < T) st = fe_add<F>(st, fe_one<F>());
  for (int r = 1; r < half; r++)
    st = full_round<F, T, L>(st, lane, tb.start + (size_t)r * T * 8, tb.mds);
  st = full_round<F, T, L>(st, lane, tb.start + (size_t)half * T * 8, tb.pre);
  for (int r = 0; r < r_p; r++) {
    // lane 0's S-box, broadcast; lane j's share of the sparse row, summed
    // over the lanes; lane j >= 1 adds its column entry times the S-box
    fe s0 = fe_add<F>(pow5_inline<F>(st), fe_load_ro(tb.partial + (size_t)r * 8));
    s0 = shfl<L>(s0, 0);
    const uint32_t* row = tb.rows + (size_t)r * T * 8;
    const uint32_t* col = tb.cols + (size_t)r * (T - 1) * 8;
    fe term = fe_mul<F>(lane == 0 ? s0 : st, fe_load_ro(row + (size_t)li * 8));
    const fe upd =
        fe_mul<F>(s0, fe_load_ro(col + (size_t)(li >= 1 ? li - 1 : 0) * 8));
    if (lane >= T) term = fe_zero();
#pragma unroll
    for (int off = L / 2; off >= 1; off /= 2)
      term = fe_add<F>(term, shfl_xor<L>(term, off));
    if (lane == 0)
      st = term;
    else if (lane < T)
      st = fe_add<F>(st, upd);
  }
  for (int r = 0; r < half - 1; r++)
    st = full_round<F, T, L>(st, lane, tb.end + (size_t)r * T * 8, tb.mds);
  return full_round<F, T, L>(st, lane, nullptr, tb.mds);
}

// Every thread runs to the end (the shuffles take the whole warp): threads
// past the last hash recompute it and store nothing.
template <class F, int T, int L>
__global__ void lanes_kernel(const uint32_t* in, uint32_t* out, int n, int len,
                             int r_f, int r_p, const uint32_t* c,
                             const uint32_t* iv) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = (int)(g % L);
  const long long h = g / L;
  const long long hh = h < n ? h : n - 1;
  const int rate = T - 1;
  fe st = lane == 0 ? fe_load_ro(iv) : fe_zero();
  const uint32_t* mine = in + (size_t)hh * len * 8;
  for (int i = 0; i < len; i += rate) {
    int k = len - i < rate ? len - i : rate;
    st = permutation_lanes<F, T, L>(st, lane, mine + (size_t)i * 8, k, r_f,
                                    r_p, c);
  }
  if (len % rate == 0)
    st = permutation_lanes<F, T, L>(st, lane, mine, 0, r_f, r_p, c);
  if (h < n && lane == 1) fe_store_v(out + (size_t)h * 8, st);
}

}  // namespace poseidon
}  // namespace mira
