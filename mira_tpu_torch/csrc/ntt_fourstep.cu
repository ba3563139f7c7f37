// Four-step NTT as a chain of column passes: a size-n transform, n = n1 * n2,
// as the size-n2 transforms of the columns of an (n2, n1) view of the input,
// each times a mid twiddle, then the size-n1 transforms of the rows of the
// (n2, n1) result.  From 2^21 the size-n2 step is itself cut in two (n2 = Nv
// * Nu), so that a transform is two or three passes; ops/cuda_ntt.py
// `fourstep_passes` chooses the cut and the radix and sets every pass's
// strides, and the kernel below runs one pass.
//
// Replaces mira_tpu/ops/ntt.py `_fourstep_kernels` (`run1`, `run2`, driven by
// `_ntt_fourstep_jit`).  With i = i1 + n1*i2 and k = k1*n2 + k2,
//
//   X[k1*n2 + k2] = sum_i1 (w^n2)^(i1 k1) * w^(i1 k2)
//                          * sum_i2 (w^n1)^(i2 k2) * a[i1 + n1*i2]
//
// One pass: a block owns a tile of C adjacent columns of m = 2^lm elements
// (C * 32 contiguous bytes per row where the columns are adjacent in memory,
// the TPU kernel's tiles of adjacent columns), and each thread holds E = 2^R
// elements of one column in registers.  The column runs its lm radix-2
// decimation-in-frequency stages R at a time: the first group takes the top
// lm - R(np - 1) stages on the top R bits of the position, the later groups R
// stages each on the next R bits down, and the threads exchange their
// elements through shared memory once between groups (two barriers), never
// within one.  DIF takes the input in natural order and leaves output
// position p holding frequency rev(p), so no load permutes: the store writes
// frequency rev(p) to its row, which moves the same C-element rows as a
// natural store would.  Both halves of the four-step run DIF (the TPU kernel
// runs DIT in its second half behind an XLA double bit reversal; here the
// reversal costs nothing at the store).  In the last group the thread's
// positions are its own E consecutive ones, so its twiddles are E-th roots
// of unity known at compile time and the butterflies with twiddle 1 do no
// product.
//
// The mid twiddle of a twiddled pass is w^e, e = (lo & lo_mask) *
// (k * kmul + hi * hmul) for column (hi, lo) and output frequency k.  Where
// e takes n values (the last twiddled pass), it is the product of two
// entries of tables of sqrt(n) powers (pw_lo[e mod 2^log_lo] * pw_hi[e >>
// log_lo]): two products an element.  Where e is a multiple of 2^log_lo
// with n / 2^log_lo values (the first of three passes, w_n2^(u kv)), it is
// one entry of the powers of w^(2^log_lo): one product.  A thread's twiddles
// are independent of each other, so no chain of products lengthens a small
// transform, and the inverse's 1/n is folded into the first pass's table.
// The transpose between passes, which the TPU version leaves to XLA, is
// folded into the strides.
//
// A batch of transforms of one size (the row transforms of the distributed
// NTT, parallel/ntt.py) is one launch per pass: the batch index is the grid's
// second dimension and transform b works at offset b * n.
//
// Shared memory holds a tile as two planes of 16-byte halves of elements,
// indexed by column * m + position with its low three bits XORed with a fold
// of the higher ones, so that the strides of both thread mappings (adjacent
// columns, adjacent positions) keep a quarter-warp's 16-byte accesses on
// distinct banks.  A tile takes C * m * 32 bytes, at most 32 KiB (256
// threads of 4 elements), within the default dynamic-size limit.  The first
// group loads from global memory straight into registers and the last
// stores from them, so no tile is staged through shared memory on its way
// in or out, and neither cp.async nor a TMA copy has a load to take over.
//
// Bound on the card (chip_smoke.py's count): the transform reads its input
// and writes its output once (1 GiB at 2^24) and needs n/2 * log n
// Montgomery products (2.0e8 at 2^24: 3.27 ms at 272 int32 multiply-adds
// each, against 0.32 ms of bytes), so integer multiplies bound it, and in
// practice the latency of each thread's chain of dependent products.  What
// the design does about it: registers hold only E = 2 (below 2^18) or 4
// elements, so that a thread's products keep the registers they need and
// an SM keeps 24 to 32 warps (E = 8, at 128 registers and 16 warps, was the
// slowest); a small transform's thread does few dependent products; a large
// one's mid twiddles cost two products an element in the last twiddled pass
// and one in the first of three, against the butterflies with twiddle 1
// that the last groups skip.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace mira;

namespace {

// Pass parameters, in the order of ops/cuda_ntt.py `PASS_FIELDS`.
struct PassArgs {
  long long lm, R, C, log_w, sh_in, sl_in, sp_in, sh_out, sl_out, sp_out,
      twiddle, lo_mask, kmul, hmul, log_n, log_lo, bstride, ncols, load_cfast,
      store_cfast;
};
constexpr int NPARAMS = 20;
constexpr int MAX_THREADS = 256;

__device__ __forceinline__ int rev_bits(unsigned x, int bits) {
  return bits == 0 ? 0 : (int)(__brev(x) >> (32 - bits));
}

// the tile's shared-memory slot of element `idx` (= column * m + position)
__device__ __forceinline__ int swz(int idx) {
  int x = idx >> 3;
  int f = (x ^ (x >> 3) ^ (x >> 6) ^ (x >> 9)) & 7;
  return idx ^ f;
}

// the thread's column in the tile and its index within the column
__device__ __forceinline__ void thread_map(bool cfast, int C, int tc, int& c,
                                           int& tid) {
  const int t = threadIdx.x;
  if (cfast) {
    c = t & (C - 1);
    tid = t / C;
  } else {
    tid = t & (tc - 1);
    c = t / tc;
  }
}

// position of the thread's element q in a group on bits [lo, lo + R)
template <int R>
__device__ __forceinline__ int position(int tid, int lo, int q) {
  return (tid & ((1 << lo) - 1)) | ((tid >> lo) << (lo + R)) | (q << lo);
}

// stages [0, kstop) of a group on bits [lo, lo + R): butterfly (u, v) ->
// (u + v, (u - v) * w_m^j), twiddles from `tw` (w_m^0 .. w_m^(m/2 - 1))
template <class F, int R>
__device__ __forceinline__ void dif_group(fe (&x)[1 << R], int lm, int lo,
                                          int kstop, int tid,
                                          const uint32_t* tw) {
  constexpr int E = 1 << R;
  const int base = position<R>(tid, lo, 0);
#pragma unroll
  for (int k = 0; k < R; k++) {
    if (k >= kstop) break;
    const int hb = 1 << (R - 1 - k);  // pair distance in q
    const int b = lo + R - 1 - k;      // pair bit of the position
    const int s = lm - 1 - b;          // global stage index
    const int hmask = (1 << b) - 1;
#pragma unroll
    for (int q = 0; q < E; q++) {
      if (q & hb) continue;
      const int j = ((base & hmask) | ((q & (hb - 1)) << lo)) << s;
      fe u = x[q], v = x[q | hb];
      x[q] = fe_add<F>(u, v);
      x[q | hb] = fe_mul<F>(fe_sub<F>(u, v), fe_load_ro(tw + (size_t)j * 8));
    }
  }
}

// the last group, on bits [0, R): the twiddle index depends on q alone, so
// the butterflies with twiddle 1 are known here and do no product
template <class F, int R>
__device__ __forceinline__ void dif_last(fe (&x)[1 << R], int lm,
                                         const uint32_t* tw) {
  constexpr int E = 1 << R;
#pragma unroll
  for (int k = 0; k < R; k++) {
    const int hb = 1 << (R - 1 - k);
    const int s = lm - R + k;  // = lm - 1 - (R - 1 - k)
#pragma unroll
    for (int q = 0; q < E; q++) {
      if (q & hb) continue;
      fe u = x[q], v = x[q | hb];
      x[q] = fe_add<F>(u, v);
      fe d = fe_sub<F>(u, v);
      const int jj = q & (hb - 1);
      x[q | hb] = jj == 0 ? d : fe_mul<F>(d, fe_load_ro(tw + (size_t)(jj << s) * 8));
    }
  }
}

// w^e for e < n: pw_lo[e mod 2^log_lo] * pw_hi[e >> log_lo]
template <class F>
__device__ __forceinline__ fe pow_w(long long e, int log_lo,
                                    const uint32_t* pw_lo,
                                    const uint32_t* pw_hi) {
  const long long lo = e & ((1ll << log_lo) - 1), hi = e >> log_lo;
  return fe_mul<F>(fe_load_ro(pw_lo + lo * 8), fe_load_ro(pw_hi + hi * 8));
}

// A tile has at most 256 threads, and an SM holds three tiles (at most 85
// registers a thread): bench/ntt_micro.py times two and four against it.
template <class F, int R>
__global__ void __launch_bounds__(MAX_THREADS, 3) ntt_pass_kernel(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ out, PassArgs a,
    const uint32_t* tw, const uint32_t* pw_lo, const uint32_t* pw_hi) {
  constexpr int E = 1 << R;
  extern __shared__ uint4 sm[];
  const int lm = (int)a.lm, m = 1 << lm, tc = m >> R, C = (int)a.C;
  const int np = (lm - 1) / R + 1;     // groups of stages
  const int r0 = lm - R * (np - 1);    // stages of the first group
  const size_t boff = (size_t)blockIdx.y * (size_t)a.bstride * 8;
  in += boff;
  out += boff;
  const long long col0 = (long long)blockIdx.x * C;

  fe x[E];
  int c, tid;
  // first group: bits [lm - R, lm), the thread's elements tid + q m/E
  thread_map(np == 1 ? a.store_cfast : a.load_cfast, C, tc, c, tid);
  {
    const long long col = col0 + c;
    const long long hi = col >> a.log_w, lo = col & ((1ll << a.log_w) - 1);
    const uint32_t* src = in + (size_t)(hi * a.sh_in + lo * a.sl_in) * 8;
#pragma unroll
    for (int q = 0; q < E; q++)
      x[q] = fe_load_v(src + (size_t)((long long)position<R>(tid, lm - R, q) *
                                      a.sp_in) * 8);
  }
  uint4* plane0 = sm;
  uint4* plane1 = sm + C * m;
  int lo = lm - R;
  for (int g = 0; g < np - 1; g++) {
    dif_group<F, R>(x, lm, lo, g == 0 ? r0 : R, tid, tw);
    // exchange: to the next group's bits and the store's thread mapping
#pragma unroll
    for (int q = 0; q < E; q++) {
      const int i = swz(c * m + position<R>(tid, lo, q));
      plane0[i] = make_uint4(x[q].v[0], x[q].v[1], x[q].v[2], x[q].v[3]);
      plane1[i] = make_uint4(x[q].v[4], x[q].v[5], x[q].v[6], x[q].v[7]);
    }
    __syncthreads();
    lo = g == 0 ? lm - r0 - R : lo - R;
    thread_map(a.store_cfast, C, tc, c, tid);
#pragma unroll
    for (int q = 0; q < E; q++) {
      const int i = swz(c * m + position<R>(tid, lo, q));
      const uint4 h0 = plane0[i], h1 = plane1[i];
      x[q].v[0] = h0.x; x[q].v[1] = h0.y; x[q].v[2] = h0.z; x[q].v[3] = h0.w;
      x[q].v[4] = h1.x; x[q].v[5] = h1.y; x[q].v[6] = h1.z; x[q].v[7] = h1.w;
    }
    __syncthreads();
  }
  // last group: bits [0, R), the thread's positions tid * E + q
  dif_last<F, R>(x, lm, tw);
  const long long col = col0 + c;
  const long long hi = col >> a.log_w, clo = col & ((1ll << a.log_w) - 1);
  if (a.twiddle) {
    // twiddle 1: w^e as the product of two table entries; twiddle 2 (e a
    // multiple of 2^log_lo): one entry of the powers of w^(2^log_lo).  A
    // thread's twiddles are independent of each other.
    const long long n = 1ll << a.log_n, cm = clo & a.lo_mask;
#pragma unroll
    for (int q = 0; q < E; q++) {
      const long long k = rev_bits((unsigned)(tid * E + q), lm);
      const long long e = (cm * (k * a.kmul + hi * a.hmul)) & (n - 1);
      x[q] = fe_mul<F>(x[q], a.twiddle == 2
                                 ? fe_load_ro(pw_lo + (e >> a.log_lo) * 8)
                                 : pow_w<F>(e, (int)a.log_lo, pw_lo, pw_hi));
    }
  }
  uint32_t* dst = out + (size_t)(hi * a.sh_out + clo * a.sl_out) * 8;
#pragma unroll
  for (int q = 0; q < E; q++) {
    const long long k = rev_bits((unsigned)(tid * E + q), lm);
    fe_store_v(dst + (size_t)(k * a.sp_out) * 8, x[q]);
  }
}

template <class F, int R>
int launch_pass(const uint32_t* in, uint32_t* out, const PassArgs& a,
                const uint32_t* tw, const uint32_t* pw_lo,
                const uint32_t* pw_hi, int batch, cudaStream_t s) {
  const int m = 1 << a.lm;
  const int threads = (int)a.C * (m >> R);
  const size_t smem = a.lm > R ? (size_t)a.C * m * 32 : 0;
  ntt_pass_kernel<F, R><<<dim3((unsigned)(a.ncols / a.C), batch), threads, smem,
                          s>>>(in, out, a, tw, pw_lo, pw_hi);
  return (int)cudaGetLastError();
}

}  // namespace

// One pass of a four-step transform over BN254 Fr (field 1; Fq, whose
// 2-adicity is 1, has no transform of four or more points).  in, out: (batch,
// n, 8) Montgomery words, different buffers, batch in 1..65535; params: the
// NPARAMS int64 values of PassArgs; tw: (max(m/2, 1), 8) powers of the column
// root; pw_lo, pw_hi: the mid twiddle's tables (twiddle 1: powers of w and
// of w^(2^log_lo); twiddle 2: powers of w^(2^log_lo) in pw_lo; read only
// when params say twiddle; the inverse's 1/n rides in the first pass's).
extern "C" int mira_ntt_pass(int field, const void* in, void* out,
                             const long long* params, const void* tw,
                             const void* pw_lo, const void* pw_hi, int batch,
                             void* stream) {
  PassArgs a;
  long long* f = &a.lm;
  for (int i = 0; i < NPARAMS; i++) f[i] = params[i];
  const long long m = 1ll << a.lm, R = a.R;
  if (field != 1 || batch < 1 || batch > 65535 || a.lm < 1 || a.lm > 10 ||
      R < 1 || R > 2 || R > a.lm || a.C < 1 || (a.C & (a.C - 1)) ||
      a.C * (m >> R) > MAX_THREADS || a.ncols % a.C || a.log_n > 28)
    return 1;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t *i = (const uint32_t*)in, *t = (const uint32_t*)tw,
                 *lo = (const uint32_t*)pw_lo, *hi = (const uint32_t*)pw_hi;
  uint32_t* o = (uint32_t*)out;
  return R == 1 ? launch_pass<Fr, 1>(i, o, a, t, lo, hi, batch, s)
                : launch_pass<Fr, 2>(i, o, a, t, lo, hi, batch, s);
}
