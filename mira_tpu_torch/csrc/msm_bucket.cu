// Generic-base bucket MSM (Pippenger): sum_i s_i * P_i over BN254 G1 or
// Grumpkin, bases affine or the identity.
//
// Replaces mira_tpu/ops/pallas_msm.py `_msm_pallas_bucket_jit` (acc_kernel,
// fin_kernel) behind msm_pallas(method="bucket").  Same function: signed
// digits with carries, per-(window, magnitude) buckets fed by mixed
// additions, sum_v v*B_v per window and Horner across windows.  The TPU
// kernel's shape came from VMEM: 5-bit windows (52 passes over the points,
// 16 buckets each) revisited in its output buffer, and an offset point so
// that Mosaic's predicated madd never meets the doubling case.  On the card
// a window of c bits (ops/msm.py `bucket_window`: c = 12 at 2^17, 15 at
// 2^21) needs 23 passes instead of 52, and the buckets are formed by
// sorting, not by a table per thread:
//   sort        recode (one thread per point, int16 digits, identity bases
//               get zero digits); a histogram of the nonzero digits by
//               (window, |digit|) in shared memory, added to global counts;
//               an exclusive scan of the counts (one block); a scatter of
//               8-byte records (bucket id, point index << 1 | sign) through
//               per-block cursors reserved by one global atomic per bucket;
//   accumulate  the sorted records cut into equal segments of ~SEG records
//               (whole waves of the card),
//               one thread per segment with one XYZZ accumulator in
//               registers, gathering affine bases by index; at a bucket
//               boundary it flushes: a run that began in an earlier segment
//               to the segment's head slot, any other run to its bucket.
//               Equal segments keep the work independent of skew: with all
//               scalars equal one bucket of each window holds all N points;
//   reduce      levels of `bucket_merge`, each summing runs of 2 (then 8)
//               heads and adding a run's sum into its bucket, until one
//               segment is left; then `bucket_bits`: per window w and bit k
//               of the magnitude, 2^k C_{w,k} with C_{w,k} the sum of the
//               buckets whose magnitude has bit k set, by block trees, and
//               window_reduce: S_w = sum_v v*B_v = sum_k 2^k C_{w,k};
//   finish      finish_terms: sum_w 2^(c*w) S_w, a Jacobian doubling chain
//               per window side by side and a block tree (msm_common.cuh).
// Every point operation is the complete one (field.cuh): duplicate and
// opposite bases, zero scalars, identity lanes and r - 1 are exact.
//
// Precondition: scalars are canonical (< the group order, < 2^254), bases
// affine or the identity (Z in {0, R mod p}), n * nwin < 2^31.
//
// Bound on the card: nwin * N mixed additions (10 products each) and at
// least 2 * 2^(c-1) full additions per window in the bucket sums (this
// design does (c - 1) / 2 per bucket, to keep every chain short), bound by
// the integer multiply rate; the scatter moves 8 bytes per (point, window)
// and the gathers 64.  What is left of the tail is the latency of one
// thread's c * (nwin - 1) Jacobian doublings (~5.6 us each on the H100).
// A design with the TPU kernel's shape, 16 XYZZ buckets per thread in local
// memory (109 MB over its threads, twice the L2), does 68M products at 2^17
// where this one does ~34M.
#include <cuda_runtime.h>

#include <algorithm>

#include "field.cuh"
#include "msm_common.cuh"

using namespace mira;

constexpr int SORT_T = 1024;  // threads of a histogram / scatter block
constexpr int SEG = 32;  // records per accumulate thread, about: mira_msm_bucket_seg
constexpr int ACC_T = 128;  // with room for 5 blocks an SM, as fixed_acc
constexpr int MERGE_FIRST = 2;  // heads per merge thread, first level
constexpr int MERGE_SEG = 8;  // heads per merge thread, later levels

// Block (g, w) counts the nonzero digits of window w over points
// [g * per, (g + 1) * per) by magnitude in shared memory (nb counters).
// Scatter off: the counts are added to counts[w * nb + |d| - 1].  Scatter
// on: each nonzero count reserves its range at cursor[w * nb + |d| - 1] with
// one atomic, and every point writes its record into its bucket's range.
template <bool SCATTER>
__global__ void __launch_bounds__(SORT_T)
    bucket_sort(const int16_t* digits, int n, int per, int nb,
                uint32_t* counts, uint2* records) {
  extern __shared__ uint32_t h[];
  int g = blockIdx.x, w = blockIdx.y;
  for (int b = threadIdx.x; b < nb; b += SORT_T) h[b] = 0;
  __syncthreads();
  int i0 = g * per, i1 = min(n, i0 + per);
  const int16_t* dw = digits + (size_t)w * n;
  for (int i = i0 + threadIdx.x; i < i1; i += SORT_T) {
    int d = dw[i];
    if (d) atomicAdd(&h[(d < 0 ? -d : d) - 1], 1u);
  }
  __syncthreads();
  uint32_t* gc = counts + (size_t)w * nb;
  for (int b = threadIdx.x; b < nb; b += SORT_T) {
    uint32_t c = h[b];
    if (c == 0) continue;
    uint32_t base = atomicAdd(&gc[b], c);
    if (SCATTER) h[b] = base;
  }
  if (!SCATTER) return;
  __syncthreads();
  for (int i = i0 + threadIdx.x; i < i1; i += SORT_T) {
    int d = dw[i];
    if (d == 0) continue;
    int b = (d < 0 ? -d : d) - 1;
    uint32_t pos = atomicAdd(&h[b], 1u);
    records[pos] = make_uint2((uint32_t)(w * nb + b),
                              ((uint32_t)i << 1) | (uint32_t)(d < 0));
  }
}

// offsets[k] = counts[0] + ... + counts[k - 1] for k in [0, m] (offsets[m]
// is the number of records), and cursor = offsets[0..m).  One block.
__global__ void __launch_bounds__(1024)
    bucket_scan(const uint32_t* counts, int m, uint32_t* offsets,
                uint32_t* cursor) {
  __shared__ uint32_t part[1024];
  int t = threadIdx.x;
  int per = (m + 1023) / 1024;
  int k0 = min(m, t * per), k1 = min(m, k0 + per);
  uint32_t s = 0;
  for (int k = k0; k < k1; k++) s += counts[k];
  part[t] = s;
  __syncthreads();
  for (int d = 1; d < 1024; d <<= 1) {
    uint32_t v = t >= d ? part[t - d] : 0u;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  uint32_t run = part[t] - s;
  for (int k = k0; k < k1; k++) {
    offsets[k] = run;
    cursor[k] = run;
    run += counts[k];
  }
  if (t == 1023) offsets[m] = part[1023];
}

// One thread per segment [s * seg, (s + 1) * seg) of the records below
// offsets[m].  hkey[s] is the bucket of the segment's head (its first run,
// when that run began in an earlier segment) or -1.
template <class F>
__global__ void __launch_bounds__(ACC_T, 5)
    bucket_acc(const uint2* rec, const uint32_t* total, int nseg, int seg,
               const uint32_t* X, const uint32_t* Y, xyzz* buckets,
               xyzz* head, int* hkey) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= nseg) return;
  hkey[s] = -1;
  uint32_t M = *total;
  uint32_t p = (uint32_t)s * seg;
  if (p >= M) return;
  uint32_t p1 = min(M, p + seg);
  uint2 r = rec[p];
  uint32_t cur = r.x;
  bool is_head = p > 0 && rec[p - 1].x == cur;
  xyzz a = xyzz_identity<F>();
  while (true) {
    size_t i = r.y >> 1;
    fe x = fe_load_v(X + 8 * i);
    fe y = fe_load_v(Y + 8 * i);
    if (r.y & 1u) y = fe_neg<F>(y);
    xyzz_madd<F>(a, x, y);
    p++;
    uint32_t nxt = 0xffffffffu;
    if (p < p1) {
      r = rec[p];
      nxt = r.x;
    }
    if (nxt == cur) continue;
    if (is_head) {
      xyzz_store(head + s, a);
      hkey[s] = (int)cur;
      is_head = false;
    } else {
      xyzz_store(buckets + cur, a);
    }
    if (p >= p1) break;
    cur = nxt;
    a = xyzz_identity<F>();
  }
}

// One level of the merge: one thread per segment of mseg heads of the
// level below (keys hk_in, -1 for none; equal keys are adjacent).  A run of
// equal keys is summed; a run that began in an earlier segment becomes this
// level's head, any other is added into its bucket (one thread per level
// touches a bucket, and the levels run in order).
template <class F>
__global__ void __launch_bounds__(ACC_T)
    bucket_merge(const xyzz* h_in, const int* hk_in, int n_in, int mseg,
                 xyzz* buckets, xyzz* h_out, int* hk_out) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  int p0 = s * mseg;
  if (p0 >= n_in) return;
  int p1 = min(n_in, p0 + mseg);
  hk_out[s] = -1;
  int prev = p0 > 0 ? hk_in[p0 - 1] : -1;
  int cur = -1;
  bool is_head = false;
  xyzz a = xyzz_identity<F>();
  for (int p = p0; p <= p1; p++) {
    int k = p < p1 ? hk_in[p] : -1;
    if (k == cur && p < p1) {
      if (k >= 0) a = xyzz_add<F>(a, xyzz_load(h_in + p));
      continue;
    }
    if (cur >= 0) {
      if (is_head) {
        xyzz_store(h_out + s, a);
        hk_out[s] = cur;
      } else {
        xyzz_store(buckets + cur, xyzz_add<F>(xyzz_load(buckets + cur), a));
      }
    }
    if (p == p1) break;
    cur = k;
    is_head = p == p0 && k >= 0 && k == prev;
    a = k >= 0 ? xyzz_load(h_in + p) : xyzz_identity<F>();
  }
}

// The window sums by the bits of the magnitude: S_w = sum_v v * B_v =
// sum_k 2^k C_{w,k} with C_{w,k} the sum of the buckets whose magnitude v
// (1..nb) has bit k set.  Every C_{w,k} is a plain sum, summed by block
// trees with no chain longer than RB_PER + log2(RB_T) additions, and each
// block doubles its sum k times (the blocks' chains run side by side), so
// that window_reduce then sums a window's blocks into S_w.
// A running sum over the buckets, the usual way, is a chain of 2 * nb
// dependent additions per window (~18 us each in one thread on the H100);
// this costs (c - 1) / 2 additions per bucket instead of 2, all in parallel.
// Block (g, k, w) sums entries [g * RB_SPAN, (g + 1) * RB_SPAN) of the list
// of magnitudes with bit k set (nb / 2 of them below bit c - 1; only nb at
// bit c - 1); an empty bucket (count 0) is skipped.  out: (nwin, c * ng),
// entry k * ng + g of window w being 2^k times the block's sum.
template <class F>
__global__ void __launch_bounds__(RB_T, 4)
    bucket_bits(const xyzz* buckets, const uint32_t* offsets, int c,
                xyzz* out) {
  __shared__ uint32_t sm[32 * RB_T];
  int g = blockIdx.x, k = blockIdx.y, w = blockIdx.z;
  int nb = 1 << (c - 1);
  int cnt = k < c - 1 ? nb >> 1 : 1;
  xyzz acc = xyzz_identity<F>();
#pragma unroll 1
  for (int r = 0; r < RB_PER; r++) {
    int j = g * RB_SPAN + r * RB_T + threadIdx.x;
    if (j >= cnt) break;
    int v = k < c - 1
                ? ((j >> k) << (k + 1)) | (1 << k) | (j & ((1 << k) - 1))
                : nb;
    size_t idx = (size_t)w * nb + v - 1;
    if (offsets[idx + 1] != offsets[idx])
      acc = xyzz_add<F>(acc, xyzz_load(buckets + idx));
  }
  acc = block_sum<F>(acc, sm);
  if (threadIdx.x != 0) return;
  for (int j = 0; j < k; j++) acc = xyzz_double<F>(acc);
  xyzz_store(out + ((size_t)w * c + k) * gridDim.x + g, acc);
}

// The four phases, each one C call so that the wrapper can time them.
// field 0: BN254 G1 (coordinates in Fq); field 1: Grumpkin (in Fr).  c: the
// window (2..16), nb = 2^(c-1) buckets per window, nwin windows; m = nwin *
// nb.  Scratch from the wrapper (ops/cuda_msm.py `msm_cuda`):
//   digits (nwin, n) int16; counts, cursor (m) uint32; offsets (m + 1);
//   records (nwin * n) uint2; buckets (m) XYZZ; heads (the merge levels'
//   head slots, ops/msm.py `merge_levels`) XYZZ with keys int32; bits
//   (nwin, c * bits_groups(c)), tmp (reduce_tmp_points(nwin, c *
//   bits_groups(c))) and ws (nwin) XYZZ; out (3, 8) canonical Jacobian
//   Montgomery words.
extern "C" int mira_msm_bucket_sort(const void* sc, const void* Z, int n,
                                    int c, int nwin, void* digits,
                                    void* counts, void* offsets, void* cursor,
                                    void* records, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int nb = 1 << (c - 1), m = nwin * nb;
  recode_digits<<<(n + 255) / 256, 256, 0, s>>>(
      (const uint32_t*)sc, (const uint32_t*)Z, n, c, nwin, (int16_t*)digits);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = (int)cudaMemsetAsync(counts, 0, (size_t)m * 4, s);
  if (err) return err;
  // a block per (window, 8 * nb points): the counts it adds are ~8x fewer
  // than its points
  int per = std::max(8 * nb, SORT_T * 4);
  int ng = (n + per - 1) / per;
  per = (n + ng - 1) / ng;
  size_t smem = (size_t)nb * 4;
  cudaFuncSetAttribute(bucket_sort<false>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncSetAttribute(bucket_sort<true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  bucket_sort<false><<<dim3(ng, nwin), SORT_T, smem, s>>>(
      (const int16_t*)digits, n, per, nb, (uint32_t*)counts, nullptr);
  err = (int)cudaGetLastError();
  if (err) return err;
  bucket_scan<<<1, 1024, 0, s>>>((const uint32_t*)counts, m,
                                 (uint32_t*)offsets, (uint32_t*)cursor);
  err = (int)cudaGetLastError();
  if (err) return err;
  bucket_sort<true><<<dim3(ng, nwin), SORT_T, smem, s>>>(
      (const int16_t*)digits, n, per, nb, (uint32_t*)cursor, (uint2*)records);
  return (int)cudaGetLastError();
}

// blocks of bucket_bits per (window, bit)
static int bits_groups(int c) {
  return std::max(1, ((1 << (c - 2)) + RB_SPAN - 1) / RB_SPAN);
}

template <class F>
static int acc_phase(const uint2* rec, const uint32_t* total, int nseg,
                     int seg, const uint32_t* X, const uint32_t* Y,
                     xyzz* buckets, xyzz* heads, int* hkeys, cudaStream_t s) {
  bucket_acc<F><<<(nseg + ACC_T - 1) / ACC_T, ACC_T, 0, s>>>(
      rec, total, nseg, seg, X, Y, buckets, heads, hkeys);
  return (int)cudaGetLastError();
}

template <class F>
static int reduce_phase(int nseg, int c, int nwin, const uint32_t* offsets,
                        xyzz* buckets, xyzz* heads, int* hkeys, xyzz* bits,
                        xyzz* tmp, xyzz* ws, cudaStream_t s) {
  int n_in = nseg, mseg = MERGE_FIRST;
  while (n_in > 1) {
    int n_out = (n_in + mseg - 1) / mseg;
    bucket_merge<F><<<(n_out + ACC_T - 1) / ACC_T, ACC_T, 0, s>>>(
        heads, hkeys, n_in, mseg, buckets, heads + n_in, hkeys + n_in);
    int err = (int)cudaGetLastError();
    if (err) return err;
    heads += n_in;
    hkeys += n_in;
    n_in = n_out;
    mseg = MERGE_SEG;
  }
  int ng = bits_groups(c);
  bucket_bits<F><<<dim3(ng, c, nwin), RB_T, 0, s>>>(buckets, offsets, c, bits);
  int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce_windows<F>(bits, nwin, c * ng, tmp, ws, s);
}

// Records per accumulate thread for n points and nwin windows: about SEG,
// sized so that the threads make whole waves of the card at the occupancy
// ptxas allows (at 2^17 points, SEG records a thread came to one wave and a
// few blocks: twice the time of one wave).  Not a launch.
extern "C" int mira_msm_bucket_seg(int field, int n, int nwin) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (field == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bucket_acc<Fq>, ACC_T, 0);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bucket_acc<Fr>, ACC_T, 0);
  long long wave = (long long)std::max(1, sms * per_sm) * ACC_T;
  long long recs = (long long)n * nwin;
  long long waves = std::max(1LL, (recs + wave * SEG / 2) / (wave * SEG));
  return (int)std::max(1LL, (recs + waves * wave - 1) / (waves * wave));
}

// nseg = ceil(nwin * n / seg) accumulate threads (those past the records
// return at once).
extern "C" int mira_msm_bucket_acc(int field, const void* records,
                                   const void* offsets, int m, int nseg,
                                   int seg, const void* X, const void* Y,
                                   void* buckets, void* heads, void* hkeys,
                                   void* stream) {
  auto run = [&](auto tag) {
    return acc_phase<decltype(tag)>(
        (const uint2*)records, (const uint32_t*)offsets + m, nseg, seg,
        (const uint32_t*)X, (const uint32_t*)Y, (xyzz*)buckets, (xyzz*)heads,
        (int*)hkeys, (cudaStream_t)stream);
  };
  return field == 0 ? run(Fq{}) : run(Fr{});
}

extern "C" int mira_msm_bucket_reduce(int field, int nseg, int c, int nwin,
                                      const void* offsets, void* buckets,
                                      void* heads, void* hkeys, void* bits,
                                      void* tmp, void* ws, void* stream) {
  auto run = [&](auto tag) {
    return reduce_phase<decltype(tag)>(
        nseg, c, nwin, (const uint32_t*)offsets, (xyzz*)buckets, (xyzz*)heads,
        (int*)hkeys, (xyzz*)bits, (xyzz*)tmp, (xyzz*)ws,
        (cudaStream_t)stream);
  };
  return field == 0 ? run(Fq{}) : run(Fr{});
}

// sum_w 2^(c*w) ws[w] over the window sums.
extern "C" int mira_msm_bucket_finish(int field, const void* ws, int nwin,
                                      int c, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    return launch_finish<Fq>((const xyzz*)ws, nwin, c, (uint32_t*)out, s);
  return launch_finish<Fr>((const xyzz*)ws, nwin, c, (uint32_t*)out, s);
}
