// Batched Poseidon sponge: N independent fixed-length hashes, bit-exact with
// the host sponge of ops/poseidon.py (the optimized-constant schedule of the
// reference, src/poseidon/poseidon_hash.rs:174-254).
//
// Replaces mira_tpu/ops/pallas_poseidon.py `_poseidon_pallas_jit` (body
// `_sponge`).  The TPU kernel rides N states on the vector lanes and keeps
// the t state elements concatenated along them so that one CIOS instance
// serves a whole round.  Here there are two routes (device code in
// poseidon.cuh), both for t = 2..5 and both fields:
//
// - thread: one thread owns a hash, its t-element state in registers and
//   the rounds plain loops.  A 2-to-1 hash (t = 3) is 520 products, all in
//   one thread's dependent chain of calls.
// - lanes: a hash on 2^ceil(log2 t) lanes of a warp, lane i holding state
//   element i: a full round is every lane's S-box at once and then lane i's
//   matrix row over the S-boxed elements gathered by __shfl_sync; a partial
//   round is lane 0's S-box, broadcast, then one product per lane for the
//   sparse row (summed over the lanes by __shfl_xor_sync) and one for the
//   column.  A t = 3 permutation's chain is 110 products instead of 260, at
//   1.7 times the products per hash (idle lanes, redundant S-boxes).
//
// ops/cuda_poseidon.py `poseidon_route` chooses: the lane route while the
// batch's lanes fill at most two warps on each SM sub-partition (the small
// levels of a Merkle tree, where a level's time is one hash's latency), the
// thread route above.  The constants sit in one device tensor, read through
// the read-only path:
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
// Bound on the card (chip_smoke.py's count): a 2-to-1 hash (t = 3, r_f = r_p
// = 10, two permutations) reads 64 B, writes 32 B and needs 520 Montgomery
// products, so integer multiplies bound a batch by three orders of
// magnitude over its bytes (2^20 hashes: 8.85 ms).  The thread route runs a
// full batch near the measured product rate; the lane route serves the
// batches too small to fill the card, whose time is a hash's latency rather
// than the products.
#include <cuda_runtime.h>

#include "poseidon.cuh"

using namespace mira;
using namespace mira::poseidon;

namespace {

constexpr int BLOCK = 128;

template <class F, int T>
int launch(int route, const void* in, void* out, int n, int len, int r_f,
           int r_p, const uint32_t* c, const uint32_t* iv, cudaStream_t s) {
  constexpr int L = T <= 2 ? 2 : (T <= 4 ? 4 : 8);
  const uint32_t* i = (const uint32_t*)in;
  uint32_t* o = (uint32_t*)out;
  if (route == 0) {
    thread_kernel<F, T><<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, s>>>(
        i, o, n, len, r_f, r_p, c, iv);
  } else {
    const long long threads = (long long)n * L;
    lanes_kernel<F, T, L><<<(unsigned)((threads + BLOCK - 1) / BLOCK), BLOCK,
                            0, s>>>(i, o, n, len, r_f, r_p, c, iv);
  }
  return (int)cudaGetLastError();
}

template <class F>
int dispatch_t(int t, int route, const void* in, void* out, int n, int len,
               int r_f, int r_p, const uint32_t* c, const uint32_t* iv,
               cudaStream_t s) {
  switch (t) {
    case 2: return launch<F, 2>(route, in, out, n, len, r_f, r_p, c, iv, s);
    case 3: return launch<F, 3>(route, in, out, n, len, r_f, r_p, c, iv, s);
    case 4: return launch<F, 4>(route, in, out, n, len, r_f, r_p, c, iv, s);
    case 5: return launch<F, 5>(route, in, out, n, len, r_f, r_p, c, iv, s);
    default: return 1;
  }
}

}  // namespace

// field 0: Fq, 1: Fr.  in: (n, len, 8) Montgomery words; out: (n, 8), each
// hash's state[1], untruncated; consts: the table described above, whose
// last element (index n_consts - 1) is the IV.  t in 2..5, r_f even and
// >= 2; route 0: a thread per hash, 1: lanes per hash.
extern "C" int mira_poseidon(int field, const void* in, void* out, int n,
                             int len, int t, int r_f, int r_p,
                             const void* consts, int n_consts, int route,
                             void* stream) {
  if (n <= 0) return 0;
  if (len < 0 || r_f < 2 || (r_f & 1) || r_p < 0 || route < 0 || route > 1)
    return 1;
  const int half = r_f / 2;
  const int expect = (half + 1) * t + r_p + (half - 1) * t + 2 * t * t +
                     r_p * t + r_p * (t - 1) + 1;
  if (n_consts != expect) return 1;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* c = (const uint32_t*)consts;
  const uint32_t* iv = c + (size_t)(n_consts - 1) * 8;
  if (field == 0)
    return dispatch_t<Fq>(t, route, in, out, n, len, r_f, r_p, c, iv, s);
  return dispatch_t<Fr>(t, route, in, out, n, len, r_f, r_p, c, iv, s);
}
