// Field and curve library inlined by every kernel of the port.
//
// Replaces mira_tpu/ops/pallas_field.py `TField` (the Pallas in-kernel
// library).  The TPU version works on (16, B) tiles of 16-bit limbs because
// the VPU has no wide multiply; here an element is eight 32-bit words in
// registers and a Montgomery product is a CIOS loop over 32x32->64-bit
// multiply-adds, which nvcc lowers to Hopper's mad.lo/hi carry chains.
// Values stay canonical (in [0, p)) after every operation, so zero tests and
// equality are word compares, TField's `canon` is the identity here and its
// masked `select` is a plain branch.  Montgomery R = 2^256, as in mira_tpu,
// so a word image here is the same integer as mira_tpu's limb array.
//
// Curve law: short Weierstrass with a = 0 (BN254 G1 over Fq, Grumpkin over
// Fr).  Point formulas follow pallas_field.py: XYZZ (x = X/ZZ, y = Y/ZZZ,
// identity ZZ == 0) for bucket accumulation and Jacobian for the rest.  The
// TPU kernels select between branches with masks (Mosaic predicates every
// branch); on the GPU a branch costs only divergence, so every point
// operation here is the complete one: identity operands, P == -Q and
// P == Q (doubling) are handled exactly by real branches.
//
// Bound on the card: a Montgomery product is ~130 dependent 32-bit
// multiply-adds; kernels built on this header are bound by integer
// multiply throughput and by the latency of those chains, not by memory.
#pragma once
#include <stdint.h>

namespace mira {

struct fe {
  uint32_t v[8];
};

// BN254 base field (coordinates of G1; scalars of Grumpkin).
struct Fq {
  static __device__ __forceinline__ uint32_t p(int i) {
    const uint32_t w[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return w[i];
  }
  static __device__ __forceinline__ uint32_t one(int i) {
    const uint32_t w[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
                           0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return w[i];
  }
  static constexpr uint32_t n0 = 0xe4866389u;  // -p^-1 mod 2^32
};

// BN254 scalar field (coordinates of Grumpkin; scalars of G1).
struct Fr {
  static __device__ __forceinline__ uint32_t p(int i) {
    const uint32_t w[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return w[i];
  }
  static __device__ __forceinline__ uint32_t one(int i) {
    const uint32_t w[8] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
                           0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return w[i];
  }
  static constexpr uint32_t n0 = 0xefffffffu;
};

// ---------------------------------------------------------------------------
// field ops (canonical in, canonical out)

__device__ __forceinline__ fe fe_load(const uint32_t* src) {
  fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = src[i];
  return r;
}

__device__ __forceinline__ void fe_store(uint32_t* dst, const fe& a) {
#pragma unroll
  for (int i = 0; i < 8; i++) dst[i] = a.v[i];
}

// 16-byte vector forms for element arrays whose rows are 32-byte aligned
// (an (n, 8) int32 tensor): two 128-bit accesses instead of eight 32-bit.
__device__ __forceinline__ fe fe_load_v(const uint32_t* src) {
  const uint4* q = reinterpret_cast<const uint4*>(src);
  uint4 lo = q[0], hi = q[1];
  fe r;
  r.v[0] = lo.x; r.v[1] = lo.y; r.v[2] = lo.z; r.v[3] = lo.w;
  r.v[4] = hi.x; r.v[5] = hi.y; r.v[6] = hi.z; r.v[7] = hi.w;
  return r;
}

// the same through the read-only data path, for tables every thread shares
__device__ __forceinline__ fe fe_load_ro(const uint32_t* src) {
  const uint4* q = reinterpret_cast<const uint4*>(src);
  uint4 lo = __ldg(q), hi = __ldg(q + 1);
  fe r;
  r.v[0] = lo.x; r.v[1] = lo.y; r.v[2] = lo.z; r.v[3] = lo.w;
  r.v[4] = hi.x; r.v[5] = hi.y; r.v[6] = hi.z; r.v[7] = hi.w;
  return r;
}

__device__ __forceinline__ void fe_store_v(uint32_t* dst, const fe& a) {
  uint4* q = reinterpret_cast<uint4*>(dst);
  q[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  q[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

__device__ __forceinline__ fe fe_zero() {
  fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = 0;
  return r;
}

template <class F>
__device__ __forceinline__ fe fe_one() {
  fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = F::one(i);
  return r;
}

__device__ __forceinline__ bool fe_is_zero(const fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a.v[i];
  return acc == 0;
}

__device__ __forceinline__ bool fe_eq(const fe& a, const fe& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a.v[i] ^ b.v[i];
  return acc == 0;
}

// r = a - p; returns the borrow out (1 when a < p)
template <class F>
__device__ __forceinline__ uint32_t sub_p(fe& r, const fe& a) {
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t d = (uint64_t)a.v[i] - F::p(i) - borrow;
    r.v[i] = (uint32_t)d;
    borrow = (d >> 63) & 1;
  }
  return (uint32_t)borrow;
}

template <class F>
__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  // a, b < p < 2^254: the sum fits in 256 bits
  fe s, d;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)a.v[i] + b.v[i];
    s.v[i] = (uint32_t)c;
    c >>= 32;
  }
  return sub_p<F>(d, s) ? s : d;
}

template <class F>
__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t t = (uint64_t)a.v[i] - b.v[i] - borrow;
    d.v[i] = (uint32_t)t;
    borrow = (t >> 63) & 1;
  }
  if (borrow) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
      c += (uint64_t)d.v[i] + F::p(i);
      d.v[i] = (uint32_t)c;
      c >>= 32;
    }
  }
  return d;
}

template <class F>
__device__ __forceinline__ fe fe_neg(const fe& a) {
  return fe_sub<F>(fe_zero(), a);
}

template <class F>
__device__ __forceinline__ fe fe_double(const fe& a) {
  return fe_add<F>(a, a);
}

// CIOS Montgomery product a * b * 2^-256 mod p over 32-bit words.
template <class F>
__device__ __forceinline__ fe fe_mul(const fe& a, const fe& b) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      uint64_t s = (uint64_t)t[j] + (uint64_t)a.v[j] * b.v[i] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * F::n0;
    s = (uint64_t)t[0] + (uint64_t)m * F::p(0);
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      s = (uint64_t)t[j] + (uint64_t)m * F::p(j) + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  // t < 2p < 2^255, so t[8] == 0
  fe r, d;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = t[i];
  return sub_p<F>(d, r) ? r : d;
}

template <class F>
__device__ __forceinline__ fe fe_sqr(const fe& a) {
  return fe_mul<F>(a, a);
}

// a^(p-2) (maps 0 to 0), square-and-multiply from the top bit
template <class F>
__device__ fe fe_inv(const fe& a) {
  fe r = fe_one<F>();
  for (int i = 7; i >= 0; i--) {
    uint32_t e = F::p(i) - (i == 0 ? 2u : 0u);
    for (int b = 31; b >= 0; b--) {
      r = fe_sqr<F>(r);
      if ((e >> b) & 1) r = fe_mul<F>(r, a);
    }
  }
  return r;
}

// ---------------------------------------------------------------------------
// XYZZ points: x = X/ZZ, y = Y/ZZZ; identity is ZZ == 0

struct xyzz {
  fe X, Y, ZZ, ZZZ;
};

template <class F>
__device__ __forceinline__ xyzz xyzz_identity() {
  xyzz r;
  r.X = fe_zero();
  r.Y = fe_one<F>();
  r.ZZ = fe_zero();
  r.ZZZ = fe_one<F>();
  return r;
}

// dbl-2008-s-1 (a = 0): identity doubles to identity (ZZ3 = V*ZZ1 = 0)
template <class F>
__device__ xyzz xyzz_double(const xyzz& p) {
  fe U = fe_double<F>(p.Y);
  fe V = fe_sqr<F>(U);
  fe W = fe_mul<F>(U, V);
  fe S = fe_mul<F>(p.X, V);
  fe XX = fe_sqr<F>(p.X);
  fe M = fe_add<F>(fe_double<F>(XX), XX);
  xyzz r;
  r.X = fe_sub<F>(fe_sqr<F>(M), fe_double<F>(S));
  r.Y = fe_sub<F>(fe_mul<F>(M, fe_sub<F>(S, r.X)), fe_mul<F>(W, p.Y));
  r.ZZ = fe_mul<F>(V, p.ZZ);
  r.ZZZ = fe_mul<F>(W, p.ZZZ);
  return r;
}

// acc += (x2, y2) affine (madd-2008-s), complete: acc identity, acc == -Q
// and acc == Q are exact.
template <class F>
__device__ void xyzz_madd(xyzz& acc, const fe& x2, const fe& y2) {
  if (fe_is_zero(acc.ZZ)) {
    acc.X = x2;
    acc.Y = y2;
    acc.ZZ = fe_one<F>();
    acc.ZZZ = fe_one<F>();
    return;
  }
  fe U2 = fe_mul<F>(x2, acc.ZZ);
  fe S2 = fe_mul<F>(y2, acc.ZZZ);
  fe P = fe_sub<F>(U2, acc.X);
  fe R = fe_sub<F>(S2, acc.Y);
  if (fe_is_zero(P)) {
    if (fe_is_zero(R)) {
      acc = xyzz_double<F>(acc);
    } else {
      acc = xyzz_identity<F>();
    }
    return;
  }
  fe PP = fe_sqr<F>(P);
  fe PPP = fe_mul<F>(P, PP);
  fe Q = fe_mul<F>(acc.X, PP);
  fe X3 = fe_sub<F>(fe_sub<F>(fe_sqr<F>(R), PPP), fe_double<F>(Q));
  fe Y3 = fe_sub<F>(fe_mul<F>(R, fe_sub<F>(Q, X3)), fe_mul<F>(acc.Y, PPP));
  acc.ZZ = fe_mul<F>(acc.ZZ, PP);
  acc.ZZZ = fe_mul<F>(acc.ZZZ, PPP);
  acc.X = X3;
  acc.Y = Y3;
}

// p + q (add-2008-s), complete.
template <class F>
__device__ xyzz xyzz_add(const xyzz& p, const xyzz& q) {
  if (fe_is_zero(p.ZZ)) return q;
  if (fe_is_zero(q.ZZ)) return p;
  fe U1 = fe_mul<F>(p.X, q.ZZ);
  fe U2 = fe_mul<F>(q.X, p.ZZ);
  fe S1 = fe_mul<F>(p.Y, q.ZZZ);
  fe S2 = fe_mul<F>(q.Y, p.ZZZ);
  fe P = fe_sub<F>(U2, U1);
  fe R = fe_sub<F>(S2, S1);
  if (fe_is_zero(P)) {
    if (fe_is_zero(R)) return xyzz_double<F>(p);
    return xyzz_identity<F>();
  }
  fe PP = fe_sqr<F>(P);
  fe PPP = fe_mul<F>(P, PP);
  fe Q = fe_mul<F>(U1, PP);
  xyzz r;
  r.X = fe_sub<F>(fe_sub<F>(fe_sqr<F>(R), PPP), fe_double<F>(Q));
  r.Y = fe_sub<F>(fe_mul<F>(R, fe_sub<F>(Q, r.X)), fe_mul<F>(S1, PPP));
  r.ZZ = fe_mul<F>(fe_mul<F>(p.ZZ, q.ZZ), PP);
  r.ZZZ = fe_mul<F>(fe_mul<F>(p.ZZZ, q.ZZZ), PPP);
  return r;
}

// ---------------------------------------------------------------------------
// Jacobian points: x = X/Z^2, y = Y/Z^3; identity is Z == 0

struct jac {
  fe X, Y, Z;
};

// XYZZ -> Jacobian with Z = ZZ*ZZZ: X = X*ZZ*ZZZ^2, Y = Y*ZZ^3*ZZZ^2
template <class F>
__device__ jac xyzz_to_jac(const xyzz& p) {
  jac r;
  fe ZZZ2 = fe_sqr<F>(p.ZZZ);
  fe ZZ3 = fe_mul<F>(fe_sqr<F>(p.ZZ), p.ZZ);
  r.Z = fe_mul<F>(p.ZZ, p.ZZZ);
  r.X = fe_mul<F>(fe_mul<F>(p.X, p.ZZ), ZZZ2);
  r.Y = fe_mul<F>(fe_mul<F>(p.Y, ZZ3), ZZZ2);
  if (fe_is_zero(p.ZZ)) {
    r.X = fe_zero();
    r.Y = fe_one<F>();
  }
  return r;
}

// dbl-2009-l (a = 0): 2M + 5S
template <class F>
__device__ jac jac_double(const jac& p) {
  fe A = fe_sqr<F>(p.X);
  fe B = fe_sqr<F>(p.Y);
  fe C = fe_sqr<F>(B);
  fe t = fe_sqr<F>(fe_add<F>(p.X, B));
  fe D = fe_double<F>(fe_sub<F>(fe_sub<F>(t, A), C));
  fe E = fe_add<F>(fe_double<F>(A), A);
  fe Fs = fe_sqr<F>(E);
  jac r;
  r.X = fe_sub<F>(Fs, fe_double<F>(D));
  fe C8 = fe_double<F>(fe_double<F>(fe_double<F>(C)));
  r.Y = fe_sub<F>(fe_mul<F>(E, fe_sub<F>(D, r.X)), C8);
  r.Z = fe_double<F>(fe_mul<F>(p.Y, p.Z));
  return r;
}

// add-2007-bl style complete addition
template <class F>
__device__ jac jac_add(const jac& p, const jac& q) {
  if (fe_is_zero(p.Z)) return q;
  if (fe_is_zero(q.Z)) return p;
  fe Z1Z1 = fe_sqr<F>(p.Z);
  fe Z2Z2 = fe_sqr<F>(q.Z);
  fe U1 = fe_mul<F>(p.X, Z2Z2);
  fe U2 = fe_mul<F>(q.X, Z1Z1);
  fe S1 = fe_mul<F>(fe_mul<F>(p.Y, q.Z), Z2Z2);
  fe S2 = fe_mul<F>(fe_mul<F>(q.Y, p.Z), Z1Z1);
  fe H = fe_sub<F>(U2, U1);
  fe R = fe_sub<F>(S2, S1);
  if (fe_is_zero(H)) {
    if (fe_is_zero(R)) return jac_double<F>(p);
    jac id;
    id.X = fe_zero();
    id.Y = fe_one<F>();
    id.Z = fe_zero();
    return id;
  }
  fe HH = fe_sqr<F>(H);
  fe HHH = fe_mul<F>(H, HH);
  fe V = fe_mul<F>(U1, HH);
  jac r;
  r.X = fe_sub<F>(fe_sub<F>(fe_sqr<F>(R), HHH), fe_double<F>(V));
  r.Y = fe_sub<F>(fe_mul<F>(R, fe_sub<F>(V, r.X)), fe_mul<F>(S1, HHH));
  r.Z = fe_mul<F>(fe_mul<F>(p.Z, q.Z), H);
  return r;
}

}  // namespace mira
