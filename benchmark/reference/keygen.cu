// Pedersen key rows on the card: keygen.cpp's per-point pipeline (run_job),
// one thread a point.  Row i of a key is expand_message_xmd(SHA-256) of its
// 32 bytes of the SHAKE-256 stream, 128 bytes out, read as two field
// elements mod p (wide_to_mont), each mapped by SvdW, the two points added
// and the sum made affine.  The rows are keygen.cpp's bit for bit: every
// step is exact arithmetic on canonical values, and the affine form of a
// point is unique (one inversion a point here, one a thread's range there).
//
// A copy written for the card, sharing nothing with the program's field
// code.  keygen.cpp stays the oracle and the route without CUDA; keys.py
// checks a seeded sample of every key made here against it.
//
// Bound by operations: ~3,500 Montgomery products a point on BN254, ~4,200
// on Grumpkin.  Each of the two SvdW maps takes an inversion, three powers
// by (q - 1)/2 (the square tests of x1, x2 and x3) and a Tonelli-Shanks in
// straight line (s = 1 on BN254's base field, 28 on Grumpkin's); then the
// affine inversion.  Every thread of a warp takes the same steps: a branch
// on which x is a square would run all three paths, and keygen.cpp's
// Tonelli-Shanks loop as many rounds as the slowest thread needs.
// Square-and-multiply by the field's exponents keeps no table.
//
// Built with nvcc into a shared library with a plain C interface (native.py);
// without __CUDACC__ the same file compiles as host C++ with one entry point,
// mira_keygen_host, so that the tests can hold this arithmetic against
// keygen.cpp on a machine with no card.

#include <cstddef>
#include <cstdint>
#include <cstring>

// HD: the field arithmetic, which load_params runs on the host too; DEV:
// the rest, device code alone in the CUDA build.  The _CALL forms stay
// calls: inlined everywhere, the kernel took nvcc ~40 s to build and spilled;
// with the product, the power, the square root, the map and the SHA-256
// block as calls it builds in ~6 s and runs ~1.5x as fast (H100).
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#define DEV __device__ __forceinline__
#define HD_CALL __host__ __device__ __noinline__
#define DEV_CALL __device__ __noinline__
#else
#define HD inline
#define DEV inline
#define HD_CALL inline
#define DEV_CALL inline
#endif

using u64 = uint64_t;
using u32 = uint32_t;
using u8 = uint8_t;

namespace {

// ---------------------------------------------------------------------------
// SHA-256 (FIPS 180-4) and expand_message_xmd (RFC 9380 5.3.1)
// ---------------------------------------------------------------------------

#ifdef __CUDACC__
__device__ __constant__ u32 SHA_K[64] = {
#else
const u32 SHA_K[64] = {
#endif
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

DEV u32 rotr32(u32 x, int n) { return (x >> n) | (x << (32 - n)); }

struct Sha256 {
    u32 h[8];
    u8 buf[64];
    u32 buf_len;
    u32 total;

    DEV Sha256() : buf_len(0), total(0) {
        const u32 iv[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                           0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
        for (int i = 0; i < 8; i++) h[i] = iv[i];
    }

    DEV_CALL void block(const u8 *p) {
        u32 w[64];
        for (int i = 0; i < 16; i++)
            w[i] = (u32(p[4 * i]) << 24) | (u32(p[4 * i + 1]) << 16) |
                   (u32(p[4 * i + 2]) << 8) | u32(p[4 * i + 3]);
        for (int i = 16; i < 64; i++) {
            u32 s0 = rotr32(w[i - 15], 7) ^ rotr32(w[i - 15], 18) ^ (w[i - 15] >> 3);
            u32 s1 = rotr32(w[i - 2], 17) ^ rotr32(w[i - 2], 19) ^ (w[i - 2] >> 10);
            w[i] = w[i - 16] + s0 + w[i - 7] + s1;
        }
        u32 a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6],
            hh = h[7];
        for (int i = 0; i < 64; i++) {
            u32 t1 = hh + (rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25)) +
                     ((e & f) ^ (~e & g)) + SHA_K[i] + w[i];
            u32 t2 = (rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22)) +
                     ((a & b) ^ (a & c) ^ (b & c));
            hh = g; g = f; f = e; e = d + t1;
            d = c; c = b; b = a; a = t1 + t2;
        }
        h[0] += a; h[1] += b; h[2] += c; h[3] += d;
        h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
    }

    DEV void update(const u8 *data, u32 len) {
        total += len;
        while (len > 0) {
            u32 take = 64 - buf_len;
            if (take > len) take = len;
            for (u32 i = 0; i < take; i++) buf[buf_len + i] = data[i];
            buf_len += take;
            data += take;
            len -= take;
            if (buf_len == 64) {
                block(buf);
                buf_len = 0;
            }
        }
    }

    DEV void digest(u8 out[32]) {
        u64 bits = u64(total) * 8;
        u8 pad[72];
        u32 pad_len = buf_len < 56 ? 56 - buf_len : 120 - buf_len;
        pad[0] = 0x80;
        for (u32 i = 1; i < pad_len; i++) pad[i] = 0;
        for (int i = 0; i < 8; i++) pad[pad_len + i] = u8(bits >> (56 - 8 * i));
        update(pad, pad_len + 8);
        for (int i = 0; i < 8; i++) {
            out[4 * i] = u8(h[i] >> 24);
            out[4 * i + 1] = u8(h[i] >> 16);
            out[4 * i + 2] = u8(h[i] >> 8);
            out[4 * i + 3] = u8(h[i]);
        }
    }
};

// DST' = DST || I2OSP(len(DST), 1)
struct Dst {
    u8 bytes[256];
    u32 len;
};

// expand_message_xmd(msg, DST, 128) for a 32-byte message
DEV void expand_xmd_128(const u8 msg[32], const Dst &dst, u8 out[128]) {
    Sha256 h0;
    u8 zeros[64] = {0};
    h0.update(zeros, 64);
    h0.update(msg, 32);
    const u8 lib[3] = {0, 128, 0};
    h0.update(lib, 3);
    h0.update(dst.bytes, dst.len);
    u8 b0[32];
    h0.digest(b0);

    u8 prev[32];
    for (int i = 1; i <= 4; i++) {
        u8 x[32];
        for (int j = 0; j < 32; j++) x[j] = i == 1 ? b0[j] : u8(b0[j] ^ prev[j]);
        Sha256 hi;
        hi.update(x, 32);
        u8 ib = u8(i);
        hi.update(&ib, 1);
        hi.update(dst.bytes, dst.len);
        hi.digest(prev);
        for (int j = 0; j < 32; j++) out[32 * (i - 1) + j] = prev[j];
    }
}

// ---------------------------------------------------------------------------
// A 4x64 Montgomery field given at run time (R = 2^256)
// ---------------------------------------------------------------------------

struct Fe {
    u64 d[4];
};

struct Field {
    Fe p;
    u64 n0inv;         // -p^-1 mod 2^64
    Fe r2;             // R^2 mod p
    Fe one;            // R mod p
    Fe c_init;         // z^q, Montgomery (z a non-residue, q the odd part of p - 1)
    u8 q12_bytes[32];  // (q - 1) / 2, little-endian
    u8 pm2_bytes[32];  // p - 2, little-endian
    int s;             // 2-adicity of p - 1
};

struct Svdw {
    Fe Z, c1, c2, c3, c4, b;
};

struct Params {
    Field F;
    Svdw S;
    Dst dst;
};

// a * b + c + carry -> (lo, carry)
HD u64 mac(u64 a, u64 b, u64 c, u64 &carry) {
#ifdef __CUDA_ARCH__
    u64 lo = a * b, hi = __umul64hi(a, b);
#else
    unsigned __int128 w = (unsigned __int128)a * b;
    u64 lo = u64(w), hi = u64(w >> 64);
#endif
    lo += c;
    hi += lo < c;
    lo += carry;
    hi += lo < carry;
    carry = hi;
    return lo;
}

HD bool geq(const Fe &a, const Fe &b) {
    for (int i = 3; i >= 0; i--)
        if (a.d[i] != b.d[i]) return a.d[i] > b.d[i];
    return true;
}

// o = a - b over 256 bits; returns the borrow
HD u64 sub_words(const Fe &a, const Fe &b, Fe &o) {
    u64 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u64 d = a.d[i] - b.d[i];
        u64 b1 = a.d[i] < b.d[i];
        u64 d2 = d - borrow;
        borrow = b1 | (d2 > d);
        o.d[i] = d2;
    }
    return borrow;
}

HD u64 add_words(const Fe &a, const Fe &b, Fe &o) {
    u64 carry = 0;
    for (int i = 0; i < 4; i++) {
        u64 s = a.d[i] + b.d[i];
        u64 c1 = s < a.d[i];
        u64 s2 = s + carry;
        carry = c1 | (s2 < s);
        o.d[i] = s2;
    }
    return carry;
}

DEV Fe fadd(const Field &F, const Fe &a, const Fe &b) {
    Fe o;
    u64 carry = add_words(a, b, o);
    if (carry || geq(o, F.p)) sub_words(o, F.p, o);
    return o;
}

DEV Fe fsub(const Field &F, const Fe &a, const Fe &b) {
    Fe o;
    if (sub_words(a, b, o)) add_words(o, F.p, o);
    return o;
}

DEV Fe fneg(const Field &F, const Fe &a) { return fsub(F, Fe{{0, 0, 0, 0}}, a); }

// a * b * R^-1 mod p (CIOS).  b may be any 256-bit value; a < p.
HD_CALL Fe fmul(const Field &F, const Fe &a, const Fe &b) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u64 carry = 0;
        for (int j = 0; j < 4; j++) t[j] = mac(a.d[j], b.d[i], t[j], carry);
        t[4] += carry;
        t[5] = t[4] < carry;
        u64 m = t[0] * F.n0inv;
        carry = 0;
        mac(m, F.p.d[0], t[0], carry);
        for (int j = 1; j < 4; j++) t[j - 1] = mac(m, F.p.d[j], t[j], carry);
        t[3] = t[4] + carry;
        t[4] = t[5] + (t[3] < carry);
    }
    Fe o{{t[0], t[1], t[2], t[3]}};
    if (t[4] || geq(o, F.p)) sub_words(o, F.p, o);
    return o;
}

DEV Fe fsqr(const Field &F, const Fe &a) { return fmul(F, a, a); }

DEV bool is_zero(const Fe &a) { return (a.d[0] | a.d[1] | a.d[2] | a.d[3]) == 0; }

DEV bool feq(const Fe &a, const Fe &b) {
    return a.d[0] == b.d[0] && a.d[1] == b.d[1] && a.d[2] == b.d[2] && a.d[3] == b.d[3];
}

// a^e for a 32-byte little-endian exponent, left to right (a Montgomery)
DEV_CALL Fe fpow(const Field &F, const Fe &a, const u8 e[32]) {
    Fe acc = F.one;
    bool started = false;
    for (int i = 255; i >= 0; i--) {
        if (started) acc = fsqr(F, acc);
        if ((e[i >> 3] >> (i & 7)) & 1) {
            acc = started ? fmul(F, acc, a) : a;
            started = true;
        }
    }
    return acc;
}

DEV Fe finv0(const Field &F, const Fe &a) {
    return is_zero(a) ? Fe{{0, 0, 0, 0}} : fpow(F, a, F.pm2_bytes);
}

// a^((q - 1)/2) for q the odd part of p - 1, and whether a is a square:
// a = 0, or (a^q)^(2^(s-1)) = 1
DEV bool half_power(const Field &F, const Fe &a, Fe &w) {
    w = fpow(F, a, F.q12_bytes);
    Fe leg = fmul(F, fmul(F, w, w), a);
    for (int i = 0; i < F.s - 1; i++) leg = fsqr(F, leg);
    return is_zero(a) || feq(leg, F.one);
}

// A root of the square a from w = a^((q - 1)/2): Tonelli-Shanks in straight
// line (RFC 9380 I.4), the same steps for every thread of a warp.  Its root
// may be the other one than keygen.cpp's loop finds; map_to_curve's sign
// rule then makes both the same.
DEV_CALL Fe sqrt_from(const Field &F, const Fe &a, const Fe &w) {
    Fe z = fmul(F, w, a);  // a^((q + 1)/2)
    Fe t = fmul(F, w, z);  // a^q
    Fe c = F.c_init;
    for (int i = F.s; i >= 2; i--) {
        Fe b = t;
        for (int j = 1; j <= i - 2; j++) b = fsqr(F, b);
        bool e = feq(b, F.one);
        Fe zc = fmul(F, z, c);
        c = fsqr(F, c);
        Fe tc = fmul(F, t, c);
        if (!e) {
            z = zc;
            t = tc;
        }
    }
    return z;
}

DEV Fe from_mont(const Field &F, const Fe &a) { return fmul(F, a, Fe{{1, 0, 0, 0}}); }

DEV int sgn0(const Field &F, const Fe &a) { return int(from_mont(F, a).d[0] & 1); }

// 64 little-endian bytes mod p, Montgomery: lo R + hi R^2 (hi 2^256 R)
DEV Fe wide_to_mont(const Field &F, const u8 *bytes64) {
    Fe lo, hi;
    for (int i = 0; i < 4; i++) {
        u64 a = 0, b = 0;
        for (int k = 7; k >= 0; k--) {
            a = (a << 8) | bytes64[8 * i + k];
            b = (b << 8) | bytes64[32 + 8 * i + k];
        }
        lo.d[i] = a;
        hi.d[i] = b;
    }
    return fadd(F, fmul(F, F.r2, lo), fmul(F, fmul(F, F.r2, hi), F.r2));
}

DEV Fe gx_of(const Field &F, const Svdw &S, const Fe &x) {
    return fadd(F, fmul(F, fsqr(F, x), x), S.b);
}

// SvdW map-to-curve (RFC 9380 6.6.1) for a = 0, Montgomery in and out
DEV_CALL void map_to_curve(const Field &F, const Svdw &S, const Fe &u, Fe &ox, Fe &oy) {
    Fe tv1 = fmul(F, fsqr(F, u), S.c1);
    Fe tv2 = fadd(F, F.one, tv1);
    tv1 = fsub(F, F.one, tv1);
    Fe tv3 = finv0(F, fmul(F, tv1, tv2));
    Fe tv4 = fmul(F, fmul(F, fmul(F, u, tv1), tv3), S.c3);
    // x1 where g(x1) is a square, else x2 where g(x2) is, else x3: all
    // three tried by every thread, so that a warp runs one path
    Fe x1 = fsub(F, S.c2, tv4), x2 = fadd(F, S.c2, tv4);
    Fe x3 = fmul(F, fsqr(F, tv2), tv3);
    x3 = fadd(F, fmul(F, fsqr(F, x3), S.c4), S.Z);
    Fe g1 = gx_of(F, S, x1), g2 = gx_of(F, S, x2), g3 = gx_of(F, S, x3), w1, w2, w3;
    bool e1 = half_power(F, g1, w1), e2 = half_power(F, g2, w2);
    half_power(F, g3, w3);  // a square by SvdW's construction
    Fe x = e1 ? x1 : e2 ? x2 : x3;
    Fe y = sqrt_from(F, e1 ? g1 : e2 ? g2 : g3, e1 ? w1 : e2 ? w2 : w3);
    if (sgn0(F, u) != sgn0(F, y)) y = fneg(F, y);
    ox = x;
    oy = y;
}

// The sum of two affine points, Jacobian; z = 0 for the point at infinity
DEV void add_affine(const Field &F, const Fe &x1, const Fe &y1, const Fe &x2, const Fe &y2,
                   Fe &X, Fe &Y, Fe &Z) {
    if (feq(x1, x2)) {
        if (feq(y1, fneg(F, y2))) {
            X = F.one;
            Y = F.one;
            Z = Fe{{0, 0, 0, 0}};
            return;
        }
        Fe xx = fsqr(F, x1), yy = fsqr(F, y1);
        Fe yyyy = fsqr(F, yy);
        Fe s = fsub(F, fsub(F, fsqr(F, fadd(F, x1, yy)), xx), yyyy);
        s = fadd(F, s, s);
        Fe m = fadd(F, fadd(F, xx, xx), xx);
        Fe t = fsub(F, fsub(F, fsqr(F, m), s), s);
        Fe y8 = fadd(F, yyyy, yyyy);
        y8 = fadd(F, y8, y8);
        y8 = fadd(F, y8, y8);
        X = t;
        Y = fsub(F, fmul(F, m, fsub(F, s, t)), y8);
        Z = fadd(F, y1, y1);
        return;
    }
    Fe h = fsub(F, x2, x1), r = fsub(F, y2, y1);
    Fe hh = fsqr(F, h);
    Fe hhh = fmul(F, hh, h), v = fmul(F, x1, hh);
    X = fsub(F, fsub(F, fsub(F, fsqr(F, r), hhh), v), v);
    Y = fsub(F, fmul(F, r, fsub(F, v, X)), fmul(F, y1, hhh));
    Z = h;
}

// One key row: 32 stream bytes -> affine (x, y), raw little-endian words;
// (0, 0) for the point at infinity
DEV void key_row(const Params &P, const u8 *msg, u64 *out) {
    const Field &F = P.F;
    u8 uniform[128];
    expand_xmd_128(msg, P.dst, uniform);
    Fe x0, y0, x1, y1, X, Y, Z;
    map_to_curve(F, P.S, wide_to_mont(F, uniform), x0, y0);
    map_to_curve(F, P.S, wide_to_mont(F, uniform + 64), x1, y1);
    add_affine(F, x0, y0, x1, y1, X, Y, Z);
    Fe zi = finv0(F, Z);
    Fe zi2 = fsqr(F, zi);
    Fe ax = from_mont(F, fmul(F, X, zi2));
    Fe ay = from_mont(F, fmul(F, Y, fmul(F, zi2, zi)));
    for (int i = 0; i < 4; i++) {
        out[i] = ax.d[i];
        out[4 + i] = ay.d[i];
    }
}

Fe raw(const u64 *w) {
    Fe a;
    for (int i = 0; i < 4; i++) a.d[i] = w[i];
    return a;
}

// keygen.cpp's arguments: fparams p[4], n0inv, r2[4], one[4], c_init[4]
// (raw words, the last two Montgomery); svdw Z, c1..c4, b raw; q12 bytes
Params load_params(const u64 *fparams, const u8 *q12_bytes, int s, const u64 *svdw,
                   const u8 *dst, size_t dst_len) {
    Params P;
    Field &F = P.F;
    F.p = raw(fparams);
    F.n0inv = fparams[4];
    F.r2 = raw(fparams + 5);
    F.one = raw(fparams + 9);
    F.c_init = raw(fparams + 13);
    std::memcpy(F.q12_bytes, q12_bytes, 32);
    Fe pm2 = F.p;
    pm2.d[0] -= 2;  // p is odd and above 2
    std::memcpy(F.pm2_bytes, pm2.d, 32);
    F.s = s;
    Fe *fields[6] = {&P.S.Z, &P.S.c1, &P.S.c2, &P.S.c3, &P.S.c4, &P.S.b};
    for (int i = 0; i < 6; i++) *fields[i] = fmul(F, F.r2, raw(svdw + 4 * i));
    std::memcpy(P.dst.bytes, dst, dst_len);
    P.dst.bytes[dst_len] = u8(dst_len);
    P.dst.len = u32(dst_len + 1);
    return P;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(128)
    keygen_kernel(const __grid_constant__ Params P, const u8 *stream, u64 *out, size_t n) {
    size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i < n) key_row(P, stream + 32 * i, out + 8 * i);
}
#endif

}  // namespace

extern "C" {

#ifdef __CUDACC__
// The number of CUDA devices this process sees (0 where the runtime fails).
int mira_keygen_cuda_devices() {
    int count = 0;
    return cudaGetDeviceCount(&count) == cudaSuccess ? count : 0;
}

// keygen.cpp's mira_keygen_mapped on the current device: n rows from the
// host's 32n stream bytes into the host's 8n words.  Copies in and out
// itself and returns when the rows are on the host: 0, or the CUDA error.
// q_bytes is unused (Tonelli-Shanks needs (q - 1)/2 alone); it keeps the
// host entry's arguments.
int mira_keygen_cuda(const u8 *stream, size_t n, const u64 *fparams, const u8 *q_bytes,
                     const u8 *q12_bytes, int s, const u64 *svdw, const u8 *dst,
                     size_t dst_len, u64 *out) {
    (void)q_bytes;
    if (n == 0) return 0;
    if (dst_len > 255) return int(cudaErrorInvalidValue);
    Params P = load_params(fparams, q12_bytes, s, svdw, dst, dst_len);
    u8 *d_stream = nullptr;
    u64 *d_out = nullptr;
    cudaError_t e = cudaMalloc(&d_stream, 32 * n);
    if (e == cudaSuccess) e = cudaMalloc(&d_out, 64 * n);
    if (e == cudaSuccess) e = cudaMemcpy(d_stream, stream, 32 * n, cudaMemcpyHostToDevice);
    if (e == cudaSuccess) {
        keygen_kernel<<<unsigned((n + 127) / 128), 128>>>(P, d_stream, d_out, n);
        e = cudaGetLastError();
    }
    if (e == cudaSuccess) e = cudaMemcpy(out, d_out, 64 * n, cudaMemcpyDeviceToHost);
    cudaFree(d_stream);
    cudaFree(d_out);
    return int(e);
}
#else
// The same rows on the host, one point after another: the tests' view of the
// card's arithmetic.
void mira_keygen_host(const u8 *stream, size_t n, const u64 *fparams, const u8 *q_bytes,
                      const u8 *q12_bytes, int s, const u64 *svdw, const u8 *dst,
                      size_t dst_len, u64 *out) {
    (void)q_bytes;
    Params P = load_params(fparams, q12_bytes, s, svdw, dst, dst_len);
    for (size_t i = 0; i < n; i++) key_row(P, stream + 32 * i, out + 8 * i);
}
#endif

}  // extern "C"
