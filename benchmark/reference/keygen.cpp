// Frozen copy of native/keygen.cpp (the native commitment-key generator), kept
// here so that the benchmark makes its own key files and its reference does
// not change when the program's copy does.  Built by reference/keys.py.
//
// Commitment-key generator: Shake256 XOF -> expand_message_xmd(SHA-256) ->
// SVDW hash_to_curve, the native twin of mira_tpu/curves/svdw.py and
// ops/commitment.py:setup.
//
// Role parity: the reference derives n = 2^k generators by streaming 32
// uniform bytes per point from a Shake256 XOF and mapping each through
// halo2curves' hash_to_curve("from_uniform_bytes"), parallelized with rayon
// (Mira's src/commitment.rs).  The round-1 python path does
// the same sequentially with python-int pow() — infeasible beyond ~2^16.
// This module reproduces the exact python semantics over a runtime-
// parameterized 4x64 Montgomery field (bn254 Fq for bn254 keys, bn254 Fr
// for grumpkin keys), threaded over points.
//
// All field parameters, SVDW constants and Tonelli-Shanks data are passed
// in raw (non-Montgomery) from python so this file holds no curve-specific
// constants.  Output points are affine raw 4x64 LE words.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread keygen.cpp -o libmirakeygen.so

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

using u64 = uint64_t;
using u128 = __uint128_t;
using u8 = uint8_t;

namespace {

// ---------------------------------------------------------------------------
// Keccak-f[1600] + SHAKE-256 (FIPS 202), matching hashlib.shake_256.
// ---------------------------------------------------------------------------

constexpr u64 KECCAK_RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808aull,
    0x8000000080008000ull, 0x000000000000808bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000aull,
    0x000000008000808bull, 0x800000000000008bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800aull, 0x800000008000000aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

inline u64 rotl64(u64 x, int n) { return (x << n) | (x >> (64 - n)); }

void keccak_f(u64 st[25]) {
    for (int round = 0; round < 24; round++) {
        u64 bc[5];
        // theta
        for (int i = 0; i < 5; i++)
            bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
        for (int i = 0; i < 5; i++) {
            u64 t = bc[(i + 4) % 5] ^ rotl64(bc[(i + 1) % 5], 1);
            for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
        }
        // rho + pi
        u64 t = st[1];
        static constexpr int piln[24] = {10, 7,  11, 17, 18, 3,  5,  16,
                                         8,  21, 24, 4,  15, 23, 19, 13,
                                         12, 2,  20, 14, 22, 9,  6,  1};
        static constexpr int rotc[24] = {1,  3,  6,  10, 15, 21, 28, 36,
                                         45, 55, 2,  14, 27, 41, 56, 8,
                                         25, 43, 62, 18, 39, 61, 20, 44};
        for (int i = 0; i < 24; i++) {
            int j = piln[i];
            u64 tmp = st[j];
            st[j] = rotl64(t, rotc[i]);
            t = tmp;
        }
        // chi
        for (int j = 0; j < 25; j += 5) {
            u64 row[5];
            for (int i = 0; i < 5; i++) row[i] = st[j + i];
            for (int i = 0; i < 5; i++)
                st[j + i] = row[i] ^ ((~row[(i + 1) % 5]) & row[(i + 2) % 5]);
        }
        st[0] ^= KECCAK_RC[round];
    }
}

// SHAKE-256 XOF: rate 136 bytes, domain byte 0x1F.
struct Shake256 {
    u64 st[25];
    u8 buf[136];
    size_t buf_len = 0;
    size_t squeeze_pos = 136;  // forces first permute on squeeze
    bool finalized = false;

    Shake256() { std::memset(st, 0, sizeof(st)); }

    void absorb(const u8 *data, size_t len) {
        while (len > 0) {
            size_t take = 136 - buf_len;
            if (take > len) take = len;
            std::memcpy(buf + buf_len, data, take);
            buf_len += take;
            data += take;
            len -= take;
            if (buf_len == 136) {
                for (int i = 0; i < 17; i++) {
                    u64 w;
                    std::memcpy(&w, buf + 8 * i, 8);
                    st[i] ^= w;
                }
                keccak_f(st);
                buf_len = 0;
            }
        }
    }

    void finalize() {
        std::memset(buf + buf_len, 0, 136 - buf_len);
        buf[buf_len] ^= 0x1F;
        buf[135] ^= 0x80;
        for (int i = 0; i < 17; i++) {
            u64 w;
            std::memcpy(&w, buf + 8 * i, 8);
            st[i] ^= w;
        }
        keccak_f(st);
        squeeze_pos = 0;
        finalized = true;
    }

    void squeeze(u8 *out, size_t len) {
        if (!finalized) finalize();
        while (len > 0) {
            if (squeeze_pos == 136) {
                keccak_f(st);
                squeeze_pos = 0;
            }
            size_t take = 136 - squeeze_pos;
            if (take > len) take = len;
            std::memcpy(out, reinterpret_cast<u8 *>(st) + squeeze_pos, take);
            squeeze_pos += take;
            out += take;
            len -= take;
        }
    }
};

// ---------------------------------------------------------------------------
// SHA-256 (FIPS 180-4) for expand_message_xmd.
// ---------------------------------------------------------------------------

constexpr uint32_t SHA_K[64] = {
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

inline uint32_t rotr32(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

struct Sha256 {
    uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                     0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
    u8 buf[64];
    size_t buf_len = 0;
    u64 total = 0;

    void block(const u8 *p) {
        uint32_t w[64];
        for (int i = 0; i < 16; i++)
            w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
                   (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
        for (int i = 16; i < 64; i++) {
            uint32_t s0 = rotr32(w[i - 15], 7) ^ rotr32(w[i - 15], 18) ^
                          (w[i - 15] >> 3);
            uint32_t s1 = rotr32(w[i - 2], 17) ^ rotr32(w[i - 2], 19) ^
                          (w[i - 2] >> 10);
            w[i] = w[i - 16] + s0 + w[i - 7] + s1;
        }
        uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
                 g = h[6], hh = h[7];
        for (int i = 0; i < 64; i++) {
            uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
            uint32_t ch = (e & f) ^ ((~e) & g);
            uint32_t t1 = hh + S1 + ch + SHA_K[i] + w[i];
            uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
            uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
            uint32_t t2 = S0 + maj;
            hh = g; g = f; f = e; e = d + t1;
            d = c; c = b; b = a; a = t1 + t2;
        }
        h[0] += a; h[1] += b; h[2] += c; h[3] += d;
        h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
    }

    void update(const u8 *data, size_t len) {
        total += len;
        while (len > 0) {
            size_t take = 64 - buf_len;
            if (take > len) take = len;
            std::memcpy(buf + buf_len, data, take);
            buf_len += take;
            data += take;
            len -= take;
            if (buf_len == 64) {
                block(buf);
                buf_len = 0;
            }
        }
    }

    void digest(u8 out[32]) {
        u64 bits = total * 8;
        u8 pad[72];
        size_t pad_len = (buf_len < 56) ? (56 - buf_len) : (120 - buf_len);
        pad[0] = 0x80;
        std::memset(pad + 1, 0, pad_len - 1);
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

void sha256(const u8 *data, size_t len, u8 out[32]) {
    Sha256 h;
    h.update(data, len);
    h.digest(out);
}

// expand_message_xmd(SHA-256), RFC 9380 §5.3.1 — twin of
// mira_tpu/curves/svdw.py:expand_message_xmd.
void expand_message_xmd(const u8 *msg, size_t msg_len, const u8 *dst,
                        size_t dst_len, size_t len_in_bytes, u8 *out) {
    const size_t b_in_bytes = 32, s_in_bytes = 64;
    size_t ell = (len_in_bytes + b_in_bytes - 1) / b_in_bytes;
    u8 dst_prime[256];
    std::memcpy(dst_prime, dst, dst_len);
    dst_prime[dst_len] = u8(dst_len);
    size_t dstp_len = dst_len + 1;

    Sha256 h0;
    u8 z_pad[64] = {0};
    h0.update(z_pad, s_in_bytes);
    h0.update(msg, msg_len);
    u8 lib[3] = {u8(len_in_bytes >> 8), u8(len_in_bytes & 0xff), 0};
    h0.update(lib, 3);
    h0.update(dst_prime, dstp_len);
    u8 b0[32];
    h0.digest(b0);

    u8 prev[32];
    {
        Sha256 h1;
        h1.update(b0, 32);
        u8 one = 1;
        h1.update(&one, 1);
        h1.update(dst_prime, dstp_len);
        h1.digest(prev);
    }
    size_t copied = 0;
    size_t take = len_in_bytes < 32 ? len_in_bytes : 32;
    std::memcpy(out, prev, take);
    copied = take;
    for (size_t i = 2; i <= ell; i++) {
        u8 x[32];
        for (int j = 0; j < 32; j++) x[j] = b0[j] ^ prev[j];
        Sha256 hi;
        hi.update(x, 32);
        u8 ib = u8(i);
        hi.update(&ib, 1);
        hi.update(dst_prime, dstp_len);
        hi.digest(prev);
        take = len_in_bytes - copied < 32 ? len_in_bytes - copied : 32;
        std::memcpy(out + copied, prev, take);
        copied += take;
    }
}

// ---------------------------------------------------------------------------
// Runtime-parameterized 4x64 Montgomery field (R = 2^256).
// ---------------------------------------------------------------------------

struct FieldParams {
    u64 p[4];
    u64 n0inv;     // -p^-1 mod 2^64
    u64 r2[4];     // R^2 mod p
    u64 one_m[4];  // R mod p (Montgomery one)
    // Tonelli-Shanks data
    u8 q_bytes[32];        // q = (p-1) / 2^s, little-endian
    u8 q12_bytes[32];      // (q-1)/2, little-endian
    int s;                 // 2-adicity
    u64 c_init[4];         // z^q in Montgomery form (z = quadratic non-residue)
};

struct Fe {
    u64 d[4];
};

inline bool geq(const u64 a[4], const u64 b[4]) {
    for (int i = 3; i >= 0; i--)
        if (a[i] != b[i]) return a[i] > b[i];
    return true;
}

inline void fe_add(const FieldParams &F, const Fe &a, const Fe &b, Fe &o) {
    u64 carry = 0;
    for (int i = 0; i < 4; i++) {
        u64 s = a.d[i] + b.d[i];
        u64 c1 = s < a.d[i];
        u64 s2 = s + carry;
        carry = c1 | (s2 < s);
        o.d[i] = s2;
    }
    if (carry || geq(o.d, F.p)) {
        u64 borrow = 0;
        for (int i = 0; i < 4; i++) {
            u64 d = o.d[i] - F.p[i];
            u64 b1 = o.d[i] < F.p[i];
            u64 d2 = d - borrow;
            borrow = b1 | (d2 > d);
            o.d[i] = d2;
        }
    }
}

inline void fe_sub(const FieldParams &F, const Fe &a, const Fe &b, Fe &o) {
    u64 borrow = 0;
    u64 t[4];
    for (int i = 0; i < 4; i++) {
        u64 d = a.d[i] - b.d[i];
        u64 b1 = a.d[i] < b.d[i];
        u64 d2 = d - borrow;
        borrow = b1 | (d2 > d);
        t[i] = d2;
    }
    if (borrow) {
        u64 carry = 0;
        for (int i = 0; i < 4; i++) {
            u64 s = t[i] + F.p[i];
            u64 c1 = s < t[i];
            u64 s2 = s + carry;
            carry = c1 | (s2 < s);
            t[i] = s2;
        }
    }
    std::memcpy(o.d, t, sizeof(t));
}

inline void fe_neg(const FieldParams &F, const Fe &a, Fe &o) {
    Fe z{};
    fe_sub(F, z, a, o);
}

// CIOS Montgomery multiplication
inline void fe_mul(const FieldParams &F, const Fe &a, const Fe &b, Fe &o) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u64 carry = 0;
        u64 ai = a.d[i];
        for (int j = 0; j < 4; j++) {
            u128 cur = (u128)ai * b.d[j] + t[j] + carry;
            t[j] = (u64)cur;
            carry = (u64)(cur >> 64);
        }
        u128 cur = (u128)t[4] + carry;
        t[4] = (u64)cur;
        t[5] = (u64)(cur >> 64);

        u64 m = t[0] * F.n0inv;
        cur = (u128)m * F.p[0] + t[0];
        carry = (u64)(cur >> 64);
        for (int j = 1; j < 4; j++) {
            cur = (u128)m * F.p[j] + t[j] + carry;
            t[j - 1] = (u64)cur;
            carry = (u64)(cur >> 64);
        }
        cur = (u128)t[4] + carry;
        t[3] = (u64)cur;
        t[4] = t[5] + (u64)(cur >> 64);
        t[5] = 0;
    }
    std::memcpy(o.d, t, 4 * sizeof(u64));
    if (t[4] || geq(o.d, F.p)) {
        u64 borrow = 0;
        for (int i = 0; i < 4; i++) {
            u64 d = o.d[i] - F.p[i];
            u64 b1 = o.d[i] < F.p[i];
            u64 d2 = d - borrow;
            borrow = b1 | (d2 > d);
            o.d[i] = d2;
        }
    }
}

inline void fe_sqr(const FieldParams &F, const Fe &a, Fe &o) { fe_mul(F, a, a, o); }

inline void fe_to_mont(const FieldParams &F, const Fe &a, Fe &o) {
    Fe r2;
    std::memcpy(r2.d, F.r2, sizeof(r2.d));
    fe_mul(F, a, r2, o);
}

inline void fe_from_mont(const FieldParams &F, const Fe &a, Fe &o) {
    Fe one{};
    one.d[0] = 1;
    fe_mul(F, a, one, o);
}

inline bool fe_is_zero(const Fe &a) {
    return (a.d[0] | a.d[1] | a.d[2] | a.d[3]) == 0;
}

inline bool fe_eq(const Fe &a, const Fe &b) {
    return a.d[0] == b.d[0] && a.d[1] == b.d[1] && a.d[2] == b.d[2] &&
           a.d[3] == b.d[3];
}

// a^e for byte-LE exponent, Montgomery in/out (4-bit fixed window)
inline void fe_pow_bytes(const FieldParams &F, const Fe &a, const u8 *e,
                         int elen, Fe &o) {
    // table[i] = a^i
    Fe table[16];
    std::memcpy(table[0].d, F.one_m, sizeof(F.one_m));
    table[1] = a;
    for (int i = 2; i < 16; i++) fe_mul(F, table[i - 1], a, table[i]);
    Fe acc;
    std::memcpy(acc.d, F.one_m, sizeof(F.one_m));
    bool started = false;
    for (int i = elen - 1; i >= 0; i--) {
        for (int half = 1; half >= 0; half--) {
            int nib = (e[i] >> (4 * half)) & 0xF;
            if (started) {
                fe_sqr(F, acc, acc);
                fe_sqr(F, acc, acc);
                fe_sqr(F, acc, acc);
                fe_sqr(F, acc, acc);
                if (nib) fe_mul(F, acc, table[nib], acc);
            } else if (nib) {
                acc = table[nib];
                started = true;
            }
        }
    }
    o = acc;
}

// Fermat inverse (0 -> 0): a^(p-2)
inline void fe_inv0(const FieldParams &F, const Fe &a, Fe &o) {
    if (fe_is_zero(a)) {
        o = Fe{};
        return;
    }
    u64 e[4];
    std::memcpy(e, F.p, sizeof(e));
    e[0] -= 2;
    fe_pow_bytes(F, a, reinterpret_cast<u8 *>(e), 32, o);
}

// Tonelli-Shanks square root with non-residue detection.
// Returns true and writes a root (Montgomery) if a is a QR; false otherwise.
// One fe_pow + s squarings + the T-S loop.
inline bool fe_sqrt(const FieldParams &F, const Fe &a, Fe &root) {
    if (fe_is_zero(a)) {
        root = Fe{};
        return true;
    }
    Fe w;  // a^((q-1)/2)
    fe_pow_bytes(F, a, F.q12_bytes, 32, w);
    Fe x, t;
    fe_mul(F, w, a, x);   // a^((q+1)/2)
    fe_mul(F, w, x, t);   // a^q
    // legendre = t^(2^(s-1)); also drives the T-S loop
    Fe leg = t;
    for (int i = 0; i < F.s - 1; i++) fe_sqr(F, leg, leg);
    Fe one_m;
    std::memcpy(one_m.d, F.one_m, sizeof(F.one_m));
    if (!fe_eq(leg, one_m)) return false;
    Fe c;
    std::memcpy(c.d, F.c_init, sizeof(F.c_init));
    int m = F.s;
    while (!fe_eq(t, one_m)) {
        // least i with t^(2^i) == 1
        Fe tt = t;
        int i = 0;
        while (!fe_eq(tt, one_m)) {
            fe_sqr(F, tt, tt);
            i++;
        }
        Fe b = c;
        for (int j = 0; j < m - i - 1; j++) fe_sqr(F, b, b);
        fe_mul(F, x, b, x);
        fe_sqr(F, b, c);
        fe_mul(F, t, c, t);
        m = i;
    }
    root = x;
    return true;
}

// sgn0: parity of the canonical (non-Montgomery) value
inline int fe_sgn0(const FieldParams &F, const Fe &a_mont) {
    Fe raw;
    fe_from_mont(F, a_mont, raw);
    return int(raw.d[0] & 1);
}

// ---------------------------------------------------------------------------
// SVDW map-to-curve (RFC 9380 §6.6.1), a = 0 — twin of
// mira_tpu/curves/svdw.py:map_to_curve_svdw.  All SVDW constants Montgomery.
// ---------------------------------------------------------------------------

struct SvdwParams {
    Fe Z, c1, c2, c3, c4, b;
};

struct JacPoint {
    Fe x, y, z;  // z == 0 -> infinity
};

// map a single field element u (Montgomery) to an affine point (Montgomery)
void map_to_curve_svdw(const FieldParams &F, const SvdwParams &S, const Fe &u,
                       Fe &ox, Fe &oy) {
    Fe one_m;
    std::memcpy(one_m.d, F.one_m, sizeof(F.one_m));
    Fe tv1, tv2, tv3, tv4;
    fe_sqr(F, u, tv1);
    fe_mul(F, tv1, S.c1, tv1);
    fe_add(F, one_m, tv1, tv2);
    fe_sub(F, one_m, tv1, tv1);
    fe_mul(F, tv1, tv2, tv3);
    fe_inv0(F, tv3, tv3);
    fe_mul(F, u, tv1, tv4);
    fe_mul(F, tv4, tv3, tv4);
    fe_mul(F, tv4, S.c3, tv4);

    auto gx_of = [&](const Fe &x, Fe &gx) {
        fe_sqr(F, x, gx);
        fe_mul(F, gx, x, gx);
        fe_add(F, gx, S.b, gx);
    };

    Fe x1, x2, x3, gx, y;
    fe_sub(F, S.c2, tv4, x1);
    gx_of(x1, gx);
    Fe x = x1;
    bool found = fe_sqrt(F, gx, y);
    if (!found) {
        fe_add(F, S.c2, tv4, x2);
        gx_of(x2, gx);
        x = x2;
        found = fe_sqrt(F, gx, y);
    }
    if (!found) {
        fe_sqr(F, tv2, x3);
        fe_mul(F, x3, tv3, x3);
        fe_sqr(F, x3, x3);
        fe_mul(F, x3, S.c4, x3);
        fe_add(F, x3, S.Z, x3);
        x = x3;
        gx_of(x3, gx);
        bool ok = fe_sqrt(F, gx, y);
        (void)ok;  // guaranteed square by SVDW construction
    }
    if (fe_sgn0(F, u) != fe_sgn0(F, y)) fe_neg(F, y, y);
    ox = x;
    oy = y;
}

// Jacobian complete-enough addition of two affine points (either may be inf
// encoded as z=0 upstream; here affine inputs are never inf since SVDW never
// outputs infinity, and q0 == -q1 has negligible probability but is handled).
void jac_add_affine(const FieldParams &F, const Fe &x1, const Fe &y1,
                    const Fe &x2, const Fe &y2, JacPoint &o) {
    Fe one_m;
    std::memcpy(one_m.d, F.one_m, sizeof(F.one_m));
    if (fe_eq(x1, x2)) {
        Fe negy2;
        fe_neg(F, y2, negy2);
        if (fe_eq(y1, negy2)) {
            o.x = one_m;
            o.y = one_m;
            o.z = Fe{};
            return;
        }
        // doubling
        Fe xx, yy, yyyy, s, m, t;
        fe_sqr(F, x1, xx);
        fe_sqr(F, y1, yy);
        fe_sqr(F, yy, yyyy);
        fe_add(F, x1, yy, s);
        fe_sqr(F, s, s);
        fe_sub(F, s, xx, s);
        fe_sub(F, s, yyyy, s);
        fe_add(F, s, s, s);
        fe_add(F, xx, xx, m);
        fe_add(F, m, xx, m);
        fe_sqr(F, m, t);
        fe_sub(F, t, s, t);
        fe_sub(F, t, s, t);
        o.x = t;
        Fe y8;
        fe_add(F, yyyy, yyyy, y8);
        fe_add(F, y8, y8, y8);
        fe_add(F, y8, y8, y8);
        Fe sx;
        fe_sub(F, s, t, sx);
        fe_mul(F, m, sx, o.y);
        fe_sub(F, o.y, y8, o.y);
        fe_add(F, y1, y1, o.z);
        return;
    }
    Fe h, r, hh, hhh, v;
    fe_sub(F, x2, x1, h);
    fe_sub(F, y2, y1, r);
    fe_sqr(F, h, hh);
    fe_mul(F, hh, h, hhh);
    fe_mul(F, x1, hh, v);
    Fe rr;
    fe_sqr(F, r, rr);
    fe_sub(F, rr, hhh, o.x);
    fe_sub(F, o.x, v, o.x);
    fe_sub(F, o.x, v, o.x);
    Fe vx;
    fe_sub(F, v, o.x, vx);
    fe_mul(F, r, vx, o.y);
    Fe y1h;
    fe_mul(F, y1, hhh, y1h);
    fe_sub(F, o.y, y1h, o.y);
    o.z = h;
}

// ---------------------------------------------------------------------------
// Per-point pipeline + threading
// ---------------------------------------------------------------------------

struct Job {
    const FieldParams *F;
    const SvdwParams *S;
    const u8 *stream;     // 32 bytes per point
    const u8 *dst;
    size_t dst_len;
    u64 *out;             // 8 u64 per point (x raw, y raw)
    size_t begin, end;
};

// decode 64 LE bytes mod p into Montgomery form:
// v = lo + hi*2^256; mont(v) = mont_mul(lo, R2) + mont_mul(mont_mul(hi, R2), R2)
void wide_to_mont(const FieldParams &F, const u8 *bytes64, Fe &o) {
    Fe lo, hi;
    std::memcpy(lo.d, bytes64, 32);
    std::memcpy(hi.d, bytes64 + 32, 32);
    Fe r2;
    std::memcpy(r2.d, F.r2, sizeof(r2.d));
    Fe mlo, mhi;
    fe_mul(F, lo, r2, mlo);   // lo*R
    fe_mul(F, hi, r2, mhi);   // hi*R
    fe_mul(F, mhi, r2, mhi);  // hi*R*R*R^-1... = hi*R^2*R^{-1}*R = hi*R^2? no:
    // fe_mul(a,b) = a*b*R^{-1}.  mhi1 = hi*R2*R^{-1} = hi*R.  mhi2 =
    // (hi*R)*R2*R^{-1} = hi*R^2 = mont(hi*R) = mont(hi*2^256).  Correct.
    fe_add(F, mlo, mhi, o);
}

void run_job(Job j) {
    const FieldParams &F = *j.F;
    const SvdwParams &S = *j.S;
    size_t n = j.end - j.begin;
    std::vector<JacPoint> acc(n);
    for (size_t idx = 0; idx < n; idx++) {
        const u8 *msg = j.stream + 32 * (j.begin + idx);
        u8 uniform[128];
        expand_message_xmd(msg, 32, j.dst, j.dst_len, 128, uniform);
        Fe u0, u1;
        wide_to_mont(F, uniform, u0);
        wide_to_mont(F, uniform + 64, u1);
        Fe x0, y0, x1, y1;
        map_to_curve_svdw(F, S, u0, x0, y0);
        map_to_curve_svdw(F, S, u1, x1, y1);
        jac_add_affine(F, x0, y0, x1, y1, acc[idx]);
    }
    // batch-normalize: invert all z at once (Montgomery's trick)
    std::vector<Fe> prefix(n);
    Fe run;
    std::memcpy(run.d, F.one_m, sizeof(F.one_m));
    for (size_t i = 0; i < n; i++) {
        prefix[i] = run;
        if (!fe_is_zero(acc[i].z)) fe_mul(F, run, acc[i].z, run);
    }
    Fe inv;
    fe_inv0(F, run, inv);
    for (size_t i = n; i-- > 0;) {
        Fe zi;
        if (fe_is_zero(acc[i].z)) {
            zi = Fe{};
        } else {
            fe_mul(F, inv, prefix[i], zi);
            fe_mul(F, inv, acc[i].z, inv);
        }
        Fe zi2, zi3, ax, ay;
        fe_sqr(F, zi, zi2);
        fe_mul(F, zi2, zi, zi3);
        fe_mul(F, acc[i].x, zi2, ax);
        fe_mul(F, acc[i].y, zi3, ay);
        Fe rx, ry;
        fe_from_mont(F, ax, rx);
        fe_from_mont(F, ay, ry);
        std::memcpy(j.out + 8 * (j.begin + i), rx.d, 32);
        std::memcpy(j.out + 8 * (j.begin + i) + 4, ry.d, 32);
    }
}

void load_field_params(const u64 *fp, const u8 *qb, const u8 *q12b, int s,
                       FieldParams &F) {
    std::memcpy(F.p, fp, 32);
    F.n0inv = fp[4];
    std::memcpy(F.r2, fp + 5, 32);
    std::memcpy(F.one_m, fp + 9, 32);
    std::memcpy(F.c_init, fp + 13, 32);
    std::memcpy(F.q_bytes, qb, 32);
    std::memcpy(F.q12_bytes, q12b, 32);
    F.s = s;
}

}  // namespace

extern "C" {

// Generate n commitment-key generators.
//   label: XOF seed (reference commitment.rs:58: Shake256 seeded with label)
//   fparams: p[4], n0inv, r2[4], one_m[4], c_init[4]  (17 u64)
//   q_bytes / q12_bytes: 32-byte LE q and (q-1)/2;  s: 2-adicity
//   svdw: Z, c1, c2, c3, c4, b — six raw 4x64 values (24 u64)
//   dst: domain separation tag
//   out: n * 8 u64 — affine (x, y) raw little-endian words
void mira_keygen(const u8 *label, size_t label_len, size_t n,
                 const u64 *fparams, const u8 *q_bytes, const u8 *q12_bytes,
                 int s, const u64 *svdw, const u8 *dst, size_t dst_len,
                 u64 *out, int nthreads) {
    FieldParams F;
    load_field_params(fparams, q_bytes, q12_bytes, s, F);
    SvdwParams S;
    const u64 *sp = svdw;
    Fe *fields[6] = {&S.Z, &S.c1, &S.c2, &S.c3, &S.c4, &S.b};
    for (int i = 0; i < 6; i++) {
        Fe raw;
        std::memcpy(raw.d, sp + 4 * i, 32);
        fe_to_mont(F, raw, *fields[i]);
    }

    // squeeze the whole stream (sequential; ~150 MB/s, fine up to 2^22;
    // larger keys should call in chunks via mira_keygen_stream)
    std::vector<u8> stream(32 * n);
    Shake256 xof;
    xof.absorb(label, label_len);
    xof.squeeze(stream.data(), stream.size());

    if (nthreads < 1) nthreads = 1;
    std::vector<std::thread> threads;
    size_t chunk = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
        size_t b = t * chunk;
        size_t e = b + chunk < n ? b + chunk : n;
        if (b >= e) break;
        threads.emplace_back(run_job,
                             Job{&F, &S, stream.data(), dst, dst_len, out, b, e});
    }
    for (auto &th : threads) th.join();
}

// Chunked variant: caller supplies the 32*n-byte uniform stream slice
// (e.g. squeezed host-side in chunks for very large keys).
void mira_keygen_mapped(const u8 *stream, size_t n, const u64 *fparams,
                        const u8 *q_bytes, const u8 *q12_bytes, int s,
                        const u64 *svdw, const u8 *dst, size_t dst_len,
                        u64 *out, int nthreads) {
    FieldParams F;
    load_field_params(fparams, q_bytes, q12_bytes, s, F);
    SvdwParams S;
    Fe *fields[6] = {&S.Z, &S.c1, &S.c2, &S.c3, &S.c4, &S.b};
    for (int i = 0; i < 6; i++) {
        Fe raw;
        std::memcpy(raw.d, svdw + 4 * i, 32);
        fe_to_mont(F, raw, *fields[i]);
    }
    if (nthreads < 1) nthreads = 1;
    std::vector<std::thread> threads;
    size_t chunk = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
        size_t b = t * chunk;
        size_t e = b + chunk < n ? b + chunk : n;
        if (b >= e) break;
        threads.emplace_back(run_job, Job{&F, &S, stream, dst, dst_len, out, b, e});
    }
    for (auto &th : threads) th.join();
}

// Batch on-curve check: y^2 == x^3 + b for n raw affine points.
// Returns the number of FAILING points (0 = all on curve).
size_t mira_on_curve_check(const u64 *xy, size_t n, const u64 *fparams,
                           const u64 *b_raw, int nthreads) {
    FieldParams F;
    std::memcpy(F.p, fparams, 32);
    F.n0inv = fparams[4];
    std::memcpy(F.r2, fparams + 5, 32);
    std::memcpy(F.one_m, fparams + 9, 32);
    Fe b_m;
    Fe braw;
    std::memcpy(braw.d, b_raw, 32);
    fe_to_mont(F, braw, b_m);
    if (nthreads < 1) nthreads = 1;
    std::vector<size_t> fails(nthreads, 0);
    std::vector<std::thread> threads;
    size_t chunk = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
        size_t bg = t * chunk;
        size_t en = bg + chunk < n ? bg + chunk : n;
        if (bg >= en) break;
        threads.emplace_back([&, t, bg, en]() {
            for (size_t i = bg; i < en; i++) {
                Fe x, y, xm, ym, lhs, rhs;
                std::memcpy(x.d, xy + 8 * i, 32);
                std::memcpy(y.d, xy + 8 * i + 4, 32);
                fe_to_mont(F, x, xm);
                fe_to_mont(F, y, ym);
                fe_sqr(F, ym, lhs);
                fe_sqr(F, xm, rhs);
                fe_mul(F, rhs, xm, rhs);
                fe_add(F, rhs, b_m, rhs);
                if (!fe_eq(lhs, rhs)) fails[t]++;
            }
        });
    }
    for (auto &th : threads) th.join();
    size_t total = 0;
    for (auto f : fails) total += f;
    return total;
}

}  // extern "C"
