// Witness-tape VM of the port: executes the straight-line witness-generation
// program captured by table/tape.py (see ivc/tape_runner.py), with the
// contract of the shared VM native/tape_vm.cpp: the same C entry arguments
// (plus one optional output, the route counts), register layout, emit table
// and error codes, and output equal to it bit for bit.
//
// Registers are sign+magnitude, magnitude = W 64-bit words (640 bits), the
// words at and above `len` always zero.  Python floor-division semantics.
//
// Routes.  A modular op (MOD, ISZM, INVMOD) takes a fast route where the
// divisor and operand allow one:
//   - divisor odd, of k <= 4 words and not 1, operand of at most 2k words:
//     the remainder by Barrett reduction (Menezes et al., Handbook of Applied
//     Cryptography, Algorithm 14.42, base 2^64) at exact operand widths of k
//     and 2k words; the inverse by Bernstein–Yang divsteps ("Fast
//     constant-time gcd computation and modular inversion", 2019) in their
//     variable-time form, 62 divsteps a batch on signed 62-bit limbs, from
//     the batch's 2x2 transition matrix;
//   - divisor a power of two (MOD, ISZM): the remainder is the operand's low
//     bits.
// Every other modular op, and every DIV, takes the general 640-bit route
// (Barrett by floor(2^640 / m), binary extended gcd), the shared VM's code.
// Both routes give the unique floor-semantics remainder and the unique
// inverse in [0, m), so the output does not depend on the route.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 tape_vm.cpp -o libmiratape.so

#include <cstdint>
#include <cstring>
#include <vector>

using u64 = uint64_t;
using i64 = int64_t;
using u128 = __uint128_t;
using i128 = __int128;

namespace {

constexpr int W = 10;        // 640-bit register magnitude
constexpr int WMUL = 2 * W;  // scratch for products / barrett

struct Reg {
    u64 d[W];
    int16_t len;  // number of significant words (0 => value 0)
    int16_t neg;  // 1 => negative
};

// -1 / 0 / +1 comparing magnitudes
inline int cmp_mag(const u64 *a, int alen, const u64 *b, int blen) {
    if (alen != blen) return alen < blen ? -1 : 1;
    for (int i = alen - 1; i >= 0; i--)
        if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
    return 0;
}

inline int norm_len(const u64 *a, int n) {
    while (n > 0 && a[n - 1] == 0) n--;
    return n;
}

// ---------------------------------------------------------------------------
// General route: variable-width magnitudes up to 640 bits.

// out = a + b (magnitudes); returns length; out may alias a
inline int add_mag(const u64 *a, int alen, const u64 *b, int blen, u64 *out,
                   int maxw) {
    int n = alen > blen ? alen : blen;
    u64 carry = 0;
    for (int i = 0; i < n; i++) {
        u64 av = i < alen ? a[i] : 0, bv = i < blen ? b[i] : 0;
        u64 s = av + bv;
        u64 c1 = s < av;
        u64 s2 = s + carry;
        carry = c1 | (s2 < s);
        out[i] = s2;
    }
    if (carry) {
        if (n >= maxw) return -1;  // overflow
        out[n++] = carry;
    }
    return n;
}

// out = a - b, requires |a| >= |b|
inline int sub_mag(const u64 *a, int alen, const u64 *b, int blen, u64 *out) {
    u64 borrow = 0;
    for (int i = 0; i < alen; i++) {
        u64 av = a[i], bv = i < blen ? b[i] : 0;
        u64 d = av - bv;
        u64 b1 = av < bv;
        u64 d2 = d - borrow;
        borrow = b1 | (d2 > d);
        out[i] = d2;
    }
    return norm_len(out, alen);
}

// out = a * b (schoolbook), returns length; out must not alias, cap maxw
inline int mul_mag(const u64 *a, int alen, const u64 *b, int blen, u64 *out,
                   int maxw) {
    if (alen == 0 || blen == 0) return 0;
    int n = alen + blen;
    if (n > maxw) return -1;
    std::memset(out, 0, sizeof(u64) * n);
    for (int i = 0; i < alen; i++) {
        u64 carry = 0;
        u64 ai = a[i];
        for (int j = 0; j < blen; j++) {
            u128 cur = (u128)ai * b[j] + out[i + j] + carry;
            out[i + j] = (u64)cur;
            carry = (u64)(cur >> 64);
        }
        out[i + blen] = carry;
    }
    return norm_len(out, n);
}

inline int shl_mag(const u64 *a, int alen, unsigned k, u64 *out, int maxw) {
    if (alen == 0) return 0;
    unsigned wsh = k / 64, bsh = k % 64;
    int n = alen + wsh + (bsh != 0);
    if (n > maxw) return -1;
    std::memset(out, 0, sizeof(u64) * n);
    for (int i = alen - 1; i >= 0; i--) {
        u64 v = a[i];
        if (bsh) {
            out[i + wsh + 1] |= v >> (64 - bsh);
            out[i + wsh] |= v << bsh;
        } else {
            out[i + wsh] = v;
        }
    }
    return norm_len(out, n);
}

inline int shr_mag(const u64 *a, int alen, unsigned k, u64 *out) {
    unsigned wsh = k / 64, bsh = k % 64;
    if ((int)wsh >= alen) return 0;
    int n = alen - wsh;
    for (int i = 0; i < n; i++) {
        u64 v = a[i + wsh] >> bsh;
        if (bsh && i + (int)wsh + 1 < alen)
            v |= a[i + wsh + 1] << (64 - bsh);
        out[i] = v;
    }
    return norm_len(out, n);
}

// ---------------------------------------------------------------------------
// Fast routes: an odd divisor m of k <= 4 words (fixed widths), a power of two.

struct FastMod {
    int pow2;      // e where m = 2^e, else -1
    int k;         // words of an odd m other than 1, at most 4; else 0
    u64 m[4];      // zero-padded
    u64 mu[5];     // floor(2^(128k) / m): k + 1 words
    i64 m62[5];    // m in signed 62-bit limbs
    u64 minv62;    // m^-1 mod 2^62
};

// r = x mod m (k = K words of r) for x < 2^(64N), N = K or 2K; HAC 14.42:
// q3 = floor(floor(x / b^(K-1)) * mu / b^(K+1)) lies within 2 of the
// quotient, so x - q3 m, taken mod b^(K+1), is below 3m.
template <int K, int N>
inline void fast_reduce(const FastMod &f, const u64 *x, u64 *r) {
    constexpr int Q = N - K + 1;  // words of q1 (and of q3)
    constexpr int R = K + 1;
    u64 p[Q + K + 1];
    for (int i = 0; i < Q + K + 1; i++) p[i] = 0;
    for (int i = 0; i < Q; i++) {
        u64 xi = x[K - 1 + i], carry = 0;
        for (int j = 0; j <= K; j++) {
            u128 cur = (u128)xi * f.mu[j] + p[i + j] + carry;
            p[i + j] = (u64)cur;
            carry = (u64)(cur >> 64);
        }
        p[i + K + 1] = carry;
    }
    const u64 *q3 = p + K + 1;
    u64 t[R];  // (q3 * m) mod b^R
    for (int i = 0; i < R; i++) t[i] = 0;
    for (int i = 0; i < Q && i < R; i++) {
        u64 carry = 0;
        for (int j = 0; j < K && i + j < R; j++) {
            u128 cur = (u128)q3[i] * f.m[j] + t[i + j] + carry;
            t[i + j] = (u64)cur;
            carry = (u64)(cur >> 64);
        }
        if (i + K < R) t[i + K] += carry;
    }
    u64 s[R];  // x - q3 m, mod b^R
    u64 borrow = 0;
    for (int i = 0; i < R; i++) {
        u64 xv = i < N ? x[i] : 0;
        u128 d = (u128)xv - t[i] - borrow;
        s[i] = (u64)d;
        borrow = (u64)(d >> 64) & 1;
    }
    for (;;) {  // at most twice
        bool ge = s[K] != 0;
        if (!ge) {
            ge = true;
            for (int i = K - 1; i >= 0; i--)
                if (s[i] != f.m[i]) {
                    ge = s[i] > f.m[i];
                    break;
                }
        }
        if (!ge) break;
        borrow = 0;
        for (int i = 0; i < R; i++) {
            u64 mv = i < K ? f.m[i] : 0;
            u128 d = (u128)s[i] - mv - borrow;
            s[i] = (u64)d;
            borrow = (u64)(d >> 64) & 1;
        }
    }
    for (int i = 0; i < K; i++) r[i] = s[i];
}

// |A| mod m into r[0..4) (zero-padded); false when A is wider than 2k words
inline bool fast_rem(const FastMod &f, const Reg &A, u64 *r) {
    r[0] = r[1] = r[2] = r[3] = 0;
    int n = A.len;
    if (n <= f.k && cmp_mag(A.d, n, f.m, f.k) < 0) {  // already below m
        for (int i = 0; i < n; i++) r[i] = A.d[i];
        return true;
    }
    switch (f.k) {
        case 4:
            if (n <= 4) fast_reduce<4, 4>(f, A.d, r);
            else if (n <= 8) fast_reduce<4, 8>(f, A.d, r);
            else return false;
            return true;
        case 3:
            if (n <= 3) fast_reduce<3, 3>(f, A.d, r);
            else if (n <= 6) fast_reduce<3, 6>(f, A.d, r);
            else return false;
            return true;
        case 2:
            if (n <= 2) fast_reduce<2, 2>(f, A.d, r);
            else if (n <= 4) fast_reduce<2, 4>(f, A.d, r);
            else return false;
            return true;
        case 1:
            if (n <= 1) fast_reduce<1, 1>(f, A.d, r);
            else if (n <= 2) fast_reduce<1, 2>(f, A.d, r);
            else return false;
            return true;
    }
    return false;
}

// |A| mod 2^e into r; returns its length (the low e bits)
inline int pow2_rem(int e, const Reg &A, u64 *r) {
    int n = (e + 63) / 64;
    if (n > A.len) n = A.len;
    for (int i = 0; i < n; i++) r[i] = A.d[i];
    if (n == (e + 63) / 64 && e % 64) r[n - 1] &= ~0ull >> (64 - e % 64);
    return norm_len(r, n);
}

// r = 2^e - r for 0 < r < 2^e, of n words (the floor remainder of a
// negative operand)
inline int pow2_neg(int e, u64 *r, int n) {
    int w = (e + 63) / 64;
    for (int i = n; i < w; i++) r[i] = 0;
    u64 carry = 1;
    for (int i = 0; i < w; i++) {
        u64 v = ~r[i] + carry;
        carry = carry && v == 0;
        r[i] = v;
    }
    if (e % 64) r[w - 1] &= ~0ull >> (64 - e % 64);
    return norm_len(r, w);
}

// r = m - r for 0 < r < m (the floor remainder of a negative operand)
inline void neg_mod(const FastMod &f, u64 *r) {
    u64 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)f.m[i] - r[i] - borrow;
        r[i] = (u64)d;
        borrow = (u64)(d >> 64) & 1;
    }
}

// --- inversion: Bernstein–Yang divsteps, variable time ----------------------
// A value is 5 signed 62-bit limbs, v = sum v[i] 2^(62 i): the lower limbs
// in [0, 2^62), the top one signed.  Each batch runs 62 divsteps on the low
// 64 bits of f and g (eta = -delta), then applies their transition matrix,
// scaled by 2^62, to the full f, g and to d, e, where f = d x and g = e x
// (mod m) throughout.  It ends at g = 0 with f = +-gcd(m, x).

constexpr u64 M62 = ~0ull >> 2;

struct Trans {
    i64 u, v, q, r;
};

inline i64 divsteps_62_var(i64 eta, u64 f, u64 g, Trans &t) {
    u64 u = 1, v = 0, q = 0, r = 1;
    int i = 62;
    for (;;) {
        // divsteps with g even only halve g: take them all at once (the
        // sentinel bit stops the count at the steps left)
        int zeros = __builtin_ctzll(g | (~0ull << i));
        g >>= zeros;
        u <<= zeros;
        v <<= zeros;
        eta -= zeros;
        i -= zeros;
        if (i == 0) break;
        if (eta < 0) {  // (f, g) <- (g, -f)
            eta = -eta;
            u64 tmp = f;
            f = g;
            g = 0 - tmp;
            tmp = u;
            u = q;
            q = 0 - tmp;
            tmp = v;
            v = r;
            r = 0 - tmp;
        }
        // the next min(eta + 1, i) divsteps keep f and add f to g when g is
        // odd: cancel up to 6 low bits of g with one multiple w of f, where
        // f (2 - f^2) is f's inverse mod 2^6
        int limit = (int)eta + 1 < i ? (int)eta + 1 : i;
        if (limit > 6) limit = 6;
        u64 w = (f * g * (f * f - 2)) & (~0ull >> (64 - limit));
        g += f * w;
        q += u * w;
        r += v * w;
    }
    t.u = (i64)u;
    t.v = (i64)v;
    t.q = (i64)q;
    t.r = (i64)r;
    return eta;
}

// (f, g) <- t (f, g) / 2^62 on the first len limbs (exact division)
inline void update_fg(int len, i64 *f, i64 *g, const Trans &t) {
    i128 cf = (i128)t.u * f[0] + (i128)t.v * g[0];
    i128 cg = (i128)t.q * f[0] + (i128)t.r * g[0];
    cf >>= 62;
    cg >>= 62;
    for (int i = 1; i < len; i++) {
        cf += (i128)t.u * f[i] + (i128)t.v * g[i];
        cg += (i128)t.q * f[i] + (i128)t.r * g[i];
        f[i - 1] = (i64)((u64)cf & M62);
        g[i - 1] = (i64)((u64)cg & M62);
        cf >>= 62;
        cg >>= 62;
    }
    f[len - 1] = (i64)cf;
    g[len - 1] = (i64)cg;
}

// (d, e) <- t (d, e) / 2^62 mod m, keeping both in (-2m, m): add the
// multiples md, me of m that make the low 62 bits zero (and that bring a
// negative input up), then shift
inline void update_de(const FastMod &f, i64 *d, i64 *e, const Trans &t) {
    i64 sd = d[4] >> 63, se = e[4] >> 63;
    i64 md = (t.u & sd) + (t.v & se);
    i64 me = (t.q & sd) + (t.r & se);
    i128 cd = (i128)t.u * d[0] + (i128)t.v * e[0];
    i128 ce = (i128)t.q * d[0] + (i128)t.r * e[0];
    md -= (i64)((f.minv62 * (u64)cd + (u64)md) & M62);
    me -= (i64)((f.minv62 * (u64)ce + (u64)me) & M62);
    cd += (i128)f.m62[0] * md;
    ce += (i128)f.m62[0] * me;
    cd >>= 62;
    ce >>= 62;
    for (int i = 1; i < 5; i++) {
        cd += (i128)t.u * d[i] + (i128)t.v * e[i] + (i128)f.m62[i] * md;
        ce += (i128)t.q * d[i] + (i128)t.r * e[i] + (i128)f.m62[i] * me;
        d[i - 1] = (i64)((u64)cd & M62);
        e[i - 1] = (i64)((u64)ce & M62);
        cd >>= 62;
        ce >>= 62;
    }
    d[4] = (i64)cd;
    e[4] = (i64)ce;
}

inline void carry62(i64 *r) {
    for (int i = 0; i < 4; i++) {
        r[i + 1] += r[i] >> 62;
        r[i] &= (i64)M62;
    }
}

inline void to_s62(const u64 *a, i64 *v) {
    v[0] = (i64)(a[0] & M62);
    v[1] = (i64)(((a[0] >> 62) | (a[1] << 2)) & M62);
    v[2] = (i64)(((a[1] >> 60) | (a[2] << 4)) & M62);
    v[3] = (i64)(((a[2] >> 58) | (a[3] << 6)) & M62);
    v[4] = (i64)(a[3] >> 56);
}

// x^-1 mod m for 0 < x < m into out[0..4); false when gcd(x, m) != 1
static bool fast_invmod(const FastMod &fm, const u64 *x, u64 *out) {
    i64 d[5] = {0, 0, 0, 0, 0}, e[5] = {1, 0, 0, 0, 0}, f[5], g[5];
    for (int i = 0; i < 5; i++) f[i] = fm.m62[i];
    to_s62(x, g);
    i64 eta = -1;  // delta = 1
    int len = 5;
    for (int batch = 0;; batch++) {
        if (batch >= 64) return false;  // 256-bit inputs need at most 12
        Trans t;
        eta = divsteps_62_var(eta, (u64)f[0], (u64)g[0], t);
        update_de(fm, d, e, t);
        update_fg(len, f, g, t);
        if (g[0] == 0) {
            i64 any = 0;
            for (int j = 1; j < len; j++) any |= g[j];
            if (any == 0) break;
        }
        // drop the top limb while it is 0 or -1 in both f and g
        i64 fn = f[len - 1], gn = g[len - 1];
        if (len > 1 && (fn ^ (fn >> 63)) == 0 && (gn ^ (gn >> 63)) == 0) {
            f[len - 2] = (i64)((u64)f[len - 2] | ((u64)fn << 62));
            g[len - 2] = (i64)((u64)g[len - 2] | ((u64)gn << 62));
            len--;
        }
    }
    // f = +-1 iff x is a unit
    bool neg = f[len - 1] < 0;
    if (neg) {
        for (int j = 0; j < len - 1; j++)
            if ((u64)f[j] != M62) return false;
        if (f[len - 1] != -1) return false;
    } else {
        if (f[0] != 1) return false;
        for (int j = 1; j < len; j++)
            if (f[j] != 0) return false;
    }
    // x^-1 = f d: bring d from (-2m, m) to [0, m) with f's sign
    i64 add = d[4] >> 63;  // d < 0: d += m, now in (-m, m)
    for (int i = 0; i < 5; i++) d[i] += fm.m62[i] & add;
    if (neg)
        for (int i = 0; i < 5; i++) d[i] = -d[i];
    carry62(d);
    add = d[4] >> 63;
    for (int i = 0; i < 5; i++) d[i] += fm.m62[i] & add;
    carry62(d);
    out[0] = (u64)d[0] | ((u64)d[1] << 62);
    out[1] = ((u64)d[1] >> 2) | ((u64)d[2] << 60);
    out[2] = ((u64)d[2] >> 4) | ((u64)d[3] << 58);
    out[3] = ((u64)d[3] >> 6) | ((u64)d[4] << 56);
    return true;
}

// ---------------------------------------------------------------------------
// Barrett contexts for the (few) distinct divisors: mu = floor(2^640 / m)
struct Barrett {
    u64 m[W];
    int mlen;
    u64 mu[W + 1];
    int mulen;
    FastMod fast;
};

// long division q = floor(num / den) via binary shift-subtract, used ONCE
// per divisor to build mu (num = 2^640)
static void build_barrett(Barrett &bc) {
    // mu = floor(2^640 / m): binary long division over 641 bits
    u64 rem[WMUL + 2] = {0};
    int rlen = 0;
    u64 q[WMUL + 2] = {0};
    for (int bit = 64 * W; bit >= 0; bit--) {
        // rem = rem*2 + bit(num); num = 2^640 has only bit 640 set
        u64 carry = (bit == 64 * W) ? 1 : 0;
        for (int i = 0; i < rlen || carry; i++) {
            u64 nv = (rem[i] << 1) | carry;
            carry = rem[i] >> 63;
            rem[i] = nv;
            if (i >= rlen && nv) rlen = i + 1;
        }
        if (cmp_mag(rem, rlen, bc.m, bc.mlen) >= 0) {
            rlen = sub_mag(rem, rlen, bc.m, bc.mlen, rem);
            q[bit / 64] |= 1ull << (bit % 64);
        }
    }
    std::memcpy(bc.mu, q, sizeof(u64) * (W + 1));
    bc.mulen = norm_len(bc.mu, W + 1);
}

// the fast routes' context: the exponent of a power of two; the fixed-width
// context of an odd divisor of at most 4 words, other than 1
static void build_fast(Barrett &bc) {
    FastMod &f = bc.fast;
    std::memset(&f, 0, sizeof(f));
    int k = bc.mlen;
    u64 top = bc.m[k - 1];
    f.pow2 = -1;
    if (!(top & (top - 1)) && norm_len(bc.m, k - 1) == 0)
        f.pow2 = 64 * (k - 1) + __builtin_ctzll(top);
    if (k > 4 || !(bc.m[0] & 1) || (k == 1 && bc.m[0] == 1)) return;
    f.k = k;
    std::memcpy(f.m, bc.m, sizeof(u64) * k);
    // floor(2^(128k) / m) = floor(floor(2^640 / m) / 2^(640 - 128k)), below
    // b^(k+1) since m > b^(k-1)
    for (int i = 0; i <= k; i++) f.mu[i] = bc.mu[W - 2 * k + i];
    to_s62(f.m, f.m62);
    u64 inv = f.m[0];  // m^-1 mod 2^64 by Newton: 3, 6, ... 96 bits
    for (int i = 0; i < 5; i++) inv *= 2 - f.m[0] * inv;
    f.minv62 = inv & M62;
}

// divmod of magnitude a (< 2^640) by bc.m: q out (may be null), r out
static bool barrett_divmod(const Barrett &bc, const u64 *a, int alen,
                           u64 *qout, int *qlen, u64 *rout, int *rlen) {
    // q_hat = (a * mu) >> 640
    u64 prod[WMUL + 4];
    int plen = mul_mag(a, alen, bc.mu, bc.mulen, prod, WMUL + 4);
    if (plen < 0) return false;
    u64 qh[WMUL + 4];
    int qhlen = plen > W ? plen - W : 0;
    for (int i = 0; i < qhlen; i++) qh[i] = prod[i + W];
    qhlen = norm_len(qh, qhlen);
    // r = a - qh * m
    u64 qm[WMUL + 4];
    int qmlen = mul_mag(qh, qhlen, bc.m, bc.mlen, qm, WMUL + 4);
    if (qmlen < 0) return false;
    u64 r[WMUL + 4];
    int rl = sub_mag(a, alen, qm, qmlen, r);  // a >= qh*m by construction
    // correct: at most a few subtractions
    int guard = 0;
    while (cmp_mag(r, rl, bc.m, bc.mlen) >= 0) {
        rl = sub_mag(r, rl, bc.m, bc.mlen, r);
        // qh += 1
        u64 one = 1;
        qhlen = add_mag(qh, qhlen, &one, 1, qh, WMUL + 4);
        if (++guard > 8) return false;
    }
    if (qout) {
        if (qhlen > W) return false;
        std::memcpy(qout, qh, sizeof(u64) * qhlen);
        *qlen = qhlen;
    }
    if (rout) {
        std::memcpy(rout, r, sizeof(u64) * rl);
        *rlen = rl;
    }
    return true;
}

// modular helpers on magnitudes < m (for invmod)
inline void mod_sub(const u64 *a, int alen, const u64 *b, int blen,
                    const u64 *m, int mlen, u64 *out, int *olen) {
    u64 t[W + 1];
    int tl;
    if (cmp_mag(a, alen, b, blen) >= 0) {
        tl = sub_mag(a, alen, b, blen, t);
    } else {
        tl = add_mag(a, alen, m, mlen, t, W + 1);
        tl = sub_mag(t, tl, b, blen, t);
    }
    std::memset(out, 0, sizeof(u64) * W);
    std::memcpy(out, t, sizeof(u64) * tl);
    *olen = tl;
}

inline void half_mod(u64 *x, int *xlen, const u64 *m, int mlen) {
    // x = x/2 if even else (x+m)/2  (m odd)
    u64 t[W + 1];
    int tl;
    if (x[0] & 1) {
        tl = add_mag(x, *xlen, m, mlen, t, W + 1);
    } else {
        std::memcpy(t, x, sizeof(u64) * (*xlen));
        tl = *xlen;
    }
    tl = shr_mag(t, tl, 1, t);
    std::memset(x, 0, sizeof(u64) * W);
    std::memcpy(x, t, sizeof(u64) * tl);
    *xlen = tl;
}

// x^{-1} mod m for odd m, gcd(x,m)=1; binary extended gcd
static bool invmod_odd(const u64 *x0, int xlen, const u64 *m, int mlen,
                       u64 *out, int *olen) {
    u64 u[W] = {0}, v[W] = {0}, b[W] = {0}, c[W] = {0};
    std::memcpy(u, x0, sizeof(u64) * xlen);
    std::memcpy(v, m, sizeof(u64) * mlen);
    int ulen = xlen, vlen = mlen;
    b[0] = 1;
    int blen = 1, clen = 0;
    int guard = 0;
    while (!(ulen == 1 && u[0] == 1) && !(vlen == 1 && v[0] == 1)) {
        if (++guard > 4000) return false;
        while (ulen > 0 && !(u[0] & 1)) {
            ulen = shr_mag(u, ulen, 1, u);
            half_mod(b, &blen, m, mlen);
        }
        while (vlen > 0 && !(v[0] & 1)) {
            vlen = shr_mag(v, vlen, 1, v);
            half_mod(c, &clen, m, mlen);
        }
        if (ulen == 0 || vlen == 0) return false;  // gcd != 1
        if (cmp_mag(u, ulen, v, vlen) >= 0) {
            ulen = sub_mag(u, ulen, v, vlen, u);
            mod_sub(b, blen, c, clen, m, mlen, b, &blen);
        } else {
            vlen = sub_mag(v, vlen, u, ulen, v);
            mod_sub(c, clen, b, blen, m, mlen, c, &clen);
        }
    }
    if (ulen == 1 && u[0] == 1) {
        std::memcpy(out, b, sizeof(u64) * blen);
        *olen = blen;
    } else {
        std::memcpy(out, c, sizeof(u64) * clen);
        *olen = clen;
    }
    return true;
}

enum Op { ADD = 0, SUB, MUL, MOD, DIV, INVMOD, ISZM, SHL, SHR, AND };

}  // namespace

extern "C" {

// Executes the renamed tape.  Returns 0 on success, else an error code:
// 1 = overflow, 2 = bad op, 3 = division internal error, 4 = negative
// operand where nonnegative required, 5 = invmod failure, 6 = shift too big.
//
// init_mag/init_hdr: preloaded registers [0, n_init)  (hdr = len, sign via
// negative hdr).  n_regs: total register count.
// code/a/b/out: per-op register indices.  emit_start (n_ops+1 prefix) /
// emit_dst: after op i, copy its out register (must fit 4 words, nonneg)
// into out_buf[emit_dst[j]*4 ..].
// route_counts (may be null): on success, the modular ops (MOD, ISZM,
// INVMOD) that took the fixed-width route [0] and the general route [1].
int mira_tape_execute(const int32_t *code, const int32_t *a_idx,
                      const int32_t *b_idx, const int32_t *out_idx,
                      i64 n_ops, const u64 *init_mag, const int32_t *init_hdr,
                      i64 n_init, i64 n_regs, const int32_t *emit_start,
                      const int32_t *emit_dst, u64 *out_buf,
                      i64 *route_counts) {
    std::vector<Reg> regs(n_regs);  // value-initialized: all zero
    for (i64 i = 0; i < n_init; i++) {
        std::memcpy(regs[i].d, init_mag + i * W, sizeof(u64) * W);
        int32_t h = init_hdr[i];
        regs[i].neg = h < 0;
        regs[i].len = h < 0 ? -h : h;
    }

    // Barrett cache keyed by divisor register index (divisors are const
    // registers, stable across ops)
    std::vector<Barrett> bcache;
    std::vector<int32_t> bkey;

    auto get_barrett = [&](int32_t reg) -> Barrett * {
        for (size_t i = 0; i < bkey.size(); i++)
            if (bkey[i] == reg) return &bcache[i];
        const Reg &m = regs[reg];
        if (m.neg || m.len == 0) return nullptr;
        bcache.emplace_back();
        Barrett &bc = bcache.back();
        std::memset(bc.m, 0, sizeof(bc.m));
        std::memcpy(bc.m, m.d, sizeof(u64) * m.len);
        bc.mlen = m.len;
        build_barrett(bc);
        build_fast(bc);
        bkey.push_back(reg);
        return &bc;
    };

    i64 n_fast = 0, n_general = 0;
    u64 scratch[WMUL + 4];

    for (i64 i = 0; i < n_ops; i++) {
        const Reg &A = regs[a_idx[i]];
        const Reg &B = regs[b_idx[i]];
        Reg &O = regs[out_idx[i]];
        // the result goes to t first (O may alias A or B), then its words
        // to O, whose stale words above the new length are cleared
        u64 t[W];
        int tlen = 0, tneg = 0;
        switch (code[i]) {
            case ADD:
            case SUB: {
                int bneg = code[i] == SUB ? !B.neg : B.neg;
                if (A.neg == bneg) {
                    tlen = add_mag(A.d, A.len, B.d, B.len, t, W);
                    if (tlen < 0) return 1;
                    tlen = norm_len(t, tlen);
                    tneg = A.neg;
                } else {
                    int c = cmp_mag(A.d, A.len, B.d, B.len);
                    if (c >= 0) {
                        tlen = sub_mag(A.d, A.len, B.d, B.len, t);
                        tneg = A.neg;
                    } else {
                        tlen = sub_mag(B.d, B.len, A.d, A.len, t);
                        tneg = bneg;
                    }
                }
                break;
            }
            case MUL: {
                tlen = mul_mag(A.d, A.len, B.d, B.len, scratch, WMUL + 4);
                if (tlen < 0 || tlen > W) return 1;
                std::memcpy(t, scratch, sizeof(u64) * tlen);
                tneg = (A.neg != B.neg) && tlen > 0;
                break;
            }
            case MOD:
            case DIV: {
                Barrett *bc = get_barrett(b_idx[i]);
                if (!bc) return 3;
                if (code[i] == MOD && bc->fast.k && fast_rem(bc->fast, A, t)) {
                    n_fast++;
                    if (A.neg && (t[0] | t[1] | t[2] | t[3])) neg_mod(bc->fast, t);
                    tlen = norm_len(t, 4);
                    break;
                }
                if (code[i] == MOD && bc->fast.pow2 >= 0) {
                    n_fast++;
                    tlen = pow2_rem(bc->fast.pow2, A, t);
                    if (A.neg && tlen) tlen = pow2_neg(bc->fast.pow2, t, tlen);
                    break;
                }
                if (code[i] == MOD) n_general++;
                u64 q[W], r[W];
                int qlen, rlen;
                if (!barrett_divmod(*bc, A.d, A.len, q, &qlen, r, &rlen))
                    return 3;
                if (code[i] == MOD) {
                    if (A.neg && rlen != 0) {
                        // python floor-mod: m - r
                        tlen = sub_mag(bc->m, bc->mlen, r, rlen, t);
                    } else {
                        std::memcpy(t, r, sizeof(u64) * rlen);
                        tlen = rlen;
                    }
                } else {
                    if (A.neg && rlen != 0) {
                        // python floor-div: -(q + 1)
                        u64 one = 1;
                        qlen = add_mag(q, qlen, &one, 1, q, W);
                        if (qlen < 0) return 1;
                    }
                    std::memcpy(t, q, sizeof(u64) * qlen);
                    tlen = qlen;
                    tneg = A.neg && qlen > 0;
                }
                break;
            }
            case INVMOD: {
                Barrett *bc = get_barrett(b_idx[i]);
                if (!bc) return 3;
                u64 r[W];
                if (bc->fast.k && fast_rem(bc->fast, A, r)) {
                    n_fast++;
                    if (!(r[0] | r[1] | r[2] | r[3])) {
                        t[0] = 1;
                        tlen = 1;
                        break;
                    }
                    if (A.neg) neg_mod(bc->fast, r);
                    if (!fast_invmod(bc->fast, r, t)) return 5;
                    tlen = norm_len(t, 4);
                    break;
                }
                n_general++;
                int rlen;
                if (!barrett_divmod(*bc, A.d, A.len, nullptr, nullptr, r,
                                    &rlen))
                    return 3;
                if (A.neg && rlen != 0)
                    rlen = sub_mag(bc->m, bc->mlen, r, rlen, r);
                if (rlen == 0) {
                    t[0] = 1;
                    tlen = 1;
                } else {
                    if (!invmod_odd(r, rlen, bc->m, bc->mlen, t, &tlen))
                        return 5;
                }
                break;
            }
            case ISZM: {
                Barrett *bc = get_barrett(b_idx[i]);
                if (!bc) return 3;
                u64 r[W];
                bool zero;
                if (bc->fast.k && fast_rem(bc->fast, A, r)) {
                    n_fast++;
                    zero = !(r[0] | r[1] | r[2] | r[3]);
                } else if (bc->fast.pow2 >= 0) {
                    n_fast++;
                    zero = pow2_rem(bc->fast.pow2, A, r) == 0;
                } else {
                    n_general++;
                    int rlen;
                    if (!barrett_divmod(*bc, A.d, A.len, nullptr, nullptr, r,
                                        &rlen))
                        return 3;
                    zero = rlen == 0;
                }
                t[0] = 1;
                tlen = zero ? 1 : 0;
                break;
            }
            case SHL: {
                if (B.neg || B.len > 1 || A.neg) return 4;
                u64 k = B.len ? B.d[0] : 0;
                if (k >= 64 * W) return 6;
                tlen = shl_mag(A.d, A.len, (unsigned)k, t, W);
                if (tlen < 0) return 1;
                break;
            }
            case SHR: {
                if (B.neg || B.len > 1 || A.neg) return 4;
                u64 k = B.len ? B.d[0] : 0;
                tlen = k >= 64 * W ? 0 : shr_mag(A.d, A.len, (unsigned)k, t);
                break;
            }
            case AND: {
                if (A.neg || B.neg) return 4;
                int n = A.len < B.len ? A.len : B.len;
                for (int j = 0; j < n; j++) t[j] = A.d[j] & B.d[j];
                tlen = norm_len(t, n);
                break;
            }
            default:
                return 2;
        }
        int old = O.len;
        std::memcpy(O.d, t, sizeof(u64) * tlen);
        for (int j = tlen; j < old; j++) O.d[j] = 0;
        O.len = (int16_t)tlen;
        O.neg = (int16_t)(tneg && tlen > 0);
        for (int32_t j = emit_start[i]; j < emit_start[i + 1]; j++) {
            if (O.neg || O.len > 4) return 1;
            u64 *dst = out_buf + (i64)emit_dst[j] * 4;
            dst[0] = O.d[0];
            dst[1] = O.d[1];
            dst[2] = O.d[2];
            dst[3] = O.d[3];
        }
    }
    if (route_counts) {
        route_counts[0] = n_fast;
        route_counts[1] = n_general;
    }
    return 0;
}
}
