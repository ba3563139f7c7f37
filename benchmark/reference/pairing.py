"""A plain BN254 optimal ate pairing in Python integers.

Fq12 is Fq[w]/(w^12 - 18 w^6 + 82): an element is a list of 12 coefficients
of 1, w, ..., w^11, so that w^6 = 9 + u with u^2 = -1.  G2 points are
affine pairs over Fq2 = Fq[u]/(u^2 + 1), as (c0, c1) tuples, on the twist
y^2 = x^3 + 3/(9 + u); the untwist is (x, y) -> (x w^2, y w^3).  The Miller
loop runs over the bits of 6t + 2 (t the BN parameter) with affine steps on
the twist, then adds pi(Q) and subtracts pi^2(Q); the result is raised to
(p^12 - 1)/r whole, so factors from proper subfields drop out.

`to_layout`/`from_layout` convert to and from the 12 Fq coefficients that
the program keeps for Gt (w^0..w^5 parts without u, then those with u).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .curves import BN254, FQ, FR, Point

P = FQ
BN_T = 4965661367192848881
LOOP = 6 * BN_T + 2
FINAL_EXP = (P ** 12 - 1) // FR

Fq2 = Tuple[int, int]
G2 = Optional[Tuple[Fq2, Fq2]]  # None at infinity
Fq12 = List[int]

# the G2 generator of Mira's examples (EIP-197), as ((x0, x1), (y0, y1))
G2_GEN = ((10857046999023057135944570762232829481370756359578518086990519993285655852781,
           11559732032986387107991004021392285783925812861821192530917403151452391805634),
          (8495653923123431417604973247489272438418190587263600148770280649306958101930,
           4082367875863433681332203403145435568316851327593401208105741076214120093531))


# -- Fq2 ------------------------------------------------------------------------


def f2_add(a: Fq2, b: Fq2) -> Fq2:
    return (a[0] + b[0]) % P, (a[1] + b[1]) % P


def f2_sub(a: Fq2, b: Fq2) -> Fq2:
    return (a[0] - b[0]) % P, (a[1] - b[1]) % P


def f2_mul(a: Fq2, b: Fq2) -> Fq2:
    return (a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P


def f2_inv(a: Fq2) -> Fq2:
    n = pow(a[0] * a[0] + a[1] * a[1], P - 2, P)
    return a[0] * n % P, -a[1] * n % P


def f2_pow(a: Fq2, e: int) -> Fq2:
    out = (1, 0)
    while e:
        if e & 1:
            out = f2_mul(out, a)
        a = f2_mul(a, a)
        e >>= 1
    return out


XI = (9, 1)
TWIST_B = f2_mul((3, 0), f2_inv(XI))
# pi(x w^2, y w^3) = (conj(x) w^2 XI^((p-1)/3), conj(y) w^3 XI^((p-1)/2))
FROB_X = f2_pow(XI, (P - 1) // 3)
FROB_Y = f2_pow(XI, (P - 1) // 2)


# -- Fq12 -----------------------------------------------------------------------


def one() -> Fq12:
    return [1] + [0] * 11


def mul(a: Sequence[int], b: Sequence[int]) -> Fq12:
    c = [0] * 23
    for i, x in enumerate(a):
        if x:
            for j, y in enumerate(b):
                c[i + j] += x * y
    for k in range(22, 11, -1):  # w^12 = 18 w^6 - 82
        c[k - 6] += 18 * c[k]
        c[k - 12] -= 82 * c[k]
    return [v % P for v in c[:12]]


def power(a: Sequence[int], e: int) -> Fq12:
    out, base = one(), list(a)
    while e:
        if e & 1:
            out = mul(out, base)
        e >>= 1
        if e:
            base = mul(base, base)
    return out


def embed(a: Fq2, shift: int) -> Fq12:
    """(a0 + a1 u) w^shift as an Fq12 element, u = w^6 - 9, shift < 6."""
    out = [0] * 12
    out[shift] = (a[0] - 9 * a[1]) % P
    out[shift + 6] = a[1] % P
    return out


def to_layout(f: Sequence[int]) -> List[int]:
    """Our coefficients -> the program's Gt layout [c0_0..c0_5, c1_0..c1_5],
    f = sum (c0_i + c1_i u) w^i."""
    return [(f[i] + 9 * f[i + 6]) % P for i in range(6)] + [f[i + 6] % P for i in range(6)]


def from_layout(v: Sequence[int]) -> Fq12:
    return [(v[i] - 9 * v[i + 6]) % P for i in range(6)] + [v[i + 6] % P for i in range(6)]


# -- G2 on the twist ------------------------------------------------------------


def g2_on_curve(q: G2) -> bool:
    if q is None:
        return True
    x, y = q
    return f2_sub(f2_mul(y, y), f2_add(f2_mul(f2_mul(x, x), x), TWIST_B)) == (0, 0)


def g2_neg(q: G2) -> G2:
    return None if q is None else (q[0], ((-q[1][0]) % P, (-q[1][1]) % P))


def _frobenius(q: G2) -> G2:
    (x0, x1), (y0, y1) = q
    return f2_mul((x0, -x1 % P), FROB_X), f2_mul((y0, -y1 % P), FROB_Y)


def _line(lam: Fq2, t: Tuple[Fq2, Fq2], p: Tuple[int, int]) -> Fq12:
    """The line of slope lam w through the untwisted T, at P:
    y_P - lam x_P w + (lam x_T - y_T) w^3."""
    xt, yt = t
    xp, yp = p
    out = embed(f2_mul(lam, (-xp % P, 0)), 1)
    w3 = embed(f2_sub(f2_mul(lam, xt), yt), 3)
    out = [a + b for a, b in zip(out, w3)]
    out[0] += yp
    return [v % P for v in out]


def _step(t, q, p):
    """(line through T and Q at P, T + Q); Q = T doubles."""
    (x1, y1), (x2, y2) = t, q
    if t == q:
        lam = f2_mul(f2_mul((3, 0), f2_mul(x1, x1)), f2_inv(f2_add(y1, y1)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_mul(lam, lam), x1), x2)
    y3 = f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1)
    return _line(lam, t, p), (x3, y3)


def miller_loop(p: Point, q: G2) -> Fq12:
    if p is None or q is None:
        return one()
    f, t = one(), q
    for bit in bin(LOOP)[3:]:
        line, t = _step(t, t, p)
        f = mul(mul(f, f), line)
        if bit == "1":
            line, t = _step(t, q, p)
            f = mul(f, line)
    q1 = _frobenius(q)
    q2 = g2_neg(_frobenius(q1))
    line, t = _step(t, q1, p)
    f = mul(f, line)
    line, _ = _step(t, q2, p)
    return mul(f, line)


def final_exponentiation(f: Sequence[int]) -> Fq12:
    return power(f, FINAL_EXP)


def pairing(p: Point, q: G2) -> Fq12:
    return final_exponentiation(miller_loop(p, q))


def pairing_product(pairs) -> Fq12:
    """prod e(P_i, Q_i) with one final exponentiation."""
    f = one()
    for p, q in pairs:
        f = mul(f, miller_loop(p, q))
    return final_exponentiation(f)


def g1_on_curve(p: Point) -> bool:
    return BN254.on_curve(p)
