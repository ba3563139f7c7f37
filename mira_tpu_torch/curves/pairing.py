"""BN254 optimal ate pairing (host).

The reference does not implement pairings in-tree — its examples call
halo2curves' `bn256::pairing` to build Gt inputs (e.g.
examples/zkml/util.rs:37-55), and its `Tuple12` Gt gadget is
checked for equivalence against halo2curves Fq12 arithmetic
(src/gadgets/fp12.rs:765-799).  This module supplies the
native equivalent so workloads can produce REAL target-group elements.

Representation: results are `Tuple12` — Fq[u, w]/(u^2+1, w^6-(9+u)) with
coefficient order [w^0..w^5 c0-parts, w^0..w^5 c1-parts] (the reference's
fp12.rs layout).  The Miller loop runs in affine Fq2 coordinates on the
D-twist E'/Fq2: y^2 = x^3 + 3/(9+u); the untwist (x, y) -> (x w^2, y w^3)
makes each line function the sparse element

    l(P) = y_P + (-lambda x_P) w + (lambda x_T - y_T) w^3 .

Anchor: `pairing(G1 gen, G2 gen) == Tuple12.generator()` — the reference's
hard-coded GT generator constants (fp12.rs:150-172) — plus bilinearity; see
tests/test_pairing.py.

Copied from mira_tpu/curves/pairing.py; the port imports nothing of mira_tpu.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Type

from ..fields.host import Fp, field
from ..fields.params import BN254_FQ, BN254_FR
from .host import XI_0, AffinePoint, Fq2, G2Point, Tuple12

# BN parameter: p = 36u^4 + 36u^3 + 24u^2 + 6u + 1
BN_U = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_U + 2  # positive for BN254


def _fq2_pow(a: Fq2, e: int) -> Fq2:
    F = type(a.c0)
    acc = Fq2.one(F)
    base = a
    while e > 0:
        if e & 1:
            acc = acc.mul(base)
        base = base.square()
        e >>= 1
    return acc


@lru_cache(maxsize=None)
def _frobenius_gammas(modulus: int):
    """gamma = xi^((p-1)/6); twist-Frobenius uses gamma^2, gamma^3."""
    F = field(modulus)
    xi = Fq2(F(XI_0), F(1))
    g = _fq2_pow(xi, (modulus - 1) // 6)
    return g.mul(g), g.mul(g).mul(g)  # gamma^2, gamma^3


def _conj(a: Fq2) -> Fq2:
    return Fq2(a.c0, -a.c1)


def _g2_frobenius(q: G2Point, modulus: int) -> G2Point:
    g2, g3 = _frobenius_gammas(modulus)
    return G2Point(_conj(q.x).mul(g2), _conj(q.y).mul(g3))


def _line(
    lam: Fq2, xt: Fq2, yt: Fq2, xp: Fp, yp: Fp, F: Type[Fp]
) -> Tuple12:
    """Sparse line through the untwisted point with slope lambda*w,
    evaluated at P = (xp, yp) in G1."""
    els = [F(0)] * 12
    els[0] = yp
    w1 = lam.mul(Fq2(-xp, F(0)))  # -lambda * x_P
    w3 = lam.mul(xt).sub(yt)  # lambda * x_T - y_T
    els[1], els[7] = w1.c0, w1.c1
    els[3], els[9] = w3.c0, w3.c1
    return Tuple12(els, F)


def miller_loop(p: AffinePoint, q: G2Point) -> Tuple12:
    F = field(p.curve.base_modulus)
    if p.is_inf or q.is_inf:
        return Tuple12.one(F)
    modulus = p.curve.base_modulus
    xp, yp = p.x, p.y
    f = Tuple12.one(F)
    xt, yt = q.x, q.y

    three = Fq2(F(3), F(0))

    def dbl_step(f, xt, yt):
        lam = xt.square().mul(three).mul(yt.add(yt).invert())
        f = f.mul(_line(lam, xt, yt, xp, yp, F))
        x3 = lam.square().sub(xt).sub(xt)
        y3 = lam.mul(xt.sub(x3)).sub(yt)
        return f, x3, y3

    def add_step(f, xt, yt, x2, y2):
        lam = y2.sub(yt).mul(x2.sub(xt).invert())
        f = f.mul(_line(lam, xt, yt, xp, yp, F))
        x3 = lam.square().sub(xt).sub(x2)
        y3 = lam.mul(xt.sub(x3)).sub(yt)
        return f, x3, y3

    bits = bin(ATE_LOOP_COUNT)[3:]  # skip the MSB
    for b in bits:
        f = f.square()
        f, xt, yt = dbl_step(f, xt, yt)
        if b == "1":
            f, xt, yt = add_step(f, xt, yt, q.x, q.y)

    # Frobenius end steps: l_{T,Q1}, then l_{T,-Q2}
    q1 = _g2_frobenius(q, modulus)
    q2 = _g2_frobenius(q1, modulus)
    f, xt, yt = add_step(f, xt, yt, q1.x, q1.y)
    f, _, _ = add_step(f, xt, yt, q2.x, q2.y.neg())
    return f


@lru_cache(maxsize=None)
def _final_exp_exponent(modulus: int, r: int) -> int:
    return (modulus**12 - 1) // r


def final_exponentiation(f: Tuple12, modulus: int = BN254_FQ,
                         r: int = BN254_FR) -> Tuple12:
    return f.scalar_mul(_final_exp_exponent(modulus, r))


def pairing(p: AffinePoint, q: G2Point) -> Tuple12:
    """e: G1 x G2 -> Gt as a reference-layout Tuple12.

    Routes to the native C++ implementation (native/pairing.cpp) when
    available and the curve is BN254 — the host final exponentiation is a
    ~3000-bit Fq12 square-and-multiply (~1s/pairing in python).
    Set MIRA_PAIRING=host to force the python path."""
    import os

    if (
        p.curve.base_modulus == BN254_FQ
        and os.environ.get("MIRA_PAIRING", "auto") != "host"
        and not (p.is_inf or q.is_inf)
    ):
        out = _pairing_native(p, q)
        if out is not None:
            return out
    return final_exponentiation(miller_loop(p, q), p.curve.base_modulus,
                                p.curve.scalar_modulus)


# ---------------------------------------------------------------------------
# native routing (4x64 C++ kernels; bit-identical to the host path — see
# tests/test_pairing.py native-vs-host case)

def _fq_words(v: int) -> list:
    return [(v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(4)]


@lru_cache(maxsize=None)
def _native_ctx():
    from ..utils.native_lib import load_pairing

    lib = load_pairing()
    if lib is None:
        return None
    import ctypes

    import numpy as np

    g2, g3 = _frobenius_gammas(BN254_FQ)
    gamma2 = np.asarray(
        _fq_words(g2.c0.v) + _fq_words(g2.c1.v), dtype=np.uint64
    )
    gamma3 = np.asarray(
        _fq_words(g3.c0.v) + _fq_words(g3.c1.v), dtype=np.uint64
    )
    e = _final_exp_exponent(BN254_FQ, BN254_FR)
    fe_exp = np.frombuffer(
        e.to_bytes((e.bit_length() + 7) // 8, "little"), dtype=np.uint8
    ).copy()
    return lib, gamma2, gamma3, fe_exp, ctypes, np


def _t12_from_words(out, F) -> Tuple12:
    vals = []
    for i in range(12):
        v = 0
        for j in range(4):
            v |= int(out[4 * i + j]) << (64 * j)
        vals.append(F(v))
    return Tuple12(vals, F)


def _pairing_native(p: AffinePoint, q: G2Point):
    ctx = _native_ctx()
    if ctx is None:
        return None
    lib, gamma2, gamma3, fe_exp, ctypes, np = ctx
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    xp = np.asarray(_fq_words(p.x.v), dtype=np.uint64)
    yp = np.asarray(_fq_words(p.y.v), dtype=np.uint64)
    xq = np.asarray(_fq_words(q.x.c0.v) + _fq_words(q.x.c1.v), dtype=np.uint64)
    yq = np.asarray(_fq_words(q.y.c0.v) + _fq_words(q.y.c1.v), dtype=np.uint64)
    out = np.zeros(48, dtype=np.uint64)
    rc = lib.mira_pairing(
        xp.ctypes.data_as(u64p), yp.ctypes.data_as(u64p),
        xq.ctypes.data_as(u64p), yq.ctypes.data_as(u64p),
        gamma2.ctypes.data_as(u64p), gamma3.ctypes.data_as(u64p),
        fe_exp.ctypes.data_as(u8p), len(fe_exp),
        out.ctypes.data_as(u64p),
    )
    if rc != 0:  # pragma: no cover
        return None
    return _t12_from_words(out, field(BN254_FQ))


def gt_mul_native(a: Tuple12, b: Tuple12):
    """Native Gt multiply, or None when unavailable/forced host.  Called
    from Tuple12.mul itself (curves/host.py), so no host fallback here."""
    import os

    if os.environ.get("MIRA_PAIRING", "auto") == "host" or a.F.P != BN254_FQ:
        return None
    ctx = _native_ctx()
    if ctx is None:
        return None
    lib, _g2, _g3, _fe, ctypes, np = ctx
    u64p = ctypes.POINTER(ctypes.c_uint64)
    aw = np.asarray(sum((_fq_words(e.v) for e in a.elements), []), dtype=np.uint64)
    bw = np.asarray(sum((_fq_words(e.v) for e in b.elements), []), dtype=np.uint64)
    out = np.zeros(48, dtype=np.uint64)
    lib.mira_gt_mul(
        aw.ctypes.data_as(u64p), bw.ctypes.data_as(u64p),
        out.ctypes.data_as(u64p),
    )
    return _t12_from_words(out, a.F)


def gt_pow_native(a: Tuple12, k: int):
    """Native Gt exponentiation (LSB square-and-multiply, same semantics as
    the host Tuple12.scalar_mul), or None.  Called from Tuple12.scalar_mul."""
    import os

    if (
        os.environ.get("MIRA_PAIRING", "auto") == "host"
        or a.F.P != BN254_FQ
        or k <= 0
    ):
        return None
    ctx = _native_ctx()
    if ctx is None:
        return None
    lib, _g2, _g3, _fe, ctypes, np = ctx
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    aw = np.asarray(sum((_fq_words(e.v) for e in a.elements), []), dtype=np.uint64)
    eb = np.frombuffer(
        k.to_bytes((k.bit_length() + 7) // 8, "little"), dtype=np.uint8
    ).copy()
    out = np.zeros(48, dtype=np.uint64)
    lib.mira_gt_pow(
        aw.ctypes.data_as(u64p), eb.ctypes.data_as(u8p), len(eb),
        out.ctypes.data_as(u64p),
    )
    return _t12_from_words(out, a.F)
