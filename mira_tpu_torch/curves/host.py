"""Host-side curve layer: bn254 G1, grumpkin, G2 (Fq2), and the Gt/Fp12 tuple.

Golden reference for the device (limb) curve kernels and workhorse for the
sequential protocol layer.  Semantics mirror the reference's off-circuit
gadget halves:

* affine `Point` add/double/scalar_mul: src/gadgets/ecc.rs:33-140
* `Tuple2` (Fq2): src/gadgets/fp2.rs:35-111 — NOTE the
  reference's `Tuple2::add` has an apparent bug (`c1 = self.c0 + other.c1`);
  we implement the mathematically correct addition and flag the divergence.
* `Tuple12` (Fp12/Gt as 12 base-field coeffs, schoolbook 6x6 with xi0
  reduction): src/gadgets/fp12.rs:22-148, generator constants
  fp12.rs:178-231.
* G2 affine arithmetic over Fq2: src/gadgets/ecc2.rs:38-148.

Copied from mira_tpu/curves/host.py; the port imports nothing of mira_tpu.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import List, Optional, Type

from ..fields.host import Fp, field
from ..fields.params import BN254_FQ, BN254_FR

XI_0 = 9  # BN254 sextic twist: Fp12 = Fp2[w]/(w^6 - (u + 9))


# ---------------------------------------------------------------------------
# Curve parameter tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CurveParams:
    name: str
    base_modulus: int  # field the coordinates live in
    scalar_modulus: int  # group order
    b: int  # y^2 = x^3 + b
    gen_x: int
    gen_y: int


def _grumpkin_gen_y() -> int:
    # y^2 = 1 - 17 = -16 over bn254 Fr; halo2curves/arkworks pick
    # y = 17631683881184975370165255887551781615748388533673675138860
    y = 17631683881184975370165255887551781615748388533673675138860
    assert (y * y) % BN254_FR == (BN254_FR - 16) % BN254_FR
    return y


BN254_G1 = CurveParams(
    name="bn254",
    base_modulus=BN254_FQ,
    scalar_modulus=BN254_FR,
    b=3,
    gen_x=1,
    gen_y=2,
)

GRUMPKIN = CurveParams(
    name="grumpkin",
    base_modulus=BN254_FR,
    scalar_modulus=BN254_FQ,
    b=BN254_FR - 17,
    gen_x=1,
    gen_y=_grumpkin_gen_y(),
)


def curve_cycle(primary: CurveParams):
    """Return (primary, secondary) of the 2-cycle."""
    return (BN254_G1, GRUMPKIN) if primary is BN254_G1 else (GRUMPKIN, BN254_G1)


# ---------------------------------------------------------------------------
# Affine points (short Weierstrass, a = 0)
# ---------------------------------------------------------------------------


class AffinePoint:
    """Affine point; (0, 0, is_inf=True) is the identity."""

    __slots__ = ("x", "y", "is_inf", "curve")

    def __init__(self, curve: CurveParams, x: Fp | int = 0, y: Fp | int = 0, is_inf=False):
        F = field(curve.base_modulus)
        self.curve = curve
        self.x = x if isinstance(x, Fp) else F(x)
        self.y = y if isinstance(y, Fp) else F(y)
        self.is_inf = is_inf

    # -- constructors -------------------------------------------------------
    @classmethod
    def identity(cls, curve: CurveParams) -> "AffinePoint":
        return cls(curve, 0, 0, True)

    @classmethod
    def generator(cls, curve: CurveParams) -> "AffinePoint":
        return cls(curve, curve.gen_x, curve.gen_y)

    @classmethod
    def random(cls, curve: CurveParams, rng) -> "AffinePoint":
        F = field(curve.base_modulus)
        while True:
            x = F.random(rng)
            y = (x * x * x + F(curve.b)).sqrt()
            if y is not None:
                return cls(curve, x, y)

    def is_identity(self) -> bool:
        return self.is_inf

    def is_on_curve(self) -> bool:
        if self.is_inf:
            return True
        F = field(self.curve.base_modulus)
        return self.y * self.y == self.x * self.x * self.x + F(self.curve.b)

    # -- group law (mirrors reference ecc.rs:33-140) ------------------------
    def add(self, other: "AffinePoint") -> "AffinePoint":
        if self.is_inf:
            return other
        if other.is_inf:
            return self
        if self.x == other.x:
            if self.y == other.y:
                return self.double()
            return AffinePoint.identity(self.curve)
        lam = (other.y - self.y) * (other.x - self.x).invert()
        x = lam * lam - self.x - other.x
        y = lam * (self.x - x) - self.y
        return AffinePoint(self.curve, x, y)

    def double(self) -> "AffinePoint":
        if self.is_inf:
            return self
        F = field(self.curve.base_modulus)
        lam = F(3) * self.x * self.x * (self.y.double()).invert()
        x = lam * lam - self.x - self.x
        y = lam * (self.x - x) - self.y
        return AffinePoint(self.curve, x, y)

    def neg(self) -> "AffinePoint":
        if self.is_inf:
            return self
        return AffinePoint(self.curve, self.x, -self.y)

    def scalar_mul(self, scalar: Fp | int) -> "AffinePoint":
        k = scalar.v if isinstance(scalar, Fp) else scalar % self.curve.scalar_modulus
        res = AffinePoint.identity(self.curve)
        for i in reversed(range(k.bit_length())):
            res = res.double()
            if (k >> i) & 1:
                res = res.add(self)
        return res

    def __eq__(self, other):
        if self.is_inf or other.is_inf:
            return self.is_inf and other.is_inf
        return self.x == other.x and self.y == other.y

    def __repr__(self):
        if self.is_inf:
            return f"{self.curve.name}::inf"
        return f"{self.curve.name}({self.x.v}, {self.y.v})"


class LazyAffinePoint(AffinePoint):
    """AffinePoint whose coordinates materialize on first access.

    Carries a thunk (typically: decode an in-flight device MSM result) and
    forces it only when x/y/is_inf are first read — equality, group ops,
    transcript absorption all inherit from AffinePoint and force
    transparently.  This is the per-step overlap lever (VERDICT r4 item 3):
    the SPS witness commitment's device MSM is dispatched at trace
    generation but its host sync slides to the NEXT phase's transcript
    absorption, after the cross-term evaluation and MSMs have been
    dispatched behind it — the host never idles on a decode while it still
    has device work to enqueue."""

    __slots__ = ("_thunk",)

    def __init__(self, curve: CurveParams, thunk):
        # bypass AffinePoint.__init__: x/y/is_inf slots stay unset until
        # _force(); reading an unset slot raises AttributeError, which
        # routes through __getattr__ below
        AffinePoint.curve.__set__(self, curve)
        self._thunk = thunk

    def _force(self):
        thunk = self._thunk
        if thunk is not None:
            pt = thunk()
            self._thunk = None
            AffinePoint.x.__set__(self, pt.x)
            AffinePoint.y.__set__(self, pt.y)
            AffinePoint.is_inf.__set__(self, pt.is_inf)

    def __getattr__(self, name):
        if name in ("x", "y", "is_inf"):
            self._force()
            return getattr(self, name)
        raise AttributeError(name)

    def __reduce__(self):
        # pickling persists the materialized point (int coords — the Fp
        # subclasses are factory-made and not themselves picklable)
        self._force()
        return (AffinePoint, (self.curve, self.x.v, self.y.v, self.is_inf))


def msm_host(scalars: List[int], points: List[AffinePoint]) -> AffinePoint:
    """Naive host MSM (golden reference for the device Pippenger)."""
    assert len(scalars) == len(points)
    if not points:
        raise ValueError("empty msm")
    acc = AffinePoint.identity(points[0].curve)
    for s, p in zip(scalars, points):
        acc = acc.add(p.scalar_mul(s))
    return acc


def msm_host_pippenger(
    scalars: List[int], points: List[AffinePoint], window: int = 8
) -> AffinePoint:
    """Host Pippenger over Jacobian ints (the CPU fallback commitment path;
    structurally the reference's best_multiexp bucket method)."""
    assert len(scalars) == len(points)
    curve = points[0].curve
    p = curve.base_modulus

    # jacobian ops over plain ints; None encodes infinity
    def jdouble(pt):
        if pt is None:
            return None
        X, Y, Z = pt
        if Y == 0:
            return None
        A = X * X % p
        B = Y * Y % p
        C = B * B % p
        D = 2 * ((X + B) ** 2 - A - C) % p
        E = 3 * A % p
        F = E * E % p
        X3 = (F - 2 * D) % p
        Y3 = (E * (D - X3) - 8 * C) % p
        Z3 = 2 * Y * Z % p
        return (X3, Y3, Z3)

    def jadd(a, b):
        if a is None:
            return b
        if b is None:
            return a
        X1, Y1, Z1 = a
        X2, Y2, Z2 = b
        Z1Z1 = Z1 * Z1 % p
        Z2Z2 = Z2 * Z2 % p
        U1 = X1 * Z2Z2 % p
        U2 = X2 * Z1Z1 % p
        S1 = Y1 * Z2 * Z2Z2 % p
        S2 = Y2 * Z1 * Z1Z1 % p
        H = (U2 - U1) % p
        R = (S2 - S1) % p
        if H == 0:
            if R == 0:
                return jdouble(a)
            return None
        HH = H * H % p
        HHH = H * HH % p
        V = U1 * HH % p
        X3 = (R * R - HHH - 2 * V) % p
        Y3 = (R * (V - X3) - S1 * HHH) % p
        Z3 = Z1 * Z2 * H % p
        return (X3, Y3, Z3)

    jac_pts = [None if q.is_inf else (q.x.v, q.y.v, 1) for q in points]
    nbits = curve.scalar_modulus.bit_length()
    nwin = (nbits + window - 1) // window
    acc = None
    for w in reversed(range(nwin)):
        for _ in range(window):
            acc = jdouble(acc)
        buckets: dict = {}
        shift = w * window
        mask = (1 << window) - 1
        for s, q in zip(scalars, jac_pts):
            d = (s >> shift) & mask
            if d and q is not None:
                buckets[d] = jadd(buckets.get(d), q)
        running, total = None, None
        for d in range(mask, 0, -1):
            if d in buckets:
                running = jadd(running, buckets[d])
            if running is not None:
                total = jadd(total, running)
        acc = jadd(acc, total)
    if acc is None:
        return AffinePoint.identity(curve)
    X, Y, Z = acc
    F = field(p)
    zinv = pow(Z, -1, p)
    zi2 = zinv * zinv % p
    return AffinePoint(curve, F(X * zi2), F(Y * zi2 * zinv % p))


# ---------------------------------------------------------------------------
# Fq2 (Tuple2)
# ---------------------------------------------------------------------------


class Fq2:
    """c0 + c1*u with u^2 = -1 over a p ≡ 3 (mod 4) field."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fp, c1: Fp):
        self.c0 = c0
        self.c1 = c1

    @classmethod
    def zero(cls, F: Type[Fp]) -> "Fq2":
        return cls(F(0), F(0))

    @classmethod
    def one(cls, F: Type[Fp]) -> "Fq2":
        return cls(F(1), F(0))

    def add(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def sub(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def mul(self, o: "Fq2") -> "Fq2":
        return Fq2(
            self.c0 * o.c0 - self.c1 * o.c1,
            self.c0 * o.c1 + self.c1 * o.c0,
        )

    def square(self) -> "Fq2":
        return self.mul(self)

    def neg(self) -> "Fq2":
        return Fq2(-self.c0, -self.c1)

    def invert(self) -> Optional["Fq2"]:
        norm = self.c0.square() + self.c1.square()
        if norm.is_zero():
            return None
        ninv = norm.invert()
        return Fq2(self.c0 * ninv, -(self.c1 * ninv))

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero()

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def __repr__(self):
        return f"Fq2({self.c0.v} + {self.c1.v}u)"


# BN254 G2 curve constant b2 = 3 / (9 + u)
@lru_cache(maxsize=None)
def g2_b() -> Fq2:
    F = field(BN254_FQ)
    nine_u = Fq2(F(9), F(1))
    return Fq2(F(3), F(0)).mul(nine_u.invert())


# halo2curves bn256 G2 generator (standard constants)
G2_GEN_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GEN_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)


class G2Point:
    """Affine point on the BN254 twist over Fq2
    (reference src/gadgets/ecc2.rs)."""

    __slots__ = ("x", "y", "is_inf")

    def __init__(self, x: Fq2, y: Fq2, is_inf=False):
        self.x = x
        self.y = y
        self.is_inf = is_inf

    @classmethod
    def identity(cls, F=None) -> "G2Point":
        F = F or field(BN254_FQ)
        return cls(Fq2.zero(F), Fq2.zero(F), True)

    @classmethod
    def generator(cls, F=None) -> "G2Point":
        """NOTE: for F != bn254 Fq the constants are reduced into F -- the
        reference instantiates the same constants in whatever C::Base is
        current (its g2 elements are random placeholders anyway)."""
        F = F or field(BN254_FQ)
        return cls(
            Fq2(F(G2_GEN_X[0]), F(G2_GEN_X[1])),
            Fq2(F(G2_GEN_Y[0]), F(G2_GEN_Y[1])),
        )

    @classmethod
    def random(cls, rng, F=None) -> "G2Point":
        return cls.generator(F).scalar_mul(rng.randrange(BN254_FR))

    def is_on_curve(self) -> bool:
        if self.is_inf:
            return True
        lhs = self.y.square()
        rhs = self.x.square().mul(self.x).add(g2_b())
        return lhs == rhs

    def add(self, o: "G2Point") -> "G2Point":
        if self.is_inf:
            return o
        if o.is_inf:
            return self
        if self.x == o.x:
            if self.y == o.y:
                return self.double()
            return G2Point.identity()
        lam = o.y.sub(self.y).mul(o.x.sub(self.x).invert())
        x = lam.square().sub(self.x).sub(o.x)
        y = lam.mul(self.x.sub(x)).sub(self.y)
        return G2Point(x, y)

    def double(self) -> "G2Point":
        if self.is_inf:
            return self
        F = type(self.x.c0)
        three = Fq2(F(3), F(0))
        lam = three.mul(self.x.square()).mul(self.y.add(self.y).invert())
        x = lam.square().sub(self.x).sub(self.x)
        y = lam.mul(self.x.sub(x)).sub(self.y)
        return G2Point(x, y)

    def neg(self) -> "G2Point":
        if self.is_inf:
            return self
        return G2Point(self.x, self.y.neg())

    def scalar_mul(self, scalar: int | Fp) -> "G2Point":
        k = scalar.v if isinstance(scalar, Fp) else scalar % BN254_FR
        res = G2Point.identity(type(self.x.c0) if not self.is_inf else None)
        for i in reversed(range(k.bit_length())):
            res = res.double()
            if (k >> i) & 1:
                res = res.add(self)
        return res

    def __eq__(self, o):
        if self.is_inf or o.is_inf:
            return self.is_inf and o.is_inf
        return self.x == o.x and self.y == o.y


# ---------------------------------------------------------------------------
# Tuple12 (Fp12 / Gt representative)
# ---------------------------------------------------------------------------

# BN254 Gt generator = e(G1, G2) coefficients
# (reference src/gadgets/fp12.rs:178-231)
GT_GENERATOR_COEFFS = [
    8493334370784016972005089913588211327688223499729897951716206968320726508021,
    20049218015652006197026173611347504489508678646783216776320737476707192559881,
    6565798094314091391201231504228224566495939541538094766881371862976727043038,
    12145052038566888241256672223106590273978429515702193755778990643425246950730,
    634997487638609332803583491743335852620873788902390365055086820718589720118,
    6223602427219597392892794664899549544171383137467762280768257680446283161705,
    3758435817766288188804561253838670030762970764366672594784247447067868088068,
    18059168546148152671857026372711724379319778306792011146784665080987064164612,
    14656606573936501743457633041048024656612227301473084805627390748872617280984,
    17918828665069491344039743589118342552553375221610735811112289083834142789347,
    19455424343576886430889849773367397946457449073528455097210946839000147698372,
    7484542354754424633621663080190936924481536615300815203692506276894207018007,
]


class Tuple12:
    """Fp12 element as 12 coefficients (a_{i0}, a_{i1} interleaved as the
    reference's layout: first 6 are c0-parts, last 6 are c1-parts of the
    w^i coefficients).  Multiplication is the reference's schoolbook 6x6
    with xi0 reduction (fp12.rs:65-117), reproduced exactly."""

    __slots__ = ("elements", "F")

    def __init__(self, elements: List[Fp], F: Type[Fp] | None = None):
        assert len(elements) == 12
        self.elements = list(elements)
        self.F = F or type(elements[0])

    @classmethod
    def zero(cls, F: Type[Fp]) -> "Tuple12":
        return cls([F(0)] * 12, F)

    @classmethod
    def one(cls, F: Type[Fp]) -> "Tuple12":
        els = [F(0)] * 12
        els[0] = F(1)
        return cls(els, F)

    @classmethod
    def generator(cls, F: Type[Fp]) -> "Tuple12":
        """NOTE: the reference instantiates these constants in whatever base
        field C::Base is current (fp12.rs:178); we mirror that behavior."""
        return cls([F(c) for c in GT_GENERATOR_COEFFS], F)

    def add(self, o: "Tuple12") -> "Tuple12":
        return Tuple12([a + b for a, b in zip(self.elements, o.elements)], self.F)

    def neg(self) -> "Tuple12":
        return Tuple12([-a for a in self.elements], self.F)

    def mul(self, o: "Tuple12", xi_0: int = XI_0) -> "Tuple12":
        F = self.F
        if F.P == BN254_FQ and xi_0 == XI_0:
            # native 4x64 kernel (native/pairing.cpp) — bit-identical, ~50x
            from .pairing import gt_mul_native

            out = gt_mul_native(self, o)
            if out is not None:
                return out
        z = F(0)
        a0b0 = [z] * 11
        a0b1 = [z] * 11
        a1b0 = [z] * 11
        a1b1 = [z] * 11
        s, t = self.elements, o.elements
        for i in range(6):
            for j in range(6):
                a0b0[i + j] = a0b0[i + j] + s[i] * t[j]
                a0b1[i + j] = a0b1[i + j] + s[i] * t[j + 6]
                a1b0[i + j] = a1b0[i + j] + s[i + 6] * t[j]
                a1b1[i + j] = a1b1[i + j] + s[i + 6] * t[j + 6]
        sub = [a0b0[i] - a1b1[i] for i in range(11)]
        add = [a0b1[i] + a1b0[i] for i in range(11)]
        xi = F(xi_0)
        out = [z] * 12
        for i in range(6):
            if i < 5:
                out[i] = xi * sub[i + 6] + sub[i] - add[i + 6]
            else:
                out[i] = sub[i]
        for i in range(6):
            if i < 5:
                out[i + 6] = add[i] + sub[i + 6] + xi * add[i + 6]
            else:
                out[i + 6] = add[i]
        return Tuple12(out, F)

    def square(self) -> "Tuple12":
        return self.mul(self)

    def scalar_mul(self, scalar: int | Fp, num_bits: int | None = None) -> "Tuple12":
        """LSB-first square-and-multiply (reference fp12.rs:119-148)."""
        k = scalar.v if isinstance(scalar, Fp) else scalar
        if k == 0:
            return Tuple12.one(self.F)
        if k > 0 and self.F.P == BN254_FQ:
            from .pairing import gt_pow_native

            out = gt_pow_native(self, k)
            if out is not None:
                return out
        acc = self if (k & 1) else Tuple12.one(self.F)
        p = self.mul(self)
        k >>= 1
        while k > 0:
            if k & 1:
                acc = acc.mul(p)
            p = p.mul(p)
            k >>= 1
        return acc

    def __eq__(self, o):
        return all(a == b for a, b in zip(self.elements, o.elements))

    def __repr__(self):
        return f"Tuple12({[e.v for e in self.elements[:2]]}...)"
