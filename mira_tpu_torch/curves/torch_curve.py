"""Jacobian curve arithmetic on torch tensors (port of
mira_tpu/curves/jax_curve.py).

Points are (X, Y, Z) tuples of (..., 8) int32 Montgomery word tensors; Z == 0
encodes the identity.  The group law is complete: identity operands,
P == Q (doubling) and P == -Q are exact.  `ldouble`/`ladd` work on lazy
coordinates (fields/limbs.py `Lz`) and are what the plain MSM chains; the
public `double`/`add` take and return canonical words.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..curves.host import BN254_G1, GRUMPKIN, AffinePoint, CurveParams
from ..fields.host import field

from ..fields.limbs import NUM_WORDS, Lz, limb_field, words_to_ints


class JacobianOps:
    """Group-law ops for one curve (a = 0, y^2 = x^3 + b)."""

    def __init__(self, curve: CurveParams):
        self.curve = curve
        self.lf = limb_field(curve.base_modulus)

    # -- host <-> tensor ----------------------------------------------------
    def encode_points(self, points, device="cpu"):
        """List of AffinePoint -> (X, Y, Z) words (Z = 0 for identity)."""
        lf = self.lf
        xs = [0 if p.is_inf else p.x.v for p in points]
        ys = [0 if p.is_inf else p.y.v for p in points]
        zs = [0 if p.is_inf else 1 for p in points]
        return (lf.encode(xs, device), lf.encode(ys, device),
                lf.encode(zs, device))

    def decode_points(self, pt):
        """(X, Y, Z) words -> list of AffinePoint (host ints)."""
        p = self.curve.base_modulus
        F = field(p)
        rinv = pow(1 << 256, -1, p)
        xs, ys, zs = (
            [v * rinv % p for v in words_to_ints(c.reshape(-1, NUM_WORDS))]
            for c in pt
        )
        out = []
        for x, y, z in zip(xs, ys, zs):
            if z == 0:
                out.append(AffinePoint.identity(self.curve))
            else:
                zinv = pow(z, -1, p)
                zi2 = zinv * zinv % p
                out.append(AffinePoint(self.curve, F(x * zi2), F(y * zi2 * zinv)))
        return out

    def identity(self, shape=(), device="cpu"):
        lf = self.lf
        return (lf.zero(shape, device), lf.one(shape, device),
                lf.zero(shape, device))

    # -- lazy group law ------------------------------------------------------
    def lz(self, pt):
        return tuple(self.lf.lz(c) for c in pt)

    def canon(self, pt):
        return tuple(self.lf.canon(c) for c in pt)

    def lidentity(self, shape, device):
        lf = self.lf
        zero = lf.lz_raw(0, shape, device)
        return (zero, lf.lz_const(1, shape, device), zero)

    def ldouble(self, p):
        """Jacobian doubling for a = 0 (2M + 5S); the identity (Z = 0) stays
        the identity."""
        X, Y, Z = p
        A = X.square()
        B = Y.square()
        C = B.square()
        D = ((X + B).square() - A - C).double()
        E = A + A + A
        X3 = E.square() - D.double()
        C8 = C.double().double().double()
        Y3 = E * (D - X3) - C8
        Z3 = (Y * Z).double()
        return (X3, Y3, Z3)

    def ladd(self, p, q):
        """Complete Jacobian addition of lazy points."""
        lf = self.lf
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        Z1Z1 = Z1.square()
        Z2Z2 = Z2.square()
        U1 = X1 * Z2Z2
        U2 = X2 * Z1Z1
        S1 = Y1 * Z2 * Z2Z2
        S2 = Y2 * Z1 * Z1Z1
        H = U2 - U1
        R = S2 - S1
        HH = H.square()
        HHH = H * HH
        V = U1 * HH
        X3 = R.square() - HHH - V.double()
        Y3 = R * (V - X3) - S1 * HHH
        Z3 = Z1 * Z2 * H
        p_inf, q_inf, h0, r0 = lf_is_zero_many(lf, (Z1, Z2, H, R))
        live = ~p_inf & ~q_inf
        is_double = h0 & r0 & live
        is_opp = h0 & ~r0 & live
        if bool(is_double.any()):
            dX, dY, dZ = self.ldouble(p)
            X3 = lf.where(is_double, dX, X3)
            Y3 = lf.where(is_double, dY, Y3)
            Z3 = lf.where(is_double, dZ, Z3)
        shape = X3.shape
        zero = lf.lz_raw(0, shape, X3.t.device)
        one = lf.lz_const(1, shape, X3.t.device)
        X3 = lf.where(is_opp, zero, X3)
        Y3 = lf.where(is_opp, one, Y3)
        Z3 = lf.where(is_opp, zero, Z3)
        X3 = lf.where(p_inf, _bc(X2, shape), lf.where(q_inf, _bc(X1, shape), X3))
        Y3 = lf.where(p_inf, _bc(Y2, shape), lf.where(q_inf, _bc(Y1, shape), Y3))
        Z3 = lf.where(p_inf, _bc(Z2, shape), lf.where(q_inf, _bc(Z1, shape), Z3))
        return (X3, Y3, Z3)

    def lselect(self, mask, p, q):
        return tuple(self.lf.where(mask, a, b) for a, b in zip(p, q))

    # -- canonical group law -------------------------------------------------
    def double(self, p):
        return self.canon(self.ldouble(self.lz(p)))

    def add(self, p, q):
        return self.canon(self.ladd(self.lz(p), self.lz(q)))

    def select(self, mask, p, q):
        return tuple(self.lf.select(mask, a, b) for a, b in zip(p, q))

    def neg(self, p):
        X, Y, Z = p
        return (X, self.lf.neg(Y), Z)


def _bc(x: Lz, shape) -> Lz:
    return Lz(x.f, x.t.expand(*shape, x.t.shape[-1]), x.w)


def lf_is_zero_many(lf, vals):
    """Zero tests of several lazy values in one canonicalisation."""
    shape = torch.broadcast_shapes(*(v.shape for v in vals))
    ts = [lf.settle(v).t.expand(*shape, v.t.shape[-1]) for v in vals]
    z = lf.is_zero_lz(Lz(lf, torch.stack(ts), 1))
    return tuple(z[i] for i in range(len(vals)))


@lru_cache(maxsize=None)
def jacobian_ops(curve_name: str) -> JacobianOps:
    return JacobianOps(BN254_G1 if curve_name == "bn254" else GRUMPKIN)
