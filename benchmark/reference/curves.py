"""The two curves of the cycle in plain Python integers: their moduli,
generators, and affine arithmetic (y^2 = x^3 + b, a = 0).

A point is a pair of ints (x, y), or None for the point at infinity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617
FQ = 21888242871839275222246405745257275088696311157297823662689037894645226208583

Point = Optional[Tuple[int, int]]


@dataclass(frozen=True)
class Curve:
    name: str
    p: int  # base field: the coordinates
    r: int  # scalar field: the group's order
    b: int
    generator: Tuple[int, int]

    def on_curve(self, pt: Point) -> bool:
        if pt is None:
            return True
        x, y = pt
        return (y * y - x * x * x - self.b) % self.p == 0

    def add(self, a: Point, c: Point) -> Point:
        p = self.p
        if a is None:
            return c
        if c is None:
            return a
        (x1, y1), (x2, y2) = a, c
        if x1 == x2:
            if (y1 + y2) % p == 0:
                return None
            lam = 3 * x1 * x1 * pow(2 * y1, p - 2, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, p - 2, p) % p
        x3 = (lam * lam - x1 - x2) % p
        return x3, (lam * (x1 - x3) - y1) % p

    def mul(self, pt: Point, k: int) -> Point:
        k %= self.r
        acc: Point = None
        while k:
            if k & 1:
                acc = self.add(acc, pt)
            pt = self.add(pt, pt)
            k >>= 1
        return acc

    def from_jacobian(self, X: int, Y: int, Z: int) -> Point:
        if Z % self.p == 0:
            return None
        zi = pow(Z, self.p - 2, self.p)
        zi2 = zi * zi % self.p
        return X * zi2 % self.p, Y * zi2 * zi % self.p


BN254 = Curve("bn254", FQ, FR, 3, (1, 2))
GRUMPKIN = Curve("grumpkin", FR, FQ, FR - 17,
                 (1, 17631683881184975370165255887551781615748388533673675138860))
CURVES = {c.name: c for c in (BN254, GRUMPKIN)}
