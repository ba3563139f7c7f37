"""A plain Groth16 verifier and the Gt invariant of folded Groth16 proofs,
over reference/pairing.py.

A verifying key is (alpha in G1, beta, gamma, delta in G2, [IC_0, IC_1, ...]
in G1); a proof is (A in G1, B in G2, C in G1).  A proof of public inputs x
is valid where

    e(A, B) = e(alpha, beta) e(vk_x, gamma) e(C, delta),  vk_x = IC_0 + sum x_i IC_i.

Folded proofs carry the relaxed form of that relation (Mira's accumulation,
degree 2 in the slack u):

    R(U) = e(A, B) e(C, -delta)^u e(vk_x, -gamma)^u e(alpha, beta)^(-u^2),

which is 1 for a fresh valid proof (u = 1) and equals the folded Gt element of
an accumulator of valid proofs folded with their cross terms.  The powers by
u are taken in G1 (e(P, Q)^k = e(kP, Q)), so one final exponentiation serves
each product.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from . import pairing
from .curves import BN254, FR, Point


@dataclass
class VerifyingKey:
    alpha: Point
    beta: pairing.G2
    gamma: pairing.G2
    delta: pairing.G2
    ic: List[Point]


@dataclass
class Proof:
    a: Point
    b: pairing.G2
    c: Point


def vk_x(vk: VerifyingKey, public_inputs: Sequence[int]) -> Point:
    if len(public_inputs) + 1 != len(vk.ic):
        raise ValueError(f"{len(public_inputs)} public inputs for {len(vk.ic) - 1}")
    acc = vk.ic[0]
    for x, ic in zip(public_inputs, vk.ic[1:]):
        acc = BN254.add(acc, BN254.mul(ic, x))
    return acc


def _in_groups(points: Sequence[Point], g2s: Sequence[pairing.G2]) -> bool:
    return (all(BN254.on_curve(p) for p in points)
            and all(pairing.g2_on_curve(q) for q in g2s))


def verify(vk: VerifyingKey, proof: Proof, public_inputs: Sequence[int]) -> bool:
    if not _in_groups([proof.a, proof.c], [proof.b]):
        return False
    neg = pairing.g2_neg
    f = pairing.pairing_product([(proof.a, proof.b),
                                 (vk.alpha, neg(vk.beta)),
                                 (vk_x(vk, public_inputs), neg(vk.gamma)),
                                 (proof.c, neg(vk.delta))])
    return f == pairing.one()


def relaxed_relation(vk: VerifyingKey, a: Point, b: pairing.G2, c: Point, x: Point,
                     u: int) -> pairing.Fq12:
    """R(U) for folded elements A, B, C, vk_x and slack u."""
    neg = pairing.g2_neg
    u %= FR
    return pairing.pairing_product([(a, b),
                                    (BN254.mul(c, u), neg(vk.delta)),
                                    (BN254.mul(x, u), neg(vk.gamma)),
                                    (BN254.mul(vk.alpha, (-u * u) % FR), vk.beta)])
