"""Pairing-data generators for the SnarkStar/TensorStar workloads
(reference examples/zkml/util.rs:7-55, groth16/util.rs).

Unlike the reference — which calls halo2curves' `bn256::pairing` — the Gt
elements here come from our own optimal ate pairing (curves/pairing.py),
anchored bit-exactly to the reference's Gt generator constants.

Copied from mira_tpu/workloads/util.py; the port imports nothing of mira_tpu.
"""

from __future__ import annotations

from typing import List

from ..curves.host import BN254_G1, AffinePoint, G2Point, Tuple12
from ..curves.pairing import pairing
from ..fields.host import field


def generate_random_g1_elems(rng, nproofs: int, k: int) -> List[List[AffinePoint]]:
    g = AffinePoint.generator(BN254_G1)
    return [
        [g.scalar_mul(rng.randrange(1, BN254_G1.scalar_modulus)) for _ in range(k)]
        for _ in range(nproofs)
    ]


def generate_random_g2_elems(rng, nproofs: int, k: int) -> List[List[G2Point]]:
    F = field(BN254_G1.base_modulus)
    g = G2Point.generator(F)
    return [
        [g.scalar_mul(rng.randrange(1, BN254_G1.scalar_modulus)) for _ in range(k)]
        for _ in range(nproofs)
    ]


def generate_random_cross_terms(rng, nproofs: int, k: int) -> List[List[Tuple12]]:
    """Real e(ka*G1, kb*G2) target-group elements (zkml/util.rs:37-55)."""
    F = field(BN254_G1.base_modulus)
    g1 = AffinePoint.generator(BN254_G1)
    g2 = G2Point.generator(F)
    return [
        [
            pairing(
                g1.scalar_mul(rng.randrange(1, BN254_G1.scalar_modulus)),
                g2.scalar_mul(rng.randrange(1, BN254_G1.scalar_modulus)),
            )
            for _ in range(k)
        ]
        for _ in range(nproofs)
    ]
