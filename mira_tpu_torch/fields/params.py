"""Prime-field parameter tables for the curves used by the framework.

The two-curve cycle is bn254 (a.k.a. bn256 in halo2curves) / grumpkin:

* bn254 G1 lives over ``Fq`` and has scalar field ``Fr``.
* grumpkin lives over ``Fr`` and has scalar field ``Fq``.

The pasta fields (pallas/vesta) are included because the reference's Poseidon
known-answer test vector is phrased over pallas
(reference: src/poseidon/poseidon_hash.rs:256-282).

Derived constants (roots of unity, zeta, R^2, ...) are computed at import time
from the modulus so there is nothing to transcribe incorrectly.

Copied from mira_tpu/fields/params.py; the port imports nothing of mira_tpu.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

# ---------------------------------------------------------------------------
# Moduli
# ---------------------------------------------------------------------------

# bn254 scalar field (order of G1 / base field of grumpkin)
BN254_FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617
# bn254 base field (base field of G1 / scalar field of grumpkin)
BN254_FQ = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# pasta
PALLAS_BASE = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
VESTA_BASE = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001

# Multiplicative generators as chosen by halo2curves (bn256: Fr -> 7, Fq -> 3)
# and by the pasta_curves crate (both fields -> 5).
_GENERATORS = {
    BN254_FR: 7,
    BN254_FQ: 3,
    PALLAS_BASE: 5,
    VESTA_BASE: 5,
}


def _two_adicity(p: int) -> int:
    s, t = 0, p - 1
    while t % 2 == 0:
        s += 1
        t //= 2
    return s


@dataclasses.dataclass(frozen=True)
class FieldParams:
    """All the `ff::PrimeField`-style associated constants for one field."""

    name: str
    modulus: int
    generator: int  # multiplicative generator of F*

    @property
    def num_bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def s(self) -> int:
        """2-adicity: modulus - 1 = 2^s * t with t odd."""
        return _two_adicity(self.modulus)

    @property
    def root_of_unity(self) -> int:
        """generator ** t, a primitive 2^s-th root of unity.

        Matches `F::ROOT_OF_UNITY` in the ff crate convention used by
        halo2curves (reference consumes it at src/fft.rs:12-23).
        """
        t = (self.modulus - 1) >> self.s
        return pow(self.generator, t, self.modulus)

    @property
    def root_of_unity_inv(self) -> int:
        return pow(self.root_of_unity, -1, self.modulus)

    @property
    def two_inv(self) -> int:
        return pow(2, -1, self.modulus)

    @property
    def zeta(self) -> int:
        """Element of multiplicative order 3 (`WithSmallOrderMulGroup<3>::ZETA`).

        halo2curves derives it as g^((p-1)/3) ... squared or not depending on
        the curve; we use g^(2(p-1)/3) which matches halo2curves bn256::Fr
        (verified against the coset-FFT semantics; only consumed by the
        ProtoGalaxy coset NTT, reference src/fft.rs:178-196).
        """
        assert (self.modulus - 1) % 3 == 0
        return pow(self.generator, 2 * (self.modulus - 1) // 3, self.modulus)

    @property
    def delta(self) -> int:
        """g^(2^s): generator of the order-t subgroup (ff's DELTA)."""
        return pow(self.generator, 1 << self.s, self.modulus)


@lru_cache(maxsize=None)
def field_params(modulus: int) -> FieldParams:
    names = {
        BN254_FR: "bn254::Fr",
        BN254_FQ: "bn254::Fq",
        PALLAS_BASE: "pallas::Base",
        VESTA_BASE: "vesta::Base",
    }
    return FieldParams(
        name=names.get(modulus, f"F_{modulus % 100000}"),
        modulus=modulus,
        generator=_GENERATORS.get(modulus, 0),
    )


FR = field_params(BN254_FR)
FQ = field_params(BN254_FQ)
PALLAS_FP = field_params(PALLAS_BASE)  # pallas base == vesta scalar
VESTA_FP = field_params(VESTA_BASE)  # vesta base == pallas scalar
