"""KZG polynomial commitment over BN254, verified with our own pairing
(port of mira_tpu/pcs/kzg.py, onto the port's `fields/limbs`).

Role: the reference's merkle example proves the same circuit non-IVC with
halo2's KZG backend as a baseline (reference examples/merkle/kzg.rs);
this module supplies the native PCS for that baseline
(workloads/merkle_baseline.py).

SRS here is generated from a seed tau (INSECURE — test/baseline use only;
a production SRS comes from a ceremony).  Commit is a G1 MSM over the tau
powers (the native host Pippenger, as mira_tpu's); verification is the standard pairing
check  e(C - y*G1, G2) == e(pi, tau*G2 - z*G2).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Sequence

from ..curves.host import BN254_G1, AffinePoint, G2Point, Tuple12
from ..curves.pairing import pairing
from ..fields.host import field


@dataclasses.dataclass
class KzgSrs:
    g1_powers: List[AffinePoint]  # [G1, tau G1, tau^2 G1, ...]
    g2: G2Point
    tau_g2: G2Point

    @classmethod
    def setup(cls, max_degree: int, seed: bytes = b"mira-kzg-test-srs") -> "KzgSrs":
        """Derive tau from a seed (test-only trusted setup)."""
        r = BN254_G1.scalar_modulus
        tau = int.from_bytes(
            hashlib.sha3_256(seed).digest() * 2, "little"
        ) % r
        g1 = AffinePoint.generator(BN254_G1)
        Fq = field(BN254_G1.base_modulus)
        g2 = G2Point.generator(Fq)
        scalars, acc = [], 1
        for _ in range(max_degree + 1):
            scalars.append(acc)
            acc = acc * tau % r
        return cls(_times(g1, scalars), g2, g2.scalar_mul(tau))

    def max_degree(self) -> int:
        return len(self.g1_powers) - 1

    @classmethod
    def load_or_setup_cache(cls, max_degree: int,
                            seed: bytes = b"mira-kzg-test-srs",
                            cache_dir: str = ".cache/kzg") -> "KzgSrs":
        import os

        import numpy as np

        from ..fields.limbs import ints_to_limbs, limbs_to_ints

        tag = hashlib.sha3_256(seed).hexdigest()[:16]
        path = os.path.join(cache_dir, f"{tag}_{max_degree}.npy")
        if os.path.exists(path):
            arr = np.load(path)
            F = field(BN254_G1.base_modulus)
            xs = limbs_to_ints(arr[:, 0])
            ys = limbs_to_ints(arr[:, 1])
            g1 = [AffinePoint(BN254_G1, F(x), F(y)) for x, y in zip(xs, ys)]
            for p in (g1[0], g1[-1]):
                assert p.is_on_curve(), "corrupted KZG SRS cache"
            srs = cls.setup(0, seed)  # cheap: rebuilds g2 / tau*g2 only
            srs.g1_powers = g1
            return srs
        srs = cls.setup(max_degree, seed)
        os.makedirs(cache_dir, exist_ok=True)
        arr = np.stack(
            [
                np.asarray(ints_to_limbs([p.x.v for p in srs.g1_powers])),
                np.asarray(ints_to_limbs([p.y.v for p in srs.g1_powers])),
            ],
            axis=1,
        )
        np.save(path, arr)
        return srs


def _times(g: AffinePoint, scalars: List[int]) -> List[AffinePoint]:
    """[s * g for s in scalars], each on the native host MSM where it is
    built (a one-point MSM, no thread pool), else by scalar_mul."""
    from ..ops.native_msm import available, msm_native

    if available():
        return [msm_native([s], [g], nthreads=1) for s in scalars]
    return [g.scalar_mul(s) for s in scalars]


def _poly_eval(coeffs: Sequence[int], z: int, r: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % r
    return acc


def _poly_div_linear(coeffs: Sequence[int], z: int, r: int) -> List[int]:
    """Synthetic division: (p(X) - p(z)) / (X - z); exact by construction."""
    q = [0] * (len(coeffs) - 1)
    acc = 0
    for i in range(len(coeffs) - 1, 0, -1):
        acc = (acc * z + coeffs[i]) % r
        q[i - 1] = acc
    return q


def _msm(scalars: List[int], points: List[AffinePoint]) -> AffinePoint:
    from ..ops.native_msm import available, msm_native

    nz = [(s % BN254_G1.scalar_modulus, p) for s, p in zip(scalars, points)]
    nz = [(s, p) for s, p in nz if s]
    if not nz:
        return AffinePoint.identity(BN254_G1)
    sc, pts = [list(x) for x in zip(*nz)]
    if available():
        return msm_native(sc, pts)
    from ..curves.host import msm_host_pippenger

    return msm_host_pippenger(sc, pts)


def kzg_commit(srs: KzgSrs, coeffs: Sequence[int]) -> AffinePoint:
    assert len(coeffs) <= len(srs.g1_powers), "polynomial degree exceeds SRS"
    return _msm(list(coeffs), srs.g1_powers[: len(coeffs)])


def kzg_open(srs: KzgSrs, coeffs: Sequence[int], z: int):
    """Returns (y, pi): the evaluation p(z) and the witness commitment."""
    r = BN254_G1.scalar_modulus
    y = _poly_eval(coeffs, z, r)
    if len(coeffs) <= 1:
        return y, AffinePoint.identity(BN254_G1)
    q = _poly_div_linear(list(coeffs), z % r, r)
    return y, kzg_commit(srs, q)


def _gt_eq(a: Tuple12, b: Tuple12) -> bool:
    return [c.v for c in a.elements] == [c.v for c in b.elements]


def kzg_verify(srs: KzgSrs, commitment: AffinePoint, z: int, y: int,
               proof: AffinePoint) -> bool:
    """e(C - y*G1, G2) == e(pi, tau*G2 - z*G2)."""
    r = BN254_G1.scalar_modulus
    g1 = AffinePoint.generator(BN254_G1)
    lhs_pt = commitment.add(g1.scalar_mul((-y) % r))
    rhs_g2 = srs.tau_g2.add(srs.g2.scalar_mul((-z) % r))
    return _gt_eq(pairing(lhs_pt, srs.g2), pairing(proof, rhs_g2))
