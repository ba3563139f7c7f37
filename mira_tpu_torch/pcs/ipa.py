"""Inner-product-argument polynomial commitment (Bulletproofs/halo2-IPA
style) over an arbitrary curve, used with Grumpkin for the merkle
baseline, mirroring the reference's halo2 IPA backend
(reference examples/merkle/ipa.rs).

Copied from mira_tpu/pcs/ipa.py (the port imports nothing of mira_tpu); its
generators are the port's commitment key's host points, and `IpaSrs.setup`
takes the device that key is loaded for.

Commit: Pedersen vector commitment C = <a, G> over XOF-derived generators
(no blinding — baseline use).  Open at z proves <a, (1, z, ..., z^{n-1})> = y
with log2(n) halving rounds; Fiat-Shamir challenges come from the Poseidon
transcript so proofs are non-interactive.
"""

from __future__ import annotations

import dataclasses
from typing import List

from ..curves.host import AffinePoint, CurveParams
from ..ops.commitment import CommitmentKey
from ..ops.poseidon import create_ro


def _msm(scalars, points):
    from ..ops.native_msm import available, msm_native

    nz = [(s, p) for s, p in zip(scalars, points) if s]
    if not nz:
        return AffinePoint.identity(points[0].curve)
    sc, pts = [list(x) for x in zip(*nz)]
    if available():
        return msm_native(sc, pts)
    from ..curves.host import msm_host

    return msm_host(sc, pts)


@dataclasses.dataclass
class IpaSrs:
    curve: CurveParams
    gens: List[AffinePoint]  # n generators
    u: AffinePoint  # inner-product pairing base

    @classmethod
    def setup(cls, curve: CurveParams, k: int, label: bytes = b"mira-ipa",
              device="cuda") -> "IpaSrs":
        """2^k generators + one extra XOF point as the inner-product base."""
        ck = CommitmentKey.load_or_setup_cache(curve, k + 1, label.decode(),
                                               device=device)
        pts = list(ck.points)
        return cls(curve, pts[: (1 << k)], pts[1 << k])


@dataclasses.dataclass
class IpaProof:
    l_points: List[AffinePoint]
    r_points: List[AffinePoint]
    a_final: int


def _transcript_challenge(ro, points, r: int) -> int:
    for p in points:
        ro.absorb_point(p)
    from ..fields.host import field

    c = ro.squeeze(field(r), 127).v
    return c if c else 1


def ipa_commit(srs: IpaSrs, coeffs: List[int]) -> AffinePoint:
    assert len(coeffs) <= len(srs.gens), "polynomial degree exceeds SRS"
    return _msm([c % srs.curve.scalar_modulus for c in coeffs],
                srs.gens[: len(coeffs)])


def ipa_open(srs: IpaSrs, coeffs: List[int], z: int) -> tuple:
    """Returns (y, IpaProof).

    The folded generator vector is kept IMPLICIT: g^{(j)}_i =
    sum_{m mod n_j == i} w_m G_m with per-original-index weights w_m updated
    by u^{+-1} per round, so each round's L/R are single MSMs over the
    ORIGINAL generators (native Pippenger) instead of n_j point scalar-muls."""
    r = srs.curve.scalar_modulus
    n0 = 1 << max((len(coeffs) - 1).bit_length(), 0)
    a = [c % r for c in coeffs] + [0] * (n0 - len(coeffs))
    b, acc = [], 1
    for _ in range(n0):
        b.append(acc)
        acc = acc * z % r
    y = sum(ai * bi for ai, bi in zip(a, b)) % r

    w = [1] * n0  # weight of G_m in its current folded slot
    gens = srs.gens[:n0]
    ro = create_ro(srs.curve.base_modulus)
    ls, rs = [], []
    n = n0
    while n > 1:
        h = n // 2
        a_lo, a_hi = a[:h], a[h:]
        b_lo, b_hi = b[:h], b[h:]
        cl = sum(x * yv for x, yv in zip(a_lo, b_hi)) % r
        cr = sum(x * yv for x, yv in zip(a_hi, b_lo)) % r
        # L = <a_lo, g_hi>: original index m contributes iff (m mod n) >= h
        sc_l = [0] * n0
        sc_r = [0] * n0
        for m in range(n0):
            i = m % n
            if i >= h:
                sc_l[m] = a_lo[i - h] * w[m] % r
            else:
                sc_r[m] = a_hi[i] * w[m] % r
        L = _msm(sc_l, gens).add(srs.u.scalar_mul(cl))
        R = _msm(sc_r, gens).add(srs.u.scalar_mul(cr))
        ls.append(L)
        rs.append(R)
        u = _transcript_challenge(ro, [L, R], r)
        uinv = pow(u, r - 2, r)
        a = [(lo * u + hi * uinv) % r for lo, hi in zip(a_lo, a_hi)]
        b = [(lo * uinv + hi * u) % r for lo, hi in zip(b_lo, b_hi)]
        for m in range(n0):
            w[m] = w[m] * (u if (m % n) >= h else uinv) % r
        n = h
    return y, IpaProof(ls, rs, a[0])


def ipa_verify(srs: IpaSrs, commitment: AffinePoint, z: int, y: int,
               proof: IpaProof, num_coeffs: int) -> bool:
    r = srs.curve.scalar_modulus
    n = 1 << max((num_coeffs - 1).bit_length(), 0)
    assert len(proof.l_points) == n.bit_length() - 1 or n == 1

    ro = create_ro(srs.curve.base_modulus)
    us = [
        _transcript_challenge(ro, [L, R], r)
        for L, R in zip(proof.l_points, proof.r_points)
    ]
    # s_i = prod over j of (u_j if bit_j(i) else u_j^-1), MSB-first rounds
    k = len(us)
    s = [1] * n
    for j, u in enumerate(us):
        uinv = pow(u, r - 2, r)
        for i in range(n):
            s[i] = s[i] * (u if (i >> (k - 1 - j)) & 1 else uinv) % r
    g_final = _msm(s, srs.gens[:n])
    b, acc = [], 1
    for _ in range(n):
        b.append(acc)
        acc = acc * z % r
    b_final = sum(si * bi for si, bi in zip(s, b)) % r

    lhs = g_final.scalar_mul(proof.a_final).add(
        srs.u.scalar_mul(proof.a_final * b_final % r)
    )
    rhs = commitment.add(srs.u.scalar_mul(y))
    for u, L, R in zip(us, proof.l_points, proof.r_points):
        u2 = u * u % r
        rhs = rhs.add(L.scalar_mul(u2)).add(
            R.scalar_mul(pow(u2, r - 2, r))
        )
    return lhs == rhs
