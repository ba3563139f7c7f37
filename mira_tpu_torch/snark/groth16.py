"""Groth16 over BN254 on this framework's own stack (pairing, NTT, MSM);
port of mira_tpu/snark/groth16.py, whose only jax tie is its NTT import:
the host NTT comes from the port's ops/ntt.py, SatError from the port's
plonk/structure.py, and everything else from mira_tpu's jax-free modules.
The setup's G2 generator multiples and the prover's G2 MSM run in
Jacobian coordinates, the G1 multiples through mira_tpu's native MSM (see
"host group arithmetic" below): the same keys and proofs as mira_tpu's
from the same rng, in seconds instead of minutes.

The reference's SnarkStar example generates real Groth16 proofs with
arkworks, then DISCARDS them and folds random group elements — both the
instance g1/g2 slots and the Gt cross terms are placeholders
("TODO(jbeal)", reference src/plonk/mod.rs:690-703,
src/nifs/vanilla/mod.rs:130-134;
examples/groth16/main.rs:214 binds proofs/vks to `_`).

This module goes further: a complete Groth16 implementation (R1CS -> QAP ->
setup/prove/verify) plus `GtAccumulator`, the REAL pairing-based accumulation
of Mira's scheme — fold N proofs with true bilinear cross terms and check the
folded Gt invariant with actual pairings at decider time.

Relation per proof (homogenized by u, degree 2):

    R(U) = e(A, B) * e(C, -delta)^u * e(vk_x, -gamma)^u * K^(u^2),
    K = e(alpha, beta)^-1

A valid fresh proof has R = 1 at u = 1.  Folding U' = U1 + r*U2:

    R(U') = R(U1) * T1^r * T2^(r^2)
    T1 = e(A1,B2) e(A2,B1) e(C2,-d)^(u1) e(C1,-d) e(vkx2,-g)^(u1)
         e(vkx1,-g) K^(2 u1)
    T2 = e(A2,B2) e(C2,-d) e(vkx2,-g) K          (= R(U2)|_{u=1} = 1 if valid)

matching the fold recurrence gt' = gt * T1^r * T2^(r^2) of
RelaxedPlonkInstance.fold (reference plonk/mod.rs:1059-1069).
"""

from __future__ import annotations

import dataclasses
import random
from functools import lru_cache
from typing import Dict, List, Tuple

from mira_tpu.curves.host import BN254_G1, AffinePoint, Fq2, G2Point, Tuple12
from mira_tpu.curves.pairing import pairing
from mira_tpu.fields.host import field
from mira_tpu.fields.params import field_params

from ..ops.ntt import get_omega, ntt_host
from ..plonk.structure import SatError

FR = BN254_G1.scalar_modulus
FQ = BN254_G1.base_modulus

LC = Dict[int, int]  # sparse linear combination: var index -> coeff


@dataclasses.dataclass
class R1CS:
    """Rows (a, b, c) meaning <a,z> * <b,z> = <c,z>; z[0] = 1, then
    num_public public inputs, then witnesses."""

    num_vars: int
    num_public: int  # excluding the constant-1 slot
    rows: List[Tuple[LC, LC, LC]]

    def is_satisfied(self, z: List[int]) -> bool:
        p = FR

        def ev(lc):
            return sum(c * z[j] for j, c in lc.items()) % p

        return all(ev(a) * ev(b) % p == ev(c) for a, b, c in self.rows)


def benchmark_r1cs(num_constraints: int) -> Tuple[R1CS, List[int]]:
    """The reference's Benchmark circuit (examples/groth16/benchmark.rs:24-79):
    a Fibonacci-style mul/add chain over 2 public inputs, closed by one
    sum-square constraint.  Returns (r1cs, full assignment z)."""
    p = FR
    rows: List[Tuple[LC, LC, LC]] = []
    z = [1]  # constant
    a_val, b_val = 1, 1
    z.append(a_val)  # public input 1 (var 1)
    z.append(b_val)  # public input 2 (var 2)
    a_var, b_var = 1, 2
    assignments = [(a_val, a_var), (b_val, b_var)]
    next_var = 3
    for i in range(num_constraints - 1):
        if i % 2 != 0:
            c_val = (a_val * b_val) % p
            c_var = next_var
            next_var += 1
            z.append(c_val)
            rows.append(({a_var: 1}, {b_var: 1}, {c_var: 1}))
        else:
            c_val = (a_val + b_val) % p
            c_var = next_var
            next_var += 1
            z.append(c_val)
            rows.append(({a_var: 1, b_var: 1}, {0: 1}, {c_var: 1}))
        assignments.append((c_val, c_var))
        a_val, a_var = b_val, b_var
        b_val, b_var = c_val, c_var
    a_lc: LC = {}
    b_lc: LC = {}
    c_val = 0
    for val, var in assignments:
        a_lc[var] = (a_lc.get(var, 0) + 1) % p
        b_lc[var] = (b_lc.get(var, 0) + 1) % p
        c_val = (c_val + val) % p
    c_val = (c_val * c_val) % p
    c_var = next_var
    next_var += 1
    z.append(c_val)
    rows.append((a_lc, b_lc, {c_var: 1}))
    return R1CS(num_vars=next_var, num_public=2, rows=rows), z


@dataclasses.dataclass
class VerifyingKey:
    alpha_g1: AffinePoint
    beta_g2: G2Point
    gamma_g2: G2Point
    delta_g2: G2Point
    gamma_abc_g1: List[AffinePoint]  # [0] constant + one per public input

    def vk_x(self, public_inputs: List[int]) -> AffinePoint:
        acc = self.gamma_abc_g1[0]
        for coeff, base in zip(public_inputs, self.gamma_abc_g1[1:]):
            acc = acc.add(base.scalar_mul(coeff))
        return acc


@dataclasses.dataclass
class ProvingKey:
    vk: VerifyingKey
    beta_g1: AffinePoint
    delta_g1: AffinePoint
    a_query: List[AffinePoint]      # [u_j(tau)]_1
    b_g1_query: List[AffinePoint]   # [v_j(tau)]_1
    b_g2_query: List[G2Point]       # [v_j(tau)]_2
    h_query: List[AffinePoint]      # [tau^i Z(tau)/delta]_1, i < n-1
    l_query: List[AffinePoint]      # [(beta u_j + alpha v_j + w_j)/delta]_1


@dataclasses.dataclass
class Proof:
    a: AffinePoint
    b: G2Point
    c: AffinePoint


def _qap_evals_at(r1cs: R1CS, tau: int) -> Tuple[List[int], List[int], List[int], int, int]:
    """Evaluate the QAP polynomials u_j, v_j, w_j at tau via Lagrange weights
    L_i(tau) = Z(tau) * omega^i / (n * (tau - omega^i))."""
    p = FR
    n = 1
    while n < len(r1cs.rows):
        n <<= 1
    w = get_omega(p, n.bit_length() - 1)
    z_tau = (pow(tau, n, p) - 1) % p
    # Lagrange weights for occupied rows only
    li = []
    wi = 1
    for i in range(len(r1cs.rows)):
        li.append(z_tau * wi % p * pow(n * (tau - wi) % p, -1, p) % p)
        wi = (wi * w) % p
    u = [0] * r1cs.num_vars
    v = [0] * r1cs.num_vars
    wv = [0] * r1cs.num_vars
    for i, (a, b, c) in enumerate(r1cs.rows):
        L = li[i]
        for j, coeff in a.items():
            u[j] = (u[j] + coeff * L) % p
        for j, coeff in b.items():
            v[j] = (v[j] + coeff * L) % p
        for j, coeff in c.items():
            wv[j] = (wv[j] + coeff * L) % p
    return u, v, wv, n, z_tau


def setup(r1cs: R1CS, rng: random.Random) -> ProvingKey:
    """Trusted setup (toxic waste stays local to this call)."""
    p = FR
    tau, alpha, beta, gamma, delta = (rng.randrange(1, p) for _ in range(5))
    u, v, w, n, z_tau = _qap_evals_at(r1cs, tau)
    ginv = pow(gamma, -1, p)
    dinv = pow(delta, -1, p)
    npub = r1cs.num_public + 1  # constant slot included
    gamma_abc = _g1_muls([
        (beta * u[j] + alpha * v[j] + w[j]) % p * ginv % p for j in range(npub)])
    l_query = _g1_muls([
        (beta * u[j] + alpha * v[j] + w[j]) % p * dinv % p
        for j in range(npub, r1cs.num_vars)])
    h_query = _g1_muls([pow(tau, i, p) * z_tau % p * dinv % p for i in range(n - 1)])
    alpha_g1, beta_g1, delta_g1 = _g1_muls([alpha, beta, delta])
    beta_g2, gamma_g2, delta_g2 = _g2_muls([beta, gamma, delta])
    vk = VerifyingKey(
        alpha_g1=alpha_g1,
        beta_g2=beta_g2,
        gamma_g2=gamma_g2,
        delta_g2=delta_g2,
        gamma_abc_g1=gamma_abc,
    )
    return ProvingKey(
        vk=vk,
        beta_g1=beta_g1,
        delta_g1=delta_g1,
        a_query=_g1_muls(u),
        b_g1_query=_g1_muls(v),
        b_g2_query=_g2_muls(v),
        h_query=h_query,
        l_query=l_query,
    )


def _msm_g1(scalars: List[int], points: List[AffinePoint]) -> AffinePoint:
    pairs = [(s, pt) for s, pt in zip(scalars, points) if s % FR]
    if not pairs:
        return AffinePoint.identity(BN254_G1)
    sc = [s for s, _ in pairs]
    pts = [pt for _, pt in pairs]
    from mira_tpu.ops.native_msm import available, msm_native

    if available() and len(sc) >= 64:
        return msm_native(sc, pts)
    from mira_tpu.curves.host import msm_host_pippenger

    return msm_host_pippenger(sc, pts)


def _h_coefficients(r1cs: R1CS, z: List[int]) -> List[int]:
    """h(X) = (a(X) b(X) - c(X)) / Z(X), computed on the coset zeta*H where
    Z is the constant zeta^n - 1 (ops/ntt.py coset semantics)."""
    p = FR
    n = 1
    while n < len(r1cs.rows):
        n <<= 1

    def lc_evals(sel):
        out = [0] * n
        for i, row in enumerate(r1cs.rows):
            out[i] = sum(c * z[j] for j, c in row[sel].items()) % p
        return out

    a_e, b_e, c_e = lc_evals(0), lc_evals(1), lc_evals(2)
    # values on H -> coefficients
    a_c = ntt_host(a_e, p, inverse=True)
    b_c = ntt_host(b_e, p, inverse=True)
    c_c = ntt_host(c_e, p, inverse=True)
    zeta = field_params(p).zeta
    zpow = [pow(zeta, i, p) for i in range(n)]
    a_s = ntt_host([x * zp % p for x, zp in zip(a_c, zpow)], p)
    b_s = ntt_host([x * zp % p for x, zp in zip(b_c, zpow)], p)
    c_s = ntt_host([x * zp % p for x, zp in zip(c_c, zpow)], p)
    z_const_inv = pow((pow(zeta, n, p) - 1) % p, -1, p)
    h_s = [(a * b - c) % p * z_const_inv % p for a, b, c in zip(a_s, b_s, c_s)]
    h_c = ntt_host(h_s, p, inverse=True)
    zinv = pow(zeta, -1, p)
    zipow = 1
    out = []
    for x in h_c:
        out.append(x * zipow % p)
        zipow = (zipow * zinv) % p
    if any(out[n - 1:]):
        raise ValueError("h degree bound violated: z does not satisfy the R1CS")
    return out[: n - 1]


def prove(pk: ProvingKey, r1cs: R1CS, z: List[int], rng: random.Random) -> Proof:
    p = FR
    npub = r1cs.num_public + 1
    r, s = rng.randrange(p), rng.randrange(p)
    g1 = AffinePoint.generator(BN254_G1)

    a_acc = pk.vk.alpha_g1.add(_msm_g1(z, pk.a_query)).add(pk.delta_g1.scalar_mul(r))
    b_g1 = pk.beta_g1.add(_msm_g1(z, pk.b_g1_query)).add(pk.delta_g1.scalar_mul(s))
    b_g2 = pk.vk.beta_g2.add(
        _g2_msm(z, pk.b_g2_query)
    ).add(pk.vk.delta_g2.scalar_mul(s))

    h = _h_coefficients(r1cs, z)
    hC = _msm_g1(h, pk.h_query)
    lC = _msm_g1(z[npub:], pk.l_query)
    c = (
        lC.add(hC)
        .add(a_acc.scalar_mul(s))
        .add(b_g1.scalar_mul(r))
        .add(pk.delta_g1.scalar_mul((-r * s) % p))
    )
    return Proof(a=a_acc, b=b_g2, c=c)


def _g2_msm(scalars: List[int], points: List[G2Point]) -> G2Point:
    """sum_i s_i * P_i over G2 by Pippenger's buckets (window 7) in
    Jacobian coordinates; raises if every scalar is zero."""
    pairs = [(sc % FR, pt) for sc, pt in zip(scalars, points)
             if sc % FR and not pt.is_inf]
    if not any(sc % FR for sc in scalars):
        raise ValueError("G2 MSM of all-zero scalars")
    jac = _G2
    pts = [jac.from_g2(pt) for _, pt in pairs]
    c = 7
    mask = (1 << c) - 1
    acc = None
    for win in reversed(range(-(-FR.bit_length() // c))):
        for _ in range(c):
            acc = jac.dbl(acc)
        buckets = [None] * mask
        for (sc, _), pt in zip(pairs, pts):
            d = (sc >> (c * win)) & mask
            if d:
                buckets[d - 1] = jac.add(buckets[d - 1], pt)
        run = tot = None
        for b in reversed(buckets):
            run = jac.add(run, b)
            tot = jac.add(tot, run)
        acc = jac.add(acc, tot)
    return jac.to_g2(acc)


# -- host group arithmetic ------------------------------------------------------
# mira_tpu's G2Point multiplies by double-and-add in affine coordinates, one
# field inversion per step; a 1000-constraint setup and each proof's G2 MSM
# then take minutes of host time.  The port computes the same G2 elements in
# Jacobian coordinates: a fixed-base window table of the generator for the
# setup, Pippenger for the prover's MSM.  G1 goes through mira_tpu's native
# MSM (its host Pippenger without the native library).


class _JacG2:
    """Jacobian points on y^2 = x^3 + b' over Fq2 = Fq[u]/(u^2 + 1), as
    (c0, c1) int pairs; None is the identity.  The formulas are complete
    in the cases they meet: P == Q doubles, P == -Q gives the identity."""

    zero, one = (0, 0), (1, 0)

    @staticmethod
    def mul(a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % FQ, (a[0] * b[1] + a[1] * b[0]) % FQ)

    @staticmethod
    def sqr(a):
        return ((a[0] + a[1]) * (a[0] - a[1]) % FQ, 2 * a[0] * a[1] % FQ)

    @staticmethod
    def add_(a, b):
        return ((a[0] + b[0]) % FQ, (a[1] + b[1]) % FQ)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % FQ, (a[1] - b[1]) % FQ)

    @staticmethod
    def scale(k, a):
        return (k * a[0] % FQ, k * a[1] % FQ)

    @staticmethod
    def inv(a):
        n = pow(a[0] * a[0] + a[1] * a[1], -1, FQ)
        return (a[0] * n % FQ, -a[1] * n % FQ)

    def dbl(self, P):
        if P is None or P[1] == self.zero:
            return None
        X, Y, Z = P
        mul, sqr, sub, scale = self.mul, self.sqr, self.sub, self.scale
        A, B = sqr(X), sqr(Y)
        C = sqr(B)
        D = scale(2, sub(sub(sqr(self.add_(X, B)), A), C))
        E = scale(3, A)
        X3 = sub(sqr(E), scale(2, D))
        return (X3, sub(mul(E, sub(D, X3)), scale(8, C)), scale(2, mul(Y, Z)))

    def add(self, P, Q):
        if P is None:
            return Q
        if Q is None:
            return P
        mul, sqr, sub = self.mul, self.sqr, self.sub
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        Z1Z1, Z2Z2 = sqr(Z1), sqr(Z2)
        U1, U2 = mul(X1, Z2Z2), mul(X2, Z1Z1)
        S1, S2 = mul(mul(Y1, Z2), Z2Z2), mul(mul(Y2, Z1), Z1Z1)
        H, r = sub(U2, U1), sub(S2, S1)
        if H == self.zero:
            return self.dbl(P) if r == self.zero else None
        HH = sqr(H)
        HHH, V = mul(H, HH), mul(U1, HH)
        X3 = sub(sub(sqr(r), HHH), self.scale(2, V))
        return (X3, sub(mul(r, sub(V, X3)), mul(S1, HHH)), mul(mul(Z1, Z2), H))

    def from_g2(self, pt: G2Point):
        if pt.is_inf:
            return None
        return ((pt.x.c0.v, pt.x.c1.v), (pt.y.c0.v, pt.y.c1.v), (1, 0))

    def to_g2(self, P) -> G2Point:
        F = field(FQ)
        if P is None:
            return G2Point.identity(F)
        zi = self.inv(P[2])
        zi2 = self.sqr(zi)
        (x0, x1), (y0, y1) = self.mul(P[0], zi2), self.mul(P[1], self.mul(zi2, zi))
        return G2Point(Fq2(F(x0), F(x1)), Fq2(F(y0), F(y1)))


_G2 = _JacG2()
FIXED_WINDOW = 8


@lru_cache(maxsize=None)
def _g2_generator_table():
    """table[i][d - 1] = d * 2^(8 i) * G for the G2 generator G."""
    G = _G2.from_g2(G2Point.generator(field(FQ)))
    table = []
    for _ in range(-(-FR.bit_length() // FIXED_WINDOW)):
        row = [G]
        for _ in range((1 << FIXED_WINDOW) - 2):
            row.append(_G2.add(row[-1], G))
        table.append(row)
        G = _G2.add(row[-1], G)
    return table


def _g1_muls(scalars: List[int]) -> List[AffinePoint]:
    """[k * G1] for each k (the G1 generator)."""
    from mira_tpu.curves.host import msm_host_pippenger
    from mira_tpu.ops.native_msm import available, msm_native

    G = AffinePoint.generator(BN254_G1)
    if available():
        # one thread: a one-point MSM gains nothing from workers, and
        # starting them costs more than the MSM on a busy host
        def mul(k):
            return msm_native([k], [G], nthreads=1)
    else:
        def mul(k):
            return msm_host_pippenger([k], [G])
    return [mul(k % FR) if k % FR else AffinePoint.identity(BN254_G1)
            for k in scalars]


def _g2_muls(scalars: List[int]) -> List[G2Point]:
    """[k * G2] for each k (the G2 generator)."""
    table = _g2_generator_table()
    mask = (1 << FIXED_WINDOW) - 1
    out = []
    for k in scalars:
        k %= FR
        acc, i = None, 0
        while k:
            if k & mask:
                acc = _G2.add(acc, table[i][(k & mask) - 1])
            k >>= FIXED_WINDOW
            i += 1
        out.append(_G2.to_g2(acc))
    return out


def gt_inv(x: Tuple12) -> Tuple12:
    """Inverse in the order-r subgroup Gt."""
    return x.scalar_mul(FR - 1)


def verify(vk: VerifyingKey, proof: Proof, public_inputs: List[int]) -> bool:
    """e(A,B) == e(alpha,beta) * e(vk_x,gamma) * e(C,delta)."""
    lhs = pairing(proof.a, proof.b)
    vkx = vk.vk_x(public_inputs)
    rhs = (
        pairing(vk.alpha_g1, vk.beta_g2)
        .mul(pairing(vkx, vk.gamma_g2))
        .mul(pairing(proof.c, vk.delta_g2))
    )
    return lhs == rhs


# ---------------------------------------------------------------------------
# Mira's pairing-based accumulation with REAL cross terms
# ---------------------------------------------------------------------------


class GtAccumulator:
    """Folds Groth16 proofs with true bilinear Gt cross terms (see module
    docstring for the relation and the fold recurrence)."""

    def __init__(self, vk: VerifyingKey):
        self.vk = vk
        Fb = field(BN254_G1.base_modulus)
        self.A = AffinePoint.identity(BN254_G1)
        self.C = AffinePoint.identity(BN254_G1)
        self.B: G2Point = G2Point.identity(Fb)
        self.vkx = AffinePoint.identity(BN254_G1)
        self.u = 0
        self.gt = Tuple12.one(Fb)
        self.neg_delta = vk.delta_g2.neg()
        self.neg_gamma = vk.gamma_g2.neg()
        self.K = gt_inv(pairing(vk.alpha_g1, vk.beta_g2))

    def _pair(self, g1: AffinePoint, g2: G2Point) -> Tuple12:
        Fb = field(BN254_G1.base_modulus)
        if g1.is_inf or g2.is_inf:
            return Tuple12.one(Fb)
        return pairing(g1, g2)

    def cross_terms(self, proof: Proof, public_inputs: List[int]):
        """[T1, T2] for folding `proof` (fresh, u=1) into the accumulator."""
        vkx2 = self.vk.vk_x(public_inputs)
        u1 = self.u
        T1 = (
            self._pair(self.A, proof.b)
            .mul(self._pair(proof.a, self.B))
            .mul(self._pair(self.C, self.neg_delta))
            .mul(self._pair(proof.c, self.neg_delta).scalar_mul(u1))
            .mul(self._pair(self.vkx, self.neg_gamma))
            .mul(self._pair(vkx2, self.neg_gamma).scalar_mul(u1))
            .mul(self.K.scalar_mul(2 * u1 % FR))
        )
        T2 = (
            self._pair(proof.a, proof.b)
            .mul(self._pair(proof.c, self.neg_delta))
            .mul(self._pair(vkx2, self.neg_gamma))
            .mul(self.K)
        )
        return [T1, T2], vkx2

    def fold(self, proof: Proof, public_inputs: List[int], r: int):
        """Fold with challenge r; returns the cross terms used."""
        (T1, T2), vkx2 = self.cross_terms(proof, public_inputs)
        r %= FR
        self.gt = self.gt.mul(T1.scalar_mul(r)).mul(T2.scalar_mul(r * r % FR))
        self.A = self.A.add(proof.a.scalar_mul(r))
        self.B = self.B.add(proof.b.scalar_mul(r))
        self.C = self.C.add(proof.c.scalar_mul(r))
        self.vkx = self.vkx.add(vkx2.scalar_mul(r))
        self.u = (self.u + r) % FR
        return [T1, T2]

    def check(self) -> bool:
        """Decider: recompute R(U_acc) with real pairings, compare to gt."""
        u = self.u
        want = (
            self._pair(self.A, self.B)
            .mul(self._pair(self.C, self.neg_delta).scalar_mul(u))
            .mul(self._pair(self.vkx, self.neg_gamma).scalar_mul(u))
            .mul(self.K.scalar_mul(u * u % FR))
        )
        return want == self.gt


class Groth16FoldContext:
    """Bridges real Groth16 proofs into the folding pipeline.

    Attach to the proof-carrying side's PlonkStructure as `S.groth16_ctx`:
    * the SPS pulls each fresh instance's g1/g2 elements from the proof queue
      (instead of the reference's random placeholders, plonk/mod.rs:690-703):
      per batch item g1 += [A, C, vk_x], g2 += [B]  (num_g1 = 3*batch)
    * VanillaFS gets REAL bilinear Gt cross terms [T1, T2] (instead of random
      Tuple12s, vanilla/mod.rs:130-134)
    * the decider checks the folded Gt invariant with actual pairings
      (`gt_is_sat`; the reference has no such check at all).
    """

    def __init__(self, vk: VerifyingKey, batch_size: int = 1):
        self.vk = vk
        self.batch = batch_size
        self.neg_delta = vk.delta_g2.neg()
        self.neg_gamma = vk.gamma_g2.neg()
        self.K = gt_inv(pairing(vk.alpha_g1, vk.beta_g2))
        self.queue: List[Tuple[Proof, List[int]]] = []

    @property
    def num_g1(self) -> int:
        return 3 * self.batch

    @property
    def num_g2(self) -> int:
        return self.batch

    num_gt_cross_terms = 2
    gt_degree = 2

    def push_proofs(self, items: List[Tuple[Proof, List[int]]]):
        self.queue.extend(items)

    def provide_elements(self):
        """(g1_elements, g2_elements) for the next fresh instance."""
        if len(self.queue) < self.batch:
            raise RuntimeError("proof queue exhausted")
        batch = [self.queue.pop(0) for _ in range(self.batch)]
        g1: List[AffinePoint] = []
        g2: List[G2Point] = []
        for proof, pub in batch:
            g1 += [proof.a, proof.c, self.vk.vk_x(pub)]
            g2 += [proof.b]
        return g1, g2

    @staticmethod
    def _pair0(a: AffinePoint, b: G2Point) -> Tuple12:
        Fb = field(BN254_G1.base_modulus)
        if a.is_inf or b.is_inf:
            return Tuple12.one(Fb)
        return pairing(a, b)

    def gt_cross_terms(self, U1, U2) -> List[Tuple12]:
        """[T1, T2] from the accumulated (U1, homogenized by u1) and fresh
        (U2, u=1) instance group elements — see module docstring."""
        Fb = field(BN254_G1.base_modulus)
        u1 = U1.u % FR
        T1, T2 = Tuple12.one(Fb), Tuple12.one(Fb)
        for i in range(self.batch):
            A1, C1, X1 = U1.g1_elements[3 * i : 3 * i + 3]
            A2, C2, X2 = U2.g1_elements[3 * i : 3 * i + 3]
            B1, B2 = U1.g2_elements[i], U2.g2_elements[i]
            T1 = (
                T1.mul(self._pair0(A1, B2))
                .mul(self._pair0(A2, B1))
                .mul(self._pair0(C1, self.neg_delta))
                .mul(self._pair0(C2, self.neg_delta).scalar_mul(u1))
                .mul(self._pair0(X1, self.neg_gamma))
                .mul(self._pair0(X2, self.neg_gamma).scalar_mul(u1))
                .mul(self.K.scalar_mul(2 * u1 % FR))
            )
            T2 = (
                T2.mul(self._pair0(A2, B2))
                .mul(self._pair0(C2, self.neg_delta))
                .mul(self._pair0(X2, self.neg_gamma))
                .mul(self.K)
            )
        return [T1, T2]

    def gt_is_sat(self, U) -> None:
        """Decider: R(U) must equal the folded gt_element (raises on fail)."""
        Fb = field(BN254_G1.base_modulus)
        u = U.u % FR
        want = Tuple12.one(Fb)
        for i in range(self.batch):
            A, C, X = U.g1_elements[3 * i : 3 * i + 3]
            B = U.g2_elements[i]
            want = (
                want.mul(self._pair0(A, B))
                .mul(self._pair0(C, self.neg_delta).scalar_mul(u))
                .mul(self._pair0(X, self.neg_gamma).scalar_mul(u))
                .mul(self.K.scalar_mul(u * u % FR))
            )
        if want != U.gt_element:
            raise SatError("Gt accumulator invariant violated (real pairings)")
