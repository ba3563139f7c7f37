"""VanillaFS: the Sangria/Mira non-interactive folding scheme (port of
mira_tpu/nifs/vanilla.py).

Cross terms: the homogeneous polynomial is evaluated at the interior fold
points j = 1..d-1 by the fold evaluator (the kernel on the card) and the
degree slices are recovered with the inverse Vandermonde, using the two
satisfaction invariants (Q(0) = E, leading coefficient 0) as mira_tpu does;
the combine runs as elementwise field ops on the witness device.  The Gt
cross terms are the real pairing cross terms of the structure's Groth16
context where one is attached, else the reference's seeded random
Tuple12s, drawn from `rng` in mira_tpu's order.
"""

from __future__ import annotations

import dataclasses
import random
from functools import lru_cache
from typing import List, Tuple

from mira_tpu.curves.host import AffinePoint, Tuple12
from mira_tpu.fields.host import field

from ..plonk.structure import (
    NUM_CHALLENGE_BITS,
    PlonkInstance,
    PlonkStructure,
    PlonkTrace,
    PlonkWitness,
    RelaxedPlonkInstance,
    RelaxedPlonkTrace,
    RelaxedPlonkWitness,
    sps_verify,
)
from ..utils.tracing import instrument, span


def _gauss_inverse(M: List[List[int]], p: int) -> Tuple[Tuple[int, ...], ...]:
    n = len(M)
    aug = [row[:] + [1 if i == j else 0 for j in range(n)]
           for i, row in enumerate(M)]
    for col in range(n):
        piv = next(r for r in range(col, n) if aug[r][col] % p != 0)
        aug[col], aug[piv] = aug[piv], aug[col]
        inv = pow(aug[col][col], -1, p)
        aug[col] = [(x * inv) % p for x in aug[col]]
        for r in range(n):
            if r != col and aug[r][col] % p != 0:
                f = aug[r][col]
                aug[r] = [(x - f * y) % p for x, y in zip(aug[r], aug[col])]
    return tuple(tuple(row[n:]) for row in aug)


@lru_cache(maxsize=None)
def _inv_vandermonde(p: int, d: int):
    """Inverse of V[j][k] = j^k (mod p), (d+1)x(d+1)."""
    return _gauss_inverse([[pow(j, k, p) for k in range(d + 1)]
                           for j in range(d + 1)], p)


@lru_cache(maxsize=None)
def _inv_vandermonde_inner(p: int, d: int):
    """Inverse of M[i][j] = (i+1)^(j+1) mod p, (d-1)x(d-1): the interior
    system once T_0 = E and T_d = 0 are eliminated."""
    return _gauss_inverse([[pow(i + 1, j + 1, p) for j in range(d - 1)]
                           for i in range(d - 1)], p)


def _lincomb(lf, coefs: List[int], vecs):
    """sum_j coefs[j] * vecs[j] on Montgomery words (lazy, one canon)."""
    acc = None
    for c, v in zip(coefs, vecs):
        if not c:
            continue
        t = v * lf.lz_const(c, v.shape, v.t.device)
        acc = t if acc is None else acc + t
    return acc


def combine_slices_sat(lf, evals, E):
    """T_k = sum_j invM[k][j] * (Q_j - E), k = 1..d-1, plus T_d = 0 (port of
    mira_tpu's `_combine_slices_sat_jit`)."""
    d = len(evals) + 1
    invM = _inv_vandermonde_inner(lf.modulus, d)
    diffs = [lf.lz(e) - lf.lz(E) for e in evals]
    outs = []
    for k in range(d - 1):
        acc = _lincomb(lf, invM[k], diffs)
        outs.append(lf.canon(acc) if acc is not None else lf.zero(E.shape[:-1], E.device))
    outs.append(lf.zero(E.shape[:-1], E.device))
    return outs


def combine_slices(lf, evals):
    """T_k = sum_j invV[k][j] * Q_j, k = 1..d (port of `_combine_slices_jit`)."""
    d = len(evals) - 1
    invV = _inv_vandermonde(lf.modulus, d)
    lz = [lf.lz(e) for e in evals]
    outs = []
    for k in range(1, d + 1):
        acc = _lincomb(lf, invV[k], lz)
        outs.append(lf.canon(acc) if acc is not None
                    else lf.zero(evals[0].shape[:-1], evals[0].device))
    return outs


@dataclasses.dataclass
class VanillaFSProverParam:
    S: PlonkStructure
    pp_digest: AffinePoint


class VanillaFS:
    """Stateless folding operations."""

    @staticmethod
    @instrument
    def commit_cross_terms(ck, S: PlonkStructure, U1: RelaxedPlonkInstance,
                           W1: RelaxedPlonkWitness, U2: PlonkInstance,
                           W2: PlonkWitness, rng=None, assume_sat: bool = True):
        rng = rng or random.Random(0xC405)
        p = S.modulus
        lf = S.lf
        d = S.get_degree_for_folding() - 1  # max degree of the homogeneous poly

        ch1 = list(U1.challenges) + [U1.u]
        ch2 = list(U2.challenges) + [1]  # fresh instance folds with u = 1

        if assume_sat and d >= 1:
            js = list(range(1, d))
        else:
            js = list(range(d + 1))
        if js:
            ev = S.fold_evaluator(W1.E.device)
            with span("cross_term_eval"):
                outs = ev.fold_eval_multi(W1.W, W2.W, js, ch1, ch2)
            evals = [outs[i] for i in range(len(js))]
        else:
            evals = []
        with span("cross_term_combine"):
            if assume_sat and d >= 1:
                cross_terms = combine_slices_sat(lf, evals, W1.E)
            else:
                cross_terms = combine_slices(lf, evals)

        skip_last = assume_sat and d >= 1
        with span("cross_term_commit"):
            # T_d = 0 on satisfied traces: its commitment is the identity
            terms = cross_terms[:-1] if skip_last else cross_terms
            decode = ck.commit_device_many(terms, defer=True)
        if S.groth16_ctx is not None:
            # host pairings while the cross-term MSMs run on the device
            with span("gt_cross_terms"):
                gt_commits = S.groth16_ctx.gt_cross_terms(U1, U2)
        else:
            Fb = field(S.curve.base_modulus)
            gt_commits = [
                Tuple12.generator(Fb).scalar_mul(rng.randrange(p))
                for _ in range(S.target_group_cross_terms)
            ]
        with span("cross_term_commit"):
            g1_commits = list(decode())
            if skip_last:
                g1_commits.append(AffinePoint.identity(S.curve))
        return cross_terms, (g1_commits, gt_commits)

    @staticmethod
    def generate_challenge(pp_digest: AffinePoint, ro_acc,
                           U1: RelaxedPlonkInstance, U2: PlonkInstance,
                           cross_term_g1_commits: List[AffinePoint],
                           cross_term_gt_commits: List[Tuple12]) -> int:
        scalar = field(U1.curve.scalar_modulus)
        ro_acc.absorb_point(pp_digest)
        U1.absorb_into(ro_acc)
        U2.absorb_into(ro_acc)
        for c in cross_term_g1_commits:
            ro_acc.absorb_point(c)
        for t in cross_term_gt_commits:
            ro_acc.absorb_fp12_tuple(t)
        return ro_acc.squeeze(scalar, NUM_CHALLENGE_BITS).v

    @staticmethod
    def setup_params(pp_digest: AffinePoint, S: PlonkStructure):
        return VanillaFSProverParam(S, pp_digest), pp_digest

    @staticmethod
    @instrument
    def generate_plonk_trace(ck, instance, witness, pp: VanillaFSProverParam,
                             ro_nark, rng=None) -> PlonkTrace:
        return pp.S.run_sps_protocol(ck, instance, witness, ro_nark, rng=rng)

    @staticmethod
    @instrument
    def prove(ck, pp: VanillaFSProverParam, ro_acc,
              accumulator: RelaxedPlonkTrace, incoming: PlonkTrace, rng=None):
        """Fold `incoming` into `accumulator`.  Contract (as in mira_tpu):
        the accumulator satisfies its relaxed relation and `incoming` its
        plain relation; cross terms rely on both."""
        U1, W1 = accumulator.U, accumulator.W
        U2, W2 = incoming.u, incoming.w
        cross_terms, (g1_commits, gt_commits) = VanillaFS.commit_cross_terms(
            ck, pp.S, U1, W1, U2, W2, rng=rng)
        r = VanillaFS.generate_challenge(pp.pp_digest, ro_acc, U1, U2,
                                         g1_commits, gt_commits)
        U = U1.fold(U2, g1_commits, gt_commits, r)
        with span("witness_fold"):
            W = W1.fold(W2, cross_terms, r)
        return RelaxedPlonkTrace(U, W), (g1_commits, gt_commits)

    @staticmethod
    def verify(vp: AffinePoint, ro_nark, ro_acc, U1: RelaxedPlonkInstance,
               U2: PlonkInstance, cross_term_commits) -> RelaxedPlonkInstance:
        g1_commits, gt_commits = cross_term_commits
        sps_verify(U2, ro_nark)
        r = VanillaFS.generate_challenge(vp, ro_acc, U1, U2, g1_commits, gt_commits)
        return U1.fold(U2, g1_commits, gt_commits, r)
