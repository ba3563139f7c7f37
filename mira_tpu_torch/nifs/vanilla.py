"""VanillaFS: the Sangria/Mira non-interactive folding scheme (port of
mira_tpu/nifs/vanilla.py).

Cross terms: the homogeneous polynomial is evaluated at the interior fold
points j = 1..d-1 by the fold evaluator (the kernel on the card) and the
degree slices are recovered with the inverse Vandermonde, using the two
satisfaction invariants (Q(0) = E, leading coefficient 0) as mira_tpu does;
the combine is one row-wise linear combination on the witness device
(ops/field_lincomb.py, the kernel on the card).
MIRA_FOLD_EVAL (or `_impl`) picks mira_tpu's other evaluators instead:
"native", the native row VM and its combine on the host's cores, or "xla",
the column evaluator.  With MIRA_DEBUG_SAT set, a prove first checks the
two invariants and raises ValueError where a trace breaks them.  The Gt
cross terms are the real pairing cross terms of the structure's Groth16
context where one is attached, else the reference's seeded random
Tuple12s, drawn from `rng` in mira_tpu's order.

With a mesh (parallel/mesh.py), as mira_tpu's mesh prove: each rank
evaluates its block of rows, combines its block of the cross terms, gathers
the blocks whole, and commits them by sharded MSMs; the witness fold is
row-sharded too (plonk/structure.py).  mira_tpu evaluates the block with its
XLA column evaluator, its Pallas sweep being a single-device program; here
every rank holds the whole columns, so the fold evaluator (the kernel on the
card) takes the block as a row range, all fold points in one call.
"""

from __future__ import annotations

import dataclasses
import os
import random
from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch

from ..curves.host import AffinePoint, Tuple12
from ..fields.host import field
from ..fields.native64 import lincomb_mont
from ..ops.field_lincomb import lincomb

from ..plonk.structure import (
    NUM_CHALLENGE_BITS,
    PlonkInstance,
    PlonkStructure,
    PlonkTrace,
    PlonkWitness,
    RelaxedPlonkInstance,
    RelaxedPlonkTrace,
    RelaxedPlonkWitness,
    fold_eval_impl,
    sps_verify,
)
from ..polynomial.native_evaluator import words_from_64, words_to_64
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


def combine_slices_sat(lf, evals, E):
    """T_k = sum_j invM[k][j] * (Q_j - E), k = 1..d-1, plus T_d = 0 (port of
    mira_tpu's `_combine_slices_sat_jit`): one `field_lincomb` over the
    evaluations and E, whose coefficient -sum_j invM[k][j] folds the
    subtraction in."""
    d = len(evals) + 1
    p = lf.modulus
    invM = _inv_vandermonde_inner(p, d)
    coefs = [list(invM[k]) + [-sum(invM[k])] for k in range(d - 1)]
    return lincomb(p, [*evals, E], coefs) + [torch.zeros_like(E)]


def combine_slices(lf, evals):
    """T_k = sum_j invV[k][j] * Q_j, k = 1..d (port of `_combine_slices_jit`),
    one `field_lincomb`."""
    d = len(evals) - 1
    invV = _inv_vandermonde(lf.modulus, d)
    return lincomb(lf.modulus, evals, [list(invV[k]) for k in range(1, d + 1)])


def combine_slices_native(p: int, d: int, outs64, E, assume_sat: bool):
    """The two combines above on the host's cores, as mira_tpu's native route
    computes them: one `native64.lincomb_mont` over the native VM's (n_j,
    n, 4) uint64 evaluations (and E, whose coefficient -sum_j invM[k][j]
    folds the subtraction in when `assume_sat`).  Returns the port's words
    on E's device."""
    if assume_sat and d >= 1:
        invM = _inv_vandermonde_inner(p, d)
        ins = np.concatenate([outs64, words_to_64(E)[None]], axis=0)
        coefs = [list(invM[k]) + [(-sum(invM[k])) % p] for k in range(d - 1)]
        T64 = lincomb_mont(p, ins, coefs)
        return ([words_from_64(t, E.device) for t in T64]
                + [torch.zeros_like(E)])  # T_d = 0 when sat
    invV = _inv_vandermonde(p, d)
    T64 = lincomb_mont(p, outs64, [list(invV[k]) for k in range(1, d + 1)])
    return [words_from_64(t, E.device) for t in T64]


def _debug_check_assume_sat(S: PlonkStructure, W1, W2, ch1, ch2):
    """MIRA_DEBUG_SAT guard for the `assume_sat` cross-term shortcut (port of
    mira_tpu's).

    The shortcut trusts two invariants without checking them: Q(0) equals
    the accumulator's stored error vector E (is_sat_relaxed invariant) and
    the leading coefficient of Q, the homogeneous polynomial evaluated on
    the fresh trace alone, vanishes (is_sat invariant).  Folding a trace
    that violates either silently produces wrong cross terms, detectable
    only by a later strict verify; with MIRA_DEBUG_SAT=1 this re-evaluates
    both on the fold evaluator at j = 0 (two extra passes) and fails loudly
    at prove time."""
    ev = S.fold_evaluator(W1.E.device)

    def eval_on(Ws, ch):
        return ev.fold_eval_multi(Ws, Ws, [0], ch, [0] * len(ch))[0]

    bad = int((eval_on(W1.W, ch1) != W1.E).any(-1).sum())
    if bad:
        raise ValueError(
            "MIRA_DEBUG_SAT: assume_sat contract violated — the accumulator "
            f"does not satisfy its relaxed relation (Q(0) != E on {bad} rows). "
            "Pass assume_sat=False to commit_cross_terms, or fix the trace.")
    bad = int((eval_on(W2.W, ch2) != 0).any(-1).sum())
    if bad:
        raise ValueError(
            "MIRA_DEBUG_SAT: assume_sat contract violated — the incoming "
            f"trace does not satisfy its relation (leading coefficient "
            f"nonzero on {bad} rows). Pass assume_sat=False to "
            "commit_cross_terms, or fix the trace.")


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
                           W2: PlonkWitness, rng=None, assume_sat: bool = True,
                           mesh=None, _impl=None):
        """The cross terms and their commitments.  The gate evaluator is
        `fold_eval_impl(_impl)` (MIRA_FOLD_EVAL): the fold evaluator by
        default, the native row VM with its combine on the host, or the
        column evaluator one point at a time.  With a mesh each route gives
        the rank's block of rows: the fold evaluator and the native VM
        evaluate that block alone, the column evaluator whole columns."""
        rng = rng or random.Random(0xC405)
        p = S.modulus
        lf = S.lf
        d = S.get_degree_for_folding() - 1  # max degree of the homogeneous poly
        impl = fold_eval_impl(_impl)

        ch1 = list(U1.challenges) + [U1.u]
        ch2 = list(U2.challenges) + [1]  # fresh instance folds with u = 1

        if assume_sat and d >= 1 and os.environ.get("MIRA_DEBUG_SAT"):
            _debug_check_assume_sat(S, W1, W2, ch1, ch2)

        if assume_sat and d >= 1:
            js = list(range(1, d))
        else:
            js = list(range(d + 1))
        nrow = W1.E.shape[0]
        dev = W1.E.device
        lo, hi = (0, nrow) if mesh is None else mesh.rows(nrow)
        native = impl == "native" and js
        evals = []
        if js:
            with span("cross_term_eval"):
                if native:
                    outs64 = S._native_fold_evaluator().fold_eval_multi(
                        W1.W, W2.W, js, ch1, ch2, rows=(lo, hi), as64=True)
                elif impl == "xla":
                    ev = S._evaluator("homogeneous", dev)
                    evals = [ev.fold_eval(W1.W, W2.W, j, [
                        (a + j * b) % p for a, b in zip(ch1, ch2)])[lo:hi]
                        for j in js]
                else:
                    outs = S.fold_evaluator(dev).fold_eval_multi(
                        W1.W, W2.W, js, ch1, ch2, rows=(lo, hi))
                    evals = [outs[i] for i in range(len(js))]
        with span("cross_term_combine"):
            if native:
                cross_terms = combine_slices_native(p, d, outs64, W1.E[lo:hi],
                                                    assume_sat)
            elif assume_sat and d >= 1:
                cross_terms = combine_slices_sat(lf, evals, W1.E[lo:hi])
            else:
                cross_terms = combine_slices(lf, evals)
            if mesh is not None:
                cross_terms = [mesh.gather_rows(t, nrow) for t in cross_terms]

        skip_last = assume_sat and d >= 1
        with span("cross_term_commit"):
            # T_d = 0 on satisfied traces: its commitment is the identity
            terms = cross_terms[:-1] if skip_last else cross_terms
            decode = ck.commit_device_many(terms, mesh=mesh, defer=True)
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
        with span("nifs_challenge"):
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
                             ro_nark, rng=None, mesh=None) -> PlonkTrace:
        return pp.S.run_sps_protocol(ck, instance, witness, ro_nark, rng=rng,
                                     mesh=mesh)

    @staticmethod
    @instrument
    def prove(ck, pp: VanillaFSProverParam, ro_acc,
              accumulator: RelaxedPlonkTrace, incoming: PlonkTrace, rng=None,
              mesh=None):
        """Fold `incoming` into `accumulator`.  Contract (as in mira_tpu):
        the accumulator satisfies its relaxed relation and `incoming` its
        plain relation; cross terms rely on both.  With a mesh, the cross
        terms, their commits and the witness fold are sharded."""
        U1, W1 = accumulator.U, accumulator.W
        U2, W2 = incoming.u, incoming.w
        cross_terms, (g1_commits, gt_commits) = VanillaFS.commit_cross_terms(
            ck, pp.S, U1, W1, U2, W2, rng=rng, mesh=mesh)
        r = VanillaFS.generate_challenge(pp.pp_digest, ro_acc, U1, U2,
                                         g1_commits, gt_commits)
        with span("instance_fold"):
            U = U1.fold(U2, g1_commits, gt_commits, r)
        with span("witness_fold"):
            W = W1.fold(W2, cross_terms, r, mesh=mesh)
        return RelaxedPlonkTrace(U, W), (g1_commits, gt_commits)

    @staticmethod
    def verify(vp: AffinePoint, ro_nark, ro_acc, U1: RelaxedPlonkInstance,
               U2: PlonkInstance, cross_term_commits) -> RelaxedPlonkInstance:
        g1_commits, gt_commits = cross_term_commits
        sps_verify(U2, ro_nark)
        r = VanillaFS.generate_challenge(vp, ro_acc, U1, U2, g1_commits, gt_commits)
        return U1.fold(U2, g1_commits, gt_commits, r)
