"""ProtoGalaxy: multi-instance folding via polynomial interpolation (port of
mira_tpu/nifs/protogalaxy.py; reference src/nifs/protogalaxy/).

Gate evaluations come from the fold evaluator (polynomial/fold_evaluator.py,
one op program per gate over all rows at the single point j = 0: the kernel
on the card, its plain version on the CPU); the pow_i binary tree
(compute_F / compute_G) is a vectorised halving reduction over the
evaluation array, batched over all interpolation points at once;
compute_K's coset transforms go through ops/ntt.py, so on the card they
launch the NTT kernels.  Everything runs on the device of the traces'
witnesses.

Reference quirks preserved: the "powers" of beta/delta are additive doublings
(2^i * beta, protogalaxy/mod.rs:72-77 uses Field::double), and the verifier is
left unimplemented there (mod.rs:299-308): here `verify` recomputes the
folded instance like the prover does.  As in mira_tpu, the accumulator keeps
the log2-many betas that are read, not the reference's
`count_of_evaluation`.

One fault of mira_tpu is not copied: its `compute_F` gives every level the
same delta, while `prove` builds betas_stroke from the doubled deltas
2^h * delta, so that F(alpha) differs from G(1) whenever the accumulator's
gate evaluations are not all zero, and a fold onto a folded accumulator
breaks the relation sum_i pow_i(betas) f_i = e.  Here compute_F doubles delta
per level as `prove` does.  Where F is zero (a fold onto the zero accumulator
of a circuit whose gates have no constant term, as in the K = 4 tests) the
two agree exactly.

`prove` raises ValueError unless the number of incoming traces L leaves
L + 1 a power of two: otherwise the fold domain has a point where the
folded witness is all zero, and a gate with a constant term does not vanish
there, so the quotient of compute_K is no polynomial and the folded
accumulator misses its relation.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from ..constants import NUM_CHALLENGE_BITS
from ..curves.host import AffinePoint
from ..fields.host import field
from ..fields.params import field_params
from ..ops.ntt import coset_intt, coset_ntt, ntt_host
from ..plonk.structure import (
    PlonkInstance,
    PlonkStructure,
    PlonkTrace,
    RelaxedPlonkInstance,
    RelaxedPlonkTrace,
    RelaxedPlonkWitness,
    sps_verify,
)
from ..polynomial.fold_evaluator import FoldEvaluator
from ..utils.tracing import instrument, span
from ..polynomial.univariate import (
    UnivariatePoly,
    eval_lagrange_polys_for_cyclic_group,
    eval_vanish_polynomial,
    iter_cyclic_subgroup,
)


@dataclasses.dataclass
class Accumulator:
    betas: List[int]
    trace: RelaxedPlonkTrace
    e: int

    def absorb_into(self, ro):
        curve = self.trace.U.curve
        base = field(curve.base_modulus)
        self.trace.U.absorb_into(ro)
        for b in self.betas:
            ro.absorb_field(base(b % curve.base_modulus))
        ro.absorb_field(base(self.e % curve.base_modulus))


@dataclasses.dataclass
class ProtoGalaxyProverParam:
    S: PlonkStructure
    pp_digest: AffinePoint


@dataclasses.dataclass
class ProtoGalaxyProof:
    poly_F: UnivariatePoly
    poly_K: UnivariatePoly


def _next_pow2_log(n: int) -> int:
    return max((n - 1).bit_length(), 0)


class ProtoGalaxy:
    # -- helpers -------------------------------------------------------------
    @staticmethod
    def _count_of_evaluation(S: PlonkStructure) -> int:
        return (1 << S.k) * len(S.gates)

    @staticmethod
    def _gate_evaluators(S: PlonkStructure, device):
        cache = S._cache()
        key = ("protogalaxy_gates", str(device))
        if key not in cache:
            cache[key] = [
                FoldEvaluator(g, S.modulus, S.num_advice_columns,
                              S.num_lookups(), S.selectors, S.fixed_columns,
                              1 << S.k, device)
                for g in S.gates
            ]
        return cache[key]

    @classmethod
    def _evaluate_gates(cls, S: PlonkStructure, W, challenges: List[int]):
        """Gate-major concatenated evaluations, (num_gates * nrow, 8): each
        gate at the fold point j = 0 of W + j W."""
        evs = cls._gate_evaluators(S, W[0].device)
        zero = [0] * len(challenges)
        return torch.cat([ev.fold_eval_multi(W, W, [0], challenges, zero)[0]
                          for ev in evs], dim=0)

    @classmethod
    def _pow_i_reduce(cls, S: PlonkStructure, evals, challenge_rows: List[List[int]]):
        """For each row c of per-level challenges, compute
        sum_i pow_i(c) * f_i via a vectorised halving tree.

        evals: (n, 8) on the device; challenge_rows: (P, m) host ints.
        Returns list of P host ints.
        """
        lf = S.lf
        n = evals.shape[0]
        m = _next_pow2_log(n)
        pad = (1 << m) - n
        if pad:
            evals = torch.cat([evals, lf.zero((pad,), evals.device)], dim=0)
        P = len(challenge_rows)
        arr = evals[None].expand(P, *evals.shape)
        for h in range(m):
            c = lf.encode([row[h] for row in challenge_rows], evals.device)
            arr = lf.add(arr[:, 0::2], lf.mul(arr[:, 1::2], c[:, None, :]))
        return lf.decode(arr[:, 0])

    @staticmethod
    def generate_challenge(pp_digest, ro_acc, accumulator: Accumulator, instances):
        curve = accumulator.trace.U.curve
        scalar = field(curve.scalar_modulus)
        ro_acc.absorb_point(pp_digest)
        accumulator.absorb_into(ro_acc)
        for inst in instances:
            inst.absorb_into(ro_acc)
        return ro_acc.squeeze(scalar, NUM_CHALLENGE_BITS).v

    @classmethod
    def new_accumulator(cls, S: PlonkStructure, pp: ProtoGalaxyProverParam,
                        ro_acc, device="cuda"):
        """The zero accumulator, its witness on `device` (where the traces
        folded into it must live too): the card unless the caller asks for
        the CPU, as `workloads/poseidon.run` does."""
        count = cls._count_of_evaluation(S)
        m = _next_pow2_log(count)
        trace = RelaxedPlonkTrace(
            RelaxedPlonkInstance.new(
                S.curve, S.num_io, S.num_challenges, len(S.round_sizes),
                S.num_g1_elems, S.num_g2_elems,
            ),
            RelaxedPlonkWitness.zeros(S.lf, S.k, S.round_sizes, device),
        )
        acc = Accumulator(betas=[0] * m, trace=trace, e=0)
        beta = cls.generate_challenge(pp.pp_digest, ro_acc, acc, [])
        p = S.modulus
        acc.betas = [(beta << i) % p for i in range(m)]  # 2^i * beta (mod.rs:72-77)
        return acc

    # -- poly computations ---------------------------------------------------
    @classmethod
    def compute_F(cls, betas: List[int], delta: int, S: PlonkStructure, trace):
        p = S.modulus
        count = cls._count_of_evaluation(S)
        if count == 0:
            return UnivariatePoly([], p)
        m = _next_pow2_log(count)
        points_count = 1 << _next_pow2_log(max(m, 1))
        log_points = _next_pow2_log(points_count)

        with span("pg_gate_eval"):
            evals = cls._evaluate_gates(S, trace.W.W, list(trace.U.challenges))
        xs = list(iter_cyclic_subgroup(p, log_points))
        # level h takes beta_h + X * 2^h * delta, the doubling `prove` uses for
        # betas_stroke: F(alpha) is then sum_i pow_i(betas_stroke) f_i = G(1)
        challenge_rows = [
            [(betas[h] + X * ((delta << h) % p)) % p for h in range(m)] for X in xs
        ]
        with span("pg_pow_i"):
            points = cls._pow_i_reduce(S, evals, challenge_rows)
        # interpolate: ifft over the cyclic subgroup
        return UnivariatePoly(ntt_host(points, p, inverse=True), p)

    @classmethod
    def _folded_witnesses(cls, S, xs: List[int], acc_trace, traces: Sequence[PlonkTrace]):
        """W(X) = L_0(X) acc + sum_j L_j(X) trace_j, per X (folded_trace.rs);
        yielded one X at a time, so that one folded witness is alive."""
        lf = S.lf
        p = S.modulus
        log_n = _next_pow2_log(len(traces) + 1)
        all_challenges = [list(acc_trace.U.challenges)] + [
            list(t.u.challenges) for t in traces]
        for X in xs:
            lag = eval_lagrange_polys_for_cyclic_group(p, X, log_n)
            with span("pg_fold_witness"):
                W = [lf.mul(lf.const(lag[0], (1,), w.device), w)
                     for w in acc_trace.W.W]
                for j, tr in enumerate(traces):
                    W = [lf.add(w, lf.mul(lf.const(lag[j + 1], (1,), w.device), wj))
                         for w, wj in zip(W, tr.w.W)]
            ch = [
                sum(lag[j] * c[i] for j, c in enumerate(all_challenges)) % p
                for i in range(len(acc_trace.U.challenges))
            ]
            yield W, ch

    @classmethod
    def compute_G(cls, S: PlonkStructure, betas_stroke: List[int], acc_trace, traces):
        p = S.modulus
        count = cls._count_of_evaluation(S)
        if count == 0:
            return UnivariatePoly([], p)
        ctx = S.query_ctx()
        max_degree = max((g.degree(ctx) for g in S.gates), default=0)
        points_count = 1 << _next_pow2_log(len(traces) * max_degree + 1)
        log_points = _next_pow2_log(points_count)
        m = _next_pow2_log(count)

        xs = list(iter_cyclic_subgroup(p, log_points))
        # one pow_i reduction per X, challenge row = betas_stroke (same for all)
        points = []
        for W, ch in cls._folded_witnesses(S, xs, acc_trace, traces):
            with span("pg_gate_eval"):
                evals = cls._evaluate_gates(S, W, ch)
            with span("pg_pow_i"):
                points.append(cls._pow_i_reduce(
                    S, evals, [[b % p for b in betas_stroke[:m]]])[0])
        return UnivariatePoly(ntt_host(points, p, inverse=True), p)

    @classmethod
    def compute_K(cls, S, f_alpha: int, betas_stroke, acc_trace, traces):
        """K := (G - F(alpha)*L_0) / Z on the coset (poly/mod.rs:339-382).

        NOTE: L_0 and Z live on the FOLD domain (size next_pow2(L+1)) so that
        G(X) = F(alpha)*L_0(X) + Z(X)*K(X) holds as polynomials; the reference
        mixes this domain with the interpolation domain (and with
        log(count_of_evaluation) in prove) -- its own verifier is `todo!()`,
        so this is the consistent version, as in mira_tpu.
        """
        p = S.modulus
        g_poly = cls.compute_G(S, betas_stroke, acc_trace, traces)
        ctx = S.query_ctx()
        max_degree = max((g.degree(ctx) for g in S.gates), default=0)
        points_count = 1 << _next_pow2_log(len(traces) * max_degree + 1)
        log_n = _next_pow2_log(points_count)
        fold_log_n = _next_pow2_log(len(traces) + 1)

        lf = S.lf
        dev = acc_trace.W.E.device
        g_evals = lf.decode(coset_ntt(lf.encode(list(g_poly), dev), p))
        zeta = field_params(p).zeta
        k_evals = []
        for pt_raw, g_y in zip(iter_cyclic_subgroup(p, log_n), g_evals):
            pt = zeta * pt_raw % p
            l0 = eval_lagrange_polys_for_cyclic_group(p, pt, fold_log_n)[0]
            l_y = f_alpha * l0 % p
            z_y = eval_vanish_polynomial(p, fold_log_n, pt)
            k_evals.append((g_y - l_y) * pow(z_y, -1, p) % p)
        coeffs = lf.decode(coset_intt(lf.encode(k_evals, dev), p))
        return UnivariatePoly(coeffs, p)

    # -- folding -------------------------------------------------------------
    @classmethod
    def fold_trace(cls, acc: RelaxedPlonkTrace, incoming: Sequence[PlonkTrace],
                   gamma: int, log_n: int) -> RelaxedPlonkTrace:
        S_curve = acc.U.curve
        p = S_curve.scalar_modulus
        lf = acc.W.lf
        lag = eval_lagrange_polys_for_cyclic_group(p, gamma, log_n)
        l0 = lag[0]
        U = RelaxedPlonkInstance(
            curve=S_curve,
            W_commitments=[w.scalar_mul(l0) for w in acc.U.W_commitments],
            E_commitment=AffinePoint.identity(S_curve),
            instance=[v * l0 % p for v in acc.U.instance],
            challenges=[c * l0 % p for c in acc.U.challenges],
            u=acc.U.u * l0 % p,
            g1_elements=list(acc.U.g1_elements),
            g2_elements=list(acc.U.g2_elements),
            gt_element=acc.U.gt_element,
        )
        dev = acc.W.E.device
        W = [lf.mul(lf.const(l0, (1,), dev), w) for w in acc.W.W]
        E = lf.mul(lf.const(l0, (1,), dev), acc.W.E)
        for j, tr in enumerate(incoming):
            ln = lag[j + 1]
            U.W_commitments = [
                a.add(b.scalar_mul(ln))
                for a, b in zip(U.W_commitments, tr.u.W_commitments)
            ]
            U.instance = [
                (a + b * ln) % p for a, b in zip(U.instance, tr.u.instance)
            ]
            U.challenges = [
                (a + b * ln) % p for a, b in zip(U.challenges, tr.u.challenges)
            ]
            lnm = lf.const(ln, (1,), dev)
            W = [lf.add(a, lf.mul(lnm, b)) for a, b in zip(W, tr.w.W)]
        return RelaxedPlonkTrace(U, RelaxedPlonkWitness(lf, W, E))

    # -- FoldingScheme API ---------------------------------------------------
    @staticmethod
    def setup_params(pp_digest: AffinePoint, S: PlonkStructure):
        return ProtoGalaxyProverParam(S, pp_digest), pp_digest

    @staticmethod
    def generate_plonk_trace(ck, instance, witness, pp, ro_nark, rng=None):
        return pp.S.run_sps_protocol(ck, instance, witness, ro_nark, rng=rng)

    @classmethod
    @instrument
    def prove(cls, ck, pp: ProtoGalaxyProverParam, ro_acc,
              accumulator: Accumulator, incoming: Sequence[PlonkTrace]):
        L = len(incoming)
        if (L + 1) & L:
            raise ValueError(f"ProtoGalaxy.prove: {L} incoming traces; L + 1 "
                             "must be a power of two (1, 3, 7, ...)")
        S = pp.S
        p = S.modulus
        base_mod = S.curve.base_modulus
        scalar = field(p)
        base = field(base_mod)

        delta = cls.generate_challenge(
            pp.pp_digest, ro_acc, accumulator, [t.u for t in incoming]
        )
        with span("pg_compute_F"):
            poly_F = cls.compute_F(accumulator.betas, delta, S, accumulator.trace)

        for v in poly_F:
            ro_acc.absorb_field(base(v % base_mod))
        alpha = ro_acc.squeeze(scalar, NUM_CHALLENGE_BITS).v

        m = len(accumulator.betas)
        betas_stroke = [
            (accumulator.betas[i] + alpha * ((delta << i) % p)) % p for i in range(m)
        ]

        poly_F_alpha = poly_F.eval(alpha)
        with span("pg_compute_K"):
            poly_K = cls.compute_K(
                S, poly_F_alpha, betas_stroke, accumulator.trace, incoming
            )

        for v in poly_K:
            ro_acc.absorb_field(base(v % base_mod))
        gamma = ro_acc.squeeze(scalar, NUM_CHALLENGE_BITS).v

        fold_log_n = _next_pow2_log(len(incoming) + 1)
        l0_gamma = eval_lagrange_polys_for_cyclic_group(p, gamma, fold_log_n)[0]
        z_gamma = eval_vanish_polynomial(p, fold_log_n, gamma)
        e = (poly_F_alpha * l0_gamma + z_gamma * poly_K.eval(gamma)) % p

        with span("pg_fold_trace"):
            trace = cls.fold_trace(accumulator.trace, incoming, gamma, fold_log_n)
        new_acc = Accumulator(betas=betas_stroke, e=e, trace=trace)
        return new_acc, ProtoGalaxyProof(poly_F, poly_K)

    @classmethod
    def verify(cls, vp, ro_nark, ro_acc, accumulator: Accumulator,
               incoming_instances: Sequence[PlonkInstance],
               proof: ProtoGalaxyProof):
        """Instance-side verification (the reference leaves this todo!();
        here: transcript replay + instance fold)."""
        curve = accumulator.trace.U.curve
        p = curve.scalar_modulus
        base_mod = curve.base_modulus
        scalar = field(p)
        base = field(base_mod)

        for u in incoming_instances:
            sps_verify(u, ro_nark)

        delta = cls.generate_challenge(vp, ro_acc, accumulator, incoming_instances)
        for v in proof.poly_F:
            ro_acc.absorb_field(base(v % base_mod))
        alpha = ro_acc.squeeze(scalar, NUM_CHALLENGE_BITS).v
        m = len(accumulator.betas)
        betas_stroke = [
            (accumulator.betas[i] + alpha * ((delta << i) % p)) % p for i in range(m)
        ]
        for v in proof.poly_K:
            ro_acc.absorb_field(base(v % base_mod))
        gamma = ro_acc.squeeze(scalar, NUM_CHALLENGE_BITS).v

        fold_log_n = _next_pow2_log(len(incoming_instances) + 1)
        lag = eval_lagrange_polys_for_cyclic_group(p, gamma, fold_log_n)
        e = (
            proof.poly_F.eval(alpha) * lag[0]
            + eval_vanish_polynomial(p, fold_log_n, gamma) * proof.poly_K.eval(gamma)
        ) % p

        U = accumulator.trace.U
        new_U = RelaxedPlonkInstance(
            curve=curve,
            W_commitments=[w.scalar_mul(lag[0]) for w in U.W_commitments],
            E_commitment=AffinePoint.identity(curve),
            instance=[v * lag[0] % p for v in U.instance],
            challenges=[c * lag[0] % p for c in U.challenges],
            u=U.u * lag[0] % p,
            g1_elements=list(U.g1_elements),
            g2_elements=list(U.g2_elements),
            gt_element=U.gt_element,
        )
        for j, u in enumerate(incoming_instances):
            ln = lag[j + 1]
            new_U.W_commitments = [
                a.add(b.scalar_mul(ln))
                for a, b in zip(new_U.W_commitments, u.W_commitments)
            ]
            new_U.instance = [
                (a + b * ln) % p for a, b in zip(new_U.instance, u.instance)
            ]
            new_U.challenges = [
                (a + b * ln) % p for a, b in zip(new_U.challenges, u.challenges)
            ]
        return betas_stroke, e, new_U
