"""Plonkish structure, instances, witnesses and the folding objects (port of
mira_tpu/plonk/structure.py).

Witness rounds are (len, 8) Montgomery word tensors on the commitment key's
device; commitments run through the bucket MSM, row checks through the fold
evaluator, and witness folding as elementwise field ops on that device.
Instance-side math (points, challenges, Gt elements) stays on the host, as
in mira_tpu.  Protocol semantics and the order of every transcript absorb
and every seeded random draw are mira_tpu's.

With a mesh (parallel/mesh.py), the SPS witness commitments are sharded
MSMs and never the incremental delta commit, and the witness fold runs
each rank's block of rows, gathered whole on every rank (mira_tpu's GSPMD
row sharding).
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..curves.host import AffinePoint, CurveParams, G2Point, Tuple12
from ..fields.host import field
from ..polynomial.expression import (
    CompressedGates,
    Expression,
    QueryIndexContext,
)

from ..fields.limbs import (
    NUM_WORDS,
    int_list_words,
    ints_to_words,
    limb_field,
    words_to_ints,
)
from ..ops.field_lincomb import lincomb
from ..table.circuit import PermutationMatrix
from ..polynomial.evaluator import ColumnEvaluator, EvalDomain, eval_rows_host
from ..utils.tracing import span

NUM_CHALLENGE_BITS = 128


# ---------------------------------------------------------------------------
# Lookup arguments (log-derivative)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LookupArguments:
    lookup_polys: List[Expression]
    table_polys: List[Expression]
    has_vector_lookup: bool

    def num_lookups(self) -> int:
        return len(self.lookup_polys)

    def vanishing_lookup_polys(self, ctx: QueryIndexContext) -> List[Expression]:
        from ..polynomial.expression import Poly, Query

        lookup_offset = ctx.num_selectors + ctx.num_fixed + ctx.num_advice
        exprs = []
        for i, L in enumerate(self.lookup_polys):
            exprs.append(L - Poly(Query(lookup_offset + i * 5)))
        for i, T in enumerate(self.table_polys):
            exprs.append(T - Poly(Query(lookup_offset + i * 5 + 1)))
        return exprs

    def log_derivative_lhs_and_rhs(self, ctx: QueryIndexContext) -> List[Expression]:
        from ..polynomial.expression import Challenge, Const, Poly, Query

        challenge_index = 1 if self.has_vector_lookup else 0
        lookup_offset = ctx.num_selectors + ctx.num_fixed + ctx.num_advice
        exprs = []
        for i in range(self.num_lookups()):
            r = Challenge(challenge_index)
            l, t, m, h, g = (
                Poly(Query(lookup_offset + i * 5 + j)) for j in range(5)
            )
            exprs.append(h * (l + r) - Const(1))
            exprs.append(g * (t + r) - m)
        return exprs


def encode_padded(lf, cols, nrow: int, device) -> torch.Tensor:
    """Ragged int columns -> concatenated (len(cols)*nrow, 8) Montgomery
    words with zero tails (Montgomery zero is zero)."""
    from ..table.packed import _last_nonzero

    out = torch.zeros(len(cols) * nrow, NUM_WORDS, dtype=torch.int32,
                      device=device)
    lasts = [_last_nonzero(c) for c in cols]
    used = [v for c, last in zip(cols, lasts) for v in c[:last]]
    if used:
        enc = lf.encode(used, device)
        off = 0
        for i, last in enumerate(lasts):
            out[i * nrow : i * nrow + last] = enc[off : off + last]
            off += last
    return out


FOLD_EVALS = ("pallas", "native", "xla")


def fold_eval_impl(impl: Optional[str] = None) -> str:
    """The gate evaluator of the cross terms and the decider: `impl`, else
    the MIRA_FOLD_EVAL knob, else "pallas".  mira_tpu's names: "pallas" is
    the fold evaluator (kernel 2 on the card, its plain version on the
    CPU), "native" the native row VM on the host, "xla" the column
    evaluator.  Another value raises ValueError."""
    impl = impl or os.environ.get("MIRA_FOLD_EVAL") or "pallas"
    if impl not in FOLD_EVALS:
        raise ValueError(f"MIRA_FOLD_EVAL={impl!r}: expected one of {FOLD_EVALS}")
    return impl


# ---------------------------------------------------------------------------
# Structure
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlonkStructure:
    curve: CurveParams  # the commitment curve; scalar field hosts the table
    k: int
    num_io: int
    selectors: List[List[bool]]
    fixed_columns: List[List[int]]
    num_advice_columns: int
    num_challenges: int
    round_sizes: List[int]
    compressed_gates: CompressedGates
    gates: List[Expression]
    permutation_matrix: PermutationMatrix  # sparse, identity implied
    lookup_arguments: Optional[LookupArguments]
    num_g1_elems: int = 0
    num_g2_elems: int = 0
    target_group_folding_degree: int = 0
    target_group_cross_terms: int = 0
    # real-proof mode: a snark.groth16.Groth16FoldContext that supplies the
    # instances' G1/G2 elements, the Gt cross terms and the Gt decider check
    groth16_ctx: Optional[object] = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def modulus(self) -> int:
        return self.curve.scalar_modulus

    @property
    def lf(self):
        return limb_field(self.modulus)

    def num_lookups(self) -> int:
        return self.lookup_arguments.num_lookups() if self.lookup_arguments else 0

    def has_vector_lookup(self) -> bool:
        return bool(self.lookup_arguments and self.lookup_arguments.has_vector_lookup)

    def get_degree_for_folding(self) -> int:
        return len(self.compressed_gates.grouped)

    def query_ctx(self) -> QueryIndexContext:
        return QueryIndexContext(
            num_selectors=len(self.selectors),
            num_fixed=len(self.fixed_columns),
            num_advice=self.num_advice_columns,
            num_challenges=self.num_challenges,
            num_lookups=self.num_lookups(),
        )

    # -- evaluators (cached per device) -------------------------------------
    def _cache(self) -> dict:
        cache = getattr(self, "_eval_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_eval_cache", cache)
        return cache

    def _evaluator(self, which: str, device) -> ColumnEvaluator:
        """Plain column evaluator (audit path, independent of the op list)."""
        key = ("column", which, str(device))
        cache = self._cache()
        if key not in cache:
            expr = {"compressed": self.compressed_gates.compressed,
                    "homogeneous": self.compressed_gates.homogeneous}[which]
            cache[key] = ColumnEvaluator(
                expr, self.modulus, self.num_advice_columns, self.num_lookups(),
                self.selectors, self.fixed_columns, 1 << self.k, device)
        return cache[key]

    def fixed_words(self) -> List[np.ndarray]:
        """Each fixed column's plain words up to its last nonzero value,
        ((last, 8) int32; the rest of the column is zero), made once."""
        from ..table.packed import _last_nonzero

        words = getattr(self, "_fixed_words", None)
        if words is None:
            words = [int_list_words(col[:_last_nonzero(col)])
                     for col in self.fixed_columns]
            object.__setattr__(self, "_fixed_words", words)
        return words

    def fold_evaluator(self, device):
        """The multi-point fold evaluator of the homogeneous expression
        (polynomial/fold_evaluator.py): the kernel on the card."""
        from ..polynomial.fold_evaluator import FoldEvaluator

        key = ("fold", str(device))
        cache = self._cache()
        if key not in cache:
            cache[key] = FoldEvaluator(
                self.compressed_gates.homogeneous, self.modulus,
                self.num_advice_columns, self.num_lookups(), self.selectors,
                self.fixed_words(), 1 << self.k, device)
        return cache[key]

    def _native_fold_evaluator(self, which: str = "homogeneous"):
        """The native C++ row VM on the host (polynomial/native_evaluator.py)
        for the compressed or homogeneous expression; raises where the native
        library is missing."""
        from ..polynomial.native_evaluator import NativeFoldEvaluator

        key = ("native_fold", which)
        cache = self._cache()
        if key not in cache:
            expr = {"compressed": self.compressed_gates.compressed,
                    "homogeneous": self.compressed_gates.homogeneous}[which]
            cache[key] = NativeFoldEvaluator(
                expr, self.modulus, self.num_advice_columns, self.num_lookups(),
                self.selectors, self.fixed_words(), 1 << self.k)
        return cache[key]

    def _eval_full(self, which: str, Ws, challenges, impl=None):
        """Evaluate a compressed-gate expression on every row, by the route
        `fold_eval_impl(impl)` names: the fold evaluator at the single point
        j = 0 (the homogeneous expression at u = 1 is the compressed one;
        the kernel on the card), the native row VM at j = 0 against a zero
        second witness, or the column evaluator.  Neither of the last two
        runs the kernel's code (the native VM shares only the op list's
        compiler with it).  Returns (nrow, 8) words on Ws[0]'s device."""
        p = self.modulus
        impl = fold_eval_impl(impl)
        ch = [c % p for c in challenges]
        if impl == "native":
            zeros = [torch.zeros(w.shape, dtype=w.dtype) for w in Ws]
            return self._native_fold_evaluator(which).fold_eval_multi(
                tuple(Ws), tuple(zeros), [0], ch, [0] * len(ch))[0]
        if impl == "xla":
            return self._evaluator(which, Ws[0].device)(Ws, (), ch)
        ch_h = ch + ([1] if which == "compressed" else [])
        ev = self.fold_evaluator(Ws[0].device)
        return ev.fold_eval_multi(tuple(Ws), tuple(Ws), [0], ch_h,
                                  [0] * len(ch_h))[0]

    # -- satisfaction checks -------------------------------------------------
    def is_sat(self, ck, ro_nark, U: "PlonkInstance", W: "PlonkWitness"):
        """Raises SatError / SpsError on failure."""
        with span("sat_sps_verify"):
            sps_verify(U, ro_nark)
        with span("sat_gate_eval"):
            out = self._eval_full("compressed", W.W, U.challenges)
            nonzero = int((out != 0).any(-1).sum())
        if nonzero:
            raise SatError(f"gate evaluation mismatch on {nonzero}/{1 << self.k} rows")
        with span("sat_log_derivative"):
            if not self.is_sat_log_derivative(W):
                raise SatError("log derivative relation not satisfied")
        for i, (ci, wi) in enumerate(zip(U.W_commitments, W.W)):
            with span(f"sat_W_commit_{i}"):
                if ck.commit_device(wi) != ci:
                    raise SatError(f"W commitment mismatch at round {i}")

    def is_sat_relaxed(self, ck, U: "RelaxedPlonkInstance", W: "RelaxedPlonkWitness"):
        with span("sat_gate_eval"):
            out = self._eval_full("homogeneous", W.W, list(U.challenges) + [U.u])
            nonzero = int((out != W.E).any(-1).sum())
        if nonzero:
            raise SatError(
                f"relaxed gate evaluation != E on {nonzero}/{1 << self.k} rows")
        with span("sat_log_derivative"):
            if not self.is_sat_log_derivative(W):
                raise SatError("log derivative relation not satisfied")
        for i, (ci, wi) in enumerate(zip(U.W_commitments, W.W)):
            with span(f"sat_W_commit_{i}"):
                if ck.commit_device(wi) != ci:
                    raise SatError(f"W commitment mismatch at round {i}")
        with span("sat_E_commit"):
            if ck.commit_device(W.E) != U.E_commitment:
                raise SatError("E commitment mismatch")
        if self.groth16_ctx is not None:
            with span("sat_gt"):
                self.groth16_ctx.gt_is_sat(U)  # the real-pairing Gt decider

    def is_sat_perm(self, U: "RelaxedPlonkInstance", W: "RelaxedPlonkWitness"):
        """P*Z = Z with Z = instance || advice part of W[0]."""
        p = self.modulus
        nrow = 1 << self.k
        P = self.permutation_matrix
        w_plain = self.lf.to_plain(W.W[0][: nrow * self.num_advice_columns])
        if (P.v == 1).all():
            # unit entries: (P*Z)[i] = Z[j], and the implied ones hold, so
            # compare Z[i] with Z[j] on the moved entries' plain words
            inst = torch.from_numpy(
                ints_to_words([v % p for v in U.instance])
                if U.instance else np.zeros((0, NUM_WORDS), np.int32)
            ).to(w_plain.device)
            ZR = torch.cat((inst, w_plain))
            moved = P.i != P.j
            i_idx, j_idx = (torch.from_numpy(a[moved]).to(w_plain.device)
                            for a in (P.i, P.j))
            mismatch = int((ZR[i_idx] != ZR[j_idx]).any(-1).sum())
        else:
            Z = [v % p for v in U.instance] + words_to_ints(w_plain)
            y = [0] * len(Z)
            for (i, j, v) in P:
                y[i] = (y[i] + v * Z[j]) % p
            mismatch = sum(1 for a, b in zip(y, Z) if a % p != b % p)
        if mismatch:
            raise SatError(f"permutation check failed on {mismatch} entries")

    def is_sat_log_derivative(self, W) -> bool:
        """sum_i h_i == sum_i g_i per lookup."""
        nlookup = self.num_lookups()
        if nlookup == 0:
            return True
        nrow = 1 << self.k
        round_idx = 2 if self.has_vector_lookup() else 1
        vals = self.lf.decode(W.W[round_idx])
        p = self.modulus
        for i in range(nlookup):
            h = vals[(2 * i) * nrow : (2 * i + 1) * nrow]
            g = vals[(2 * i + 1) * nrow : (2 * i + 2) * nrow]
            if (sum(h) - sum(g)) % p != 0:
                return False
        return True

    # -- SPS protocol --------------------------------------------------------
    def run_sps_protocol(self, ck, instance: List[int], advice, ro_nark,
                         rng=None, mesh=None) -> "PlonkTrace":
        """advice: raw advice columns (each 2^k ints) or a DeviceWitness
        (table/packed.py).  With a mesh, the commitments are sharded."""
        from ..table.packed import DeviceWitness

        rng = rng or random.Random(0x5050)
        n = self.num_challenges
        if isinstance(advice, DeviceWitness) and n >= 2:
            # only the lookup coefficient rounds read int columns
            advice = advice.to_int_cols()
        if n == 0:
            return self._sps_0(ck, instance, advice, rng, mesh)
        if n == 1:
            return self._sps_1(ck, instance, advice, ro_nark, rng, mesh)
        if n == 2:
            return self._sps_2(ck, instance, advice, ro_nark, rng, mesh)
        if n == 3:
            return self._sps_3(ck, instance, advice, ro_nark, rng, mesh)
        raise ValueError(f"unsupported challenge count {n}")

    def _concat_pad(self, cols: List[List[int]]) -> List[int]:
        nrow = 1 << self.k
        out: List[int] = []
        for c in cols:
            out.extend(c)
            out.extend([0] * (nrow - len(c)))
        return out

    def _random_group_elements(self, rng):
        """The fresh instance's G1/G2 elements: the next proof's [A, C, vk_x]
        and [B] in real-proof mode, else seeded random placeholders (as the
        reference's SPS draws them)."""
        if self.groth16_ctx is not None:
            return self.groth16_ctx.provide_elements()
        Fb = field(self.curve.base_modulus)
        g1 = [AffinePoint.random(self.curve, rng) for _ in range(self.num_g1_elems)]
        g2 = [G2Point.random(rng, Fb) for _ in range(self.num_g2_elems)]
        return g1, g2

    def _sps_0(self, ck, instance, advice, rng, mesh=None) -> "PlonkTrace":
        from ..table.packed import DeviceWitness

        lf = self.lf
        with span("witness_encode"):
            if isinstance(advice, DeviceWitness):
                assert advice.nrow == 1 << self.k
                W1 = advice.encode_mont(lf, ck.device)
            else:
                W1 = encode_padded(lf, advice, 1 << self.k, ck.device)
        with span("witness_commit"):
            if isinstance(advice, DeviceWitness) and mesh is None:
                C1 = ck.commit_delta(advice)
            else:
                C1 = ck.commit_device(W1, mesh=mesh)
        with span("sps_group_elements"):
            g1, g2 = self._random_group_elements(rng)
        return PlonkTrace(
            u=PlonkInstance(self.curve, [C1], list(instance), [], g1, g2),
            w=PlonkWitness(lf, [W1]),
        )

    def _sps_1(self, ck, instance, advice, ro_nark, rng, mesh=None) -> "PlonkTrace":
        trace = self._sps_0(ck, instance, advice, rng, mesh)
        base = field(self.curve.base_modulus)
        scalar = field(self.modulus)
        for inst in instance:
            ro_nark.absorb_field(base(inst % self.curve.base_modulus))
        for c in trace.u.W_commitments:
            ro_nark.absorb_point(c)
        r1 = ro_nark.squeeze(scalar, NUM_CHALLENGE_BITS).v
        trace.u.challenges.append(r1)
        return trace

    def _sps_2(self, ck, instance, advice, ro_nark, rng, mesh=None) -> "PlonkTrace":
        lf = self.lf
        base = field(self.curve.base_modulus)
        scalar = field(self.modulus)
        nrow = 1 << self.k
        # columns interleaved per lookup (l_i, t_i, m_i), the layout the
        # evaluator's index map expects
        ls, ts, ms = self._lookup_coeff_1(advice, 0)
        W1 = encode_padded(lf, list(advice) + list(_interleave3(ls, ts, ms)),
                           nrow, ck.device)
        cm1 = ck.commit_device(W1, mesh=mesh)
        for inst in instance:
            ro_nark.absorb_field(base(inst % self.curve.base_modulus))
        ro_nark.absorb_point(cm1)
        r1 = ro_nark.squeeze(scalar, NUM_CHALLENGE_BITS).v
        hs, gs = self._lookup_coeff_2(ls, ts, ms, r1)
        W2 = encode_padded(lf, _interleave(hs, gs), nrow, ck.device)
        cm2 = ck.commit_device(W2, mesh=mesh)
        ro_nark.absorb_point(cm2)
        r2 = ro_nark.squeeze(scalar, NUM_CHALLENGE_BITS).v
        g1, g2 = self._random_group_elements(rng)
        return PlonkTrace(
            u=PlonkInstance(self.curve, [cm1, cm2], list(instance), [r1, r2], g1, g2),
            w=PlonkWitness(lf, [W1, W2]),
        )

    def _sps_3(self, ck, instance, advice, ro_nark, rng, mesh=None) -> "PlonkTrace":
        lf = self.lf
        base = field(self.curve.base_modulus)
        scalar = field(self.modulus)
        nrow = 1 << self.k
        for inst in instance:
            ro_nark.absorb_field(base(inst % self.curve.base_modulus))
        W1 = encode_padded(lf, advice, nrow, ck.device)
        cm1 = ck.commit_device(W1, mesh=mesh)
        ro_nark.absorb_point(cm1)
        r1 = ro_nark.squeeze(scalar, NUM_CHALLENGE_BITS).v
        ls, ts, ms = self._lookup_coeff_1(advice, r1)
        W2 = encode_padded(lf, _interleave3(ls, ts, ms), nrow, ck.device)
        cm2 = ck.commit_device(W2, mesh=mesh)
        ro_nark.absorb_point(cm2)
        r2 = ro_nark.squeeze(scalar, NUM_CHALLENGE_BITS).v
        hs, gs = self._lookup_coeff_2(ls, ts, ms, r2)
        W3 = encode_padded(lf, _interleave(hs, gs), nrow, ck.device)
        cm3 = ck.commit_device(W3, mesh=mesh)
        ro_nark.absorb_point(cm3)
        r3 = ro_nark.squeeze(scalar, NUM_CHALLENGE_BITS).v
        g1, g2 = self._random_group_elements(rng)
        return PlonkTrace(
            u=PlonkInstance(self.curve, [cm1, cm2, cm3], list(instance),
                            [r1, r2, r3], g1, g2),
            w=PlonkWitness(lf, [W1, W2, W3]),
        )

    # -- lookup coefficient evaluation --------------------------------------
    def _lookup_coeff_1(self, advice, r: int):
        la = self.lookup_arguments
        assert la is not None
        dom = EvalDomain(
            modulus=self.modulus,
            num_advice=self.num_advice_columns,
            num_lookup=self.num_lookups(),
            challenges=[r],
            selectors=self.selectors,
            fixed=self.fixed_columns,
            W1s=[self._concat_pad(advice)],
            W2s=[],
        )
        ls = [eval_rows_host(poly, dom) for poly in la.lookup_polys]
        ts = [eval_rows_host(poly, dom) for poly in la.table_polys]
        ms = []
        for l, t in zip(ls, ts):
            counts = {}
            for v in l:
                counts[v] = counts.get(v, 0) + 1
            seen = set()
            m = []
            for tv in t:
                if tv in seen:
                    m.append(0)
                else:
                    seen.add(tv)
                    m.append(counts.get(tv, 0))
            ms.append(m)
        return ls, ts, ms

    def _lookup_coeff_2(self, ls, ts, ms, r: int):
        p = self.modulus
        hs, gs = [], []
        for l, t, m in zip(ls, ts, ms):
            h = [pow((li + r) % p, -1, p) if (li + r) % p != 0 else 0 for li in l]
            g = [
                (mi * (pow((ti + r) % p, -1, p) if (ti + r) % p != 0 else 0)) % p
                for ti, mi in zip(t, m)
            ]
            hs.append(h)
            gs.append(g)
        return hs, gs


def _interleave(hs, gs):
    out = []
    for h, g in zip(hs, gs):
        out.append(h)
        out.append(g)
    return out


def _interleave3(ls, ts, ms):
    out = []
    for l, t, m in zip(ls, ts, ms):
        out.extend([l, t, m])
    return out


class SatError(Exception):
    pass


# ---------------------------------------------------------------------------
# Instances / witnesses
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlonkInstance:
    curve: CurveParams
    W_commitments: List[AffinePoint]
    instance: List[int]
    challenges: List[int]
    g1_elements: List[AffinePoint]
    g2_elements: List[G2Point]

    @classmethod
    def new(cls, curve, num_io, num_challenges, num_witness, num_g1, num_g2):
        return cls(
            curve,
            [AffinePoint.identity(curve) for _ in range(num_witness)],
            [0] * num_io,
            [0] * num_challenges,
            [AffinePoint.identity(curve) for _ in range(num_g1)],
            [G2Point.identity(field(curve.base_modulus)) for _ in range(num_g2)],
        )

    def to_relax(self) -> "RelaxedPlonkInstance":
        Fb = field(self.curve.base_modulus)
        return RelaxedPlonkInstance(
            curve=self.curve,
            W_commitments=list(self.W_commitments),
            E_commitment=AffinePoint.identity(self.curve),
            instance=list(self.instance),
            challenges=list(self.challenges),
            u=1,
            g1_elements=list(self.g1_elements),
            g2_elements=list(self.g2_elements),
            gt_element=Tuple12.one(Fb),
        )

    def absorb_into(self, ro):
        base = field(self.curve.base_modulus)
        for c in self.W_commitments:
            ro.absorb_point(c)
        for v in self.instance:
            ro.absorb_field(base(v % self.curve.base_modulus))
        for v in self.challenges:
            ro.absorb_field(base(v % self.curve.base_modulus))
        for g in self.g1_elements:
            ro.absorb_point(g)
        for g in self.g2_elements:
            ro.absorb_g2_point(g)


@dataclasses.dataclass
class RelaxedPlonkInstance:
    curve: CurveParams
    W_commitments: List[AffinePoint]
    E_commitment: AffinePoint
    instance: List[int]
    challenges: List[int]
    u: int
    g1_elements: List[AffinePoint]
    g2_elements: List[G2Point]
    gt_element: Tuple12

    @classmethod
    def new(cls, curve, num_io, num_challenges, num_witness, num_g1, num_g2):
        Fb = field(curve.base_modulus)
        return cls(
            curve,
            [AffinePoint.identity(curve) for _ in range(num_witness)],
            AffinePoint.identity(curve),
            [0] * num_io,
            [0] * num_challenges,
            0,
            [AffinePoint.identity(curve) for _ in range(num_g1)],
            [G2Point.identity(Fb) for _ in range(num_g2)],
            Tuple12.one(Fb),
        )

    def absorb_into(self, ro):
        base = field(self.curve.base_modulus)
        for c in self.W_commitments:
            ro.absorb_point(c)
        ro.absorb_point(self.E_commitment)
        for v in self.instance:
            ro.absorb_field(base(v % self.curve.base_modulus))
        for v in self.challenges:
            ro.absorb_field(base(v % self.curve.base_modulus))
        ro.absorb_field(base(self.u % self.curve.base_modulus))
        for g in self.g1_elements:
            ro.absorb_point(g)
        for g in self.g2_elements:
            ro.absorb_g2_point(g)
        ro.absorb_fp12_tuple(self.gt_element)

    def fold(self, U2: PlonkInstance, cross_term_g1_commits: List[AffinePoint],
             cross_term_gt_commits: List[Tuple12], r: int) -> "RelaxedPlonkInstance":
        p = self.curve.scalar_modulus
        W_commitments = [
            w1.add(w2.scalar_mul(r))
            for w1, w2 in zip(self.W_commitments, U2.W_commitments)
        ]
        g1_elements = [
            a.add(b.scalar_mul(r)) for a, b in zip(self.g1_elements, U2.g1_elements)
        ]
        g2_elements = [
            a.add(b.scalar_mul(r)) for a, b in zip(self.g2_elements, U2.g2_elements)
        ]
        instance = [(a + r * b) % p for a, b in zip(self.instance, U2.instance)]
        challenges = [(a + r * b) % p for a, b in zip(self.challenges, U2.challenges)]
        u = (self.u + r) % p

        E_commitment = self.E_commitment
        rpow = r
        for tk in cross_term_g1_commits:
            E_commitment = E_commitment.add(tk.scalar_mul(rpow))
            rpow = (rpow * r) % p

        gt_element = self.gt_element
        rpow = r
        for gt in cross_term_gt_commits:
            gt_element = gt_element.mul(gt.scalar_mul(rpow))
            rpow = (rpow * r) % p

        return RelaxedPlonkInstance(self.curve, W_commitments, E_commitment,
                                    instance, challenges, u, g1_elements,
                                    g2_elements, gt_element)

    def __eq__(self, o):
        return (
            self.W_commitments == o.W_commitments
            and self.E_commitment == o.E_commitment
            and self.instance == o.instance
            and self.challenges == o.challenges
            and self.u == o.u
            and self.g1_elements == o.g1_elements
            and self.g2_elements == o.g2_elements
            and self.gt_element == o.gt_element
        )


class PlonkWitness:
    """Witness rounds as (len, 8) Montgomery word tensors."""

    def __init__(self, lf, W):
        self.lf = lf
        self.W = list(W)

    @classmethod
    def zeros(cls, lf, round_sizes, device="cpu"):
        return cls(lf, [lf.zero((sz,), device) for sz in round_sizes])

    def to_relax(self, k: int) -> "RelaxedPlonkWitness":
        return RelaxedPlonkWitness(self.lf, list(self.W),
                                   self.lf.zero((1 << k,), self.W[0].device))

class RelaxedPlonkWitness:
    def __init__(self, lf, W, E):
        self.lf = lf
        self.W = list(W)
        self.E = E

    @classmethod
    def zeros(cls, lf, k, round_sizes, device="cpu"):
        return cls(lf, [lf.zero((sz,), device) for sz in round_sizes],
                   lf.zero((1 << k,), device))

    def fold(self, W2: PlonkWitness, cross_terms: List, r: int,
             mesh=None) -> "RelaxedPlonkWitness":
        """W' = W1 + r*W2; E' = E + sum_k r^k T_k, each array one row-wise
        linear combination on the witness device (ops/field_lincomb.py, one
        launch of the kernel on the card).  With a mesh, each rank folds its
        block of the rows of every array, and the blocks are gathered."""
        p = self.lf.modulus
        r %= p
        rpows = [pow(r, k, p) for k in range(len(cross_terms) + 1)]  # 1, r, r^2, ...

        def fold_E(E1, *ts):
            return lincomb(p, [E1, *ts], [rpows])[0]

        def rlc(a, b):
            return lincomb(p, [a, b], [rpows[:2]])[0]

        rows = mesh.rowwise if mesh is not None else (lambda fn, *ts: fn(*ts))
        return RelaxedPlonkWitness(
            self.lf, [rows(rlc, a, b) for a, b in zip(self.W, W2.W)],
            rows(fold_E, self.E, *cross_terms))


@dataclasses.dataclass
class PlonkTrace:
    u: PlonkInstance
    w: PlonkWitness

    def to_relax(self, k: int) -> "RelaxedPlonkTrace":
        return RelaxedPlonkTrace(self.u.to_relax(), self.w.to_relax(k))


@dataclasses.dataclass
class RelaxedPlonkTrace:
    U: RelaxedPlonkInstance
    W: RelaxedPlonkWitness


# ---------------------------------------------------------------------------
# SPS verification
# ---------------------------------------------------------------------------


class SpsError(Exception):
    pass


def sps_verify(U: PlonkInstance, ro_nark):
    num_challenges = len(U.challenges)
    if num_challenges == 0:
        return
    base = field(U.curve.base_modulus)
    scalar = field(U.curve.scalar_modulus)
    for v in U.instance:
        ro_nark.absorb_field(base(v % U.curve.base_modulus))
    for i in range(num_challenges):
        ro_nark.absorb_point(U.W_commitments[i])
        got = ro_nark.squeeze(scalar, NUM_CHALLENGE_BITS).v
        if got != U.challenges[i]:
            raise SpsError(f"challenge mismatch at index {i}")

