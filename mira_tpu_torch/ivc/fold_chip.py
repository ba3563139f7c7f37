"""In-circuit verifier of the folding step: the on-circuit analog of
`RelaxedPlonkInstance::fold`.

Mirrors reference src/ivc/fold_relaxed_plonk_instance_chip.rs:
witness assignment + transcript absorption + challenge squeeze
(assign_witness_with_challenge, :1051-1271), then fold_W/fold_E (ECC),
fold_instances/fold_challenges (nonnative bignat RLC via mult_mod->sum->
red_mod, :693-823), fold_g1/g2/gt for the Mira pairing extensions
(:515-675), orchestrated by fold() (:826-935).

Port of mira_tpu/ivc/fold_chip.py: the same logic, bound to the port's
structure, folding scheme and commitment key."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..curves.host import AffinePoint, G2Point, Tuple12
from ..fields.host import field
from ..gadgets.bignum import BigUintMulModChip, OverflowingBigUint
from ..gadgets.ecc import AssignedEccPoint, EccChip
from ..gadgets.fp12_chip import AssignedG2Point, AssignedTuple12, Fp12Chip, G2EccChip
from ..gadgets.main_gate import CyclicAssigner, MainGate, MainGateConfig
from ..plonk.structure import PlonkInstance, RelaxedPlonkInstance
from ..table.circuit import AssignedValue, RegionCtx
from ..constants import NUM_CHALLENGE_BITS


@dataclasses.dataclass
class AssignedRelaxedPlonkInstance:
    folded_W: List[AssignedEccPoint]
    folded_E: AssignedEccPoint
    folded_u: AssignedValue
    folded_challenges: List[List[AssignedValue]]  # limb cells
    folded_X0: List[AssignedValue]  # limb cells
    folded_X1: List[AssignedValue]
    folded_g1_elements: List[AssignedEccPoint]
    folded_g2_elements: List[AssignedG2Point]
    folded_gt_element: AssignedTuple12

    @staticmethod
    def conditional_select(ctx, config: MainGateConfig, lhs, rhs, cond):
        """cond ? lhs : rhs (fold chip :129-231)."""
        ecc_sel = lambda a, b: AssignedEccPoint(
            MainGate(config).conditional_select(ctx, a.x, b.x, cond),
            MainGate(config).conditional_select(ctx, a.y, b.y, cond),
        )
        mg = MainGate(config)
        g2chip = G2EccChip(config)
        fp12 = Fp12Chip(config)
        sel = lambda a, b: mg.conditional_select(ctx, a, b, cond)
        return AssignedRelaxedPlonkInstance(
            folded_W=[ecc_sel(a, b) for a, b in zip(lhs.folded_W, rhs.folded_W)],
            folded_E=ecc_sel(lhs.folded_E, rhs.folded_E),
            folded_u=sel(lhs.folded_u, rhs.folded_u),
            folded_challenges=[
                [sel(a, b) for a, b in zip(ca, cb)]
                for ca, cb in zip(lhs.folded_challenges, rhs.folded_challenges)
            ],
            folded_X0=[sel(a, b) for a, b in zip(lhs.folded_X0, rhs.folded_X0)],
            folded_X1=[sel(a, b) for a, b in zip(lhs.folded_X1, rhs.folded_X1)],
            folded_g1_elements=[
                ecc_sel(a, b)
                for a, b in zip(lhs.folded_g1_elements, rhs.folded_g1_elements)
            ],
            folded_g2_elements=[
                g2chip.conditional_select_g2(ctx, a, b, cond)
                for a, b in zip(lhs.folded_g2_elements, rhs.folded_g2_elements)
            ],
            folded_gt_element=fp12.conditional_select(
                ctx, lhs.folded_gt_element, rhs.folded_gt_element, cond
            ),
        )

    def iter_wrap_values(self):
        """Absorption order for the instance hash (fold chip :233-268)."""
        out = []
        for W in self.folded_W:
            out.extend([W.x, W.y])
        out.extend([self.folded_E.x, self.folded_E.y])
        out.extend(self.folded_X0)
        out.extend(self.folded_X1)
        for ch in self.folded_challenges:
            out.extend(ch)
        out.append(self.folded_u)
        for g in self.folded_g1_elements:
            out.extend([g.x, g.y])
        for g in self.folded_g2_elements:
            out.extend([g.x[0], g.x[1], g.y[0], g.y[1]])
        out.extend(self.folded_gt_element.elements)
        return out

    def to_relaxed_plonk_instance(self, curve, limb_width: int, limbs_count: int) -> RelaxedPlonkInstance:
        """Read back host-side values (for off/on-circuit consistency tests)."""
        from ..gadgets.bignum import limbs_to_int_bn

        Fb = field(curve.base_modulus)

        def pt(p: AssignedEccPoint) -> AffinePoint:
            if p.x.value == 0 and p.y.value == 0:
                return AffinePoint.identity(curve)
            return AffinePoint(curve, Fb(p.x.value), Fb(p.y.value))

        def g2pt(p: AssignedG2Point) -> G2Point:
            from ..curves.host import Fq2

            if all(v.value == 0 for v in (*p.x, *p.y)):
                return G2Point.identity()
            Fqb = field(curve.base_modulus)
            return G2Point(
                Fq2(Fqb(p.x[0].value), Fqb(p.x[1].value)),
                Fq2(Fqb(p.y[0].value), Fqb(p.y[1].value)),
            )

        bn = lambda cells: limbs_to_int_bn([c.value for c in cells], limb_width)
        return RelaxedPlonkInstance(
            curve=curve,
            W_commitments=[pt(p) for p in self.folded_W],
            E_commitment=pt(self.folded_E),
            instance=[bn(self.folded_X0), bn(self.folded_X1)],
            challenges=[bn(c) for c in self.folded_challenges],
            u=self.folded_u.value,
            g1_elements=[pt(p) for p in self.folded_g1_elements],
            g2_elements=[g2pt(p) for p in self.folded_g2_elements],
            gt_element=Tuple12([Fb(e.value) for e in self.folded_gt_element.elements], Fb),
        )


@dataclasses.dataclass
class AssignedWitness:
    public_params_hash: AssignedEccPoint
    assigned_relaxed: AssignedRelaxedPlonkInstance
    input_W_commitments: List[AssignedEccPoint]
    # (raw value cell, limb cells) per instance element
    input_instance: List[Tuple[AssignedValue, List[AssignedValue]]]
    input_challenges: List[List[AssignedValue]]
    input_g1_elements: List[AssignedEccPoint]
    input_g2_elements: List[AssignedG2Point]
    cross_terms_commits: List[AssignedEccPoint]
    cross_term_gt_commits: List[AssignedTuple12]


@dataclasses.dataclass
class FoldResult:
    assigned_input: AssignedWitness
    assigned_result_of_fold: AssignedRelaxedPlonkInstance


class FoldRelaxedPlonkInstanceChip:
    def __init__(
        self,
        relaxed: RelaxedPlonkInstance,
        limb_width: int,
        limbs_count: int,
        config: MainGateConfig,
    ):
        self.relaxed = relaxed
        self.config = config
        self.limb_width = limb_width
        self.limbs_count = limbs_count
        self.bn_chip = BigUintMulModChip(config, limb_width, limbs_count)
        # the nonnative ("wrong-field") modulus folded over: the scalar field
        # of the commitment curve
        self.scalar_modulus = relaxed.curve.scalar_modulus

    # -- assignment helpers --------------------------------------------------
    def _assign_point(self, ctx, assigner: CyclicAssigner, point: AffinePoint) -> AssignedEccPoint:
        if point.is_inf:
            xv, yv = 0, 0
        else:
            xv, yv = point.x.v, point.y.v
        return AssignedEccPoint(
            assigner.assign_next(ctx, xv), assigner.assign_next(ctx, yv)
        )

    def _assign_g2(self, ctx, assigner, p: G2Point) -> AssignedG2Point:
        if p.is_inf:
            vals = [0, 0, 0, 0]
        else:
            vals = [p.x.c0.v, p.x.c1.v, p.y.c0.v, p.y.c1.v]
        cells = [assigner.assign_next(ctx, v) for v in vals]
        return AssignedG2Point(x=(cells[0], cells[1]), y=(cells[2], cells[3]))

    def _assign_tuple12(self, ctx, assigner, t: Tuple12) -> AssignedTuple12:
        return AssignedTuple12([assigner.assign_next(ctx, e.v) for e in t.elements])

    def _assign_diff_field(self, ctx, assigner, value: int) -> AssignedValue:
        base_mod = ctx.modulus
        assert value < base_mod, "fe_to_fe_safe: value exceeds base field"
        return assigner.assign_next(ctx, value)

    def _bn_decompose(self, ctx, assigner, cell: AssignedValue) -> List[AssignedValue]:
        assigner.finish(ctx)
        return self.bn_chip.from_assigned_cell_to_limbs(ctx, cell)

    # -- witness assignment + challenge (fold chip :1051-1271) ---------------
    def assign_witness_with_challenge(
        self,
        ctx: RegionCtx,
        public_params_hash: AffinePoint,
        input_plonk: PlonkInstance,
        cross_term_commits: List[AffinePoint],
        cross_term_gt_commits: List[Tuple12],
        ro_circuit,
    ) -> Tuple[AssignedWitness, List[AssignedValue]]:
        assigner = CyclicAssigner(self.config.iter_advice_columns(), advice=True)

        def point_(p):
            out = self._assign_point(ctx, assigner, p)
            ro_circuit.absorb_point([out.x, out.y])
            return out

        def g2_(p):
            out = self._assign_g2(ctx, assigner, p)
            ro_circuit.absorb_g2_point([out.x[0], out.x[1], out.y[0], out.y[1]])
            return out

        def tuple12_(t):
            out = self._assign_tuple12(ctx, assigner, t)
            ro_circuit.absorb_fp12_tuple(list(out.elements))
            return out

        def diff_(v):
            out = self._assign_diff_field(ctx, assigner, v % ctx.modulus)
            ro_circuit.absorb_base(out)
            return out

        def diff_bn_(v):
            cell = diff_(v)
            limbs = self._bn_decompose(ctx, assigner, cell)
            return cell, limbs

        rel = self.relaxed
        assigned_pp_hash = point_(public_params_hash)
        assigned_W = [point_(W) for W in rel.W_commitments]
        assigned_E = point_(rel.E_commitment)
        assigned_X0 = diff_bn_(rel.instance[0])[1]
        assigned_X1 = diff_bn_(rel.instance[1])[1]
        assigned_challenges = [diff_bn_(c)[1] for c in rel.challenges]
        assigned_u = diff_(rel.u)
        assigned_g1 = [point_(g) for g in rel.g1_elements]
        assigned_g2 = [g2_(g) for g in rel.g2_elements]
        assigned_gt = tuple12_(rel.gt_element)

        assigned_relaxed = AssignedRelaxedPlonkInstance(
            folded_W=assigned_W,
            folded_E=assigned_E,
            folded_u=assigned_u,
            folded_challenges=assigned_challenges,
            folded_X0=assigned_X0,
            folded_X1=assigned_X1,
            folded_g1_elements=assigned_g1,
            folded_g2_elements=assigned_g2,
            folded_gt_element=assigned_gt,
        )

        input_W = [point_(c) for c in input_plonk.W_commitments]
        input_instance = [diff_bn_(v) for v in input_plonk.instance]
        input_challenges = [diff_bn_(c)[1] for c in input_plonk.challenges]
        input_g1 = [point_(g) for g in input_plonk.g1_elements]
        input_g2 = [g2_(g) for g in input_plonk.g2_elements]
        cross_commits = [point_(c) for c in cross_term_commits]
        gt_commits = [tuple12_(t) for t in cross_term_gt_commits]

        assigner.finish(ctx)
        r = ro_circuit.squeeze_n_bits(ctx, NUM_CHALLENGE_BITS)

        return (
            AssignedWitness(
                public_params_hash=assigned_pp_hash,
                assigned_relaxed=assigned_relaxed,
                input_W_commitments=input_W,
                input_instance=input_instance,
                input_challenges=input_challenges,
                input_g1_elements=input_g1,
                input_g2_elements=input_g2,
                cross_terms_commits=cross_commits,
                cross_term_gt_commits=gt_commits,
            ),
            r,
        )

    # -- fold pieces ---------------------------------------------------------
    def _fold_points(self, ctx, ecc, folded, inputs, r_bits):
        out = []
        for W1, W2 in zip(folded, inputs):
            rW = ecc.scalar_mul(ctx, W2, r_bits)
            out.append(ecc.add(ctx, W1, rW))
        return out

    def _powers_of_r(self, ctx, r_limbs, r_bits, count):
        """[(bits, limbs) for r^1..r^count] via mult_mod chains."""
        powers = [(r_bits, r_limbs)]
        while len(powers) < count:
            prev_limbs = powers[-1][1]
            nxt = self.bn_chip.mult_mod(ctx, prev_limbs, r_limbs, self.scalar_modulus).remainder
            bits = self.bn_chip.to_le_bits(ctx, nxt)
            powers.append((bits, nxt))
        return powers[:count]

    def fold_E(self, ctx, ecc, folded_E, cross_term_commits, r_limbs, r_bits):
        powers = self._powers_of_r(ctx, r_limbs, r_bits, len(cross_term_commits))
        for commit, (bits, _limbs) in zip(cross_term_commits, powers):
            rT = ecc.scalar_mul(ctx, commit, bits)
            folded_E = ecc.add(ctx, folded_E, rT)
        return folded_E

    def fold_gt(self, ctx, fp12, folded_gt, gt_commits, r_limbs, r_bits):
        powers = self._powers_of_r(ctx, r_limbs, r_bits, len(gt_commits))
        for commit, (bits, _limbs) in zip(gt_commits, powers):
            rT = fp12.scalar_mul(ctx, commit, bits)
            folded_gt = fp12.mul(ctx, folded_gt, rT)
        return folded_gt

    def fold_via_biguint(self, ctx, input_limbs, folded_limbs, r_limbs):
        """new_folded = (folded + input*r mod m) mod m (fold chip :693-736)."""
        part_mult_r = self.bn_chip.mult_mod(
            ctx, input_limbs, r_limbs, self.scalar_modulus
        ).remainder
        mw = (1 << self.limb_width) - 1
        _, summed = self.bn_chip.assign_sum(
            ctx, OverflowingBigUint(list(folded_limbs), mw), part_mult_r
        )
        return self.bn_chip.red_mod(ctx, summed, self.scalar_modulus).remainder

    def fold(self, ctx: RegionCtx, w: AssignedWitness, r: List[AssignedValue]) -> FoldResult:
        mg = MainGate(self.config)
        ecc = EccChip(self.config, self.relaxed.curve)
        fp12 = Fp12Chip(self.config)

        r_value = mg.le_bits_to_num(ctx, r)
        r_limbs = self.bn_chip.from_assigned_cell_to_limbs(ctx, r_value)
        r_bits = r

        rel = w.assigned_relaxed
        new_W = self._fold_points(ctx, ecc, rel.folded_W, w.input_W_commitments, r_bits)
        new_E = self.fold_E(ctx, ecc, rel.folded_E, w.cross_terms_commits, r_limbs, r_bits)
        new_u = mg.add(ctx, rel.folded_u, r_value)

        new_X0 = self.fold_via_biguint(ctx, w.input_instance[0][1], rel.folded_X0, r_limbs)
        new_X1 = self.fold_via_biguint(ctx, w.input_instance[1][1], rel.folded_X1, r_limbs)
        new_challenges = [
            self.fold_via_biguint(ctx, inp, fold, r_limbs)
            for inp, fold in zip(w.input_challenges, rel.folded_challenges)
        ]

        new_g1 = self._fold_points(ctx, ecc, rel.folded_g1_elements, w.input_g1_elements, r_bits)
        new_g2 = self._fold_g2(ctx, rel.folded_g2_elements, w.input_g2_elements, r_bits)
        new_gt = self.fold_gt(
            ctx, fp12, rel.folded_gt_element, w.cross_term_gt_commits, r_limbs, r_bits
        )

        result = AssignedRelaxedPlonkInstance(
            folded_W=new_W,
            folded_E=new_E,
            folded_u=new_u,
            folded_challenges=new_challenges,
            folded_X0=new_X0,
            folded_X1=new_X1,
            folded_g1_elements=new_g1,
            folded_g2_elements=new_g2,
            folded_gt_element=new_gt,
        )
        return FoldResult(assigned_input=w, assigned_result_of_fold=result)

    def _fold_g2(self, ctx, folded_g2, input_g2, r_bits):
        """new_g2[i] = folded_g2[i] + r * input_g2[i] (fold chip :540-562)."""
        if not folded_g2:
            return []
        g2 = G2EccChip(self.config)
        out = []
        for W1, W2 in zip(folded_g2, input_g2):
            rW = g2.scalar_mul(ctx, W2, r_bits)
            out.append(g2.add_g2(ctx, W1, rW))
        return out
