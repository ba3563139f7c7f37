"""In-circuit elliptic curve operations over the MainGate
(reference src/gadgets/ecc.rs:173-500).

Points are (x, y) cell pairs with (0, 0) encoding infinity.  `scalar_mul`
uses the reference's incomplete+complete double-and-add split: the first
NUM_BITS-2 bits use unsafe (incomplete) formulas, the tail uses complete
ones, with first-bit and infinity corrections.

Copied from mira_tpu/gadgets/ecc.py; the port imports nothing of mira_tpu.
"""

from __future__ import annotations

import dataclasses
from typing import List

from ..curves.host import AffinePoint, CurveParams
from ..table.circuit import AssignedValue, RegionCtx
from .main_gate import MainGate, MainGateConfig


@dataclasses.dataclass
class AssignedEccPoint:
    x: AssignedValue
    y: AssignedValue


class EccChip:
    def __init__(self, config: MainGateConfig, curve: CurveParams):
        self.main_gate = MainGate(config)
        self.curve = curve  # the curve whose BASE field is the circuit field

    def assign_point(self, ctx: RegionCtx, point: AffinePoint | None) -> AssignedEccPoint:
        cfg = self.main_gate.config
        if point is None or point.is_inf:
            xv, yv = 0, 0
        else:
            xv, yv = point.x.v, point.y.v
        x = ctx.assign_advice(cfg.state[0], xv)
        y = ctx.assign_advice(cfg.state[1], yv)
        ctx.next()
        return AssignedEccPoint(x, y)

    def to_host(self, p: AssignedEccPoint) -> AffinePoint:
        if p.x.value == 0 and p.y.value == 0:
            return AffinePoint.identity(self.curve)
        from ..fields.host import field

        F = field(self.curve.base_modulus)
        return AffinePoint(self.curve, F(p.x.value), F(p.y.value))

    def negate(self, ctx, p: AssignedEccPoint) -> AssignedEccPoint:
        mg = self.main_gate
        pm = ctx.modulus
        y = mg.apply(
            ctx, ([1], None, [p.y]), None, (1, (-p.y.value) % pm)
        )
        return AssignedEccPoint(p.x, y)

    def _add_unsafe(self, ctx, p, q) -> AssignedEccPoint:
        mg = self.main_gate
        yd = mg.sub(ctx, p.y, q.y)
        xd = mg.sub(ctx, p.x, q.x)
        lam = mg.divide(ctx, yd, xd)
        lam2 = mg.square(ctx, lam)
        t1 = mg.sub(ctx, lam2, p.x)
        xr = mg.sub(ctx, t1, q.x)
        t2 = mg.sub(ctx, p.x, xr)
        t3 = mg.mul(ctx, lam, t2)
        yr = mg.sub(ctx, t3, p.y)
        return AssignedEccPoint(xr, yr)

    def _double_unsafe(self, ctx, p) -> AssignedEccPoint:
        mg = self.main_gate
        xp2 = mg.square(ctx, p.x)
        lnum = mg.mul_by_const(ctx, xp2, 3)
        lden = mg.add(ctx, p.y, p.y)
        lam = mg.divide(ctx, lnum, lden)
        lam2 = mg.square(ctx, lam)
        t1 = mg.sub(ctx, lam2, p.x)
        xr = mg.sub(ctx, t1, p.x)
        t2 = mg.sub(ctx, p.x, xr)
        t3 = mg.mul(ctx, lam, t2)
        yr = mg.sub(ctx, t3, p.y)
        return AssignedEccPoint(xr, yr)

    def double(self, ctx, p) -> AssignedEccPoint:
        mg = self.main_gate
        is_inf = mg.is_infinity_point(ctx, p.x, p.y)
        inf = self.assign_point(ctx, None)
        p2 = self._double_unsafe(ctx, p)
        return AssignedEccPoint(
            mg.conditional_select(ctx, inf.x, p2.x, is_inf),
            mg.conditional_select(ctx, inf.y, p2.y, is_inf),
        )

    def add(self, ctx, p, q) -> AssignedEccPoint:
        """Complete addition (ecc.rs:398-455)."""
        mg = self.main_gate
        is_p_iden = mg.is_infinity_point(ctx, p.x, p.y)
        is_q_iden = mg.is_infinity_point(ctx, q.x, q.y)
        is_equal_x = mg.is_equal_term(ctx, p.x, q.x)
        is_equal_y = mg.is_equal_term(ctx, p.y, q.y)

        inf = self.assign_point(ctx, None)
        r = self._add_unsafe(ctx, p, q)
        p2 = self.double(ctx, p)

        x1 = mg.conditional_select(ctx, p2.x, inf.x, is_equal_y)
        y1 = mg.conditional_select(ctx, p2.y, inf.y, is_equal_y)
        x2 = mg.conditional_select(ctx, x1, r.x, is_equal_x)
        y2 = mg.conditional_select(ctx, y1, r.y, is_equal_x)
        x3 = mg.conditional_select(ctx, p.x, x2, is_q_iden)
        y3 = mg.conditional_select(ctx, p.y, y2, is_q_iden)
        x = mg.conditional_select(ctx, q.x, x3, is_p_iden)
        y = mg.conditional_select(ctx, q.y, y3, is_p_iden)
        return AssignedEccPoint(x, y)

    def conditional_select(self, ctx, lhs, rhs, cond) -> AssignedEccPoint:
        mg = self.main_gate
        return AssignedEccPoint(
            mg.conditional_select(ctx, lhs.x, rhs.x, cond),
            mg.conditional_select(ctx, lhs.y, rhs.y, cond),
        )

    def scalar_mul(self, ctx, p0: AssignedEccPoint, scalar_bits: List[AssignedValue]) -> AssignedEccPoint:
        """Incomplete+complete double-and-add (ecc.rs:219-301)."""
        mg = self.main_gate
        num_bits = self.curve.base_modulus.bit_length()
        split_len = min(len(scalar_bits), num_bits - 2)
        incomplete, complete = scalar_bits[:split_len], scalar_bits[split_len:]

        acc = AssignedEccPoint(p0.x, p0.y)
        p = self._double_unsafe(ctx, p0)
        for bit in incomplete[1:]:
            tmp = self._add_unsafe(ctx, acc, p)
            acc = AssignedEccPoint(
                mg.conditional_select(ctx, tmp.x, acc.x, bit),
                mg.conditional_select(ctx, tmp.y, acc.y, bit),
            )
            p = self._double_unsafe(ctx, p)

        # correct if the first bit is 0
        neg = self.negate(ctx, p0)
        acc_minus_initial = self.add(ctx, acc, neg)
        res = AssignedEccPoint(
            mg.conditional_select(ctx, acc.x, acc_minus_initial.x, scalar_bits[0]),
            mg.conditional_select(ctx, acc.y, acc_minus_initial.y, scalar_bits[0]),
        )

        # infinity correction
        infp = self.assign_point(ctx, None)
        is_p_iden = mg.is_infinity_point(ctx, p0.x, p0.y)
        acc = AssignedEccPoint(
            mg.conditional_select(ctx, infp.x, res.x, is_p_iden),
            mg.conditional_select(ctx, infp.y, res.y, is_p_iden),
        )
        p = AssignedEccPoint(
            mg.conditional_select(ctx, infp.x, p.x, is_p_iden),
            mg.conditional_select(ctx, infp.y, p.y, is_p_iden),
        )

        for bit in complete:
            tmp = self.add(ctx, acc, p)
            acc = AssignedEccPoint(
                mg.conditional_select(ctx, tmp.x, acc.x, bit),
                mg.conditional_select(ctx, tmp.y, acc.y, bit),
            )
            p = self.double(ctx, p)
        return acc
