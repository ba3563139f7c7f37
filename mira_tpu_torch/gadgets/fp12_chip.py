"""In-circuit Fp12/Gt tuple operations (reference src/gadgets/fp12.rs
in-circuit half) and the G2 point container (ecc2.rs).

The full G2 in-circuit scalar-mul arrives with the SnarkStar workload; the
trivial/poseidon/merkle IVC slice needs assignment, absorption and
conditional-select only (gt cross terms empty => fold_gt is a no-op chain).

Copied from mira_tpu/gadgets/fp12_chip.py; the port imports nothing of mira_tpu.
"""

from __future__ import annotations

import dataclasses
from typing import List

from ..curves.host import XI_0
from ..table.circuit import AssignedValue, RegionCtx
from .main_gate import MainGate, MainGateConfig


@dataclasses.dataclass
class AssignedTuple12:
    elements: List[AssignedValue]  # 12 cells


@dataclasses.dataclass
class AssignedG2Point:
    x: tuple  # (c0 cell, c1 cell)
    y: tuple


class Fp12Chip:
    def __init__(self, config: MainGateConfig):
        self.main_gate = MainGate(config)

    def conditional_select(self, ctx, lhs: AssignedTuple12, rhs: AssignedTuple12, cond):
        mg = self.main_gate
        return AssignedTuple12(
            [
                mg.conditional_select(ctx, a, b, cond)
                for a, b in zip(lhs.elements, rhs.elements)
            ]
        )

    def mul(self, ctx, a: AssignedTuple12, b: AssignedTuple12) -> AssignedTuple12:
        """Schoolbook 6x6 with xi0 reduction, mirroring the off-circuit
        algorithm (fp12.rs:65-117) with one MainGate row per mul/add."""
        mg = self.main_gate
        s, t = a.elements, b.elements
        zero = mg.assign_value(ctx, 0)

        def addc(x, y):
            return mg.add(ctx, x, y)

        def subc(x, y):
            return mg.sub(ctx, x, y)

        def mulc(x, y):
            return mg.mul(ctx, x, y)

        a0b0 = [zero] * 11
        a0b1 = [zero] * 11
        a1b0 = [zero] * 11
        a1b1 = [zero] * 11
        for i in range(6):
            for j in range(6):
                a0b0[i + j] = addc(a0b0[i + j], mulc(s[i], t[j]))
                a0b1[i + j] = addc(a0b1[i + j], mulc(s[i], t[j + 6]))
                a1b0[i + j] = addc(a1b0[i + j], mulc(s[i + 6], t[j]))
                a1b1[i + j] = addc(a1b1[i + j], mulc(s[i + 6], t[j + 6]))
        sub = [subc(a0b0[i], a1b1[i]) for i in range(11)]
        add = [addc(a0b1[i], a1b0[i]) for i in range(11)]
        out = [zero] * 12
        for i in range(6):
            if i < 5:
                xi_term = mg.mul_by_const(ctx, sub[i + 6], XI_0)
                out[i] = subc(addc(xi_term, sub[i]), add[i + 6])
            else:
                out[i] = sub[i]
        for i in range(6):
            if i < 5:
                xi_term = mg.mul_by_const(ctx, add[i + 6], XI_0)
                out[i + 6] = addc(addc(add[i], sub[i + 6]), xi_term)
            else:
                out[i + 6] = add[i]
        return AssignedTuple12(out)

    def one(self, ctx) -> AssignedTuple12:
        mg = self.main_gate
        one = mg.assign_value(ctx, 1)
        mg.assert_equal_const(ctx, one, 1)
        zeros = []
        for _ in range(11):
            z = mg.assign_value(ctx, 0)
            mg.assert_equal_const(ctx, z, 0)
            zeros.append(z)
        return AssignedTuple12([one] + zeros)

    def scalar_mul(self, ctx, base: AssignedTuple12, scalar_bits) -> AssignedTuple12:
        """LSB-first square-and-multiply over assigned bits
        (fp12.rs in-circuit scalar_mul)."""
        acc = self.one(ctx)
        p = base
        for i, bit in enumerate(scalar_bits):
            mult = self.mul(ctx, acc, p)
            acc = self.conditional_select(ctx, mult, acc, bit)
            if i + 1 < len(scalar_bits):
                p = self.mul(ctx, p, p)
        return acc


class G2EccChip:
    """G2 (Fq2-coordinate) on-circuit arithmetic
    (reference src/gadgets/ecc2.rs:227-737).

    Points are four cells (x0, x1, y0, y1); (0,0,0,0) encodes infinity.
    Fq2 = F[u]/(u^2+1)."""

    def __init__(self, config: MainGateConfig):
        self.main_gate = MainGate(config)

    # -- fq2 helpers (ecc2.rs:639-760) --------------------------------------
    def fq2_add(self, ctx, a, b):
        mg = self.main_gate
        return (mg.add(ctx, a[0], b[0]), mg.add(ctx, a[1], b[1]))

    def fq2_sub(self, ctx, a, b):
        mg = self.main_gate
        return (mg.sub(ctx, a[0], b[0]), mg.sub(ctx, a[1], b[1]))

    def fq2_mul(self, ctx, a, b):
        mg = self.main_gate
        a0b0 = mg.mul(ctx, a[0], b[0])
        a1b1 = mg.mul(ctx, a[1], b[1])
        a0b1 = mg.mul(ctx, a[0], b[1])
        a1b0 = mg.mul(ctx, a[1], b[0])
        return (mg.sub(ctx, a0b0, a1b1), mg.add(ctx, a0b1, a1b0))

    def fq2_is_zero(self, ctx, a):
        mg = self.main_gate
        z0 = mg.is_zero_term(ctx, a[0])
        z1 = mg.is_zero_term(ctx, a[1])
        return mg.mul(ctx, z0, z1)

    def fq2_is_equal(self, ctx, a, b):
        mg = self.main_gate
        e0 = mg.is_equal_term(ctx, a[0], b[0])
        e1 = mg.is_equal_term(ctx, a[1], b[1])
        return mg.mul(ctx, e0, e1)

    def fq2_inv_or_zero(self, ctx, a):
        """(a0 - a1*u)/(a0^2 + a1^2), with 0 -> garbage-but-satisfiable via
        divide semantics (ecc2.rs:698-760)."""
        mg = self.main_gate
        n0 = mg.mul(ctx, a[0], a[0])
        n1 = mg.mul(ctx, a[1], a[1])
        norm = mg.add(ctx, n0, n1)
        _, norm_inv = mg.invert_with_flag(ctx, norm)
        c0 = mg.mul(ctx, a[0], norm_inv)
        a1n = mg.mul(ctx, a[1], norm_inv)
        p = ctx.modulus
        c1 = mg.apply(ctx, ([p - 1], None, [a1n]), None, (p - 1, (-a1n.value) % p))
        return (c0, c1)

    # -- points --------------------------------------------------------------
    def assign_g2_point(self, ctx, point) -> AssignedG2Point:
        cfg = self.main_gate.config
        if point is None or point.is_inf:
            vals = [0, 0, 0, 0]
        else:
            vals = [point.x.c0.v, point.x.c1.v, point.y.c0.v, point.y.c1.v]
        cells = [ctx.assign_advice(cfg.state[i], vals[i]) for i in range(4)]
        ctx.next()
        return AssignedG2Point(x=(cells[0], cells[1]), y=(cells[2], cells[3]))

    def zero_g2(self, ctx) -> AssignedG2Point:
        return self.assign_g2_point(ctx, None)

    def is_infinity_g2(self, ctx, p):
        return self.fq2_is_zero(ctx, p.x)

    def negate_g2(self, ctx, p) -> AssignedG2Point:
        mg = self.main_gate
        pm = ctx.modulus
        ny0 = mg.apply(ctx, ([1], None, [p.y[0]]), None, (1, (-p.y[0].value) % pm))
        ny1 = mg.apply(ctx, ([1], None, [p.y[1]]), None, (1, (-p.y[1].value) % pm))
        # gate: y + out = 0  =>  out = -y
        return AssignedG2Point(x=p.x, y=(ny0, ny1))

    def conditional_select_g2(self, ctx, lhs: AssignedG2Point, rhs: AssignedG2Point, cond):
        mg = self.main_gate
        return AssignedG2Point(
            x=(
                mg.conditional_select(ctx, lhs.x[0], rhs.x[0], cond),
                mg.conditional_select(ctx, lhs.x[1], rhs.x[1], cond),
            ),
            y=(
                mg.conditional_select(ctx, lhs.y[0], rhs.y[0], cond),
                mg.conditional_select(ctx, lhs.y[1], rhs.y[1], cond),
            ),
        )

    def double_g2(self, ctx, p) -> AssignedG2Point:
        """Complete doubling (ecc2.rs:349-413)."""
        mg = self.main_gate
        is_inf = self.is_infinity_g2(ctx, p)
        y_is_zero = self.fq2_is_zero(ctx, p.y)
        x2 = self.fq2_mul(ctx, p.x, p.x)
        three = mg.assign_value(ctx, 3)
        zero = mg.assign_value(ctx, 0)
        three_x2 = self.fq2_mul(ctx, (three, zero), x2)
        two = mg.assign_value(ctx, 2)
        zero2 = mg.assign_value(ctx, 0)
        two_y = self.fq2_mul(ctx, (two, zero2), p.y)
        two_y_inv = self.fq2_inv_or_zero(ctx, two_y)
        lam = self.fq2_mul(ctx, three_x2, two_y_inv)
        lam2 = self.fq2_mul(ctx, lam, lam)
        two_x = self.fq2_mul(ctx, (two, zero2), p.x)
        x3 = self.fq2_sub(ctx, lam2, two_x)
        x_minus_x3 = self.fq2_sub(ctx, p.x, x3)
        t = self.fq2_mul(ctx, lam, x_minus_x3)
        y3 = self.fq2_sub(ctx, t, p.y)
        result = AssignedG2Point(x=x3, y=y3)
        inf = self.zero_g2(ctx)
        result = self.conditional_select_g2(ctx, inf, result, y_is_zero)
        return self.conditional_select_g2(ctx, inf, result, is_inf)

    def add_g2(self, ctx, p, q) -> AssignedG2Point:
        """Complete addition (ecc2.rs:273-347)."""
        mg = self.main_gate
        p_inf = self.fq2_is_zero(ctx, p.x)
        q_inf = self.fq2_is_zero(ctx, q.x)
        x_equal = self.fq2_is_equal(ctx, p.x, q.x)
        y_equal = self.fq2_is_equal(ctx, p.y, q.y)
        points_equal = mg.mul(ctx, x_equal, y_equal)

        dy = self.fq2_sub(ctx, q.y, p.y)
        dx = self.fq2_sub(ctx, q.x, p.x)
        dx_inv = self.fq2_inv_or_zero(ctx, dx)
        lam = self.fq2_mul(ctx, dy, dx_inv)
        lam2 = self.fq2_mul(ctx, lam, lam)
        t = self.fq2_sub(ctx, lam2, p.x)
        x3 = self.fq2_sub(ctx, t, q.x)
        x1_minus_x3 = self.fq2_sub(ctx, p.x, x3)
        t2 = self.fq2_mul(ctx, lam, x1_minus_x3)
        y3 = self.fq2_sub(ctx, t2, p.y)

        normal = AssignedG2Point(x=x3, y=y3)
        zero_pt = self.zero_g2(ctx)
        res = self.conditional_select_g2(ctx, zero_pt, normal, x_equal)
        doubled = self.double_g2(ctx, p)
        res = self.conditional_select_g2(ctx, doubled, res, points_equal)
        res = self.conditional_select_g2(ctx, q, res, p_inf)
        return self.conditional_select_g2(ctx, p, res, q_inf)

    def scalar_mul(self, ctx, p, scalar_bits) -> AssignedG2Point:
        """Double-and-add with first-bit/infinity corrections
        (ecc2.rs:415-612)."""
        mg = self.main_gate
        num_bits = ctx.modulus.bit_length()
        split_len = min(len(scalar_bits), num_bits - 2)
        incomplete, complete = scalar_bits[:split_len], scalar_bits[split_len:]

        acc = p
        double_p = self.double_g2(ctx, p)
        for bit in incomplete[1:]:
            s = self.add_g2(ctx, acc, double_p)
            acc = self.conditional_select_g2(ctx, s, acc, bit)
            double_p = self.double_g2(ctx, double_p)

        neg_p = self.negate_g2(ctx, p)
        acc_minus_initial = self.add_g2(ctx, acc, neg_p)
        acc = self.conditional_select_g2(ctx, acc, acc_minus_initial, scalar_bits[0])

        inf = self.zero_g2(ctx)
        is_p_inf = self.is_infinity_g2(ctx, p)
        acc = self.conditional_select_g2(ctx, inf, acc, is_p_inf)
        double_p = self.conditional_select_g2(ctx, inf, double_p, is_p_inf)

        for bit in complete:
            s = self.add_g2(ctx, acc, double_p)
            acc = self.conditional_select_g2(ctx, s, acc, bit)
            double_p = self.double_g2(ctx, double_p)
        return acc
