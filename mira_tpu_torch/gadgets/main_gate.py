"""The universal MainGate: the single custom gate every chip builds on.

Gate equation (reference src/main_gate.rs:566-591):

    q_m[0]*s0*s1 + q_m[1]*s2*s3 (T>=4) + sum_i q_1[i]*s_i + sum_i q_5[i]*s_i^5
      + rc + q_i*input + q_o*out = 0

Column creation order matches the reference's configure() exactly
(state advice, input, out; then q_1[T], q_5[T], q_m[2], q_i, q_o, rc fixed),
so the emitted gate expression string equals the reference's parity string
(main_gate.rs:900-935 tests).

Helper rows mirror src/gadgets/util.rs (with the cell-overwrite
bugs in the reference's `assign_bit`/`add_with_const` fixed — our versions
actually constrain b^2=b and lhs+c=out; the reference's rows were vacuous or
unsatisfiable and unused on the hot path).

Copied from mira_tpu/gadgets/main_gate.py; the port imports nothing of mira_tpu.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

from ..table.circuit import AssignedValue, Cell, Column, ConstraintSystem, RegionCtx
from ..table.tape import as_int, getbit, invmod_or_one, iszero_mod

# WrapValue: either a plain int (assign fresh) or an AssignedValue (assign +
# copy-constrain to the source cell); None means leave the default 0.
Wrap = Union[int, AssignedValue, None]


def wrap_value(v: Wrap) -> int:
    if v is None:
        return 0
    if isinstance(v, AssignedValue):
        return v.value
    return v


class MainGateConfig:
    def __init__(self, t: int, state, input_, out, q_m, q_1, q_5, q_i, q_o, rc):
        self.t = t
        self.state = state
        self.input = input_
        self.out = out
        self.q_m = q_m
        self.q_1 = q_1
        self.q_5 = q_5
        self.q_i = q_i
        self.q_o = q_o
        self.rc = rc

    def into_smaller_size(self, n: int) -> "MainGateConfig":
        assert n <= self.t
        return MainGateConfig(
            n, self.state[:n], self.input, self.out, self.q_m,
            self.q_1[:n], self.q_5[:n], self.q_i, self.q_o, self.rc,
        )

    def iter_advice_columns(self):
        return [*self.state, self.input, self.out]

    def iter_fixed_columns(self):
        return [*self.q_1, *self.q_5, *self.q_m, self.q_i, self.q_o, self.rc]


class MainGate:
    def __init__(self, config: MainGateConfig):
        self.config = config

    @staticmethod
    def configure(cs: ConstraintSystem, t: int) -> MainGateConfig:
        assert t >= 2
        state = [cs.advice_column() for _ in range(t)]
        input_ = cs.advice_column()
        out = cs.advice_column()
        q_1 = [cs.fixed_column() for _ in range(t)]
        q_5 = [cs.fixed_column() for _ in range(t)]
        q_m = [cs.fixed_column() for _ in range(2)]
        q_i = cs.fixed_column()
        q_o = cs.fixed_column()
        rc = cs.fixed_column()

        for s in state:
            cs.enable_equality(s)
        cs.enable_equality(input_)
        cs.enable_equality(out)

        se = [cs.query(s) for s in state]
        ie = cs.query(input_)
        oe = cs.query(out)
        q1e = [cs.query(q) for q in q_1]
        q5e = [cs.query(q) for q in q_5]
        qme = [cs.query(q) for q in q_m]
        qie, qoe, rce = cs.query(q_i), cs.query(q_o), cs.query(rc)

        def pow5(v):
            v2 = v * v
            return v2 * v2 * v

        init = qme[0] * se[0] * se[1] + qie * ie + rce + qoe * oe
        if t >= 4:
            init = qme[1] * se[2] * se[3] + init
        expr = init
        for s, q1, q5 in zip(se, q1e, q5e):
            expr = expr + (q1 * s + q5 * pow5(s))
        cs.create_gate("main_gate", [expr])

        return MainGateConfig(t, state, input_, out, q_m, q_1, q_5, q_i, q_o, rc)

    # -- core assignment helpers --------------------------------------------
    def _assign_wrapped(self, ctx: RegionCtx, col: Column, v: Wrap) -> Optional[AssignedValue]:
        if v is None:
            return None
        av = ctx.assign_advice(col, wrap_value(v))
        if isinstance(v, AssignedValue):
            ctx.constrain_equal(av.cell, v.cell)
        return av

    def apply(
        self,
        ctx: RegionCtx,
        state: Tuple[Optional[List[int]], Optional[List[int]], Optional[List[Wrap]]],
        rc: Optional[int],
        out: Tuple[int, Wrap],
    ) -> AssignedValue:
        """(q_1, q_m, state), rc, (q_o, out) -> assigned out
        (reference main_gate.rs:608-667)."""
        cfg = self.config
        q_1, q_m, st = state
        if q_1 is not None:
            for i, v in enumerate(q_1):
                ctx.assign_fixed(cfg.q_1[i], v)
        if q_m is not None:
            for i, v in enumerate(q_m):
                ctx.assign_fixed(cfg.q_m[i], v)
        if st is not None:
            for i, v in enumerate(st):
                self._assign_wrapped(ctx, cfg.state[i], v)
        if rc is not None:
            ctx.assign_fixed(cfg.rc, rc)
        ctx.assign_fixed(cfg.q_o, out[0])
        assert out[1] is not None
        res = self._assign_wrapped(ctx, cfg.out, out[1])
        ctx.next()
        return res

    def apply_with_input(
        self,
        ctx: RegionCtx,
        state: Tuple[Optional[List[int]], Optional[int], Optional[List[Wrap]]],
        input_: Tuple[Optional[int], Optional[Wrap]],
        out: Tuple[int, Wrap],
    ) -> AssignedValue:
        cfg = self.config
        q_1, q_m0, st = state
        if q_1 is not None:
            for i, v in enumerate(q_1):
                ctx.assign_fixed(cfg.q_1[i], v)
        if q_m0 is not None:
            ctx.assign_fixed(cfg.q_m[0], q_m0)
        if st is not None:
            for i, v in enumerate(st):
                self._assign_wrapped(ctx, cfg.state[i], v)
        if input_[0] is not None:
            ctx.assign_fixed(cfg.q_i, input_[0])
        if input_[1] is not None:
            self._assign_wrapped(ctx, cfg.input, input_[1])
        ctx.assign_fixed(cfg.q_o, out[0])
        res = self._assign_wrapped(ctx, cfg.out, out[1])
        ctx.next()
        return res

    # -- value helpers -------------------------------------------------------
    def assign_value(self, ctx: RegionCtx, v: int) -> AssignedValue:
        out = ctx.assign_advice(self.config.out, v)
        ctx.next()
        return out

    def assign_bit(self, ctx: RegionCtx, v: int) -> AssignedValue:
        """Constrain b*b - b = 0 (fixed version of gadgets/util.rs:22-38)."""
        p = ctx.modulus
        cfg = self.config
        s0 = ctx.assign_advice(cfg.state[0], v)
        s1 = ctx.assign_advice(cfg.state[1], v)
        out = ctx.assign_advice(cfg.out, v)
        ctx.constrain_equal(s0.cell, out.cell)
        ctx.constrain_equal(s1.cell, out.cell)
        ctx.assign_fixed(cfg.q_m[0], 1)
        ctx.assign_fixed(cfg.q_o, p - 1)
        ctx.next()
        return out

    def assign_bits(self, ctx: RegionCtx, bits) -> List[AssignedValue]:
        """bits: bools, 0/1 ints, or traced 0/1 values."""
        return [
            self.assign_bit(ctx, (1 if b else 0) if isinstance(b, bool) else b)
            for b in bits
        ]

    def add(self, ctx, a: AssignedValue, b: AssignedValue) -> AssignedValue:
        p = ctx.modulus
        return self.apply(
            ctx, ([1, 1], None, [a, b]), None, (p - 1, (a.value + b.value) % p)
        )

    def sub(self, ctx, a: AssignedValue, b: AssignedValue) -> AssignedValue:
        p = ctx.modulus
        return self.apply(
            ctx, ([1, p - 1], None, [a, b]), None, (p - 1, (a.value - b.value) % p)
        )

    def mul(self, ctx, a: AssignedValue, b: AssignedValue) -> AssignedValue:
        p = ctx.modulus
        return self.apply(
            ctx, (None, [1], [a, b]), None, (p - 1, (a.value * b.value) % p)
        )

    def mul_by_const(self, ctx, a: AssignedValue, c: int) -> AssignedValue:
        p = ctx.modulus
        return self.apply(
            ctx, ([c % p], None, [a]), None, (p - 1, (a.value * c) % p)
        )

    def add_with_const(self, ctx, a: AssignedValue, c: int) -> AssignedValue:
        """lhs + c = out via q_i/rc/q_o (fixed version of util.rs:210-227)."""
        p = ctx.modulus
        cfg = self.config
        ctx.assign_fixed(cfg.q_i, 1)
        ctx.assign_fixed(cfg.rc, c % p)
        ctx.assign_fixed(cfg.q_o, p - 1)
        inp = ctx.assign_advice(cfg.input, a.value)
        ctx.constrain_equal(inp.cell, a.cell)
        out = ctx.assign_advice(cfg.out, (a.value + c) % p)
        ctx.next()
        return out

    def assert_equal_const(self, ctx, a: AssignedValue, c: int):
        p = ctx.modulus
        self.apply(ctx, (None, None, None), c % p, (p - 1, a))

    def invert_with_flag(self, ctx, a: AssignedValue):
        """Returns (r, a_inv): r=1 iff a==0 (gadgets/util.rs:51-80)."""
        p = ctx.modulus
        # tape-safe: both the zero flag and the inverse are value ops, not a
        # python branch (invmod_or_one(0) = 1, matching gadgets/util.rs:51-80)
        r_val = iszero_mod(a.value, p)
        inv_val = invmod_or_one(a.value, p)
        r = self.assign_bit(ctx, r_val)
        a_inv = self.assign_value(ctx, inv_val)
        # a * a' = 1 - r   <=>  q_m*a*a' + rc(-1) + q_o(1)*r = 0
        self.apply(ctx, (None, [1], [a, a_inv]), p - 1, (1, r))
        # r * a' = r       <=>  q_m*r*a' + q_o(-1)*r = 0
        self.apply(ctx, (None, [1], [r, a_inv]), None, (p - 1, r))
        return r, a_inv

    def square(self, ctx, a: AssignedValue) -> AssignedValue:
        return self.mul(ctx, a, a)

    def divide(self, ctx, a: AssignedValue, b: AssignedValue) -> AssignedValue:
        """a / b via invert_with_flag (b=0 yields a*1, satisfiable garbage the
        caller must mask -- gadgets/util.rs:255-264)."""
        _, b_inv = self.invert_with_flag(ctx, b)
        return self.mul(ctx, a, b_inv)

    def is_zero_term(self, ctx, a: AssignedValue) -> AssignedValue:
        return self.invert_with_flag(ctx, a)[0]

    def is_equal_term(self, ctx, a, b) -> AssignedValue:
        return self.is_zero_term(ctx, self.sub(ctx, a, b))

    def is_infinity_point(self, ctx, x, y) -> AssignedValue:
        r1 = self.is_zero_term(ctx, x)
        r2 = self.is_zero_term(ctx, y)
        return self.mul(ctx, r1, r2)

    def assert_not_zero(self, ctx, a: AssignedValue):
        r = self.is_zero_term(ctx, a)
        self.assert_equal_const(ctx, r, 0)

    def assert_not_equal(self, ctx, a, b):
        self.assert_not_zero(ctx, self.sub(ctx, a, b))

    def conditional_select(self, ctx, a, b, cond) -> AssignedValue:
        """cond*a + (1-cond)*b; requires T >= 4 (gadgets/util.rs:100-123)."""
        p = ctx.modulus
        val = (cond.value * a.value + (1 - cond.value) * b.value) % p
        return self.apply(
            ctx,
            ([0, 0, 1], [1, p - 1], [a, cond, b, cond]),
            None,
            (p - 1, val),
        )

    # -- bit decomposition ---------------------------------------------------
    def le_bits_to_num(self, ctx, bits: List[AssignedValue]) -> AssignedValue:
        """Recombine LE bits, T at a time (main_gate.rs:786-816)."""
        p = ctx.modulus
        t = self.config.t
        acc = self.assign_value(ctx, 0)
        shift = 1
        for i in range(0, len(bits), t):
            chunk = bits[i : i + t]
            shifts = []
            acc_val = acc.value
            for b in chunk:
                shifts.append(shift % p)
                acc_val = (acc_val + shift * b.value) % p
                shift <<= 1
            acc = self.apply_with_input(
                ctx,
                (shifts, None, list(chunk)),
                (1, acc),
                (p - 1, acc_val),
            )
        return acc

    def le_num_to_bits(self, ctx, input_: AssignedValue, bit_len: int) -> List[AssignedValue]:
        """Decompose into LE bits and constrain the recomposition
        (main_gate.rs:818-843)."""
        v = input_.value
        # normalize_trailing_zeros semantics: pad/truncate to bit_len
        assert as_int(v).bit_length() <= bit_len, "value exceeds bit length"
        bits = [getbit(v, i) for i in range(bit_len)]
        assigned = self.assign_bits(ctx, bits)
        num = self.le_bits_to_num(ctx, assigned)
        assert as_int(num.value) == as_int(input_.value)
        ctx.constrain_equal(input_.cell, num.cell)
        return assigned

    def random_linear_combination(self, ctx, terms: List[int], r: int) -> AssignedValue:
        """sum_i r^i terms[i] via Horner rows (main_gate.rs:739-773)."""
        p = ctx.modulus
        cfg = self.config
        d = len(terms)
        out = None
        for i in range(1, d):
            lhs_val = terms[d - 1 - i] % p
            rhs_val = terms[d - i] % p if i == 1 else out.value
            ctx.assign_advice(cfg.input, lhs_val)
            rhs = ctx.assign_advice(cfg.state[1], rhs_val)
            if out is not None:
                ctx.constrain_equal(rhs.cell, out.cell)
            ctx.assign_advice(cfg.state[0], r % p)
            out = ctx.assign_advice(cfg.out, (lhs_val + r * rhs_val) % p)
            ctx.assign_fixed(cfg.q_i, 1)
            ctx.assign_fixed(cfg.q_m[0], 1)
            ctx.assign_fixed(cfg.q_o, p - 1)
            ctx.next()
        if out is None:
            out = self.assign_value(ctx, terms[0] % p if terms else 0)
        return out

    # -- cyclic assigners (main_gate.rs:428-514) -----------------------------
    def advice_cycle_assigner(self) -> "CyclicAssigner":
        return CyclicAssigner(self.config.iter_advice_columns(), advice=True)

    def fixed_cycle_assigner(self) -> "CyclicAssigner":
        return CyclicAssigner(self.config.iter_fixed_columns(), advice=False)


class CyclicAssigner:
    """Assign values to columns cyclically, advancing the row when out of
    columns (reference main_gate.rs advice/fixed cycle assigners)."""

    def __init__(self, columns: List[Column], advice: bool):
        self.columns = columns
        self.advice = advice
        self.pos = 0
        self.first = True

    def assign_next(self, ctx: RegionCtx, value: int) -> AssignedValue:
        if self.pos >= len(self.columns):
            self.pos = 0
            ctx.next()
        col = self.columns[self.pos]
        self.pos += 1
        if self.advice:
            return ctx.assign_advice(col, value)
        return ctx.assign_fixed(col, value)

    def assign_all(self, ctx: RegionCtx, values: List[int]) -> List[AssignedValue]:
        return [self.assign_next(ctx, v) for v in values]

    def finish(self, ctx: RegionCtx):
        """Advance to a fresh row if anything was assigned."""
        if self.pos > 0:
            ctx.next()
            self.pos = 0
