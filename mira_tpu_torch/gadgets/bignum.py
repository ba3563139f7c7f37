"""Nonnative big-integer arithmetic chip (scalar-field values inside a
base-field circuit).

Mirrors src/gadgets/nonnative/bn/big_uint_mul_mod_chip
(assign_mult/assign_sum grade-school layout, limb grouping, carry-based
equality with decomposed carries, mult_mod / red_mod, bit decomposition).
Numbers are `limbs_count` limbs of `limb_width` bits (defaults 32x10,
reference examples).

The reference assigns the modulus limbs as plain advice without binding them
to fixed columns (mult_mod, mod.rs:1243-1249); we mirror that layout.

Copied from mira_tpu/gadgets/bignum.py; the port imports nothing of mira_tpu.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Union

from ..table.circuit import AssignedValue, RegionCtx
from .main_gate import MainGate, MainGateConfig, Wrap, wrap_value

DEFAULT_LIMB_WIDTH = 32
DEFAULT_LIMBS_COUNT = 10


def int_to_bn_limbs(v: int, limb_width: int, limbs_count: int) -> List[int]:
    mask = (1 << limb_width) - 1
    limbs = [(v >> (i * limb_width)) & mask for i in range(limbs_count)]
    assert v < 1 << (limb_width * limbs_count), "value too big for bignat"
    return limbs


def limbs_to_int_bn(limbs: Sequence[int], limb_width: int) -> int:
    from ..table.tape import TV

    return sum(
        (l if isinstance(l, TV) else int(l)) << (i * limb_width)
        for i, l in enumerate(limbs)
    )


@dataclasses.dataclass
class OverflowingBigUint:
    cells: List[AssignedValue]
    max_word: int  # integer bound on each limb

    def value(self, limb_width: int) -> int:
        return limbs_to_int_bn([c.value for c in self.cells], limb_width)


@dataclasses.dataclass
class ModOperationResult:
    quotient: List[AssignedValue]
    remainder: List[AssignedValue]


class BigUintMulModChip:
    def __init__(
        self,
        config: MainGateConfig,
        limb_width: int = DEFAULT_LIMB_WIDTH,
        limbs_count: int = DEFAULT_LIMBS_COUNT,
    ):
        assert config.t >= 4
        self.main_gate = MainGate(config if config.t == 4 else config.into_smaller_size(4))
        self.limb_width = limb_width
        self.limbs_count = limbs_count

    @property
    def config(self):
        return self.main_gate.config

    def to_limbs(self, v: int) -> List[int]:
        return int_to_bn_limbs(v, self.limb_width, self.limbs_count)

    def _assign_from(self, ctx, col, v: Wrap) -> AssignedValue:
        av = ctx.assign_advice(col, wrap_value(v))
        if isinstance(v, AssignedValue):
            ctx.constrain_equal(av.cell, v.cell)
        return av

    # -- primitive layouts ---------------------------------------------------
    def assign_sum(self, ctx: RegionCtx, lhs: OverflowingBigUint, rhs: List[Wrap]):
        """Limbwise lhs + rhs without carry handling (mod.rs:98-181)."""
        cfg = self.config
        p = ctx.modulus
        n = max(len(lhs.cells), len(rhs))
        sum_cells, rhs_cells = [], []
        for i in range(n):
            ctx.assign_fixed(cfg.q_1[0], 1)
            ctx.assign_fixed(cfg.q_1[1], 1)
            ctx.assign_fixed(cfg.q_o, p - 1)
            lv = lhs.cells[i] if i < len(lhs.cells) else 0
            rv = rhs[i] if i < len(rhs) else 0
            lcell = self._assign_from(ctx, cfg.state[0], lv)
            rcell = self._assign_from(ctx, cfg.state[1], rv)
            s = ctx.assign_advice(cfg.out, (lcell.value + rcell.value) % p)
            sum_cells.append(s)
            rhs_cells.append(rcell)
            ctx.next()
        rhs_max_word = (1 << self.limb_width) - 1
        return rhs_cells[: self.limbs_count], OverflowingBigUint(
            sum_cells, lhs.max_word + rhs_max_word
        )

    def assign_mult(self, ctx: RegionCtx, lhs: List[Wrap], rhs: List[Wrap],
                    lhs_max_word: int, rhs_max_word: int):
        """Grade-school product columns without carries (mod.rs:214-345)."""
        cfg = self.config
        p = ctx.modulus
        n, m = len(lhs), len(rhs)
        prod_cells: List = [None] * (n + m - 1)
        lhs_cells: List = [None] * n
        rhs_cells: List = [None] * m
        for i in range(n):
            for j in range(m):
                lcell = self._assign_from(ctx, cfg.state[0], lhs[i])
                rcell = self._assign_from(ctx, cfg.state[1], rhs[j])
                if lhs_cells[i] is not None:
                    ctx.constrain_equal(lhs_cells[i].cell, lcell.cell)
                else:
                    lhs_cells[i] = lcell
                if rhs_cells[j] is not None:
                    ctx.constrain_equal(rhs_cells[j].cell, rcell.cell)
                else:
                    rhs_cells[j] = rcell
                k = i + j
                part = lcell.value * rcell.value % p
                ctx.assign_fixed(cfg.q_i, 1)
                if prod_cells[k] is not None:
                    prev = prod_cells[k]
                    self._assign_from(ctx, cfg.input, prev)
                    part = (part + prev.value) % p
                ctx.assign_fixed(cfg.q_m[0], 1)
                ctx.assign_fixed(cfg.q_o, p - 1)
                prod_cells[k] = ctx.assign_advice(cfg.out, part)
                ctx.next()
        max_word = min(n, m) * lhs_max_word * rhs_max_word
        return (
            lhs_cells,
            rhs_cells,
            OverflowingBigUint(prod_cells, max_word),
        )

    def group_limbs(self, ctx: RegionCtx, bn: OverflowingBigUint, limbs_per_group: int):
        """Merge limbs into wider groups (mod.rs:371-485)."""
        cfg = self.config
        p = ctx.modulus
        limb_block = 1 << self.limb_width
        grouped = []
        for g0 in range(0, len(bn.cells), limbs_per_group):
            group = bn.cells[g0 : g0 + limbs_per_group]
            prev = None
            shift = 1
            for cell in group:
                lc = self._assign_from(ctx, cfg.state[0], cell)
                ctx.assign_fixed(cfg.q_1[0], shift % p)
                new_val = lc.value * shift % p
                ctx.assign_fixed(cfg.q_1[1], 1)
                if prev is not None:
                    pc = self._assign_from(ctx, cfg.state[1], prev)
                    new_val = (new_val + pc.value) % p
                out = ctx.assign_advice(cfg.out, new_val)
                ctx.assign_fixed(cfg.q_o, p - 1)
                ctx.next()
                prev = out
                shift *= limb_block
            grouped.append(prev)
        grouped_max_word = sum(
            1 << (i * self.limb_width) for i in range(limbs_per_group)
        )
        return (
            grouped,
            grouped_max_word * bn.max_word,
            self.limb_width * limbs_per_group,
        )

    def is_equal(self, ctx: RegionCtx, lhs: OverflowingBigUint, rhs: OverflowingBigUint):
        """Carry-chain equality of two overflowing bignats (mod.rs:541-766)."""
        cfg = self.config
        p = ctx.modulus
        max_word_bn = max(lhs.max_word, rhs.max_word)
        carry_bits = calc_carry_bits(max_word_bn, self.limb_width)
        limbs_per_group = calc_limbs_per_group(carry_bits, self.limb_width, p)

        g_lhs, lhs_max, group_width = self.group_limbs(ctx, lhs, limbs_per_group)
        g_rhs, rhs_max, _ = self.group_limbs(ctx, rhs, limbs_per_group)

        max_word_bn = max(lhs_max, rhs_max)
        max_word = max_word_bn % p
        target_base = 1 << group_width
        carry_bits_len = calc_carry_bits(max_word_bn, self.limb_width)

        accumulated_extra = 0
        prev_carry = None
        ncells = max(len(g_lhs), len(g_rhs))
        # integer carries computed on the true integer values
        lhs_vals = [c.value for c in g_lhs]
        rhs_vals = [c.value for c in g_rhs]
        carry_int = 0
        for idx in range(ncells):
            ctx.assign_fixed(cfg.q_1[0], 1)
            ctx.assign_fixed(cfg.q_1[1], p - 1)
            accumulated_extra += max_word_bn
            m_i = accumulated_extra % target_base
            ctx.assign_advice(cfg.state[2], m_i % p)
            accumulated_extra //= target_base
            ctx.assign_fixed(cfg.q_1[2], p - 1)
            ctx.assign_advice(cfg.state[3], max_word)
            ctx.assign_fixed(cfg.q_1[3], 1)
            ctx.assign_fixed(cfg.q_i, 1)
            if prev_carry is not None:
                self._assign_from(ctx, cfg.input, prev_carry)
            lv = lhs_vals[idx] if idx < len(lhs_vals) else 0
            rv = rhs_vals[idx] if idx < len(rhs_vals) else 0
            if idx < len(g_lhs):
                self._assign_from(ctx, cfg.state[0], g_lhs[idx])
            if idx < len(g_rhs):
                self._assign_from(ctx, cfg.state[1], g_rhs[idx])
            ctx.assign_fixed(cfg.q_o, (p - target_base) % p)
            # integer carry: (prev + lhs - rhs + max_word) / base
            dividend = carry_int + lv - rv + max_word_bn
            assert dividend % target_base == m_i, "is_equal: limbs not equal"
            carry_int = dividend // target_base
            carry_cell = ctx.assign_advice(cfg.out, carry_int % p)
            if idx != ncells - 1:
                ctx.next()
                self.decompose_in_bits(ctx, carry_cell, carry_bits_len)
                prev_carry = carry_cell
            else:
                prev_carry = carry_cell
            ctx.next()
        # final row: carry == accumulated_extra
        ctx.assign_fixed(cfg.q_o, 1)
        self._assign_from(ctx, cfg.out, prev_carry)
        ctx.assign_advice(cfg.state[2], accumulated_extra % p)
        ctx.assign_fixed(cfg.q_1[2], p - 1)
        assert carry_int == accumulated_extra, "is_equal: final carry mismatch"
        ctx.next()

    def assign_and_check_bits(self, ctx: RegionCtx, value: int, nbits: int):
        cfg = self.config
        p = ctx.modulus
        cells = []
        for i in range(nbits):
            bit = (value >> i) & 1
            bc = ctx.assign_advice(cfg.input, bit)
            ctx.assign_fixed(cfg.q_i, 1)
            for col in cfg.state[:2]:
                c = ctx.assign_advice(col, bit)
                ctx.constrain_equal(c.cell, bc.cell)
            ctx.assign_fixed(cfg.q_m[0], p - 1)
            ctx.next()
            cells.append(bc)
        return cells

    def decompose_in_bits(self, ctx: RegionCtx, cell: AssignedValue, nbits: int):
        """Prove `cell` fits in nbits (mod.rs:859-944)."""
        cfg = self.config
        p = ctx.modulus
        bits = self.assign_and_check_bits(ctx, cell.value, nbits)
        t = len(cfg.state)
        prev = None
        coeff = 1
        final = None
        for c0 in range(0, len(bits), t):
            chunk = bits[c0 : c0 + t]
            chunk_sum = 0
            for bi, bcell in enumerate(chunk):
                b = self._assign_from(ctx, cfg.state[bi], bcell)
                ctx.assign_fixed(cfg.q_1[bi], coeff % p)
                chunk_sum = (chunk_sum + b.value * coeff) % p
                coeff <<= 1
            ctx.assign_fixed(cfg.q_i, 1)
            if prev is not None:
                pc = self._assign_from(ctx, cfg.input, prev)
                chunk_sum = (chunk_sum + pc.value) % p
            ctx.assign_fixed(cfg.q_o, p - 1)
            final = ctx.assign_advice(cfg.out, chunk_sum)
            ctx.next()
            prev = final
        ctx.constrain_equal(final.cell, cell.cell)
        return bits

    def from_assigned_cell_to_limbs(self, ctx: RegionCtx, input_cell: AssignedValue):
        """Decompose a native cell into bignat limbs (mod.rs:1039-1155)."""
        cfg = self.config
        p = ctx.modulus
        shift = 1 << self.limb_width
        limbs_vals = self.to_limbs(input_cell.value)
        prev = None
        cells_rev = []
        for limb in reversed(limbs_vals):  # MSB-first rows
            ctx.assign_fixed(cfg.q_1[0], 1)
            limb_cell = ctx.assign_advice(cfg.state[0], limb)
            ctx.assign_fixed(cfg.q_i, shift % p)
            acc = limb
            if prev is not None:
                pc = self._assign_from(ctx, cfg.input, prev)
                acc = (shift * pc.value + limb) % p
            ctx.assign_fixed(cfg.q_o, p - 1)
            prev = ctx.assign_advice(cfg.out, acc)
            ctx.next()
            cells_rev.append(limb_cell)
        assert prev.value == input_cell.value
        ctx.constrain_equal(prev.cell, input_cell.cell)
        return list(reversed(cells_rev))

    # -- top-level ops -------------------------------------------------------
    def mult_mod(self, ctx: RegionCtx, lhs: List[AssignedValue],
                 rhs: List[AssignedValue], modulus: int) -> ModOperationResult:
        """lhs * rhs = q * m + r with all identities enforced
        (mod.rs:1184-1266)."""
        lw = self.limb_width
        lhs_i = limbs_to_int_bn([c.value for c in lhs], lw)
        rhs_i = limbs_to_int_bn([c.value for c in rhs], lw)
        prod = lhs_i * rhs_i
        q_limbs = self.to_limbs(prod // modulus)
        r_limbs = self.to_limbs(prod % modulus)
        mod_limbs = self.to_limbs(modulus)
        mw = (1 << lw) - 1

        _, _, left = self.assign_mult(ctx, list(lhs), list(rhs), mw, mw)
        assigned_q, _, q_mul_m = self.assign_mult(ctx, q_limbs, mod_limbs, mw, mw)
        assigned_r, right = self.assign_sum(ctx, q_mul_m, r_limbs)
        self.is_equal(ctx, left, right)
        return ModOperationResult(assigned_q, assigned_r)

    def red_mod(self, ctx: RegionCtx, val: OverflowingBigUint, modulus: int) -> ModOperationResult:
        """val = q * m + r (mod.rs:1299-1369)."""
        lw = self.limb_width
        val_i = val.value(lw)
        q_limbs = self.to_limbs(val_i // modulus)
        r_limbs = self.to_limbs(val_i % modulus)
        mod_limbs = self.to_limbs(modulus)

        assigned_q, _, q_mul_m = self.assign_mult(
            ctx, q_limbs, mod_limbs, val.max_word, val.max_word
        )
        assigned_r, right = self.assign_sum(ctx, q_mul_m, r_limbs)
        self.is_equal(ctx, val, right)
        return ModOperationResult(assigned_q, assigned_r)

    def to_le_bits(self, ctx: RegionCtx, limbs: List[AssignedValue]):
        bits = []
        for limb in limbs:
            bits.extend(self.main_gate.le_num_to_bits(ctx, limb, self.limb_width))
        return bits


def calc_carry_bits(max_word: int, limb_width: int) -> int:
    """mod.rs:1407-1430 (float semantics preserved)."""
    carry_bits = int(math.ceil(math.log2(max_word * 2) - limb_width) + 0.1)
    assert carry_bits > 0
    return carry_bits


def calc_limbs_per_group(carry_bits: int, limb_width: int, modulus: int) -> int:
    capacity = modulus.bit_length() - 1
    out = (capacity - carry_bits) // limb_width
    assert out > 0
    return out
