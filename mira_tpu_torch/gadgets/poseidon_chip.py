"""In-circuit Poseidon sponge on the MainGate (the on-circuit half of the
random oracle pair).

Row layout mirrors the reference PoseidonChip
(src/poseidon/poseidon_circuit.rs): each output state element
of each round is one MainGate row — the q_5 columns carry the MDS-row-scaled
sbox coefficients so sbox+MDS+constants collapse into the single gate
equation.  The off-circuit/on-circuit outputs must agree bit-exactly
(consistency is tested in tests/test_gadgets.py, the analog of the
reference's off/on-circuit tests).

Copied from mira_tpu/gadgets/poseidon_chip.py; the port imports nothing of mira_tpu.
"""

from __future__ import annotations

from typing import List, Optional, Union

from ..constants import MAX_BITS
from ..ops.poseidon import Spec
from ..table.circuit import AssignedValue, RegionCtx
from .main_gate import MainGate, MainGateConfig, Wrap, wrap_value


class PoseidonChip:
    def __init__(self, config: MainGateConfig, spec: Spec):
        self.main_gate = MainGate(config)
        self.spec = spec
        self.buf: List[Wrap] = []
        assert config.t == spec.t

    # -- absorb API (ROCircuitTrait) ----------------------------------------
    def update(self, inputs: List[Wrap]) -> "PoseidonChip":
        self.buf.extend(inputs)
        return self

    def absorb_base(self, v: Wrap) -> "PoseidonChip":
        return self.update([v])

    def absorb_point(self, xy) -> "PoseidonChip":
        return self.update(list(xy))

    def absorb_g2_point(self, coords) -> "PoseidonChip":
        return self.update(list(coords))

    def absorb_fp12_tuple(self, elements) -> "PoseidonChip":
        return self.update(list(elements))

    def absorb_iter(self, it) -> "PoseidonChip":
        for v in it:
            self.absorb_base(v)
        return self

    # -- permutation rows ----------------------------------------------------
    def _pre_round(self, ctx, inputs: List[Wrap], state_idx: int, state):
        """out = s + input_vec[idx] + start[0][idx]
        (reference poseidon_circuit.rs:116-170)."""
        mg, cfg = self.main_gate, self.main_gate.config
        p = ctx.modulus
        t = cfg.t
        s_val = state[state_idx].value
        input_vec = [0] + [wrap_value(v) for v in inputs] + [1] + [0] * t
        input_val = input_vec[state_idx] % p
        rc_val = self.spec.constants_start[0][state_idx].v
        out_val = (s_val + input_val + rc_val) % p

        si = ctx.assign_advice(cfg.state[state_idx], s_val)
        ctx.constrain_equal(state[state_idx].cell, si.cell)
        ctx.assign_advice(cfg.input, input_val)
        ctx.assign_fixed(cfg.q_1[state_idx], 1)
        ctx.assign_fixed(cfg.q_i, 1)
        ctx.assign_fixed(cfg.q_o, p - 1)
        ctx.assign_fixed(cfg.rc, rc_val)
        out = ctx.assign_advice(cfg.out, out_val)
        ctx.next()
        return out

    def _next_state_val(self, state_vals, q_1, q_5, rc, p):
        out = rc
        for s, q1, q5 in zip(state_vals, q_1, q_5):
            out = (out + q5 * pow(s, 5, p) + q1 * s) % p
        return out  # q_o = -1 so out_cell = expression value

    def _full_round(self, ctx, first_half: bool, round_idx: int, state_idx: int, state):
        mg, cfg = self.main_gate, self.main_gate.config
        p = ctx.modulus
        t = cfg.t
        spec = self.spec
        half = spec.r_f // 2
        consts = spec.constants_start if first_half else spec.constants_end
        if first_half:
            rcs = consts[round_idx + 1]
        elif round_idx < half - 1:
            rcs = consts[round_idx]
        else:
            rcs = None  # zeros
        mds = (
            spec.pre_sparse_mds
            if (first_half and round_idx == half - 1)
            else spec.mds
        )
        mds_row = mds[state_idx]

        q_5 = [0] * t
        rc_val = 0
        for j in range(t):
            mij = mds_row[j].v
            cj = rcs[j].v if rcs is not None else 0
            rc_val = (rc_val + mij * cj) % p
            q_5[j] = mij
            ctx.assign_fixed(cfg.q_5[j], mij)

        state_vals = []
        for i, s in enumerate(state):
            state_vals.append(s.value)
            si = ctx.assign_advice(cfg.state[i], s.value)
            ctx.constrain_equal(s.cell, si.cell)

        ctx.assign_fixed(cfg.rc, rc_val)
        ctx.assign_fixed(cfg.q_o, p - 1)
        out_val = self._next_state_val(state_vals, [0] * t, q_5, rc_val, p)
        out = ctx.assign_advice(cfg.out, out_val)
        ctx.next()
        return out

    def _partial_round(self, ctx, round_idx: int, state_idx: int, state):
        mg, cfg = self.main_gate, self.main_gate.config
        p = ctx.modulus
        t = cfg.t
        spec = self.spec
        rc = spec.constants_partial[round_idx].v
        sparse = spec.sparse_matrices[round_idx]
        row = [x.v for x in sparse.row]
        col_hat = [x.v for x in sparse.col_hat]

        state_vals = []
        for i, s in enumerate(state):
            state_vals.append(s.value)
            si = ctx.assign_advice(cfg.state[i], s.value)
            ctx.constrain_equal(s.cell, si.cell)

        q_1 = [0] * t
        q_5 = [0] * t
        if state_idx == 0:
            q_5[0] = row[0]
            ctx.assign_fixed(cfg.q_5[0], row[0])
            rc_val = (row[0] * rc) % p
            for j in range(1, t):
                q_1[j] = row[j]
                ctx.assign_fixed(cfg.q_1[j], row[j])
        else:
            q_5[0] = col_hat[state_idx - 1]
            q_1[state_idx] = 1
            ctx.assign_fixed(cfg.q_5[0], col_hat[state_idx - 1])
            ctx.assign_fixed(cfg.q_1[state_idx], 1)
            rc_val = (col_hat[state_idx - 1] * rc) % p
        ctx.assign_fixed(cfg.rc, rc_val)
        ctx.assign_fixed(cfg.q_o, p - 1)
        out_val = self._next_state_val(state_vals, q_1, q_5, rc_val, p)
        out = ctx.assign_advice(cfg.out, out_val)
        ctx.next()
        return out

    def permutation(self, ctx, inputs: List[Wrap], init_state):
        t = self.main_gate.config.t
        state = [self._pre_round(ctx, inputs, i, init_state) for i in range(t)]
        half = self.spec.r_f // 2
        r_p = len(self.spec.constants_partial)
        for round_idx in range(half):
            state = [
                self._full_round(ctx, True, round_idx, i, state) for i in range(t)
            ]
        for round_idx in range(r_p):
            state = [self._partial_round(ctx, round_idx, i, state) for i in range(t)]
        for round_idx in range(half):
            state = [
                self._full_round(ctx, False, round_idx, i, state) for i in range(t)
            ]
        return state

    # -- sponge --------------------------------------------------------------
    def squeeze(self, ctx: RegionCtx) -> AssignedValue:
        buf = list(self.buf)
        rate = self.spec.rate
        exact = len(buf) % rate == 0
        cfg = self.main_gate.config
        # initial state with the 2^64 capacity IV
        iv = [(1 << 64), *([0] * (cfg.t - 1))]
        state = [
            ctx.assign_advice(col, v % ctx.modulus)
            for col, v in zip(cfg.state, iv)
        ]
        # NOTE: initial-state row carries no gate; values are unconstrained
        # constants, mirroring the reference (poseidon_circuit.rs:419-431).
        for i in range(0, len(buf), rate):
            state = self.permutation(ctx, buf[i : i + rate], state)
        if exact:
            state = self.permutation(ctx, [], state)
        return state[1]

    def squeeze_n_bits(self, ctx: RegionCtx, num_bits: int) -> List[AssignedValue]:
        val = self.squeeze(ctx)
        bits = self.main_gate.le_num_to_bits(ctx, val, MAX_BITS)
        return bits[:num_bits]
