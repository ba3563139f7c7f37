"""StepCircuit protocol + the trivial identity circuit
(reference src/ivc/step_circuit.rs).

Copied from mira_tpu/ivc/step_circuit.py; the port imports nothing of mira_tpu.
"""

from __future__ import annotations

from typing import List

from ..table.circuit import AssignedValue, ConstraintSystem, RegionCtx, TableData


class StepCircuit:
    """User step function F: z_i -> z_{i+1}.

    Implementations provide `arity`, `configure(cs)` and
    `synthesize_step(config, ctx, z_in) -> z_out`.
    """

    arity: int = 1

    # -- witness-tape protocol (ivc/tape_runner.py) --------------------------
    # A circuit is tape-safe when its synthesize_step control flow depends
    # only on structure (never on witness values).  Per-step values the
    # circuit reads from `self` must be exposed via tape_signals() (flat int
    # list, stable order) and consumed through the wrapper wrap_for_tape
    # builds, so replays bind fresh values.
    tape_safe: bool = False

    def tape_signals(self) -> List[int]:
        """Flat per-step value inputs (beyond z_in, which is already traced)."""
        return []

    def wrap_for_tape(self, tape) -> "StepCircuit":
        """Return a view of self whose per-step values are tape inputs, in
        tape_signals() order.  Default: no per-step values — self."""
        return self

    def configure(self, cs: ConstraintSystem):
        raise NotImplementedError

    def synthesize_step(self, config, ctx: RegionCtx, z_in: List[AssignedValue]):
        raise NotImplementedError

    def process_step(self, z_i: List[int], k: int, modulus: int) -> List[int]:
        """Off-circuit z_{i+1} via a scratch synthesis
        (step_circuit.rs:83-127 default impl)."""
        cs = ConstraintSystem()
        col = cs.advice_column()
        config = self.configure(cs)
        table = TableData(k, cs, [], modulus)
        ctx = RegionCtx(table)
        assigned = []
        for v in z_i:
            assigned.append(table.assign_advice(col, ctx.offset, v))
            ctx.next()
        z_out = self.synthesize_step(config, ctx, assigned)
        return [c.value for c in z_out]


class TrivialCircuit(StepCircuit):
    """Identity step (step_circuit.rs trivial::Circuit)."""

    tape_safe = True

    def __init__(self, arity: int = 1):
        self.arity = arity

    def configure(self, cs: ConstraintSystem):
        return None

    def synthesize_step(self, config, ctx, z_in):
        return list(z_in)
