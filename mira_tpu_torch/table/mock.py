"""MockProver equivalent: direct row-satisfaction checking of a synthesized
table (the reference leans on halo2's MockProver inside debug-mode folds,
incrementally_verifiable_computation.rs:244-252; this is our native analog,
per SURVEY.md §4's test-strategy translation).  Port of
mira_tpu/table/mock.py; host Python ints only."""

from __future__ import annotations

from typing import List

from mira_tpu.table.circuit import ConstraintSystem, TableData

from ..polynomial.evaluator import EvalDomain, eval_rows_host


def _resolved_gates_and_lookups(cs: ConstraintSystem):
    from .runner import _remap_advice

    gates = [_remap_advice(g, cs.num_fixed) for g in cs.gates]
    lookups = [
        (
            name,
            [_remap_advice(e, cs.num_fixed) for e in inputs],
            [_remap_advice(e, cs.num_fixed) for e in tables],
        )
        for name, inputs, tables in cs.lookups
    ]
    return gates, lookups


class MockError(Exception):
    pass


def mock_check(cs: ConstraintSystem, table: TableData):
    """Check every user gate on every row, all copy constraints, and lookup
    multiset inclusion. Raises MockError with details on failure."""
    nrow = table.nrow
    p = table.modulus
    concat_advice = [v for col in table.advice for v in col]

    dom = EvalDomain(
        modulus=p,
        num_advice=cs.num_advice,
        num_lookup=0,
        challenges=[],
        selectors=[],
        fixed=table.fixed,
        W1s=[concat_advice],
        W2s=[],
    )

    gates, lookups = _resolved_gates_and_lookups(cs)
    for gate_idx, expr in enumerate(gates):
        rows = eval_rows_host(expr, dom)
        bad = [r for r, v in enumerate(rows) if v % p != 0]
        if bad:
            name = cs.gate_names[gate_idx]
            raise MockError(
                f"gate '{name}' (#{gate_idx}) unsatisfied on rows {bad[:5]}"
                + (f" (+{len(bad)-5} more)" if len(bad) > 5 else "")
            )

    # copy constraints: every cell equals its cycle successor
    def cell_value(key):
        kind, col, row = key
        if kind == "instance":
            return table.instance[row] % p
        return table.advice[col][row] % p

    for a, b in table._perm_next.items():
        if cell_value(a) != cell_value(b):
            raise MockError(f"copy constraint violated: {a}={cell_value(a)} vs {b}={cell_value(b)}")

    # lookups: multiset inclusion of input rows in table rows
    for name, inputs, tables in lookups:
        in_cols = [eval_rows_host(e, dom) for e in inputs]
        tb_cols = [eval_rows_host(e, dom) for e in tables]
        in_rows = list(zip(*in_cols))
        tb_rows = set(zip(*tb_cols))
        missing = [t for t in in_rows if t not in tb_rows]
        if missing:
            raise MockError(f"lookup '{name}': {len(missing)} rows not in table")
