"""Circuit construction API: the framework's replacement for halo2's
ConstraintSystem / Layouter / Assignment machinery.

Deliberately simpler than halo2 (reference consumes halo2 via
src/table/): one global region, explicit row cursors, columns
of three kinds (fixed / advice / instance).  Gates are Expressions over the
query index space `selectors < fixed < advice` (we emit no halo2-style
selectors; chips use fixed columns, as the reference's MainGate also does).

A `Circuit` implements:
    configure(cs: ConstraintSystem) -> config
    synthesize(config, ctx: RegionCtx) -> None
and is synthesized once to collect fixed columns, advice columns and copy
constraints (the reference splits this into CircuitData/WitnessCollector,
table/circuit_data.rs + witness_data.rs).

Copied from mira_tpu/table/circuit.py; the port imports nothing of mira_tpu.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..polynomial.expression import Expression, Poly, Query


@dataclasses.dataclass(frozen=True)
class Column:
    kind: str  # 'fixed' | 'advice' | 'instance'
    index: int


class ConstraintSystem:
    """Collects columns, gates and lookup arguments at configure time."""

    def __init__(self):
        self.num_fixed = 0
        self.num_advice = 0
        self.num_instance = 0
        self.gates: List[Expression] = []
        self.gate_names: List[str] = []
        # each lookup: (name, [input exprs], [table exprs]); vector lookup
        # when len(inputs) > 1
        self.lookups: List[Tuple[str, List[Expression], List[Expression]]] = []
        self.equality_columns: set = set()

    def fixed_column(self) -> Column:
        c = Column("fixed", self.num_fixed)
        self.num_fixed += 1
        return c

    def advice_column(self) -> Column:
        c = Column("advice", self.num_advice)
        self.num_advice += 1
        return c

    def instance_column(self) -> Column:
        c = Column("instance", self.num_instance)
        self.num_instance += 1
        return c

    def enable_equality(self, col: Column):
        self.equality_columns.add(col)

    # Advice queries use a sentinel base because `num_fixed` may still grow
    # (a later chip's configure can add fixed columns); build_metainfo remaps
    # sentinel indices to `final_num_fixed + col` once all columns exist.
    ADVICE_SENTINEL = 1 << 24

    def query(self, col: Column, rotation: int = 0) -> Expression:
        """Query a column as an expression (index space: fixed < advice)."""
        if col.kind == "fixed":
            return Poly(Query(col.index, rotation))
        if col.kind == "advice":
            return Poly(Query(self.ADVICE_SENTINEL + col.index, rotation))
        raise ValueError("instance columns cannot be queried in gates")

    def create_gate(self, name: str, exprs: List[Expression]):
        self.gates.extend(exprs)
        self.gate_names.extend([name] * len(exprs))

    def lookup(self, name: str, inputs: List[Expression], tables: List[Expression]):
        assert len(inputs) == len(tables)
        self.lookups.append((name, inputs, tables))


class Cell:
    """A (column, row) coordinate.  Plain __slots__ class: synthesis
    creates millions of these — frozen-dataclass __init__ overhead was a
    measurable slice of the fold step."""

    __slots__ = ("column", "row")

    def __init__(self, column: Column, row: int):
        self.column = column
        self.row = row

    def __eq__(self, other):
        return (
            isinstance(other, Cell)
            and self.column == other.column
            and self.row == other.row
        )

    def __hash__(self):
        return hash((self.column, self.row))

    def __repr__(self):
        return f"Cell({self.column}, {self.row})"


class AssignedValue:
    """A value placed in a specific cell; carries the value for later reuse
    (host python int in the table's field)."""

    __slots__ = ("cell", "value")

    def __init__(self, cell: Cell, value: int):
        self.cell = cell
        self.value = value

    def __repr__(self):
        return f"Assigned({self.cell.column.kind}{self.cell.column.index}@{self.cell.row}={self.value})"


class TableData:
    """Assignment target for one synthesis pass."""

    def __init__(self, k: int, cs: ConstraintSystem, instance_values: List[int], modulus: int):
        self.k = k
        self.cs = cs
        self.modulus = modulus
        self.nrow = 1 << k
        self.instance = list(instance_values)
        self.fixed = [[0] * self.nrow for _ in range(cs.num_fixed)]
        self.advice = [[0] * self.nrow for _ in range(cs.num_advice)]
        # permutation cycles as halo2-style next-pointers over cells
        # cell key: ('instance'|'advice', column_index, row)
        self._perm_next: Dict[Tuple[str, int, int], Tuple[str, int, int]] = {}
        # optional witness-tape recorder (table/tape.py): advice writes of
        # traced values are logged so later steps can replay this synthesis
        self.tape = None

    # -- assignment ----------------------------------------------------------
    def assign_fixed(self, col: Column, row: int, value: int) -> AssignedValue:
        assert col.kind == "fixed"
        v = value % self.modulus
        if type(v) is not int:
            from .tape import TapeUnsafe

            raise TapeUnsafe(
                "fixed cell assigned a traced value (fixed columns are "
                "structure, not witness)"
            )
        self.fixed[col.index][row] = v
        return AssignedValue(Cell(col, row), v)

    def assign_advice(self, col: Column, row: int, value: int) -> AssignedValue:
        assert col.kind == "advice"
        v = value % self.modulus
        if type(v) is not int:
            from .tape import TV

            if isinstance(v, TV):
                # capture mode: store the concrete value, log the write
                self.advice[col.index][row] = v.v
                self.tape.record_write(col.index, row, v.i)
                return AssignedValue(Cell(col, row), v)
        self.advice[col.index][row] = v
        return AssignedValue(Cell(col, row), v)

    # -- copy constraints ----------------------------------------------------
    def _key(self, cell: Cell):
        return (cell.column.kind, cell.column.index, cell.row)

    def copy(self, a: Cell, b: Cell):
        """Constrain two cells equal (halo2-style cycle pointer swap).

        Fixed columns may not join copy constraints (breaks folding,
        reference plonk/util.rs:33-35)."""
        ca, cb = a.column, b.column
        if ca.kind == "fixed" or cb.kind == "fixed":
            raise AssertionError(
                "fixed columns may not join copy constraints"
            )
        perm = self._perm_next
        ka = (ca.kind, ca.index, a.row)
        kb = (cb.kind, cb.index, b.row)
        na = perm.get(ka, ka)
        nb = perm.get(kb, kb)
        perm[ka] = nb
        perm[kb] = na

    def constrain_instance(self, cell: Cell, instance_row: int):
        self.copy(cell, Cell(Column("instance", 0), instance_row))

    # -- permutation matrix (reference plonk/util.rs:128-174) ----------------
    def permutation_matrix(self) -> List[Tuple[int, int, int]]:
        num_io = len(self.instance)
        nrow = self.nrow

        def z_idx(kind: str, col: int, row: int) -> int:
            # Z = (io..., advice col 0 rows..., advice col 1 rows..., ...)
            if kind == "instance":
                return row
            if num_io > 0:
                return num_io + col * nrow + row
            return col * nrow + row

        entries = []
        touched = set()
        for ka, kb in self._perm_next.items():
            kind_a, col_a, row_a = ka
            if kind_a == "instance" and row_a >= num_io:
                continue
            entries.append(
                (z_idx(*ka), z_idx(kb[0], kb[1], kb[2]), 1)
            )
            touched.add(z_idx(*ka))
        # identity rows for untouched entries
        total = num_io + self.cs.num_advice * nrow
        for i in range(total):
            if i not in touched:
                entries.append((i, i, 1))
        return entries


class RegionCtx:
    """Row-cursor assignment helper (reference main_gate.rs:26-116)."""

    def __init__(self, table: TableData, offset: int = 0):
        self.table = table
        self.offset = offset

    def next(self):
        self.offset += 1

    def assign_advice(self, col: Column, value: int) -> AssignedValue:
        return self.table.assign_advice(col, self.offset, value)

    def assign_fixed(self, col: Column, value: int) -> AssignedValue:
        return self.table.assign_fixed(col, self.offset, value)

    def constrain_equal(self, a: Cell, b: Cell):
        self.table.copy(a, b)

    @property
    def modulus(self):
        return self.table.modulus
