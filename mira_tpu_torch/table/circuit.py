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

import numpy as np

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
    def permutation_matrix(self) -> "PermutationMatrix":
        """The copy cycles' entries (z_a, z_b, 1) over Z = (io..., advice
        col 0 rows..., advice col 1 rows..., ...), in the order of
        `_perm_next`; every other index of Z maps to itself (implied)."""
        num_io = len(self.instance)
        nrow = self.nrow

        def z_idx(kind: str, col: int, row: int) -> int:
            return row if kind == "instance" else num_io + col * nrow + row

        pairs = [(z_idx(*ka), z_idx(*kb)) for ka, kb in self._perm_next.items()
                 if ka[0] != "instance" or ka[2] < num_io]
        ij = np.array(pairs, dtype=np.int64).reshape(-1, 2)
        return PermutationMatrix(ij[:, 0], ij[:, 1], np.ones(len(ij), np.int64),
                                 num_io + self.cs.num_advice * nrow)


class PermutationMatrix:
    """A sparse permutation matrix over Z of `size` entries: the explicit
    entries (i, j, v) as int64 arrays, 0 <= i < size, in the order they
    were made; every index that no explicit entry starts at maps to itself
    with weight 1.  Iterating gives the entries as mira_tpu's list of tuples
    holds them (explicit ones, then the implied ones in ascending order),
    so it compares equal to that list; `json_chunks` gives the text of
    `json.dumps(sorted(entries))` without building either."""

    def __init__(self, i, j, v, size: int):
        self.i = np.asarray(i, dtype=np.int64)
        self.j = np.asarray(j, dtype=np.int64)
        self.v = np.asarray(v, dtype=np.int64)
        self.size = int(size)
        self.touched = np.zeros(self.size, dtype=bool)
        self.touched[self.i] = True

    def __len__(self):
        return len(self.i) + int(self.size - self.touched.sum())

    def __iter__(self):
        yield from zip(self.i.tolist(), self.j.tolist(), self.v.tolist())
        for k in np.flatnonzero(~self.touched).tolist():
            yield (k, k, 1)

    def __eq__(self, other):
        return list(self) == list(other)

    def sorted_chunks(self, chunk: int = 1 << 22):
        """(i, j, v) arrays of every entry, explicit and implied, in the
        order of `sorted()` on the tuples, a range of i at a time."""
        order = np.lexsort((self.v, self.j, self.i))
        ti, tj, tv = self.i[order], self.j[order], self.v[order]
        for a in range(0, self.size, chunk):
            b = min(a + chunk, self.size)
            ids = np.arange(a, b, dtype=np.int64)
            ids = ids[~self.touched[ids]]
            s, e = np.searchsorted(ti, (a, b))
            i = np.concatenate((ids, ti[s:e]))
            j = np.concatenate((ids, tj[s:e]))
            v = np.concatenate((np.ones(len(ids), np.int64), tv[s:e]))
            o = np.lexsort((v, j, i))
            yield i[o], j[o], v[o]

    def json_chunks(self, device="cpu", chunk: int = 1 << 22):
        """The bytes of `json.dumps(sorted(entries))`, in pieces; the text
        is formatted by tensor ops on `device`."""
        yield b"["
        first = True
        for i, j, v in self.sorted_chunks(chunk):
            if not len(i):
                continue
            if not first:
                yield b", "
            first = False
            yield _json_triples(i, j, v, device)
        yield b"]"


_DIGITS4 = np.array([[ord(c) for c in f"{k:04d}"] for k in range(10 ** 4)],
                    dtype=np.uint8)
_POW10 = 10 ** np.arange(19, dtype=np.int64)


def _json_triples(i, j, v, device="cpu") -> bytes:
    """b"[i0, j0, v0], [i1, j1, v1], ..." for non-negative int64 arrays (a
    permutation's indices and weights), as json.dumps
    writes them: each entry's characters at fixed widths (numbers
    zero-padded, four digits a table lookup), then the padding dropped by
    one mask."""
    import torch

    n = len(i)
    dev = torch.device(device)
    table = torch.from_numpy(_DIGITS4).to(dev)
    pow10 = torch.from_numpy(_POW10).to(dev)
    parts, keep = [], []

    def text(s: str):
        c = torch.tensor(list(s.encode()), dtype=torch.uint8, device=dev)
        parts.append(c.expand(n, len(s)))
        keep.append(torch.ones(n, len(s), dtype=torch.bool, device=dev))

    def number(a):
        x = torch.from_numpy(a).to(dev)
        nd = torch.searchsorted(pow10, x, right=True).clamp_(min=1)
        groups = (int(nd.max()) + 3) // 4
        digits = []
        for _ in range(groups):
            q = torch.div(x, 10 ** 4, rounding_mode="floor")
            digits.append(table[x - q * 10 ** 4])
            x = q
        parts.append(torch.cat(digits[::-1], dim=1))
        width = 4 * groups
        keep.append(torch.arange(width, device=dev)[None, :] >= (width - nd)[:, None])

    text("[")
    number(i)
    text(", ")
    number(j)
    text(", ")
    number(v)
    text("], ")
    out = torch.cat(parts, dim=1)[torch.cat(keep, dim=1)]
    return out.cpu().numpy().tobytes()[:-2]


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
