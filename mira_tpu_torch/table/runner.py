"""CircuitRunner: synthesize a circuit into a PlonkStructure + witness
(port of mira_tpu/table/runner.py onto the port's PlonkStructure).

Equivalent of the reference's table layer (src/table/):
`collect_structure` plays CircuitRunner::try_collect_plonk_structure
(circuit_runner.rs:55-96) + ConstraintSystemMetainfo::build
(constraint_system_metainfo.rs:22-119); `collect_witness` plays
try_collect_witness (advice columns only).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..curves.host import CurveParams
from ..polynomial.expression import (
    CompressedGates,
    Const,
    Challenge,
    Expression,
    Neg,
    Poly,
    Product,
    Query,
    QueryIndexContext,
    Scaled,
    Sum,
    compress_expressions,
)
from ..table.circuit import ConstraintSystem, RegionCtx, TableData

from ..plonk.structure import LookupArguments, PlonkStructure


def _remap_advice(expr: Expression, num_fixed: int) -> Expression:
    """Resolve ADVICE_SENTINEL-based query indices to the final flat index
    space (fixed columns may be added after a query is made)."""
    sent = ConstraintSystem.ADVICE_SENTINEL
    return expr.evaluate(
        constant=lambda c: Const(c),
        poly=lambda q: Poly(
            Query(num_fixed + (q.index - sent), q.rotation)
            if q.index >= sent
            else q
        ),
        challenge=lambda i: Challenge(i),
        negated=lambda a: Neg(a),
        sum_=lambda a, b: Sum(a, b),
        product=lambda a, b: Product(a, b),
        scaled=lambda a, k: Scaled(a, k),
    )


def build_metainfo(
    cs: ConstraintSystem,
    k: int,
    num_g1_elems: int = 0,
    num_g2_elems: int = 0,
    target_group_folding_degree: int = 0,
    target_group_cross_terms: int = 0,
):
    """Mirrors ConstraintSystemMetainfo::build."""
    # resolve advice sentinel indices now that all columns exist
    gates_resolved = [_remap_advice(g, cs.num_fixed) for g in cs.gates]
    lookups_resolved = [
        (
            name,
            [_remap_advice(e, cs.num_fixed) for e in inputs],
            [_remap_advice(e, cs.num_fixed) for e in tables],
        )
        for name, inputs, tables in cs.lookups
    ]

    # lookup compression (reference plonk/lookup.rs:84-130)
    lookup_arguments: Optional[LookupArguments] = None
    if lookups_resolved:
        has_vector_lookup = any(len(inputs) > 1 for _, inputs, _ in lookups_resolved)
        lookup_polys = [
            compress_expressions(inputs, 0) if len(inputs) > 1 else inputs[0]
            for _, inputs, _ in lookups_resolved
        ]
        table_polys = [
            compress_expressions(tables, 0) if len(tables) > 1 else tables[0]
            for _, _, tables in lookups_resolved
        ]
        lookup_arguments = LookupArguments(lookup_polys, table_polys, has_vector_lookup)

    num_lookups = lookup_arguments.num_lookups() if lookup_arguments else 0
    has_vector_lookup = bool(lookup_arguments and lookup_arguments.has_vector_lookup)

    ctx = QueryIndexContext(
        num_selectors=0,
        num_fixed=cs.num_fixed,
        num_advice=cs.num_advice,
        num_lookups=num_lookups,
        num_challenges=2 if has_vector_lookup else (1 if num_lookups > 0 else 0),
    )

    gates = list(gates_resolved)
    if lookup_arguments:
        gates.extend(lookup_arguments.vanishing_lookup_polys(ctx))
        gates.extend(lookup_arguments.log_derivative_lhs_and_rhs(ctx))

    nrow = 1 << k
    if has_vector_lookup:
        round_sizes = [
            cs.num_advice * nrow,
            3 * num_lookups * nrow,
            2 * num_lookups * nrow,
        ]
    elif num_lookups > 0:
        round_sizes = [
            (cs.num_advice + 3 * num_lookups) * nrow,
            2 * num_lookups * nrow,
        ]
    else:
        round_sizes = [cs.num_advice * nrow]

    compressed = CompressedGates.new(gates, ctx)
    return (
        compressed.compressed.num_challenges(),
        round_sizes,
        gates,
        compressed,
        lookup_arguments,
    )


class CircuitRunner:
    """Synthesizes `circuit` once and exposes structure + witness."""

    def __init__(
        self,
        k: int,
        circuit,
        instance: List[int],
        curve: CurveParams,
        num_g1_elems: int = 0,
        num_g2_elems: int = 0,
        target_group_folding_degree: int = 0,
        target_group_cross_terms: int = 0,
    ):
        self.k = k
        self.circuit = circuit
        self.instance = list(instance)
        self.curve = curve
        self.num_g1_elems = num_g1_elems
        self.num_g2_elems = num_g2_elems
        self.target_group_folding_degree = target_group_folding_degree
        self.target_group_cross_terms = target_group_cross_terms
        self._synthesized: Optional[TableData] = None
        self._cs: Optional[ConstraintSystem] = None

    def _synthesize(self) -> Tuple[ConstraintSystem, TableData]:
        if self._synthesized is None:
            cs = ConstraintSystem()
            config = self.circuit.configure(cs)
            table = TableData(self.k, cs, self.instance, self.curve.scalar_modulus)
            ctx = RegionCtx(table)
            self.circuit.synthesize(config, ctx)
            self._cs, self._synthesized = cs, table
        return self._cs, self._synthesized

    def use_synthesis(self, cs: ConstraintSystem, table: TableData):
        """Take (cs, table) of a synthesis made elsewhere (a capture of the
        same circuit, ivc/tape_runner.py) as this runner's own."""
        self._cs, self._synthesized = cs, table

    def collect_structure(self) -> PlonkStructure:
        cs, table = self._synthesize()
        (num_challenges, round_sizes, gates, compressed, lookup_arguments) = (
            build_metainfo(
                cs,
                self.k,
                self.num_g1_elems,
                self.num_g2_elems,
                self.target_group_folding_degree,
                self.target_group_cross_terms,
            )
        )
        return PlonkStructure(
            curve=self.curve,
            k=self.k,
            num_io=len(self.instance),
            selectors=[],
            fixed_columns=table.fixed,
            num_advice_columns=cs.num_advice,
            num_challenges=num_challenges,
            round_sizes=round_sizes,
            compressed_gates=compressed,
            gates=gates,
            permutation_matrix=table.permutation_matrix(),
            lookup_arguments=lookup_arguments,
            num_g1_elems=self.num_g1_elems,
            num_g2_elems=self.num_g2_elems,
            target_group_folding_degree=self.target_group_folding_degree,
            target_group_cross_terms=self.target_group_cross_terms,
        )

    def collect_witness(self) -> List[List[int]]:
        _, table = self._synthesize()
        return table.advice
