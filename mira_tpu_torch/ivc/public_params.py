"""Public parameters for the two-curve IVC
(reference src/ivc/public_params.rs).

Builds both StepFoldingCircuit structures via dry-run synthesis with
self-referentially-sized default inputs, computes the pp digest points, and
caches the secondary's initial (zero-step) plonk trace.

Port of mira_tpu/ivc/public_params.py: the same logic, bound to the port's
structure, folding scheme and commitment key."""

from __future__ import annotations

import dataclasses
import hashlib
import json
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from ..constants import NUM_HASH_BITS
from ..curves.host import AffinePoint, CurveParams
from ..fields.host import field
from ..ops.commitment import CommitmentKey
from ..ops.poseidon import PoseidonHash, Spec, get_spec
from ..nifs.vanilla import VanillaFS
from ..plonk.structure import PlonkStructure, PlonkTrace
from ..table.circuit import ConstraintSystem
from ..table.runner import CircuitRunner, build_metainfo
from .instance_computation import compute_instance_hash
from ..ivc.step_circuit import StepCircuit
from .tape_runner import capture_runner, uses_tape
from .step_folding_circuit import (
    NUM_IO,
    StepFoldingCircuit,
    StepInputs,
    StepParams,
)

DEFAULT_LIMB_WIDTH = 32
DEFAULT_LIMBS_COUNT = 10
# IVC random-oracle spec (reference examples/trivial/main.rs:24-25,72-73)
RO_T, RO_RATE, RO_R_F, RO_R_P = 5, 4, 10, 10


def sfc_shape(step_circuit: StepCircuit, k: int):
    """(num_challenges, round_sizes, folding_degree) of a StepFoldingCircuit
    over `step_circuit` -- input-independent, so computable from configure()
    alone (plays StepInputs::without_witness's metainfo derivation)."""
    sfc = StepFoldingCircuit(step_circuit, None)
    cs = ConstraintSystem()
    sfc.configure(cs)
    num_challenges, round_sizes, _gates, compressed, _lookups = build_metainfo(cs, k)
    return num_challenges, round_sizes, len(compressed.grouped)


@dataclasses.dataclass
class CircuitPublicParams:
    S: PlonkStructure
    ck: CommitmentKey
    params: StepParams
    curve: CurveParams  # commitment curve for this side

    @property
    def k(self) -> int:
        return self.S.k


@dataclasses.dataclass
class CircuitSide:
    """Per-side construction inputs (CircuitPublicParamsInput)."""

    step_circuit: StepCircuit
    ck: CommitmentKey
    k: int
    num_g1: int = 0
    num_g2: int = 0
    gt_degree: int = 0
    gt_cross_terms: int = 0
    # real-proof mode: a snark.groth16.Groth16FoldContext supplying actual
    # proof elements and real Gt cross terms (the reference folds random
    # placeholders)
    groth16_ctx: Optional[object] = None


class PublicParams:
    def __init__(
        self,
        primary: CircuitSide,
        secondary: CircuitSide,
        primary_curve: CurveParams,
        secondary_curve: CurveParams,
        limb_width: int = DEFAULT_LIMB_WIDTH,
        limbs_count: int = DEFAULT_LIMBS_COUNT,
        r_f: int = RO_R_F,
        r_p: int = RO_R_P,
    ):
        # primary circuit lives over primary_curve's SCALAR field
        self.primary_curve = primary_curve
        self.secondary_curve = secondary_curve
        self.limb_width = limb_width
        self.limbs_count = limbs_count

        primary_spec = get_spec(
            primary_curve.scalar_modulus, RO_T, RO_RATE, r_f, r_p
        )
        secondary_spec = get_spec(
            secondary_curve.scalar_modulus, RO_T, RO_RATE, r_f, r_p
        )
        primary_params = StepParams(limb_width, limbs_count, primary_spec)
        secondary_params = StepParams(limb_width, limbs_count, secondary_spec)

        # shapes of each side's SFC (for the paired side's default inputs)
        primary_shape = sfc_shape(primary.step_circuit, primary.k)
        secondary_shape = sfc_shape(secondary.step_circuit, secondary.k)

        # --- primary structure (dry-run with defaults sized from secondary)
        # NOTE: the primary SFC folds SECONDARY-curve instances, so its U/u
        # slots are sized by the SECONDARY side's g1/g2/gt params.  The
        # reference sizes each SFC with its own side's params
        # (public_params.rs:330-346), which mismatches the runtime inputs for
        # the pairing workloads -- masked there by the commented-out sat
        # checks (ivc :617-680); we use the consistent sizing.
        primary_default_inputs = StepInputs.without_witness(
            (secondary_shape[0], secondary_shape[1]),
            secondary_curve,
            primary.step_circuit.arity,
            primary_params,
            secondary.num_g1,
            secondary.num_g2,
            secondary.gt_cross_terms,
            secondary_shape[2],
        )
        primary_sfc = StepFoldingCircuit(primary.step_circuit, primary_default_inputs)
        primary_runner = CircuitRunner(
            primary.k, primary_sfc, [0] * NUM_IO, primary_curve,
            primary.num_g1, primary.num_g2, primary.gt_degree, primary.gt_cross_terms,
        )
        # a tape-safe side is synthesized once, here, in capture mode: the
        # structure comes from the captured table, and the IVC's zero step
        # replays the tape with its own inputs instead of synthesizing again
        self.tapes = {}
        if uses_tape(primary.step_circuit):
            self.tapes["primary"] = capture_runner(primary_runner)
        self.primary = CircuitPublicParams(
            S=primary_runner.collect_structure(),
            ck=primary.ck,
            params=primary_params,
            curve=primary_curve,
        )
        self.primary.S.groth16_ctx = primary.groth16_ctx

        # --- secondary structure + initial plonk trace
        secondary_default_inputs = StepInputs.without_witness(
            (primary_shape[0], primary_shape[1]),
            primary_curve,
            secondary.step_circuit.arity,
            secondary_params,
            primary.num_g1,
            primary.num_g2,
            primary.gt_cross_terms,
            primary_shape[2],
        )
        sec_z0 = [0] * secondary.step_circuit.arity
        sec_z_out = secondary.step_circuit.process_step(
            sec_z0, secondary.k, secondary_curve.scalar_modulus
        )
        secondary_initial_instance = [
            secondary_default_inputs.u.instance[0] % secondary_curve.scalar_modulus,
            compute_instance_hash(
                PoseidonHash(secondary_spec),
                secondary_default_inputs.public_params_hash,
                1,
                sec_z0,
                sec_z_out,
                secondary_default_inputs.U,
                limb_width,
                limbs_count,
            ),
        ]
        secondary_sfc = StepFoldingCircuit(
            secondary.step_circuit, secondary_default_inputs
        )
        secondary_runner = CircuitRunner(
            secondary.k, secondary_sfc, secondary_initial_instance, secondary_curve,
            secondary.num_g1, secondary.num_g2, secondary.gt_degree,
            secondary.gt_cross_terms,
        )
        if uses_tape(secondary.step_circuit):
            self.tapes["secondary"] = capture_runner(secondary_runner)
        secondary_S = secondary_runner.collect_structure()
        # attached before the initial trace below: the zero-step SPS must
        # already draw real proof elements
        secondary_S.groth16_ctx = secondary.groth16_ctx
        self.secondary = CircuitPublicParams(
            S=secondary_S,
            ck=secondary.ck,
            params=secondary_params,
            curve=secondary_curve,
        )

        nifs_pp, _ = VanillaFS.setup_params(
            AffinePoint.identity(secondary_curve), secondary_S
        )
        # RO for secondary traces runs over secondary_curve.base = primary scalar
        self.secondary_initial_plonk_trace = VanillaFS.generate_plonk_trace(
            secondary.ck,
            secondary_initial_instance,
            secondary_runner.collect_witness(),
            nifs_pp,
            PoseidonHash(primary_spec),
        )

        # --- digest -> curve points (reference public_params.rs:392-398)
        digest_bits = self._digest_bits()
        self.digest_1 = _into_curve_from_bits(primary_curve, digest_bits)
        self.digest_2 = _into_curve_from_bits(secondary_curve, digest_bits)

    def _digest_bits(self) -> int:
        """SHA3 digest of the structural public parameters, truncated to
        NUM_HASH_BITS (reference digest.rs:17-64; serialization layout is
        this framework's own canonical form).  The four large hashes (each
        side's fixed columns and permutation) run as threads of their own:
        hashlib lets go of the GIL while it hashes a large buffer."""
        sides = (self.primary, self.secondary)
        with ThreadPoolExecutor(4) as pool:
            fixed = [pool.submit(_sha3_hex, _fixed_bytes(side.S)) for side in sides]
            perm = [pool.submit(_sha3_hex,
                                side.S.permutation_matrix.json_chunks(side.ck.device))
                    for side in sides]
            hashes = [(f.result(), q.result()) for f, q in zip(fixed, perm)]

        def structure_repr(S: PlonkStructure, fixed_hex: str, perm_hex: str):
            return {
                "k": S.k,
                "num_io": S.num_io,
                "num_advice": S.num_advice_columns,
                "num_challenges": S.num_challenges,
                "round_sizes": S.round_sizes,
                "fixed": fixed_hex,
                "perm": perm_hex,
                "num_g1": S.num_g1_elems,
                "num_g2": S.num_g2_elems,
                "gt_degree": S.target_group_folding_degree,
                "gt_cross": S.target_group_cross_terms,
            }

        payload = json.dumps(
            {
                "primary": structure_repr(self.primary.S, *hashes[0]),
                "secondary": structure_repr(self.secondary.S, *hashes[1]),
                "limb_width": self.limb_width,
                "limbs_count": self.limbs_count,
            },
            sort_keys=True,
        ).encode()
        h = hashlib.sha3_256(payload).digest()
        return int.from_bytes(h, "little") & ((1 << NUM_HASH_BITS) - 1)


def _sha3_hex(chunks) -> str:
    h = hashlib.sha3_256()
    for c in chunks:
        h.update(c)
    return h.hexdigest()


_ZEROS = bytes(1 << 25)


def _fixed_bytes(S: PlonkStructure):
    """The bytes of every value of every fixed column, 32 little-endian
    bytes each, in order (mira_tpu hashes `v.to_bytes(32, "little")` per
    value): each column's words up to its last nonzero value, then its zero
    tail from one buffer of zeros."""
    for words, col in zip(S.fixed_words(), S.fixed_columns):
        if len(words):
            yield words
        tail = 32 * (len(col) - len(words))
        while tail:
            n = min(tail, len(_ZEROS))
            yield memoryview(_ZEROS)[:n]
            tail -= n


def _into_curve_from_bits(curve: CurveParams, bits_value: int) -> AffinePoint:
    """scalar = bits mod r; point = G * scalar (reference digest.rs:66-83)."""
    scalar = bits_value % curve.scalar_modulus
    return AffinePoint.generator(curve).scalar_mul(scalar)
