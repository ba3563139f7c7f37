"""The two-curve Nova-style IVC driver
(reference src/ivc/incrementally_verifiable_computation.rs).

`IVC.new` runs the zero step on both curves; `fold_step` performs:
NIFS-prove(secondary acc) -> synthesize primary SFC -> SPS trace ->
NIFS-prove(primary acc) -> synthesize secondary SFC -> new secondary trace.
`verify` recomputes both instance hashes and runs the satisfaction checks
(which the reference suppresses behind comments,
incrementally_verifiable_computation.rs:617-680 -- here they are enforced
unless `strict=False`).

Port of mira_tpu/ivc/ivc.py: the same logic, bound to the port's
structure, folding scheme and commitment key."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..ops.poseidon import PoseidonHash
from ..utils.tracing import instrument, span
from ..nifs.vanilla import VanillaFS
from ..plonk.structure import PlonkTrace, RelaxedPlonkTrace, SatError
from ..table.mock import mock_check
from ..table.runner import CircuitRunner
from .instance_computation import compute_instance_hash
from .public_params import NUM_IO, PublicParams
from ..ivc.step_circuit import StepCircuit
from .step_folding_circuit import StepFoldingCircuit, StepInputs


class VerificationError(Exception):
    pass


def _one_tuple12(curve):
    from ..curves.host import Tuple12
    from ..fields.host import field

    return Tuple12.one(field(curve.base_modulus))


@dataclasses.dataclass
class _Context:
    relaxed_trace: RelaxedPlonkTrace
    z_0: List[int]
    z_i: List[int]


class IVC:
    def __init__(
        self,
        pp: PublicParams,
        primary: StepCircuit,
        primary_z_0: List[int],
        secondary: StepCircuit,
        secondary_z_0: List[int],
        debug_mode: bool = False,
    ):
        self._init_common(pp, primary, secondary, debug_mode)
        primary_ro, secondary_ro = self._primary_ro, self._secondary_ro

        # ------- zero step, primary side (ivc :196-280)
        sec_pre_trace = pp.secondary_initial_plonk_trace
        p_mod = pp.primary_curve.scalar_modulus
        s_mod = pp.secondary_curve.scalar_modulus

        primary_z_out = primary.process_step(primary_z_0, pp.primary.k, p_mod)
        secondary_relaxed = sec_pre_trace.to_relax(pp.secondary.k)

        primary_instance = [
            sec_pre_trace.u.instance[1] % p_mod,
            compute_instance_hash(
                primary_ro(),
                pp.digest_2,
                1,
                primary_z_0,
                primary_z_out,
                secondary_relaxed.U,
                pp.limb_width,
                pp.limbs_count,
            ),
        ]

        primary_sfc = StepFoldingCircuit(
            primary,
            StepInputs(
                step=0,
                step_pp=pp.primary.params,
                public_params_hash=pp.digest_2,
                z_0=list(primary_z_0),
                z_i=list(primary_z_0),
                U=secondary_relaxed.U,
                u=sec_pre_trace.u,
                cross_term_commits=[
                    type(pp.digest_2).identity(pp.secondary_curve)
                    for _ in range(pp.secondary.S.get_degree_for_folding() - 1)
                ],
                cross_term_gt_commits=[
                    _one_tuple12(pp.secondary_curve)
                    for _ in range(pp.secondary.S.target_group_cross_terms)
                ],
            ),
        )
        primary_witness = self._synthesize(
            pp.primary.k, primary_sfc, primary_instance, pp.primary_curve,
            side="primary",
        )

        primary_trace = VanillaFS.generate_plonk_trace(
            pp.primary.ck, primary_instance, primary_witness,
            self.primary_nifs_pp, secondary_ro(),
        )
        primary_relaxed = primary_trace.to_relax(pp.primary.k)

        # ------- zero step, secondary side (ivc :281-382)
        secondary_z_out = secondary.process_step(secondary_z_0, pp.secondary.k, s_mod)
        secondary_instance = [
            primary_trace.u.instance[1] % s_mod,
            compute_instance_hash(
                secondary_ro(),
                pp.digest_1,
                1,
                secondary_z_0,
                secondary_z_out,
                primary_relaxed.U,
                pp.limb_width,
                pp.limbs_count,
            ),
        ]
        secondary_sfc = StepFoldingCircuit(
            secondary,
            StepInputs(
                step=0,
                step_pp=pp.secondary.params,
                public_params_hash=pp.digest_1,
                z_0=list(secondary_z_0),
                z_i=list(secondary_z_0),
                U=primary_relaxed.U,
                u=primary_trace.u,
                cross_term_commits=[
                    type(pp.digest_1).identity(pp.primary_curve)
                    for _ in range(pp.primary.S.get_degree_for_folding() - 1)
                ],
                cross_term_gt_commits=[
                    _one_tuple12(pp.primary_curve)
                    for _ in range(pp.primary.S.target_group_cross_terms)
                ],
            ),
        )
        secondary_witness = self._synthesize(
            pp.secondary.k, secondary_sfc, secondary_instance,
            pp.secondary_curve, side="secondary",
        )
        secondary_trace = VanillaFS.generate_plonk_trace(
            pp.secondary.ck, secondary_instance, secondary_witness,
            self.secondary_nifs_pp, primary_ro(),
        )

        self.step = 1
        self.secondary_trace = secondary_trace
        self.primary = _Context(primary_relaxed, list(primary_z_0), primary_z_out)
        self.secondary = _Context(
            secondary_relaxed, list(secondary_z_0), secondary_z_out
        )

    def _init_common(self, pp, primary, secondary, debug_mode):
        """What a new IVC and a resumed one share: the public parameters,
        the circuits, the tapes the public parameters captured (the zero
        step and every later step replay them), the random oracles and both
        sides' NIFS parameters."""
        self.pp = pp
        self.primary_circuit = primary
        self.secondary_circuit = secondary
        self.debug_mode = debug_mode
        self._tapes = dict(pp.tapes)
        self._primary_ro = lambda: PoseidonHash(pp.primary.params.ro_spec)
        self._secondary_ro = lambda: PoseidonHash(pp.secondary.params.ro_spec)
        self.primary_nifs_pp, _ = VanillaFS.setup_params(pp.digest_1, pp.primary.S)
        self.secondary_nifs_pp, _ = VanillaFS.setup_params(pp.digest_2, pp.secondary.S)

    # ------------------------------------------------------------------
    def _synthesize(self, k, sfc, instance, curve, side=None):
        with span("synthesize"):
            return self._synthesize_inner(k, sfc, instance, curve, side)

    def _synthesize_inner(self, k, sfc, instance, curve, side=None):
        # witness-tape fast path (ivc/tape_runner.py): capture the first
        # synthesis of each circuit side as a straight-line program, replay
        # it for later steps.  Debug mode keeps the plain path (mock_check
        # wants the full table).
        from .tape_runner import capture_sfc, replay_sfc, uses_tape

        use_tape = (
            side is not None
            and not self.debug_mode
            and uses_tape(sfc.step_circuit)
        )
        if use_tape:
            captured = self._tapes.get(side)
            if captured is None:
                captured, witness = capture_sfc(k, sfc, instance, curve)
                self._tapes[side] = captured
                return witness
            ck = self.pp.primary.ck if side == "primary" else self.pp.secondary.ck
            return replay_sfc(captured, sfc, ck.device)

        runner = CircuitRunner(k, sfc, instance, curve)
        if self.debug_mode:
            cs, table = runner._synthesize()
            mock_check(cs, table)
        return runner.collect_witness()

    # ------------------------------------------------------------------
    @instrument
    def fold_step(self, mesh=None):
        """One IVC step (reference ivc :385-562).  With a mesh
        (parallel/mesh.py), as mira_tpu's: the cross terms, every commit and
        the witness folds of both sides are sharded across its ranks."""
        pp = self.pp
        p_mod = pp.primary_curve.scalar_modulus
        s_mod = pp.secondary_curve.scalar_modulus

        # 1. fold secondary accumulator with the last secondary trace
        secondary_new_trace, secondary_cross_commits = VanillaFS.prove(
            pp.secondary.ck, self.secondary_nifs_pp, self._primary_ro(),
            self.secondary.relaxed_trace, self.secondary_trace, mesh=mesh,
        )

        # 2. primary SFC over the secondary fold
        primary_z_next = self.primary_circuit.process_step(
            self.primary.z_i, pp.primary.k, p_mod
        )
        primary_instance = [
            self.secondary_trace.u.instance[1] % p_mod,
            compute_instance_hash(
                self._primary_ro(), pp.digest_2, self.step + 1,
                self.primary.z_0, primary_z_next, secondary_new_trace.U,
                pp.limb_width, pp.limbs_count,
            ),
        ]
        primary_sfc = StepFoldingCircuit(
            self.primary_circuit,
            StepInputs(
                step=self.step,
                step_pp=pp.primary.params,
                public_params_hash=pp.digest_2,
                z_0=self.primary.z_0,
                z_i=self.primary.z_i,
                U=self.secondary.relaxed_trace.U,
                u=self.secondary_trace.u,
                cross_term_commits=secondary_cross_commits[0],
                cross_term_gt_commits=secondary_cross_commits[1],
            ),
        )
        primary_witness = self._synthesize(
            pp.primary.k, primary_sfc, primary_instance, pp.primary_curve,
            side="primary",
        )
        self.primary.z_i = primary_z_next
        self.secondary.relaxed_trace = secondary_new_trace

        primary_trace = VanillaFS.generate_plonk_trace(
            pp.primary.ck, primary_instance, primary_witness,
            self.primary_nifs_pp, self._secondary_ro(), mesh=mesh,
        )

        # 3. fold primary accumulator
        primary_new_trace, primary_cross_commits = VanillaFS.prove(
            pp.primary.ck, self.primary_nifs_pp, self._secondary_ro(),
            self.primary.relaxed_trace, primary_trace, mesh=mesh,
        )

        # 4. secondary SFC over the primary fold
        secondary_z_next = self.secondary_circuit.process_step(
            self.secondary.z_i, pp.secondary.k, s_mod
        )
        secondary_instance = [
            primary_trace.u.instance[1] % s_mod,
            compute_instance_hash(
                self._secondary_ro(), pp.digest_1, self.step + 1,
                self.secondary.z_0, secondary_z_next, primary_new_trace.U,
                pp.limb_width, pp.limbs_count,
            ),
        ]
        secondary_sfc = StepFoldingCircuit(
            self.secondary_circuit,
            StepInputs(
                step=self.step,
                step_pp=pp.secondary.params,
                public_params_hash=pp.digest_1,
                z_0=self.secondary.z_0,
                z_i=self.secondary.z_i,
                U=self.primary.relaxed_trace.U,
                u=primary_trace.u,
                cross_term_commits=primary_cross_commits[0],
                cross_term_gt_commits=primary_cross_commits[1],
            ),
        )
        secondary_witness = self._synthesize(
            pp.secondary.k, secondary_sfc, secondary_instance,
            pp.secondary_curve, side="secondary",
        )
        self.secondary.z_i = secondary_z_next
        self.primary.relaxed_trace = primary_new_trace

        self.secondary_trace = VanillaFS.generate_plonk_trace(
            pp.secondary.ck, secondary_instance, secondary_witness,
            self.secondary_nifs_pp, self._primary_ro(), mesh=mesh,
        )
        self.step += 1

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str):
        """Persist the full prover state (see ivc/checkpoint.py)."""
        from .checkpoint import save

        save(self, path)

    def load_checkpoint(self, path: str) -> "IVC":
        """Restore state saved by save_checkpoint into this IVC (must be
        built with the same PublicParams/circuits)."""
        from .checkpoint import load

        return load(self, path)

    @classmethod
    def resume(
        cls,
        pp: PublicParams,
        primary: StepCircuit,
        secondary: StepCircuit,
        path: str,
        debug_mode: bool = False,
    ) -> "IVC":
        """Construct an IVC directly from a checkpoint without running the
        zero step.  `pp` and the circuits must match the ones the checkpoint
        was saved under (the restored instances hash pp digests, so a
        mismatch fails `verify`).  The resumed IVC replays the tapes the
        public parameters captured, as the IVC that saved the checkpoint
        did (a side the public parameters did not capture is captured by
        the first `fold_step`)."""
        from .checkpoint import load

        ivc = cls.__new__(cls)
        ivc._init_common(pp, primary, secondary, debug_mode)
        ivc.primary = _Context(None, [], [])
        ivc.secondary = _Context(None, [], [])
        ivc.secondary_trace = None
        ivc.step = 0
        return load(ivc, path)

    # ------------------------------------------------------------------
    @instrument
    def verify(self, strict: bool = True):
        """Final decider checks (reference ivc :565-687).

        The reference only enforces the instance-hash equalities and comments
        out the satisfaction checks; `strict=True` enforces everything."""
        pp = self.pp
        errors = []

        expected_X0 = compute_instance_hash(
            self._primary_ro(), pp.digest_2, self.step,
            self.primary.z_0, self.primary.z_i, self.secondary.relaxed_trace.U,
            pp.limb_width, pp.limbs_count,
        )
        if expected_X0 != self.secondary_trace.u.instance[0] % pp.primary_curve.scalar_modulus:
            errors.append("primary instance hash (X0) mismatch")

        expected_X1 = compute_instance_hash(
            self._secondary_ro(), pp.digest_1, self.step,
            self.secondary.z_0, self.secondary.z_i, self.primary.relaxed_trace.U,
            pp.limb_width, pp.limbs_count,
        )
        if expected_X1 != self.secondary_trace.u.instance[1] % pp.secondary_curve.scalar_modulus:
            errors.append("secondary instance hash (X1) mismatch")

        if strict:
            checks = [
                (
                    "primary relaxed sat",
                    lambda: pp.primary.S.is_sat_relaxed(
                        pp.primary.ck,
                        self.primary.relaxed_trace.U,
                        self.primary.relaxed_trace.W,
                    ),
                ),
                (
                    "secondary relaxed sat",
                    lambda: pp.secondary.S.is_sat_relaxed(
                        pp.secondary.ck,
                        self.secondary.relaxed_trace.U,
                        self.secondary.relaxed_trace.W,
                    ),
                ),
                (
                    "secondary fresh sat",
                    lambda: pp.secondary.S.is_sat(
                        pp.secondary.ck,
                        self._primary_ro(),
                        self.secondary_trace.u,
                        self.secondary_trace.w,
                    ),
                ),
                (
                    "primary perm",
                    lambda: pp.primary.S.is_sat_perm(
                        self.primary.relaxed_trace.U, self.primary.relaxed_trace.W
                    ),
                ),
                (
                    "secondary perm",
                    lambda: pp.secondary.S.is_sat_perm(
                        self.secondary.relaxed_trace.U, self.secondary.relaxed_trace.W
                    ),
                ),
            ]
            for name, check in checks:
                try:
                    with span(f"verify:{name.replace(' ', '_')}"):
                        check()
                except SatError as e:
                    errors.append(f"{name}: {e}")

        if errors:
            raise VerificationError("; ".join(errors))
