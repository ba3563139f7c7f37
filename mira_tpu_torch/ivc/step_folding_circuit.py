"""The augmented circuit F' (StepFoldingCircuit): runs the in-circuit fold
verifier, the instance-hash consistency check, and the user's step circuit.

Mirrors reference src/ivc/step_folding_circuit.rs:294-548 adapted to the
framework's single-region synthesis:
1. assign z_0/z_i;
2. assign witness + squeeze fold challenge (FoldRelaxedPlonkInstanceChip);
3. step counter row (step+1);
4. X0 hash-consistency check (on-circuit RO);
5. non-base-case fold;
6. conditional select base/non-base by step==0;
7. user step circuit on selected input;
8. output hash; pin instance cells: X0 := old u.X1, X1 := output hash.

Port of mira_tpu/ivc/step_folding_circuit.py: the same logic, bound to the port's
structure, folding scheme and commitment key."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..curves.host import AffinePoint, Tuple12
from ..fields.host import field
from ..gadgets.main_gate import CyclicAssigner, MainGate
from ..gadgets.poseidon_chip import PoseidonChip
from ..ops.poseidon import Spec, get_spec
from ..plonk.structure import PlonkInstance, RelaxedPlonkInstance
from ..table.circuit import ConstraintSystem, RegionCtx
from .fold_chip import AssignedRelaxedPlonkInstance, FoldRelaxedPlonkInstanceChip
from .instance_computation import compute_instance_hash_on_circuit
from ..ivc.step_circuit import StepCircuit

MAIN_GATE_T = 5
NUM_IO = 2


@dataclasses.dataclass
class StepParams:
    """limb_width/limbs_count/ro_constant (step_folding_circuit.rs:31-63)."""

    limb_width: int
    limbs_count: int
    ro_spec: Spec  # poseidon spec over the circuit field


@dataclasses.dataclass
class StepInputs:
    step: int
    step_pp: StepParams
    public_params_hash: AffinePoint
    z_0: List[int]
    z_i: List[int]
    U: RelaxedPlonkInstance
    u: PlonkInstance
    cross_term_commits: List[AffinePoint]
    cross_term_gt_commits: List[Tuple12]

    @staticmethod
    def without_witness(
        paired_sfc_metainfo,
        curve,
        arity: int,
        step_pp: StepParams,
        num_g1: int,
        num_g2: int,
        gt_cross_terms: int,
        folding_degree: int,
    ) -> "StepInputs":
        """Self-referential sizing: shapes derived from the PAIRED circuit's
        metainfo (step_folding_circuit.rs:115-168)."""
        num_challenges, round_sizes = paired_sfc_metainfo
        Fb = field(curve.base_modulus)
        return StepInputs(
            step=0,
            step_pp=step_pp,
            public_params_hash=AffinePoint.identity(curve),
            z_0=[0] * arity,
            z_i=[0] * arity,
            U=RelaxedPlonkInstance.new(
                curve, NUM_IO, num_challenges, len(round_sizes), num_g1, num_g2
            ),
            u=PlonkInstance.new(
                curve, NUM_IO, num_challenges, len(round_sizes), num_g1, num_g2
            ),
            cross_term_commits=[
                AffinePoint.identity(curve) for _ in range(max(folding_degree - 1, 0))
            ],
            cross_term_gt_commits=[Tuple12.one(Fb) for _ in range(gt_cross_terms)],
        )


@dataclasses.dataclass
class StepConfig:
    step_config: object
    main_gate_config: object


class StepFoldingCircuit:
    def __init__(self, step_circuit: StepCircuit, inputs: StepInputs):
        self.step_circuit = step_circuit
        self.inputs = inputs

    def configure(self, cs: ConstraintSystem) -> StepConfig:
        main_gate_config = MainGate.configure(cs, MAIN_GATE_T)
        step_config = self.step_circuit.configure(cs)
        assert cs.num_instance == 0, "step circuits may not use instance columns"
        cs.instance_column()
        return StepConfig(step_config=step_config, main_gate_config=main_gate_config)

    def synthesize(self, config: StepConfig, ctx: RegionCtx):
        inp = self.inputs
        cfg = config.main_gate_config
        mg = MainGate(cfg)
        p = ctx.modulus

        # 1. z_0 / z_i
        assigner = CyclicAssigner(cfg.iter_advice_columns(), advice=True)
        assigned_z_0 = assigner.assign_all(ctx, [v % p for v in inp.z_0])
        assigned_z_i = assigner.assign_all(ctx, [v % p for v in inp.z_i])
        assigner.finish(ctx)

        # 2. witness + challenge
        chip = FoldRelaxedPlonkInstanceChip(
            inp.U, inp.step_pp.limb_width, inp.step_pp.limbs_count, cfg
        )
        ro = PoseidonChip(cfg, inp.step_pp.ro_spec)
        w, r = chip.assign_witness_with_challenge(
            ctx,
            inp.public_params_hash,
            inp.u,
            inp.cross_term_commits,
            inp.cross_term_gt_commits,
            ro,
        )
        U_new_base = w.assigned_relaxed

        # 3. step counter row: step + 1 = next_step
        ctx.assign_fixed(cfg.q_i, 1)
        assigned_step = ctx.assign_advice(cfg.input, inp.step % p)
        ctx.assign_fixed(cfg.rc, 1)
        ctx.assign_fixed(cfg.q_o, p - 1)
        assigned_next_step = ctx.assign_advice(cfg.out, (inp.step + 1) % p)
        ctx.next()

        # 4. X0 consistency
        base_case_input_check = ctx.assign_advice(cfg.input, 1)
        ctx.next()
        ro2 = PoseidonChip(cfg, inp.step_pp.ro_spec)
        expected_X0 = compute_instance_hash_on_circuit(
            ro2, ctx, cfg, w.public_params_hash, assigned_step,
            assigned_z_0, assigned_z_i, w.assigned_relaxed,
        )
        non_base_case_input_check = mg.is_equal_term(
            ctx, expected_X0, w.input_instance[0][0]
        )

        # 5. non-base-case fold
        fold_result = chip.fold(ctx, w, r)
        U_new_non_base = fold_result.assigned_result_of_fold

        # 6. select base/non-base
        assigned_is_zero_step = mg.is_zero_term(ctx, assigned_step)
        new_U = AssignedRelaxedPlonkInstance.conditional_select(
            ctx, cfg, U_new_base, U_new_non_base, assigned_is_zero_step
        )
        input_check = mg.conditional_select(
            ctx, base_case_input_check, non_base_case_input_check, assigned_is_zero_step
        )
        mg.assert_equal_const(ctx, input_check, 1)
        assigned_input = [
            mg.conditional_select(ctx, z0, zi, assigned_is_zero_step)
            for z0, zi in zip(assigned_z_0, assigned_z_i)
        ]

        # 7. user step circuit
        z_output = self.step_circuit.synthesize_step(
            config.step_config, ctx, assigned_input
        )

        # 8. output hash
        ro3 = PoseidonChip(cfg, inp.step_pp.ro_spec)
        output_hash = compute_instance_hash_on_circuit(
            ro3, ctx, cfg, fold_result.assigned_input.public_params_hash,
            assigned_next_step, assigned_z_0, z_output, new_U,
        )

        # instance pinning: X0 == old u.X1; X1 == output hash
        ctx.table.constrain_instance(fold_result.assigned_input.input_instance[1][0].cell, 0)
        ctx.table.constrain_instance(output_hash.cell, 1)
