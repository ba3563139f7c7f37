"""The public-IO instance hash X = H(pp_hash, step, z_0, z_i, relaxed-U),
off-circuit and on-circuit (bit-exact twins).

Mirrors reference src/ivc/instance_computation.rs: scalar-field values
(instance / challenges) are limb-decomposed to bignat limbs before absorption;
the squeeze is truncated to NUM_CHALLENGE_BITS.

Port of mira_tpu/ivc/instance_computation.py: the same logic, bound to the port's
structure, folding scheme and commitment key."""

from __future__ import annotations

from typing import List

from mira_tpu.constants import NUM_CHALLENGE_BITS
from mira_tpu.fields.host import field
from mira_tpu.gadgets.bignum import int_to_bn_limbs
from mira_tpu.gadgets.main_gate import MainGate, MainGateConfig
from ..plonk.structure import RelaxedPlonkInstance


def compute_instance_hash(
    ro,
    public_params_hash,
    step: int,
    z_0: List[int],
    z_i: List[int],
    relaxed: RelaxedPlonkInstance,
    limb_width: int,
    limbs_count: int,
) -> int:
    """Off-circuit X hash; returns the integer value (< 2^128)."""
    curve = relaxed.curve
    base = field(curve.base_modulus)
    scalar = field(curve.scalar_modulus)

    ro.absorb_point(public_params_hash)
    ro.absorb_field(base(step))
    for v in z_0:
        ro.absorb_field(base(v))
    for v in z_i:
        ro.absorb_field(base(v))
    # relaxed view with limb-decomposed instance/challenges
    for c in relaxed.W_commitments:
        ro.absorb_point(c)
    ro.absorb_point(relaxed.E_commitment)
    for v in relaxed.instance:
        for limb in int_to_bn_limbs(v % curve.base_modulus, limb_width, limbs_count):
            ro.absorb_field(base(limb))
    for v in relaxed.challenges:
        for limb in int_to_bn_limbs(v % curve.base_modulus, limb_width, limbs_count):
            ro.absorb_field(base(limb))
    ro.absorb_field(base(relaxed.u % curve.base_modulus))
    for g in relaxed.g1_elements:
        ro.absorb_point(g)
    for g in relaxed.g2_elements:
        ro.absorb_g2_point(g)
    ro.absorb_fp12_tuple(relaxed.gt_element)
    return ro.squeeze(scalar, NUM_CHALLENGE_BITS).v


def compute_instance_hash_on_circuit(
    ro_chip,
    ctx,
    config: MainGateConfig,
    public_params_hash,  # AssignedEccPoint
    step_cell,
    z_0_cells,
    z_i_cells,
    assigned_relaxed,
):
    """On-circuit twin (instance_computation.rs:46-69); returns the
    assigned hash value cell."""
    ro_chip.absorb_point([public_params_hash.x, public_params_hash.y])
    ro_chip.absorb_base(step_cell)
    ro_chip.absorb_iter(z_0_cells)
    ro_chip.absorb_iter(z_i_cells)
    ro_chip.absorb_iter(assigned_relaxed.iter_wrap_values())
    bits = ro_chip.squeeze_n_bits(ctx, NUM_CHALLENGE_BITS)
    return MainGate(config).le_bits_to_num(ctx, bits)
