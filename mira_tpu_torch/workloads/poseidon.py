"""Poseidon hash-chain IVC workload
(reference examples/poseidon.rs + benches/poseidon).

Copied from mira_tpu/workloads/poseidon.py (the port imports nothing of
mira_tpu); `run` gained the device its keys live on.
"""

from __future__ import annotations

from ..gadgets.main_gate import MainGate
from ..gadgets.poseidon_chip import PoseidonChip
from ..ops.poseidon import PoseidonHash, get_spec
from ..fields.host import field
from ..ivc.step_circuit import StepCircuit

# step-circuit poseidon spec (examples/poseidon.rs:21-27)
SC_T, SC_RATE, SC_R_F, SC_R_P = 3, 2, 4, 3


class PoseidonStepCircuit(StepCircuit):
    """z_{i+1} = Poseidon(z_i), repeated `repeat_count` times per step."""

    arity = 1
    # no per-step self state: z flows in through z_in, structure is static
    tape_safe = True

    def __init__(self, modulus: int, repeat_count: int = 1):
        self.modulus = modulus
        self.repeat_count = repeat_count
        self.spec = get_spec(modulus, SC_T, SC_RATE, SC_R_F, SC_R_P)

    def configure(self, cs):
        return MainGate.configure(cs, SC_T)

    def synthesize_step(self, config, ctx, z_in):
        z = list(z_in)
        for _ in range(self.repeat_count + 1):
            chip = PoseidonChip(config, self.spec)
            chip.update(list(z))
            z = [chip.squeeze(ctx)]
        return z

    def process_step(self, z_i, k, modulus):
        F = field(self.modulus)
        z = list(z_i)
        for _ in range(self.repeat_count + 1):
            h = PoseidonHash(self.spec)
            h.update([F(v) for v in z])
            z = [h.output(F, 255).v]
        return z


def run(steps: int = 2, k: int = 17, use_mock_ck: bool = True, repeat_count: int = 1,
        device="cuda"):
    from ..curves.host import BN254_G1, GRUMPKIN
    from ..ivc.ivc import IVC
    from ..ivc.public_params import CircuitSide, PublicParams
    from ..ivc.step_circuit import TrivialCircuit
    from ..ops.commitment import CommitmentKey
    from ..ops.mock_commitment import MockCommitmentKey

    ck_k = k + 4
    if use_mock_ck:
        ck1 = MockCommitmentKey(BN254_G1, ck_k, b"bn256", device)
        ck2 = MockCommitmentKey(GRUMPKIN, ck_k, b"grumpkin", device)
    else:
        ck1 = CommitmentKey.load_or_setup_cache(BN254_G1, ck_k, "bn256",
                                                device=device)
        ck2 = CommitmentKey.load_or_setup_cache(GRUMPKIN, ck_k, "grumpkin",
                                                device=device)

    sc1 = PoseidonStepCircuit(BN254_G1.scalar_modulus, repeat_count)
    sc2 = TrivialCircuit(arity=1)
    pp = PublicParams(
        CircuitSide(sc1, ck1, k), CircuitSide(sc2, ck2, k), BN254_G1, GRUMPKIN
    )
    ivc = IVC(pp, sc1, [0], sc2, [0])
    import time

    for step in range(steps):
        t0 = time.time()
        ivc.fold_step()
        print(f"fold step {step + 1}: {time.time() - t0:.1f}s")
    ivc.verify(strict=True)
    print(f"poseidon IVC: {steps} steps verified OK; z_i = {ivc.primary.z_i}")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--k", type=int, default=17)
    ap.add_argument("--repeat-count", type=int, default=1)
    ap.add_argument("--real-ck", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args()
    run(args.steps, args.k, not args.real_ck, args.repeat_count, args.device)
