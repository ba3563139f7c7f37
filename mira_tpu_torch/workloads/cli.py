"""Workload CLI: compose any primary/secondary step-circuit pair with sizing
flags (reference examples/cli.rs).

Copied from mira_tpu/workloads/cli.py (the port imports nothing of
mira_tpu); it gained `--device`, the device the keys and witnesses live on.

    python -m mira_tpu_torch.workloads.cli --primary poseidon \
        --secondary trivial --k-table-size 17 --steps 2 --device cuda
"""

from __future__ import annotations

import argparse
import random
import time


def build_circuit(name: str, modulus: int, args):
    from ..ivc.step_circuit import TrivialCircuit

    if name == "trivial":
        return TrivialCircuit(arity=args.arity)
    if name == "poseidon":
        from .poseidon import PoseidonStepCircuit

        return PoseidonStepCircuit(modulus, args.repeat_count)
    if name in ("merkle", "groth16"):
        # the reference's groth16 example drives the same MerkleTreeUpdate
        # step circuit (groth16/circuit.rs:120-164); selecting "groth16"
        # additionally expects the pairing sizing flags (--num-g1 etc.) to
        # be set, mirroring examples/cli.rs:37-80
        from .merkle import MerkleTreeUpdateCircuit

        sc = MerkleTreeUpdateCircuit(modulus, args.batch_size)
        rng = random.Random(args.seed)
        for _ in range(args.steps + 2):
            sc.random_update_leaves(rng)
        return sc
    raise SystemExit(f"unknown circuit {name!r}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--primary", default="poseidon",
                    choices=["trivial", "poseidon", "merkle", "groth16"])
    ap.add_argument("--secondary", default="trivial",
                    choices=["trivial", "poseidon", "merkle", "groth16"])
    ap.add_argument("--k-table-size", type=int, default=17)
    ap.add_argument("--commitment-key-size", type=int, default=21)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--arity", type=int, default=1)
    ap.add_argument("--repeat-count", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--limb-width", type=int, default=32)
    ap.add_argument("--limbs-count", type=int, default=10)
    # Poseidon RO rounds (reference cli.rs primary_r_f/r_p flags)
    ap.add_argument("--r-f", type=int, default=10)
    ap.add_argument("--r-p", type=int, default=10)
    # per-side pairing-instance shape (reference cli.rs:45-71)
    ap.add_argument("--num-g1", type=int, default=0)
    ap.add_argument("--num-g2", type=int, default=0)
    ap.add_argument("--gt-degree", type=int, default=0)
    ap.add_argument("--gt-cross-terms", type=int, default=0)
    ap.add_argument("--secondary-num-g1", type=int, default=0)
    ap.add_argument("--secondary-num-g2", type=int, default=0)
    ap.add_argument("--secondary-gt-degree", type=int, default=0)
    ap.add_argument("--secondary-gt-cross-terms", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--real-ck", action="store_true",
                    help="use the real Pedersen key (device MSM) instead of "
                         "the homomorphic mock key")
    ap.add_argument("--debug-mode", action="store_true",
                    help="mock-check every synthesized step circuit")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)

    from ..curves.host import BN254_G1, GRUMPKIN
    from ..ivc.ivc import IVC
    from ..ivc.public_params import CircuitSide, PublicParams
    from ..ops.commitment import CommitmentKey
    from ..ops.mock_commitment import MockCommitmentKey

    p_mod = BN254_G1.scalar_modulus
    s_mod = GRUMPKIN.scalar_modulus
    sc1 = build_circuit(args.primary, p_mod, args)
    sc2 = build_circuit(args.secondary, s_mod, args)

    ck_k = args.commitment_key_size
    if args.real_ck:
        ck1 = CommitmentKey.load_or_setup_cache(BN254_G1, ck_k, "bn256",
                                                device=args.device)
        ck2 = CommitmentKey.load_or_setup_cache(GRUMPKIN, ck_k, "grumpkin",
                                                device=args.device)
    else:
        ck1 = MockCommitmentKey(BN254_G1, ck_k, b"bn256", args.device)
        ck2 = MockCommitmentKey(GRUMPKIN, ck_k, b"grumpkin", args.device)

    t0 = time.time()
    pp = PublicParams(
        CircuitSide(sc1, ck1, args.k_table_size, args.num_g1, args.num_g2,
                    args.gt_degree, args.gt_cross_terms),
        CircuitSide(sc2, ck2, args.k_table_size, args.secondary_num_g1,
                    args.secondary_num_g2, args.secondary_gt_degree,
                    args.secondary_gt_cross_terms),
        BN254_G1,
        GRUMPKIN,
        limb_width=args.limb_width,
        limbs_count=args.limbs_count,
        r_f=args.r_f,
        r_p=args.r_p,
    )
    print(f"public params: {time.time() - t0:.1f}s")

    z0_1 = (
        [sc1.front_proof_batch()[0].root().old]
        if args.primary in ("merkle", "groth16")
        else [0] * sc1.arity
    )
    z0_2 = (
        [sc2.front_proof_batch()[0].root().old]
        if args.secondary in ("merkle", "groth16")
        else [0] * sc2.arity
    )
    t0 = time.time()
    ivc = IVC(pp, sc1, z0_1, sc2, z0_2, debug_mode=args.debug_mode)
    print(f"ivc zero step: {time.time() - t0:.1f}s")

    for step in range(args.steps):
        for sc, name in ((sc1, args.primary), (sc2, args.secondary)):
            if name in ("merkle", "groth16"):
                sc.pop_front_proof_batch()
        t0 = time.time()
        ivc.fold_step()
        print(f"fold step {step + 1}: {time.time() - t0:.1f}s")

    t0 = time.time()
    ivc.verify(strict=True)
    print(f"verify: {time.time() - t0:.1f}s")
    print(f"OK: {args.primary}/{args.secondary} x {args.steps} steps")
    return ivc


if __name__ == "__main__":
    main()
