"""SnarkStar: Groth16-verifier folding, Mira's pairing-based accumulation
workload (port of mira_tpu/workloads/snarkstar.py; reference
examples/groth16/).

The primary step circuit applies Merkle-tree updates (workloads/merkle.py).
In structural mode the SECONDARY side's instances carry the pairing data's
shapes (per proof batch: num_g1 = 2*batch, num_g2 = batch, gt_degree = 2,
gt_cross_terms = 2*batch; groth16/main.rs:258-267) with the reference's
random placeholders.  In real-proof mode the pairing data rides the PRIMARY
(bn254) side: real Groth16 proofs (snark/groth16.py) supply [A, C, vk_x]/[B]
to the SPS instances, the NIFS folds true bilinear Gt cross terms, and the
decider checks the folded Gt with real pairings.  BN254 points and Gt live
over Fq, the bn254 base field, which only the primary side's instances fold
consistently.  With `proof_file` the proofs come from a snarkjs bundle
(snark/conversion.py) instead.

    python -m mira_tpu_torch.workloads.snarkstar --steps 2 --real-ck \\
        --real-proofs --device cuda
"""

from __future__ import annotations

import random
import time


def table_sizes(batch_size: int):
    """(k1, k2) ladder (groth16/main.rs:47-61)."""
    ladder = {0: (21, 21), 1: (19, 19), 2: (20, 20), 4: (21, 21),
              8: (22, 22), 16: (23, 23), 32: (24, 24)}
    return ladder[batch_size]


def ck_sizes(batch_size: int):
    """(ck1, ck2) ladder (groth16/main.rs:63-77)."""
    ladder = {0: (25, 24), 1: (23, 24), 2: (24, 24), 4: (25, 24),
              8: (26, 25), 16: (27, 26), 32: (28, 27)}
    return ladder[batch_size]


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(steps: int = 1, batch_size: int = 1, use_mock_ck: bool = True,
        k_override: int | None = None, debug_mode: bool = False,
        real_proofs: bool = False, num_constraints: int = 1000,
        proof_file: str | None = None, device="cuda") -> dict:
    """Fold `steps` SnarkStar steps on `device` and verify the accumulators
    (strict).  Returns the seconds of each phase: "proofs", "keys",
    "public_params", "zero_step", "fold_steps" (a list, each step timed to
    the device's end) and "verify"; besides, under "tables", the (lanes,
    window) of each key's multiples tables by curve name, as they stood
    before the decider freed them, and under "ivc" the verified IVC."""
    from ..curves.host import BN254_G1, GRUMPKIN
    from ..ivc.step_circuit import TrivialCircuit

    from ..ivc.ivc import IVC
    from ..ivc.public_params import CircuitSide, PublicParams
    from ..ops.commitment import CommitmentKey
    from ..ops.mock_commitment import MockCommitmentKey
    from .merkle import MerkleTreeUpdateCircuit

    secs = {}
    k1, k2 = (k_override, k_override) if k_override else table_sizes(batch_size)
    ckk1, ckk2 = (k1 + 4, k2 + 4) if k_override else ck_sizes(batch_size)

    rng = random.Random(0)
    p_mod = BN254_G1.scalar_modulus
    sc1 = MerkleTreeUpdateCircuit(p_mod, batch_size=1)
    for _ in range(steps + 2):
        sc1.random_update_leaves(rng)
    sc2 = TrivialCircuit(arity=1)

    t0 = time.perf_counter()
    if use_mock_ck:
        ck1 = MockCommitmentKey(BN254_G1, k1 + 4, b"bn256", device)
        ck2 = MockCommitmentKey(GRUMPKIN, k2 + 4, b"grumpkin", device)
    else:
        ck1 = CommitmentKey.load_or_setup_cache(BN254_G1, ckk1, "bn256",
                                                device=device)
        ck2 = CommitmentKey.load_or_setup_cache(GRUMPKIN, ckk2, "grumpkin",
                                                device=device)
    secs["keys"] = time.perf_counter() - t0

    ctx = None
    t0 = time.perf_counter()
    if proof_file is not None:
        # external proofs: a snarkjs-format bundle (vk + proofs) through the
        # conversion layer (the role of the reference's conversion.rs)
        from ..snark.conversion import load_proof_bundle
        from ..snark.groth16 import Groth16FoldContext, verify

        vk, items = load_proof_bundle(proof_file)
        for pf, pub in items:
            if not verify(vk, pf, pub):
                raise ValueError(f"a proof of {proof_file} fails verification")
        need = (steps + 2) * batch_size
        if len(items) < need:  # cycle the bundle to fill the fold schedule
            items = [items[i % len(items)] for i in range(need)]
        ctx = Groth16FoldContext(vk, batch_size)
        ctx.push_proofs(items)
        real_proofs = True
        print(f"ingested {len(items)} external proofs from {proof_file}")
    elif real_proofs:
        # real mode (beyond the reference, which discards its arkworks proofs
        # and folds random elements): Groth16 proofs on this stack
        from ..snark.groth16 import (
            Groth16FoldContext,
            benchmark_r1cs,
            prove,
            setup,
            verify,
        )

        r1cs, z = benchmark_r1cs(num_constraints)
        pk = setup(r1cs, rng)
        pub = z[1 : r1cs.num_public + 1]
        # the zero step and the trailing secondary trace of every fold step
        # each consume one batch
        proofs = [(prove(pk, r1cs, z, rng), list(pub))
                  for _ in range((steps + 2) * batch_size)]
        if not verify(pk.vk, proofs[0][0], pub):
            raise AssertionError("a fresh Groth16 proof fails verification")
        ctx = Groth16FoldContext(pk.vk, batch_size)
        ctx.push_proofs(proofs)
    secs["proofs"] = time.perf_counter() - t0
    if ctx is not None:
        print(f"groth16: {len(ctx.queue)} proofs: {secs['proofs']:.1f} s")

    t0 = time.perf_counter()
    if ctx is not None:
        pp = PublicParams(
            CircuitSide(sc1, ck1, k1, num_g1=ctx.num_g1, num_g2=ctx.num_g2,
                        gt_degree=2, gt_cross_terms=ctx.num_gt_cross_terms,
                        groth16_ctx=ctx),
            CircuitSide(sc2, ck2, k2),
            BN254_G1,
            GRUMPKIN,
        )
    else:
        pp = PublicParams(
            CircuitSide(sc1, ck1, k1),
            CircuitSide(sc2, ck2, k2, num_g1=2 * batch_size,
                        num_g2=1 * batch_size, gt_degree=2,
                        gt_cross_terms=2 * batch_size),
            BN254_G1,
            GRUMPKIN,
        )
    secs["public_params"] = time.perf_counter() - t0
    print(f"public params: {secs['public_params']:.1f} s")

    z0 = [sc1.front_proof_batch()[0].root().old]
    t0 = time.perf_counter()
    ivc = IVC(pp, sc1, z0, sc2, [0], debug_mode=debug_mode)
    _sync(device)
    secs["zero_step"] = time.perf_counter() - t0
    print(f"ivc zero step: {secs['zero_step']:.1f} s")
    secs["fold_steps"] = []
    for step in range(steps):
        sc1.pop_front_proof_batch()
        t0 = time.perf_counter()
        ivc.fold_step()
        _sync(device)
        secs["fold_steps"].append(time.perf_counter() - t0)
        print(f"fold step {step + 1}: {secs['fold_steps'][-1]:.3f} s", flush=True)
    # the decider recomputes full-width commitments: free the folding
    # phase's device tables first
    secs["tables"] = {}
    for ck in (ck1, ck2):
        if hasattr(ck, "release_device_cache"):
            secs["tables"][ck.curve.name] = ck.table_shapes()
            ck.release_device_cache()
    t0 = time.perf_counter()
    ivc.verify(strict=True)
    _sync(device)
    secs["verify"] = time.perf_counter() - t0
    mode = ("REAL Groth16 proofs + true Gt cross terms" if real_proofs
            else "structural")
    print(f"SnarkStar: {steps} steps x batch {batch_size} verified OK ({mode}); "
          f"verify {secs['verify']:.1f} s")
    secs["ivc"] = ivc
    return secs


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="SnarkStar IVC on the port")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--real-ck", action="store_true")
    ap.add_argument("--debug-mode", action="store_true")
    ap.add_argument("--real-proofs", action="store_true",
                    help="fold actual Groth16 proofs with real Gt cross terms")
    ap.add_argument("--num-constraints", type=int, default=1000)
    ap.add_argument("--proof-file", type=str, default=None,
                    help="snarkjs-format JSON bundle of external proofs to fold")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args()
    run(args.steps, args.batch_size, not args.real_ck, args.k, args.debug_mode,
        args.real_proofs, args.num_constraints, args.proof_file, args.device)
