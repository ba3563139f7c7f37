"""Trivial identity-circuit IVC workload (reference
examples/trivial/main.rs: ARITY=8, k=17).

Copied from mira_tpu/workloads/trivial.py (the port imports nothing of
mira_tpu); `run` gained the device its keys live on.

    python -m mira_tpu_torch.workloads.trivial --steps 2 --k 17 --device cuda
"""

from __future__ import annotations


def run(steps: int = 2, k: int = 17, use_mock_ck: bool = True, arity: int = 8,
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

    sc1 = TrivialCircuit(arity=arity)
    sc2 = TrivialCircuit(arity=arity)
    pp = PublicParams(
        CircuitSide(sc1, ck1, k), CircuitSide(sc2, ck2, k), BN254_G1, GRUMPKIN
    )
    ivc = IVC(pp, sc1, list(range(arity)), sc2, list(range(arity)))
    import time

    for step in range(steps):
        t0 = time.time()
        ivc.fold_step()
        print(f"fold step {step + 1}: {time.time() - t0:.1f}s")
    ivc.verify(strict=True)
    print(f"trivial IVC: {steps} steps verified OK")
    return ivc


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--k", type=int, default=17)
    ap.add_argument("--arity", type=int, default=8)
    ap.add_argument("--real-ck", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args()
    run(args.steps, args.k, not args.real_ck, args.arity, args.device)
