"""TensorStar: zkml program-counter folding, Mira's pairing-based zkml
accumulation workload (port of mira_tpu/workloads/tensorstar.py; reference
examples/zkml/).

The primary step circuit is a program-counter update over the Merkle tree
(zkml/circuit.rs `ProgramCounterUpdateCircuit`: the merkle workload's chip
stack, driven by deterministic updates derived from the model inputs
instead of random leaves; zkml/main.rs:104-138 converts the inputs and
indexes them as (batch_idx*len*2 + proof_idx*2 + j)).  The SECONDARY side
carries the zkml pairing instance shape: num_g1=23, num_g2=2, gt_degree=3,
gt_cross_terms=12 (zkml/main.rs:183-190), so the primary step-folding
circuit runs Mira's fold_g1/fold_g2/fold_gt at the zkml proof dimensions.
Its primary circuit needs 2^22 rows: k = 22 is the ladder's smallest size.

As with SnarkStar, the reference's SPS fills the g1/g2/gt element slots
with random placeholders; real proof ingestion is a recorded gap on both
sides.  `run` prints the device memory in use and its peak after the zero
step and after each fold step (the reference read the TPU's HBM there).

    python -m mira_tpu_torch.workloads.tensorstar --repeat-count 1 \\
        --matrix-dim 32 --device cuda
"""

from __future__ import annotations

import time


def table_sizes(matrix_dim: int):
    """(k1, k2) ladder (zkml/main.rs:41-57); 0 = the no-pairing baseline."""
    if matrix_dim == 0:
        return (23, 23)
    if matrix_dim in (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192):
        return (22, 22)
    raise ValueError(f"invalid matrix dim {matrix_dim}")


def ck_sizes(matrix_dim: int):
    """(ck1, ck2) ladder (zkml/main.rs:60-77)."""
    if matrix_dim == 0:
        return (27, 26)
    if matrix_dim in (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192):
        return (26, 25)
    raise ValueError(f"invalid matrix dim {matrix_dim}")


def program_counter_updates(repeat_count: int, inputs, modulus: int):
    """zkml/main.rs:104-138: (repeat_count+1) batches of the converted model
    inputs, flattened with indices batch*len*2 + proof*2 + j."""
    n = len(inputs)
    return [
        [((i * n + j) % (1 << 31), inputs[j] % modulus) for j in range(n)]
        for i in range(repeat_count + 1)
    ]


def _memory(device, tag: str) -> int:
    """Print the device memory in use and its peak; returns the peak."""
    import torch

    if torch.device(device).type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    used = torch.cuda.memory_allocated(device)
    peak = torch.cuda.max_memory_allocated(device)
    print(f"device memory [{tag}]: {used / 2**30:.3f} GiB in use, peak "
          f"{peak / 2**30:.3f} GiB", flush=True)
    return peak


def run(repeat_count: int = 1, matrix_dim: int = 32, baseline: bool = False,
        use_mock_ck: bool = True, k_override: int | None = None,
        debug_mode: bool = False, device="cuda") -> dict:
    """Fold `repeat_count` TensorStar steps on `device` and verify the
    accumulators (strict).  Returns the seconds of each phase: "keys",
    "public_params", "zero_step", "fold_steps" (a list, each step timed to
    the device's end) and "verify"; "peak_bytes", the peak device memory
    over the run (0 on the CPU); and under "ivc" the verified IVC."""
    from ..curves.host import BN254_G1, GRUMPKIN
    from ..ivc.ivc import IVC
    from ..ivc.public_params import CircuitSide, PublicParams
    from ..ivc.step_circuit import TrivialCircuit
    from ..ops.commitment import CommitmentKey
    from ..ops.mock_commitment import MockCommitmentKey
    from .merkle import MerkleTreeUpdateCircuit
    from .snarkstar import _sync

    secs = {}
    size_param = 0 if baseline else matrix_dim
    k1, k2 = (k_override, k_override) if k_override else table_sizes(size_param)
    ckk1, ckk2 = (k1 + 4, k2 + 4) if k_override else ck_sizes(size_param)

    p_mod = BN254_G1.scalar_modulus
    # model inputs: [1, 1] (zkml/main.rs:128: Fr::one() twice)
    updates = program_counter_updates(repeat_count, [1, 1], p_mod)

    sc1 = MerkleTreeUpdateCircuit(p_mod, batch_size=1)
    for batch in updates:
        sc1.update_leaves(batch)
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

    t0 = time.perf_counter()
    pp = PublicParams(
        CircuitSide(sc1, ck1, k1),
        CircuitSide(
            sc2, ck2, k2,
            num_g1=23,
            num_g2=2,
            gt_degree=3,
            gt_cross_terms=12,
        ) if not baseline else CircuitSide(sc2, ck2, k2),
        BN254_G1,
        GRUMPKIN,
    )
    _sync(device)
    secs["public_params"] = time.perf_counter() - t0
    print(f"public params: {secs['public_params']:.1f} s", flush=True)

    z0 = [sc1.front_proof_batch()[0].root().old]
    t0 = time.perf_counter()
    ivc = IVC(pp, sc1, z0, sc2, [0], debug_mode=debug_mode)
    _sync(device)
    secs["zero_step"] = time.perf_counter() - t0
    print(f"ivc zero step: {secs['zero_step']:.1f} s", flush=True)
    _memory(device, "after the zero step")
    secs["fold_steps"] = []
    for step in range(repeat_count):
        sc1.pop_front_proof_batch()
        t0 = time.perf_counter()
        ivc.fold_step()
        _sync(device)
        secs["fold_steps"].append(time.perf_counter() - t0)
        print(f"fold step {step + 1}: {secs['fold_steps'][-1]:.3f} s", flush=True)
        _memory(device, f"after fold step {step + 1}")
    if not use_mock_ck:
        for ck in (ck1, ck2):
            ck.release_device_cache()
    t0 = time.perf_counter()
    ivc.verify(strict=True)
    _sync(device)
    secs["verify"] = time.perf_counter() - t0
    secs["peak_bytes"] = _memory(device, "after verify")
    print(f"TensorStar: {repeat_count} steps (matrix_dim {matrix_dim}"
          f"{', baseline' if baseline else ''}) verified OK; verify "
          f"{secs['verify']:.1f} s")
    secs["ivc"] = ivc
    return secs


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="TensorStar IVC on the port")
    ap.add_argument("--repeat-count", type=int, default=1)
    ap.add_argument("--matrix-dim", type=int, default=32)
    ap.add_argument("--baseline", action="store_true")
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--real-ck", action="store_true")
    ap.add_argument("--debug-mode", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args()
    run(args.repeat_count, args.matrix_dim, args.baseline, not args.real_ck,
        args.k, args.debug_mode, args.device)
