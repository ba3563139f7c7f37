"""Seconds of the k=17 IVC's fold steps alone, on one NVIDIA GPU:

    python3 mira_tpu_torch/bench/k17_steps.py [--root TREE] [--steps N]

chip_smoke.py's main path with nothing beside it: real keys of 2^21
points per curve (made by the native keygen, kept in .cache/ck under the
working directory), the public parameters of the Poseidon/trivial
two-curve IVC at k=17, its zero step and N fold steps, each timed to
`torch.cuda.synchronize()`, then verify(strict=True).  `--root` imports
mira_tpu_torch from another checkout (a parent commit unpacked with `git
archive`), so that two trees are timed by this one script, each run in its
own process, in turns (parent, change, change, parent), with the keys
made once for both.  Prints one JSON line: the tree, the card's name and
power limit, the build, keys, public parameters and zero step seconds, the
step seconds and the median of the steps after the first.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

K = 17


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--root", default=os.path.join(here, "..", ".."),
                    help="the checkout whose mira_tpu_torch is timed")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("k17_steps: no CUDA device visible", file=sys.stderr)
        return 2
    import mira_tpu_torch
    from mira_tpu_torch import _build

    if not os.path.abspath(mira_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"mira_tpu_torch imported from {mira_tpu_torch.__file__}, "
                           f"not from {root}")
    from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN
    from mira_tpu_torch.ivc.ivc import IVC
    from mira_tpu_torch.ivc.public_params import CircuitSide, PublicParams
    from mira_tpu_torch.ivc.step_circuit import TrivialCircuit
    from mira_tpu_torch.ops.commitment import CommitmentKey
    from mira_tpu_torch.workloads.poseidon import PoseidonStepCircuit

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    secs = {}
    t0 = time.perf_counter()
    _build.lib()
    secs["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck1 = CommitmentKey.load_or_setup_cache(BN254_G1, K + 4, "bn256", device=dev)
    ck2 = CommitmentKey.load_or_setup_cache(GRUMPKIN, K + 4, "grumpkin", device=dev)
    secs["keys"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sc1 = PoseidonStepCircuit(BN254_G1.scalar_modulus, 1)
    sc2 = TrivialCircuit(arity=1)
    pp = PublicParams(CircuitSide(sc1, ck1, K), CircuitSide(sc2, ck2, K),
                      BN254_G1, GRUMPKIN)
    secs["public_params"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ivc = IVC(pp, sc1, [0], sc2, [0])
    torch.cuda.synchronize()
    secs["zero_step"] = time.perf_counter() - t0
    steps = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        ivc.fold_step()
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    ivc.verify(strict=True)
    secs["verify"] = time.perf_counter() - t0
    print(json.dumps({"root": root, "card": card, "secs": secs, "steps": steps,
                      "steady_median": statistics.median(steps[1:] or steps)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
