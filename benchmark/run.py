"""The benchmark of mira_tpu_torch, the PyTorch and CUDA port: one run of
one cell.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

The checkout is the directory above benchmark/. BENCHMARK.json names the
cells; a cell's configuration, traffic mix, reference and metric readers
are files under benchmark/ found by name (harness/cell.py). The run
loads the program and its keys, warms up the cell's shapes, measures
whole units of work for S seconds, judges what the timed path produced
against the plain reference (benchmark/reference/), and prints one JSON
line last on standard output: with --trace 0 the cell's end-to-end
metrics, with --trace 1 its per-layer ones and the device's busy and
window seconds. It exits with another code than 0, and prints no result,
without enough CUDA devices or where JAX or the JAX package (mira_tpu)
got loaded.

Extra options, for the control and fault runs only: --fault NAME plants a
fault in the program (harness/runner.py Faults); --device cpu runs the
plain versions on the CPU (the CPU tests); --manifest and --data point at
other manifests and data directories.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def environment(root: str, trace: bool):
    """Caches at fixed paths inside the checkout; no JAX through transformers;
    spans off for the end-to-end runs, fenced for the traced ones."""
    cache = os.path.join(root, ".cache", "bench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["MIRA_TRACE"] = "collect" if trace else "off"
    os.environ["MIRA_SYNC_SPANS"] = "1" if trace else "0"
    os.environ.pop("MIRA_FOLD_EVAL", None)
    os.environ.pop("MIRA_DEBUG_SAT", None)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default="none")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--manifest", default=None)
    ap.add_argument("--data", action="append", default=[])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    environment(ROOT, bool(args.trace))
    sys.path.insert(0, BENCH)
    sys.path.insert(0, ROOT)
    from harness import guard

    guard.install()
    from harness import runner

    code, _ = runner.run(args, ROOT, T_START, data_dirs=args.data)
    return code


if __name__ == "__main__":
    sys.exit(main())
