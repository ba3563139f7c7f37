"""Runs of the command on the CPU: each cell's path at a tiny size (the
poseidon-k17 configuration with the program's mock keys, one fold step) in
a process whose sys.meta_path blocks JAX and the JAX package, printing the
contract's last line; every fault the cells can have making `correct`
false; the command refusing to run without a card or without the program.
The control at each cell's own size runs on the card (marked `cuda`).

The cells' other faults do not exist here: a batch (half left out) and an
exchange between chips.  Each CPU run takes one to three minutes."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from harness.cell import BENCH

ROOT = os.path.dirname(BENCH)
DATA = os.path.join(BENCH, "tests", "data")
TINY = ["--manifest", os.path.join(DATA, "BENCHMARK.json"), "--data", DATA, "--device", "cpu"]
BLOCKING = """
import runpy, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'mira_tpu'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
sys.argv = ['benchmark/run.py'] + sys.argv[1:]
runpy.run_path('benchmark/run.py', run_name='__main__')
"""


def run(args, cwd=ROOT, timeout=900):
    p = subprocess.run([sys.executable, "-c", BLOCKING, *args], cwd=cwd, capture_output=True,
                       text=True, timeout=timeout)
    lines = [x for x in p.stdout.splitlines() if x.strip()]
    result = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    return p, result


def check_line(result, stderr):
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "compared"
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    compared = result["compared"]
    tail = stderr.strip().splitlines()[-len(compared):]
    assert all(line.startswith("compared ") for line in tail)
    assert all(v["limit"] == 0 for v in compared.values())


DECIDED = ["structure", "steps", "z_values", "io_hashes", "sps_challenges", "gate_rows",
           "copy_rows", "lookup_sums", "commitments"]


@pytest.mark.parametrize("cell,metrics,compared", [
    ("tiny.steady", {"setup_s", "step_s", "step_p90_s"}, DECIDED),
    ("tiny.proofs", {"setup_s", "proof_s"}, ["proof_z_values", "proofs_refused", *DECIDED]),
])
def test_a_tiny_cell_runs_end_to_end_without_jax(cell, metrics, compared):
    p, result = run(["--workload", cell, "--seed", "3147483901", "--seconds", "0.001",
                     "--trace", "0", *TINY])
    assert p.returncode == 0, p.stderr[-3000:]
    check_line(result, p.stderr)
    assert result["correct"] is True, result["compared"]
    assert list(result["compared"]) == compared
    assert set(result["metrics"]) == metrics
    assert result["attempted"] == 1 and result["failed"] == 0
    assert all(m["value"] > 0 for m in result["metrics"].values())


@pytest.mark.parametrize("fault,caught", [
    ("drop_cross_term", "gate_rows"),  # the control: T_1 left out of E
    ("unchanged_step", "z_values"),  # a step that returns its state unchanged
    ("altered_answer", "gate_rows"),  # one word of E altered where it is made
    ("altered_z", "z_values"),  # the step's output altered where it is made
])
def test_every_fault_makes_correct_false(fault, caught):
    p, result = run(["--workload", "tiny.steady", "--seed", "3147483902", "--seconds", "0.001",
                     "--trace", "0", "--fault", fault, *TINY])
    assert p.returncode == 0, p.stderr[-3000:]
    check_line(result, p.stderr)
    assert result["correct"] is False
    assert result["compared"][caught]["value"] > 0


@pytest.mark.slow
@pytest.mark.parametrize("fault,caught", [
    ("none", None),
    ("altered_gt", "gt_accumulator"),  # the folded Gt element times a Gt element
])
def test_the_snarkstar_cell_runs_on_the_cpu(fault, caught):
    """snarkstar-b1 with the program's mock keys, one fold step at k=19
    (some twenty minutes a run on the CPU)."""
    p, result = run(["--workload", "tiny.snarkstar", "--seed", "3147483903", "--seconds", "0.001",
                     "--trace", "0", "--fault", fault, *TINY], timeout=3600)
    assert p.returncode == 0, p.stderr[-3000:]
    check_line(result, p.stderr)
    assert list(result["compared"]) == [*DECIDED, "gt_accumulator", "groth16_proofs"]
    if caught is None:
        assert result["correct"] is True, result["compared"]
    else:
        assert result["correct"] is False
        assert result["compared"][caught]["value"] > 0


def test_no_card_no_result():
    p, result = run(["--workload", "poseidon-k17.steady", "--seed", "1", "--seconds", "1",
                     "--trace", "0"], timeout=300)
    if p.returncode == 0:
        pytest.skip("a card is visible")
    assert result is None and not p.stdout.strip()


def test_no_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".build", "__pycache__"))
    p, result = run(["--workload", "poseidon-k17.steady", "--seed", "1", "--seconds", "1",
                     "--trace", "0", "--device", "cpu"], cwd=str(tmp_path), timeout=300)
    assert p.returncode != 0 and result is None and not p.stdout.strip()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault,caught", [
    ("poseidon-k17.steady", "drop_cross_term", "gate_rows"),
    ("poseidon-k17.proofs2", "drop_cross_term", "gate_rows"),
    ("snarkstar-b1.steady", "drop_cross_term", "gate_rows"),
    ("snarkstar-b1.steady", "altered_gt", "gt_accumulator"),
])
@pytest.mark.parametrize("seed", [2147483801, 2147483802, 2147483803])
def test_the_control_fails_at_the_cells_size(card, cell, fault, caught, seed):
    """The control (harness/runner.py Faults, `drop_cross_term`): the fold's
    E leaves out its first cross term, a fold that breaks the configuration's
    exact-folding guarantee; at the cell's own size it must read as not
    correct.  SnarkStar's Gt accumulator altered after a fold (`altered_gt`)
    must read so too."""
    p, result = run(["--workload", cell, "--seed", str(seed), "--seconds", "10", "--trace", "0",
                     "--fault", fault], timeout=1800)
    assert p.returncode == 0, p.stderr[-3000:]
    assert result["correct"] is False
    assert result["compared"][caught]["value"] > 0
