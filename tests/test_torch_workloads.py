"""The port's workloads against mira_tpu's: TensorStar's ladders and
program-counter updates over its whole ladder; one fold at TensorStar's
secondary-side shape (23 G1, 2 G2, Gt degree 3, 12 Gt cross terms) through
both packages under the same seeded structural rng; the program-counter
updates through the Merkle circuit of both packages; and the workload CLIs'
flags.  The CLIs' k=17 IVC runs are behind `slow`."""

import random
import subprocess
import sys

import pytest

from mira_tpu.curves.host import GRUMPKIN as MIRA_GRUMPKIN
from mira_tpu.curves.host import AffinePoint as MiraPoint
from mira_tpu.nifs.vanilla import VanillaFS as MiraFS
from mira_tpu.ops.commitment import CommitmentKey as MiraKey
from mira_tpu.ops.poseidon import create_ro
from mira_tpu.plonk import structure as ms
from mira_tpu.table.runner import CircuitRunner as MiraRunner
from mira_tpu.workloads import cli as mira_cli
from mira_tpu.workloads import tensorstar as mira_ts
from mira_tpu_torch.convert import relaxed_trace_from_mira
from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN, AffinePoint
from mira_tpu_torch.nifs.vanilla import VanillaFS
from mira_tpu_torch.ops import poseidon as port_poseidon
from mira_tpu_torch.ops.commitment import CommitmentKey
from mira_tpu_torch.table.runner import CircuitRunner
from mira_tpu_torch.workloads import cli, tensorstar

from test_nifs import K, MulCircuit
from test_torch_checkpoint import SHAPE
from test_torch_nifs import _same_relaxed
from torch_port_helpers import same

LADDER = [0, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192]


@pytest.mark.parametrize("dim", LADDER + [1, 33, 16384])
def test_tensorstar_ladders_match_mira(dim):
    for fn in ("table_sizes", "ck_sizes"):
        if dim in LADDER:
            assert getattr(tensorstar, fn)(dim) == getattr(mira_ts, fn)(dim)
        else:
            with pytest.raises(ValueError):
                getattr(tensorstar, fn)(dim)
            with pytest.raises(ValueError):
                getattr(mira_ts, fn)(dim)


@pytest.mark.parametrize("repeat_count", [0, 1, 2, 5])
def test_program_counter_updates_match_mira(repeat_count):
    p = BN254_G1.scalar_modulus
    rng = random.Random(repeat_count)
    for inputs in ([1, 1], [rng.randrange(p) for _ in range(3)], [p + 5]):
        got = tensorstar.program_counter_updates(repeat_count, inputs, p)
        assert got == mira_ts.program_counter_updates(repeat_count, inputs, p)
        assert len(got) == repeat_count + 1


def test_program_counter_updates_drive_the_merkle_circuit():
    """The updates of the reference's run ([1, 1] inputs) give the same
    roots through the port's Merkle circuit as through mira_tpu's."""
    from mira_tpu.workloads.merkle import MerkleTreeUpdateCircuit as MiraMerkle
    from mira_tpu_torch.workloads.merkle import MerkleTreeUpdateCircuit

    p = BN254_G1.scalar_modulus
    mine, theirs = MerkleTreeUpdateCircuit(p), MiraMerkle(p)
    for batch in tensorstar.program_counter_updates(2, [1, 1], p):
        assert mine.update_leaves(batch) == theirs.update_leaves(batch)
    assert (mine.front_proof_batch()[0].root().old
            == theirs.front_proof_batch()[0].root().old)


def test_secondary_side_fold_matches_mira():
    """A VanillaFS fold of two traces with TensorStar's secondary-side shape
    over Grumpkin, each package with the same key and seeded rng: the
    cross-term commitments, the 12 Gt cross terms and the accumulators are
    equal after every fold; the port's fold verifies and satisfies its
    relation."""
    shape = (SHAPE["num_g1"], SHAPE["num_g2"], SHAPE["gt_degree"],
             SHAPE["gt_cross_terms"])
    S_m = MiraRunner(K, MulCircuit(4), [], MIRA_GRUMPKIN, *shape).collect_structure()
    S_t = CircuitRunner(K, MulCircuit(4), [], GRUMPKIN, *shape).collect_structure()
    assert S_t.target_group_cross_terms == 12 and S_t.num_g1_elems == 23
    ck_m = MiraKey.setup(MIRA_GRUMPKIN, K + 2, b"ts")
    ck_t = CommitmentKey(GRUMPKIN, ck_m._limbs, device="cpu")
    pp_m, vp_m = MiraFS.setup_params(MiraPoint.generator(MIRA_GRUMPKIN), S_m)
    pp_t, vp_t = VanillaFS.setup_params(AffinePoint.generator(GRUMPKIN), S_t)
    base = GRUMPKIN.base_modulus

    def ro_m():
        return create_ro(base)

    def ro_t():
        return port_poseidon.create_ro(base)

    acc_m = ms.RelaxedPlonkTrace(
        ms.RelaxedPlonkInstance.new(S_m.curve, S_m.num_io, S_m.num_challenges,
                                    len(S_m.round_sizes), *shape[:2]),
        ms.RelaxedPlonkWitness.zeros(S_m.lf, S_m.k, S_m.round_sizes))
    acc_t = relaxed_trace_from_mira(acc_m)
    rng_m, rng_t = random.Random(11), random.Random(11)
    for seed in (5, 6):
        adv = MiraRunner(K, MulCircuit(seed), [], MIRA_GRUMPKIN, *shape).collect_witness()
        sps_m, sps_t = random.Random(seed), random.Random(seed)
        tm = S_m.run_sps_protocol(ck_m, [], adv, ro_m(), rng=sps_m)
        tt = S_t.run_sps_protocol(ck_t, [], adv, ro_t(), rng=sps_t)
        assert same(tt.u, tm.u)
        prev_t, prev_m = acc_t, acc_m
        acc_m, proof_m = MiraFS.prove(ck_m, pp_m, ro_m(), acc_m, tm, rng=rng_m)
        acc_t, proof_t = VanillaFS.prove(ck_t, pp_t, ro_t(), acc_t, tt, rng=rng_t)
        assert same(proof_t[0], proof_m[0])
        assert len(proof_t[1]) == 12 and same(proof_t[1], proof_m[1])
        _same_relaxed(acc_t, acc_m)
        U_v = VanillaFS.verify(vp_t, ro_t(), ro_t(), prev_t.U, tt.u, proof_t)
        assert U_v == acc_t.U
        assert same(U_v, MiraFS.verify(vp_m, ro_m(), ro_m(), prev_m.U, tm.u, proof_m))
    S_t.is_sat_relaxed(ck_t, acc_t.U, acc_t.W)
    assert rng_t.random() == rng_m.random()


@pytest.mark.parametrize("name", ["trivial", "poseidon", "merkle", "groth16"])
def test_cli_builds_mira_circuits(name):
    """cli.build_circuit gives the circuit mira_tpu's CLI builds for the same
    flags: same class name, arity and first step output."""
    argv = ["--primary", name, "--arity", "3", "--steps", "1", "--seed", "4",
            "--device", "cpu"]
    p = BN254_G1.scalar_modulus
    args = _parse(cli, argv)
    mine = cli.build_circuit(name, p, args)
    theirs = mira_cli.build_circuit(name, p, _parse(mira_cli, argv[:-2]))
    assert type(mine).__name__ == type(theirs).__name__
    assert mine.arity == theirs.arity
    z0 = ([mine.front_proof_batch()[0].root().old]
          if name in ("merkle", "groth16") else [7] * mine.arity)
    assert mine.process_step(z0, 17, p) == theirs.process_step(z0, 17, p)


def _parse(module, argv):
    """The namespace `module.main` parses from argv, without running."""
    import argparse

    seen = {}

    class Stop(Exception):
        pass

    orig = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        seen["args"] = orig(self, args, namespace)
        raise Stop

    argparse.ArgumentParser.parse_args = parse
    try:
        module.main(argv)
    except Stop:
        pass
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen["args"]


def test_cli_flags_default_to_the_card_and_reject_unknown_circuits():
    args = _parse(cli, [])
    assert args.device == "cuda" and args.k_table_size == 17
    with pytest.raises(SystemExit):
        cli.main(["--primary", "nope"])


@pytest.mark.parametrize("module", ["trivial", "merkle", "cli", "tensorstar",
                                    "merkle_baseline", "snarkstar", "poseidon"])
def test_workload_entry_points_take_a_device(module):
    """Every workload's command line takes --device."""
    out = subprocess.run(
        [sys.executable, "-m", f"mira_tpu_torch.workloads.{module}", "--help"],
        capture_output=True, text=True, check=True, cwd=_root())
    assert "--device" in out.stdout


def _root():
    import os

    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
@pytest.mark.parametrize("which", ["trivial", "merkle", "cli"])
def test_workload_runs_verify_on_the_cpu(which):
    """Each k=17 workload folds one step on the CPU with mock keys and
    verifies strictly."""
    from mira_tpu_torch.workloads import merkle, trivial

    if which == "trivial":
        ivc = trivial.run(steps=1, k=17, arity=1, device="cpu")
    elif which == "merkle":
        ivc = merkle.run(steps=1, k=17, device="cpu")
    else:
        ivc = cli.main(["--primary", "poseidon", "--secondary", "trivial",
                        "--steps", "1", "--device", "cpu"])
    assert ivc.step == 2


def test_tensorstar_rejects_a_k_its_circuit_does_not_fit():
    """TensorStar's primary circuit needs 2^22 rows: below that the public
    parameters cannot be built (the reference fails the same way)."""
    with pytest.raises(IndexError):
        tensorstar.run(repeat_count=1, k_override=12, device="cpu")
