"""ProtoGalaxy on the port (mira_tpu_torch/nifs/protogalaxy.py) on the CPU:
the five cases of tests/test_protogalaxy.py, and `prove`/`verify` through
both packages on the same circuits, key and transcripts (K = 4, the TwoGate
circuit, one and three incoming traces): the same poly_F, poly_K, betas, e and
folded instance and witness, the accumulator and proof carried across in
both directions, a nonzero F through both packages at delta = 0 (where the
two definitions of compute_F coincide), and a second fold onto the result,
where the port keeps the accumulator relation that mira_tpu's compute_F
loses.  Exact equality."""

import random

import numpy as np
import pytest
import torch

from mira_tpu.curves.host import BN254_G1 as MIRA_BN254_G1
from mira_tpu.curves.host import AffinePoint as MiraPoint
from mira_tpu.nifs.protogalaxy import ProtoGalaxy as MiraPG
from mira_tpu.ops.commitment import CommitmentKey as MiraKey
from mira_tpu.ops.poseidon import create_ro as mira_ro
from mira_tpu.table.runner import CircuitRunner as MiraRunner
from mira_tpu_torch.convert import (
    accumulator_from_mira,
    limbs16_to_words,
    proof_from_mira,
)
from mira_tpu_torch.curves.host import BN254_G1, AffinePoint
from mira_tpu_torch.fields.params import BN254_FQ, BN254_FR
from mira_tpu_torch.nifs.protogalaxy import ProtoGalaxy
from mira_tpu_torch.ops.commitment import CommitmentKey
from mira_tpu_torch.ops.poseidon import create_ro
from mira_tpu_torch.polynomial.univariate import (
    eval_lagrange_polys_for_cyclic_group,
)
from mira_tpu_torch.table.runner import CircuitRunner

from test_protogalaxy import K, TwoGate
from torch_port_helpers import (
    accumulator_to_mira,
    proof_to_mira,
    relaxed_trace_to_mira,
    same,
)


def make_trace(seed, ro=None):
    runner = CircuitRunner(K, TwoGate(seed), [], BN254_G1)
    S = runner.collect_structure()
    ck = CommitmentKey.setup(BN254_G1, K + 2, b"pg", device="cpu")
    trace = S.run_sps_protocol(ck, [], runner.collect_witness(),
                               ro or create_ro(BN254_FQ))
    return S, ck, trace


def test_lagrange_parity_vector():
    """Hard-coded Fr values from reference lagrange.rs basic_lagrange_test."""
    got = eval_lagrange_polys_for_cyclic_group(BN254_FR, 2, 2)
    assert got == [
        5472060717959818805561601436314318772137091100104008585924551046643952123908,
        5472060717959818798949719980869953008325120142272090480018905346516323946831,
        5472060717959818805561601436314318772137091100104008585924551046643952123903,
        5472060717959818812173482891758684535949062057935926691830196746771580300976,
    ]


def test_zero_f_for_satisfied_trace():
    S, ck, trace = make_trace(0)
    rng = random.Random(1)
    betas = [rng.randrange(BN254_FR) for _ in range(20)]
    delta = rng.randrange(BN254_FR)
    poly = ProtoGalaxy.compute_F(betas, delta, S, trace.to_relax(S.k))
    assert all(c == 0 for c in poly)


def test_nonzero_f_for_garbage_trace():
    S, ck, trace = make_trace(0)
    rng = random.Random(2)
    rel = trace.to_relax(S.k)
    rel.W.W = [S.lf.encode([rng.randrange(BN254_FR) for _ in range(w.shape[0])])
               for w in rel.W.W]
    betas = [rng.randrange(BN254_FR) for _ in range(20)]
    poly = ProtoGalaxy.compute_F(betas, rng.randrange(BN254_FR), S, rel)
    assert any(c != 0 for c in poly)


@pytest.mark.parametrize("which", ["garbage", "folded"])
def test_nonzero_f_matches_mira_at_delta_zero(which):
    """A nonzero F through both packages.  At delta = 0 the port's per-level
    doubling of delta and mira_tpu's single delta give the same challenges,
    so the coefficients must agree exactly: on a garbage witness, and on the
    accumulator of a first fold (whose F(betas', 0) is the constant e')."""
    rng = random.Random(6)
    S, ck, trace = make_trace(4)
    S_m = MiraRunner(K, TwoGate(4), [], MIRA_BN254_G1).collect_structure()
    if which == "garbage":
        rel = trace.to_relax(S.k)
        rel.W.W = [S.lf.encode([rng.randrange(BN254_FR) for _ in range(w.shape[0])])
                   for w in rel.W.W]
        betas = [rng.randrange(BN254_FR) for _ in range(20)]
    else:
        pp, _ = ProtoGalaxy.setup_params(AffinePoint.generator(BN254_G1), S)
        acc = ProtoGalaxy.new_accumulator(S, pp, create_ro(BN254_FQ), "cpu")
        new_acc, _ = ProtoGalaxy.prove(ck, pp, create_ro(BN254_FQ), acc,
                                       [trace, make_trace(5)[2], make_trace(6)[2]])
        rel, betas = new_acc.trace, new_acc.betas
    mine = ProtoGalaxy.compute_F(betas, 0, S, rel)
    theirs = MiraPG.compute_F(betas, 0, S_m, relaxed_trace_to_mira(rel))
    assert any(c != 0 for c in mine)
    assert list(mine.coeffs) == list(theirs.coeffs)


def test_prove_rejects_two_traces():
    """L + 1 must be a power of two: two incoming traces raise before any
    transcript is touched."""
    S, ck, trace = make_trace(4)
    pp, _ = ProtoGalaxy.setup_params(AffinePoint.generator(BN254_G1), S)
    acc = ProtoGalaxy.new_accumulator(S, pp, create_ro(BN254_FQ), "cpu")
    with pytest.raises(ValueError, match="power of two"):
        ProtoGalaxy.prove(ck, pp, create_ro(BN254_FQ), acc,
                          [trace, make_trace(5)[2]])


def test_zero_g_for_satisfied_traces():
    S, ck, trace = make_trace(0)
    rng = random.Random(3)
    betas = [rng.randrange(BN254_FR) for _ in range(20)]
    poly = ProtoGalaxy.compute_G(S, betas, trace.to_relax(S.k), [trace])
    assert all(c == 0 for c in poly)


def test_prove_fold_and_verify_instance_match():
    """Full PG prove over one incoming trace: accumulator updates, and the
    verifier's instance-side fold matches the prover's."""
    S, ck, trace1 = make_trace(4)
    pp, vp = ProtoGalaxy.setup_params(AffinePoint.generator(BN254_G1), S)
    acc = ProtoGalaxy.new_accumulator(S, pp, create_ro(BN254_FQ), "cpu")
    new_acc, proof = ProtoGalaxy.prove(ck, pp, create_ro(BN254_FQ), acc, [trace1])
    betas_v, e_v, U_v = ProtoGalaxy.verify(
        vp, create_ro(BN254_FQ), create_ro(BN254_FQ), acc, [trace1.u], proof)
    assert betas_v == new_acc.betas
    assert e_v == new_acc.e
    assert U_v == new_acc.trace.U
    # F(X) with delta = 0 is the constant sum_i pow_i(betas') * f_i = e
    evals_poly = ProtoGalaxy.compute_F(new_acc.betas, 0, S, new_acc.trace)
    assert evals_poly.eval(0) == new_acc.e


def _same_accumulator(mine, theirs):
    assert mine.betas == list(theirs.betas) and mine.e == theirs.e
    assert same(mine.trace.U, theirs.trace.U)
    for a, b in zip(mine.trace.W.W, theirs.trace.W.W):
        assert torch.equal(a, limbs16_to_words(np.asarray(b)))
    assert torch.equal(mine.trace.W.E, limbs16_to_words(np.asarray(theirs.trace.W.E)))


@pytest.mark.parametrize("incoming", [1, 3], ids=["one-trace", "three-traces"])
def test_prove_and_verify_match_mira(incoming):
    """The same seeds through both packages.  The traces share one running
    NARK transcript, which the verifier replays in the same order."""
    seeds = [4, 5, 6][:incoming]
    ro_t, ro_m = create_ro(BN254_FQ), mira_ro(BN254_FQ)
    S, ck, _ = make_trace(seeds[0])
    traces = [make_trace(s, ro_t)[2] for s in seeds]
    m_runners = [MiraRunner(K, TwoGate(s), [], MIRA_BN254_G1) for s in seeds]
    S_m = m_runners[0].collect_structure()
    ck_m = MiraKey.setup(MIRA_BN254_G1, K + 2, b"pg")
    traces_m = [S_m.run_sps_protocol(ck_m, [], r.collect_witness(), ro_m)
                for r in m_runners]
    assert same([t.u for t in traces], [t.u for t in traces_m])

    pp, vp = ProtoGalaxy.setup_params(AffinePoint.generator(BN254_G1), S)
    pp_m, vp_m = MiraPG.setup_params(MiraPoint.generator(MIRA_BN254_G1), S_m)
    acc = ProtoGalaxy.new_accumulator(S, pp, create_ro(BN254_FQ), "cpu")
    acc_m = MiraPG.new_accumulator(S_m, pp_m, mira_ro(BN254_FQ))
    _same_accumulator(acc, acc_m)

    new_acc, proof = ProtoGalaxy.prove(ck, pp, create_ro(BN254_FQ), acc, traces)
    new_acc_m, proof_m = MiraPG.prove(ck_m, pp_m, mira_ro(BN254_FQ), acc_m, traces_m)
    assert proof.poly_F.coeffs == proof_m.poly_F.coeffs
    assert proof.poly_K.coeffs == proof_m.poly_K.coeffs
    assert any(c != 0 for c in proof.poly_K.coeffs) or incoming == 1
    _same_accumulator(new_acc, new_acc_m)

    betas_v, e_v, U_v = ProtoGalaxy.verify(
        vp, create_ro(BN254_FQ), create_ro(BN254_FQ), acc, [t.u for t in traces],
        proof)
    assert (betas_v, e_v) == (new_acc.betas, new_acc.e) and U_v == new_acc.trace.U
    betas_m, e_m, U_m = MiraPG.verify(
        vp_m, mira_ro(BN254_FQ), mira_ro(BN254_FQ), acc_m,
        [t.u for t in traces_m], proof_m)
    assert (betas_v, e_v) == (betas_m, e_m) and same(U_v, U_m)
    assert ProtoGalaxy.compute_F(new_acc.betas, 0, S, new_acc.trace).eval(0) == new_acc.e

    # carried across: mira_tpu's accumulator and proof as the port's, and the
    # port's as mira_tpu's, give the same next fold and pass the other's
    # verifier
    carried = accumulator_from_mira(new_acc_m)
    _same_accumulator(carried, new_acc_m)
    assert same(proof_from_mira(proof_m), proof)
    betas_c, e_c, U_c = MiraPG.verify(
        vp_m, mira_ro(BN254_FQ), mira_ro(BN254_FQ), acc_m,
        [t.u for t in traces_m], proof_to_mira(proof))
    assert (betas_c, e_c) == (betas_m, e_m) and same(U_c, U_m)
    _same_accumulator(new_acc, accumulator_to_mira(new_acc))

    # a second fold, onto the folded accumulator: the port keeps the
    # accumulator relation and the verifier still agrees.  mira_tpu's own
    # second fold loses the relation (its compute_F does not double delta per
    # level as its betas_stroke does), which is why the port's compute_F
    # differs from it there and only there
    again, proof2 = ProtoGalaxy.prove(ck, pp, create_ro(BN254_FQ), carried, traces)
    assert any(c != 0 for c in proof2.poly_F.coeffs)
    assert ProtoGalaxy.compute_F(again.betas, 0, S, again.trace).eval(0) == again.e
    betas_2, e_2, U_2 = ProtoGalaxy.verify(
        vp, create_ro(BN254_FQ), create_ro(BN254_FQ), carried,
        [t.u for t in traces], proof2)
    assert (betas_2, e_2) == (again.betas, again.e) and U_2 == again.trace.U
    again_m, _ = MiraPG.prove(ck_m, pp_m, mira_ro(BN254_FQ), new_acc_m, traces_m)
    assert MiraPG.compute_F(again_m.betas, 0, S_m, again_m.trace).eval(0) != again_m.e
