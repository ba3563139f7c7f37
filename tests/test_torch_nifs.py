"""The slice as a whole at small size: tests/test_nifs.py's fold sequence
(two traces folded into a zero accumulator, prove/verify, is_sat_relaxed,
is_sat_perm) run by mira_tpu and by the port on the same circuits, the same
key and the same seeded rng (random.Random(7)); the accumulators must be
equal step for step."""

import random

import numpy as np
import pytest
import torch

from mira_tpu.curves.host import BN254_G1, AffinePoint
from mira_tpu.fields.params import BN254_FQ
from mira_tpu.nifs.vanilla import VanillaFS as MiraFS
from mira_tpu.ops.commitment import CommitmentKey as MiraKey
from mira_tpu.ops.poseidon import create_ro
from mira_tpu.plonk import structure as ms
from mira_tpu.table.runner import CircuitRunner as MiraRunner
from mira_tpu_torch.convert import limbs16_to_words, relaxed_trace_from_mira
from mira_tpu_torch.nifs.vanilla import VanillaFS
from mira_tpu_torch.ops.commitment import CommitmentKey
from mira_tpu_torch.plonk import structure as ts
from mira_tpu_torch.table.runner import CircuitRunner

from test_nifs import K, FiboCircuit, MulCircuit, TwoGateCircuit
from torch_port_helpers import relaxed_trace_to_mira

CIRCUITS = [MulCircuit, TwoGateCircuit, FiboCircuit]


def ro():
    return create_ro(BN254_FQ)


def _setup(circuit_cls, seed):
    m_runner = MiraRunner(K, circuit_cls(seed), [], BN254_G1)
    t_runner = CircuitRunner(K, circuit_cls(seed), [], BN254_G1)
    ck_m = MiraKey.setup(BN254_G1, K + 2, b"test")
    ck_t = CommitmentKey(BN254_G1, ck_m._limbs)
    return (m_runner.collect_structure(), t_runner.collect_structure(),
            m_runner.collect_witness(), ck_m, ck_t)


def _same_instance(t, m):
    """Field-by-field equality of a port PlonkInstance and mira_tpu's."""
    for name in ("W_commitments", "instance", "challenges", "g1_elements",
                 "g2_elements"):
        assert getattr(t, name) == getattr(m, name), name


def _same_witness(tW, mW):
    assert len(tW) == len(mW)
    for a, b in zip(tW, mW):
        assert torch.equal(a, limbs16_to_words(np.asarray(b)))


def _same_relaxed(t, m):
    assert t.U == m.U  # commitments, E commitment, instance, challenges, u,
    _same_witness(t.W.W, m.W.W)  # group elements, Gt element
    assert torch.equal(t.W.E, limbs16_to_words(np.asarray(m.W.E)))


@pytest.mark.parametrize("circuit_cls", CIRCUITS)
def test_sps_and_is_sat(circuit_cls):
    S_m, S_t, advice, ck_m, ck_t = _setup(circuit_cls, 0)
    tr_t = S_t.run_sps_protocol(ck_t, [], advice, ro())
    tr_m = S_m.run_sps_protocol(ck_m, [], advice, ro())
    _same_instance(tr_t.u, tr_m.u)
    _same_witness(tr_t.w.W, tr_m.w.W)
    S_t.is_sat(ck_t, ro(), tr_t.u, tr_t.w)
    bad = [list(col) for col in advice]
    bad[-1][0] = (bad[-1][0] + 1) % S_t.modulus
    bad_trace = S_t.run_sps_protocol(ck_t, [], bad, ro())
    with pytest.raises(ts.SatError):
        S_t.is_sat(ck_t, ro(), bad_trace.u, bad_trace.w)


@pytest.mark.parametrize("circuit_cls", CIRCUITS)
def test_fold_two_steps_matches_mira(circuit_cls):
    S_m, S_t, advice1, ck_m, ck_t = _setup(circuit_cls, 1)
    advice2 = MiraRunner(K, circuit_cls(2), [], BN254_G1).collect_witness()
    G = AffinePoint.generator(BN254_G1)
    pp_m, vp = MiraFS.setup_params(G, S_m)
    pp_t, _ = VanillaFS.setup_params(G, S_t)

    traces = []
    for adv in (advice1, advice2):
        tm = MiraFS.generate_plonk_trace(ck_m, [], adv, pp_m, ro())
        tt = VanillaFS.generate_plonk_trace(ck_t, [], adv, pp_t, ro())
        _same_instance(tt.u, tm.u)
        _same_witness(tt.w.W, tm.w.W)
        traces.append((tt, tm))

    acc_m = ms.RelaxedPlonkTrace(
        ms.RelaxedPlonkInstance.new(S_m.curve, S_m.num_io, S_m.num_challenges,
                                    len(S_m.round_sizes), 0, 0),
        ms.RelaxedPlonkWitness.zeros(S_m.lf, S_m.k, S_m.round_sizes))
    acc_t = relaxed_trace_from_mira(acc_m)
    _same_relaxed(acc_t, acc_m)
    S_t.is_sat_relaxed(ck_t, acc_t.U, acc_t.W)

    rng_m, rng_t = random.Random(7), random.Random(7)
    for tt, tm in traces:
        prev_t, prev_m = acc_t, acc_m
        acc_m, proof_m = MiraFS.prove(ck_m, pp_m, ro(), acc_m, tm, rng=rng_m)
        acc_t, proof_t = VanillaFS.prove(ck_t, pp_t, ro(), acc_t, tt, rng=rng_t)
        assert proof_t[0] == proof_m[0]  # cross-term commitments
        assert proof_t[1] == proof_m[1]  # Gt cross terms (seeded draws)
        _same_relaxed(acc_t, acc_m)
        S_t.is_sat_relaxed(ck_t, acc_t.U, acc_t.W)
        U_v = VanillaFS.verify(vp, ro(), ro(), prev_t.U, tt.u, proof_t)
        assert U_v == acc_t.U == MiraFS.verify(vp, ro(), ro(), prev_m.U, tm.u,
                                               proof_m)
    S_t.is_sat_perm(acc_t.U, acc_t.W)
    assert rng_t.random() == rng_m.random()
    # the port's accumulator, carried back, passes mira_tpu's decider
    back = relaxed_trace_to_mira(acc_t)
    S_m.is_sat_relaxed(ck_m, back.U, back.W)


def test_cross_terms_match_mira_full_interpolation():
    """assume_sat=False (all d+1 points, full inverse Vandermonde) gives
    mira_tpu's cross-term vectors."""
    S_m, S_t, advice, ck_m, ck_t = _setup(MulCircuit, 3)
    tm = S_m.run_sps_protocol(ck_m, [], advice, ro())
    tt = S_t.run_sps_protocol(ck_t, [], advice, ro())
    acc_m = tm.to_relax(S_m.k)
    acc_t = tt.to_relax(S_t.k)
    ct_m, (g1_m, _) = MiraFS.commit_cross_terms(ck_m, S_m, acc_m.U, acc_m.W,
                                                tm.u, tm.w, assume_sat=False)
    ct_t, (g1_t, _) = VanillaFS.commit_cross_terms(ck_t, S_t, acc_t.U, acc_t.W,
                                                   tt.u, tt.w, assume_sat=False)
    assert g1_t == g1_m
    for a, b in zip(ct_t, ct_m):
        assert torch.equal(a, limbs16_to_words(np.asarray(b)))
