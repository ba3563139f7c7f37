"""The MIRA_DEBUG_SAT guard of the port's `commit_cross_terms`
(nifs/vanilla.py `_debug_check_assume_sat`): tests/test_nifs.py's
`test_debug_sat_guard` on the port, the accumulator's (W1.E) branch, the
guard's messages against mira_tpu's on the same data, and no extra
evaluation without the knob."""

import random

import pytest

from mira_tpu.curves.host import BN254_G1 as MIRA_BN254_G1
from mira_tpu.nifs import vanilla as mira_vanilla
from mira_tpu.table.runner import CircuitRunner as MiraRunner
from mira_tpu_torch.curves.host import BN254_G1, AffinePoint
from mira_tpu_torch.fields.params import BN254_FQ
from mira_tpu_torch.nifs.vanilla import VanillaFS
from mira_tpu_torch.ops.commitment import CommitmentKey
from mira_tpu_torch.ops.poseidon import create_ro
from mira_tpu_torch.plonk import structure as ts
from mira_tpu_torch.polynomial.fold_evaluator import FoldEvaluator
from mira_tpu_torch.table.runner import CircuitRunner

from test_nifs import K, MulCircuit
from torch_port_helpers import (
    plonk_trace_to_mira,
    relaxed_trace_to_mira,
    tamper_word,
)


def ro():
    return create_ro(BN254_FQ)


def _setup():
    runner = CircuitRunner(K, MulCircuit(3), [], BN254_G1)
    S = runner.collect_structure()
    ck = CommitmentKey.setup(BN254_G1, K + 2, b"test", device="cpu")
    pp, _ = VanillaFS.setup_params(AffinePoint.generator(BN254_G1), S)
    acc = ts.RelaxedPlonkTrace(
        ts.RelaxedPlonkInstance.new(S.curve, S.num_io, S.num_challenges,
                                    len(S.round_sizes), S.num_g1_elems,
                                    S.num_g2_elems),
        ts.RelaxedPlonkWitness.zeros(S.lf, S.k, S.round_sizes))
    return S, ck, pp, acc, runner.collect_witness()


def _mira_message(S, acc, trace):
    """mira_tpu's guard on the same accumulator and trace: its ValueError's
    text."""
    S_m = MiraRunner(K, MulCircuit(3), [], MIRA_BN254_G1).collect_structure()
    acc_m, inc_m = relaxed_trace_to_mira(acc), plonk_trace_to_mira(trace)
    with pytest.raises(ValueError) as err:
        mira_vanilla._debug_check_assume_sat(
            S_m, acc_m.W, inc_m.w, list(acc.U.challenges) + [acc.U.u],
            list(trace.u.challenges) + [1])
    return str(err.value)


def test_debug_sat_guard(monkeypatch):
    """MIRA_DEBUG_SAT=1 makes VanillaFS.prove fail loudly when the incoming
    trace violates the assume_sat contract, with mira_tpu's message; without
    the knob the same fold goes through (the documented hazard); a
    satisfying trace passes under it."""
    S, ck, pp, acc, advice = _setup()
    # tamper the witness BEFORE trace generation: SPS commits happily but the
    # trace no longer satisfies its gate relation
    bad = [list(col) for col in advice]
    bad[-1][0] = (bad[-1][0] + 1) % S.modulus
    bad_trace = VanillaFS.generate_plonk_trace(ck, [], bad, pp, ro())

    monkeypatch.setenv("MIRA_DEBUG_SAT", "1")
    with pytest.raises(ValueError, match="assume_sat contract violated") as err:
        VanillaFS.prove(ck, pp, ro(), acc, bad_trace, rng=random.Random(7))
    assert "leading coefficient nonzero on 1 rows" in str(err.value)
    assert str(err.value) == _mira_message(S, acc, bad_trace)

    monkeypatch.delenv("MIRA_DEBUG_SAT")
    VanillaFS.prove(ck, pp, ro(), acc, bad_trace, rng=random.Random(7))

    monkeypatch.setenv("MIRA_DEBUG_SAT", "1")
    good_trace = VanillaFS.generate_plonk_trace(ck, [], advice, pp, ro())
    acc1, _ = VanillaFS.prove(ck, pp, ro(), acc, good_trace, rng=random.Random(7))
    S.is_sat_relaxed(ck, acc1.U, acc1.W)

    # the accumulator's branch: E with one word changed breaks Q(0) = E
    acc1.W.E = tamper_word(S.lf, acc1.W.E, 2)
    with pytest.raises(ValueError, match="assume_sat contract violated") as err:
        VanillaFS.prove(ck, pp, ro(), acc1, good_trace, rng=random.Random(7))
    assert "Q(0) != E on 1 rows" in str(err.value)
    assert str(err.value) == _mira_message(S, acc1, good_trace)


@pytest.mark.parametrize("knob", [None, "1"])
@pytest.mark.parametrize("assume_sat", [True, False])
def test_guard_evaluations(knob, assume_sat, monkeypatch):
    """The guard adds two fold-evaluator passes, and only with the knob set
    and assume_sat: without it commit_cross_terms evaluates once."""
    S, ck, pp, acc, advice = _setup()
    trace = VanillaFS.generate_plonk_trace(ck, [], advice, pp, ro())
    calls = []
    orig = FoldEvaluator.fold_eval_multi

    def counted(self, *args, **kwargs):
        calls.append(list(args[2]))
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(FoldEvaluator, "fold_eval_multi", counted)
    if knob is None:
        monkeypatch.delenv("MIRA_DEBUG_SAT", raising=False)
    else:
        monkeypatch.setenv("MIRA_DEBUG_SAT", knob)
    d = S.get_degree_for_folding() - 1
    VanillaFS.commit_cross_terms(ck, S, acc.U, acc.W, trace.u, trace.w,
                                 assume_sat=assume_sat)
    points = list(range(1, d)) if assume_sat else list(range(d + 1))
    guard = [[0], [0]] if knob and assume_sat else []
    assert calls == guard + ([points] if points else [])
