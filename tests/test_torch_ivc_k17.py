"""k=17 parity of the port on the CPU, behind the `slow` marker: the
step-folding circuit's fold evaluation against mira_tpu's native row VM,
and the port's witness-tape replay against a fresh synthesis inside a
two-curve IVC step.  These tests check witnesses and row evaluations, not
commitments, so the keys are a stand-in whose every commitment is the
identity point: a plain-PyTorch MSM over 2^21 points on the CPU would take
hours.

    python -m pytest tests/test_torch_ivc_k17.py -q -m slow
"""

import numpy as np
import pytest
import torch

from mira_tpu.polynomial.native_evaluator import NativeFoldEvaluator
from mira_tpu_torch.convert import limbs16_to_words, words_to_limbs16
from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN, AffinePoint
from mira_tpu_torch.ivc.ivc import IVC
from mira_tpu_torch.ivc.public_params import CircuitSide, PublicParams
from mira_tpu_torch.ivc.step_circuit import TrivialCircuit
from mira_tpu_torch.table.runner import CircuitRunner

from torch_port_helpers import expression_to_mira  # also sizes torch's threads

K = 17
pytestmark = pytest.mark.slow


class IdentityKey:
    """Commitment-key stand-in on the CPU: every commitment is the
    identity point of `curve`."""

    def __init__(self, curve):
        self.curve = curve
        self.device = torch.device("cpu")

    def commit_device(self, _witness, mesh=None):
        return AffinePoint.identity(self.curve)

    def commit_delta(self, _device_witness):
        return AffinePoint.identity(self.curve)

    def commit_device_many(self, vectors, mesh=None, defer=False):
        out = [AffinePoint.identity(self.curve) for _ in vectors]
        return (lambda: out) if defer else out


@pytest.fixture(scope="module")
def pp():
    return PublicParams(
        CircuitSide(TrivialCircuit(arity=1), IdentityKey(BN254_G1), K),
        CircuitSide(TrivialCircuit(arity=1), IdentityKey(GRUMPKIN), K),
        BN254_G1, GRUMPKIN)


def test_sfc_fold_eval_matches_native_row_vm(pp):
    S = pp.primary.S
    lf = S.lf
    rng = np.random.default_rng(17)

    def random_round(n):
        w = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
        w[:, 7] &= 0x1FFFFFFF  # below 2^253 < p
        return lf.from_plain(torch.from_numpy(w.view(np.int32)))

    W1 = [random_round(n) for n in S.round_sizes]
    W2 = [random_round(n) for n in S.round_sizes]
    nch = S.num_challenges + 1
    ch1 = [int(v) for v in rng.integers(0, 1 << 62, size=nch)]
    ch2 = [int(v) for v in rng.integers(0, 1 << 62, size=nch)]
    js = list(range(S.get_degree_for_folding()))
    got = S.fold_evaluator("cpu").fold_eval_multi(W1, W2, js, ch1, ch2)
    native = NativeFoldEvaluator(
        expression_to_mira(S.compressed_gates.homogeneous), S.modulus,
        S.num_advice_columns, S.num_lookups(), S.selectors, S.fixed_columns,
        1 << K)
    want = native.fold_eval_multi([words_to_limbs16(w) for w in W1],
                                  [words_to_limbs16(w) for w in W2],
                                  js, ch1, ch2)
    assert torch.equal(got, limbs16_to_words(want))


def test_tape_replay_matches_fresh_synthesis(pp, monkeypatch):
    checked = []
    orig = IVC._synthesize_inner

    def cross_check(self, k, sfc, instance, curve, side=None):
        replaying = side is not None and self._tapes.get(side) is not None
        out = orig(self, k, sfc, instance, curve, side)
        if replaying:
            p = curve.scalar_modulus
            fresh = CircuitRunner(k, sfc, instance, curve).collect_witness()
            assert out.to_int_cols() == [[v % p for v in col] for col in fresh]
            checked.append(side)
        return out

    monkeypatch.setattr(IVC, "_synthesize_inner", cross_check)
    ivc = IVC(pp, TrivialCircuit(arity=1), [11], TrivialCircuit(arity=1), [22])
    ivc.fold_step()
    ivc.verify(strict=True)
    # the public parameters capture both sides' tapes, so the zero step
    # replays them too
    assert sorted(checked) == ["primary", "primary", "secondary", "secondary"]
