"""Port fold evaluator (plain version of csrc/fold_eval.cu) against
mira_tpu's PallasFoldEvaluator run as plain jnp (impl="jnp"), on the
circuits of tests/test_nifs.py at K=4: every fold point, plus the decider's
single point j = 0.  Exact equality."""

import numpy as np
import pytest
import torch

from mira_tpu.curves.host import BN254_G1
from mira_tpu.fields.limbs import limb_field as jax_limb_field
from mira_tpu.polynomial.evaluator import EvalDomain as MiraDomain
from mira_tpu.polynomial.evaluator import eval_rows_host as mira_eval_rows
from mira_tpu.polynomial.pallas_evaluator import PallasFoldEvaluator
from mira_tpu.table.runner import CircuitRunner as MiraRunner
from mira_tpu_torch.convert import limbs16_to_words
from mira_tpu_torch.fields.limbs import limb_field
from mira_tpu_torch.polynomial import fold_evaluator as fe
from mira_tpu_torch.polynomial.evaluator import ColumnEvaluator
from mira_tpu_torch.table.runner import CircuitRunner

from test_nifs import K, FiboCircuit, MulCircuit, TwoGateCircuit
import torch_port_helpers  # noqa: F401  (sizes torch's thread pool)

CIRCUITS = [MulCircuit, TwoGateCircuit, FiboCircuit]


def _inputs(S, seed):
    rng = np.random.default_rng(seed)
    p = S.modulus
    Ws1, Ws2 = ([[int(x) % p for x in rng.integers(0, 1 << 62, size=sz)]
                 for sz in S.round_sizes] for _ in range(2))
    nch = S.num_challenges + 1
    ch1, ch2 = ([int(x) % p for x in rng.integers(0, 1 << 62, size=nch)]
                for _ in range(2))
    return Ws1, Ws2, ch1, ch2


def _reference(S, Ws1, Ws2, js, ch1, ch2):
    jlf = jax_limb_field(S.modulus)
    ev = PallasFoldEvaluator(S.compressed_gates.homogeneous, S.modulus,
                             S.num_advice_columns, S.num_lookups(),
                             S.selectors, S.fixed_columns, 1 << S.k)
    out = ev.fold_eval_multi([jlf.encode(w) for w in Ws1],
                             [jlf.encode(w) for w in Ws2], js, ch1, ch2,
                             impl="jnp")
    return limbs16_to_words(out)


@pytest.mark.parametrize("circuit_cls", CIRCUITS)
def test_fold_eval_all_points_vs_jnp(circuit_cls):
    S = CircuitRunner(K, circuit_cls(1), [], BN254_G1).collect_structure()
    Ws1, Ws2, ch1, ch2 = _inputs(S, 5)
    d = S.get_degree_for_folding() - 1
    js = list(range(d + 1))
    lf = limb_field(S.modulus)
    got = S.fold_evaluator("cpu").fold_eval_multi(
        [lf.encode(w) for w in Ws1], [lf.encode(w) for w in Ws2], js, ch1, ch2)
    assert torch.equal(got, _reference(S, Ws1, Ws2, js, ch1, ch2))


@pytest.mark.parametrize("circuit_cls", CIRCUITS)
def test_fold_eval_all_points_vs_host(circuit_cls):
    """Every fold point against Python-int row evaluation of the folded
    witness and challenges (mira_tpu's golden evaluator)."""
    S = CircuitRunner(K, circuit_cls(4), [], BN254_G1).collect_structure()
    Ws1, Ws2, ch1, ch2 = _inputs(S, 9)
    p = S.modulus
    js = list(range(S.get_degree_for_folding()))
    lf = limb_field(p)
    got = S.fold_evaluator("cpu").fold_eval_multi(
        [lf.encode(w) for w in Ws1], [lf.encode(w) for w in Ws2], js, ch1, ch2)
    for i, j in enumerate(js):
        Wj = [[(a + j * b) % p for a, b in zip(w1, w2)] for w1, w2 in zip(Ws1, Ws2)]
        chj = [(a + j * b) % p for a, b in zip(ch1, ch2)]
        dom = MiraDomain(p, S.num_advice_columns, S.num_lookups(), chj,
                         S.selectors, S.fixed_columns, Wj, [])
        assert lf.decode(got[i]) == mira_eval_rows(S.compressed_gates.homogeneous, dom)


@pytest.mark.parametrize("circuit_cls", CIRCUITS)
def test_decider_point_matches_column_and_host(circuit_cls):
    """_eval_full (fold evaluator at j = 0) == the independent plain column
    evaluator == Python-int row evaluation."""
    S = CircuitRunner(K, circuit_cls(2), [], BN254_G1).collect_structure()
    Ws1, _, ch1, _ = _inputs(S, 6)
    lf = limb_field(S.modulus)
    W = [lf.encode(w) for w in Ws1]
    got = S._eval_full("homogeneous", W, ch1)
    col = S._evaluator("homogeneous", "cpu")(W, (), ch1)
    assert torch.equal(got, col)
    dom = MiraDomain(S.modulus, S.num_advice_columns, S.num_lookups(), ch1,
                     S.selectors, S.fixed_columns, Ws1, [])
    want = mira_eval_rows(S.compressed_gates.homogeneous, dom)
    assert lf.decode(got) == want


def test_registers_compacted_and_structure_matches_mira():
    S = CircuitRunner(K, FiboCircuit(0), [], BN254_G1).collect_structure()
    M = MiraRunner(K, FiboCircuit(0), [], BN254_G1).collect_structure()
    assert (S.round_sizes, S.num_challenges, S.fixed_columns,
            S.permutation_matrix) == (M.round_sizes, M.num_challenges,
                                      M.fixed_columns, M.permutation_matrix)
    ev = S.fold_evaluator("cpu")
    _, ops, _, n_regs, _ = ev._program(S.num_challenges + 1)
    raw, _ = fe._compile_ops(fe._split_scalar_subtrees(
        S.compressed_gates.homogeneous, S.num_challenges + 1)[0], ev.qslot,
        S.modulus)
    assert len(ops) == len(raw) and n_regs < len(raw)
    # every register read was written before (in program order)
    written = set()
    for op, a, b, dst in ops:
        reads = (a, b) if op in (fe.OP_ADD, fe.OP_MUL) else (
            (a,) if op in (fe.OP_NEG, fe.OP_OUTPUT) else ())
        assert all(r in written for r in reads)
        if op != fe.OP_OUTPUT:
            written.add(dst)


def test_column_evaluator_fold_eval():
    S = CircuitRunner(K, TwoGateCircuit(3), [], BN254_G1).collect_structure()
    Ws1, Ws2, ch1, ch2 = _inputs(S, 7)
    lf = limb_field(S.modulus)
    W1 = [lf.encode(w) for w in Ws1]
    W2 = [lf.encode(w) for w in Ws2]
    ev = ColumnEvaluator(S.compressed_gates.homogeneous, S.modulus,
                         S.num_advice_columns, S.num_lookups(), S.selectors,
                         S.fixed_columns, 1 << S.k)
    p = S.modulus
    j = 3
    chj = [(a + j * b) % p for a, b in zip(ch1, ch2)]
    got = ev.fold_eval(W1, W2, j, chj)
    Wj = [[(a + j * b) % p for a, b in zip(w1, w2)] for w1, w2 in zip(Ws1, Ws2)]
    dom = MiraDomain(p, S.num_advice_columns, S.num_lookups(), chj,
                     S.selectors, S.fixed_columns, Wj, [])
    assert lf.decode(got) == mira_eval_rows(S.compressed_gates.homogeneous, dom)

