"""The port's native row VM (polynomial/native_evaluator.py) and the
evaluator switch of the cross terms and the decider (MIRA_FOLD_EVAL):

- `NativeFoldEvaluator` equals the port's fold evaluator (the plain version
  of csrc/fold_eval.cu) and mira_tpu's `NativeFoldEvaluator` on the same
  seeded inputs, at every fold point and one far off, on structures with a
  rotation and with scalar and vector lookups, on whole columns and on row
  ranges;
- `commit_cross_terms` under each route gives mira_tpu's cross terms and
  commitments under the same MIRA_FOLD_EVAL, with assume_sat on and off;
- `_eval_full` under each route equals mira_tpu's, for both expressions;
- a witness or E with one word changed fails `is_sat` / `is_sat_relaxed` at
  the gate evaluation under every route;
- a missing native library or an unknown route raises.

Exact equality of words (decoded integers)."""

import functools
import random

import numpy as np
import pytest
import torch

from mira_tpu.curves.host import BN254_G1 as MIRA_BN254_G1
from mira_tpu.fields.limbs import limb_field as jax_limb_field
from mira_tpu.fields.params import BN254_FQ
from mira_tpu.nifs.vanilla import VanillaFS as MiraFS
from mira_tpu.ops.commitment import CommitmentKey as MiraKey
from mira_tpu.polynomial.native_evaluator import (
    NativeFoldEvaluator as MiraNative,
)
from mira_tpu.polynomial.pallas_evaluator import PallasFoldEvaluator
from mira_tpu.table.runner import CircuitRunner as MiraRunner
from mira_tpu_torch.convert import limbs16_to_words, words_to_limbs16
from mira_tpu_torch.curves.host import BN254_G1
from mira_tpu_torch.fields.limbs import limb_field
from mira_tpu_torch.nifs.vanilla import VanillaFS
from mira_tpu_torch.ops import poseidon as port_poseidon
from mira_tpu_torch.ops.commitment import CommitmentKey
from mira_tpu_torch.plonk import structure as ts
from mira_tpu_torch.polynomial import native_evaluator as ne
from mira_tpu_torch.table.runner import CircuitRunner

from test_lookup import LookupCircuit, MultiLookupCircuit, VectorLookupCircuit
from test_nifs import K, FiboCircuit, MulCircuit, TwoGateCircuit
from torch_port_helpers import (
    plonk_trace_to_mira,
    relaxed_trace_to_mira,
    same,
    tamper_word,
)

# a rotation (Fibo), SPS-2 with one and two lookups, SPS-3 (vector lookup)
CIRCUITS = [MulCircuit, TwoGateCircuit, FiboCircuit, LookupCircuit,
            MultiLookupCircuit, VectorLookupCircuit]
ROUTES = [None, "pallas", "native", "xla"]


@functools.lru_cache(maxsize=None)
def _structures(circuit_cls):
    """(the port's structure, mira_tpu's) of the circuit at K = 4."""
    return (CircuitRunner(K, circuit_cls(1), [], BN254_G1).collect_structure(),
            MiraRunner(K, circuit_cls(1), [], MIRA_BN254_G1).collect_structure())


def _inputs(S, seed):
    """Two seeded witnesses of the structure's round sizes (port words) and
    two challenge vectors with u."""
    rng = np.random.default_rng(seed)
    p = S.modulus
    lf = limb_field(p)
    Ws1, Ws2 = ([lf.encode([int(x) % p for x in rng.integers(0, 1 << 62, size=sz)])
                 for sz in S.round_sizes] for _ in range(2))
    nch = S.num_challenges + 1
    ch1, ch2 = ([int(x) % p for x in rng.integers(0, 1 << 62, size=nch)]
                for _ in range(2))
    return Ws1, Ws2, ch1, ch2


def _mira_native(M, which):
    expr = {"compressed": M.compressed_gates.compressed,
            "homogeneous": M.compressed_gates.homogeneous}[which]
    return MiraNative(expr, M.modulus, M.num_advice_columns, M.num_lookups(),
                      M.selectors, M.fixed_columns, 1 << M.k)


def _limbs(Ws):
    return [words_to_limbs16(w) for w in Ws]


@pytest.mark.parametrize("circuit_cls", CIRCUITS)
def test_native_vs_fold_evaluator_and_mira(circuit_cls):
    S, M = _structures(circuit_cls)
    Ws1, Ws2, ch1, ch2 = _inputs(S, 5)
    js = list(range(S.get_degree_for_folding())) + [12345]
    got = S._native_fold_evaluator().fold_eval_multi(Ws1, Ws2, js, ch1, ch2)
    assert got.shape == (len(js), 1 << K, 8)
    assert torch.equal(got, S.fold_evaluator("cpu").fold_eval_multi(
        Ws1, Ws2, js, ch1, ch2))
    want = _mira_native(M, "homogeneous").fold_eval_multi(
        _limbs(Ws1), _limbs(Ws2), js, ch1, ch2)
    assert torch.equal(got, limbs16_to_words(want))
    # the compressed expression at j = 0, challenges without u (the
    # decider's native call)
    got_c = S._native_fold_evaluator("compressed").fold_eval_multi(
        Ws1, Ws2, [0], ch1[:-1], ch2[:-1])
    want_c = _mira_native(M, "compressed").fold_eval_multi(
        _limbs(Ws1), _limbs(Ws2), [0], ch1[:-1], ch2[:-1])
    assert torch.equal(got_c, limbs16_to_words(want_c))


# K = 4: 16 rows.  Ends off any block, one row, the last rows (rotations
# wrap), an empty range
RANGES = [(0, 16), (3, 11), (5, 6), (9, 16), (15, 16), (7, 7)]


@pytest.mark.parametrize("circuit_cls", [FiboCircuit, VectorLookupCircuit])
def test_native_row_ranges(circuit_cls):
    S, _ = _structures(circuit_cls)
    Ws1, Ws2, ch1, ch2 = _inputs(S, 9)
    js = list(range(S.get_degree_for_folding()))
    nev = S._native_fold_evaluator()
    whole = nev.fold_eval_multi(Ws1, Ws2, js, ch1, ch2)
    for lo, hi in RANGES:
        got = nev.fold_eval_multi(Ws1, Ws2, js, ch1, ch2, rows=(lo, hi))
        assert torch.equal(got, whole[:, lo:hi])
        raw = nev.fold_eval_multi(Ws1, Ws2, js, ch1, ch2, rows=(lo, hi), as64=True)
        assert raw.dtype == np.uint64 and raw.shape == (len(js), hi - lo, 4)
        assert torch.equal(ne.words_from_64(raw, "cpu"), whole[:, lo:hi])
    for rows in ((-1, 4), (4, 17), (9, 8)):
        with pytest.raises(ValueError, match="rows"):
            nev.fold_eval_multi(Ws1, Ws2, js, ch1, ch2, rows=rows)


@pytest.mark.parametrize("circuit_cls", CIRCUITS)
@pytest.mark.parametrize("which", ["compressed", "homogeneous"])
def test_eval_full_routes_vs_mira(circuit_cls, which, monkeypatch):
    S, M = _structures(circuit_cls)
    Ws, _, ch, _ = _inputs(S, 13)
    ch = ch[:-1] if which == "compressed" else ch
    jlf = jax_limb_field(S.modulus)
    want = limbs16_to_words(np.asarray(
        M._eval_full(which, [jlf.encode(S.lf.decode(w)) for w in Ws], ch)))
    for route in ROUTES:
        assert torch.equal(S._eval_full(which, Ws, ch, impl=route), want), route
        if route is None:
            monkeypatch.delenv("MIRA_FOLD_EVAL", raising=False)
        else:
            monkeypatch.setenv("MIRA_FOLD_EVAL", route)
        assert torch.equal(S._eval_full(which, Ws, ch), want), route


def _mira_pallas_as_jnp(monkeypatch):
    """mira_tpu's "pallas" route through its kernel body run as plain jnp: its
    interpret-mode compile takes minutes on the CPU (tests/test_nifs.py marks
    it slow); tests/test_torch_fold_eval.py holds the body equal to the
    port's fold evaluator."""
    orig = PallasFoldEvaluator.fold_eval_multi

    def jnp_body(self, W1s, W2s, j_values, ch1, ch2, impl=None):
        return orig(self, W1s, W2s, j_values, ch1, ch2, impl="jnp")

    monkeypatch.setattr(PallasFoldEvaluator, "fold_eval_multi", jnp_body)


@functools.lru_cache(maxsize=None)
def _traces(circuit_cls):
    """The port's structure and key, and its SPS traces of two witnesses of
    the circuit (mira_tpu's, carried over by `plonk_trace_to_mira`, are the
    same: tests/test_torch_nifs.py holds the two packages' traces equal)."""
    S = CircuitRunner(K, circuit_cls(3), [], BN254_G1).collect_structure()
    ck = CommitmentKey.setup(BN254_G1, K + 3, b"test", device="cpu")
    traces = [S.run_sps_protocol(
        ck, [], MiraRunner(K, circuit_cls(seed), [], MIRA_BN254_G1).collect_witness(),
        port_poseidon.create_ro(BN254_FQ)) for seed in (3, 4)]
    return S, ck, traces


@pytest.mark.parametrize("route", ROUTES, ids=lambda r: r or "unset")
@pytest.mark.parametrize("assume_sat", [True, False])
def test_cross_terms_routes_vs_mira(route, assume_sat, monkeypatch):
    """tests/test_nifs.py's cross-term test on both packages: the same
    MIRA_FOLD_EVAL for both (unset: the port's fold evaluator, mira_tpu's
    native VM on a CPU host), the same accumulator and incoming trace, the
    same key and rng."""
    S, ck, (t1, t2) = _traces(TwoGateCircuit)
    M = MiraRunner(K, TwoGateCircuit(3), [], MIRA_BN254_G1).collect_structure()
    ck_m = MiraKey(MIRA_BN254_G1, ck._limbs)
    if route is None:
        monkeypatch.delenv("MIRA_FOLD_EVAL", raising=False)
    else:
        monkeypatch.setenv("MIRA_FOLD_EVAL", route)
    _mira_pallas_as_jnp(monkeypatch)
    acc = t1.to_relax(S.k)
    acc_m, inc_m = relaxed_trace_to_mira(acc), plonk_trace_to_mira(t2)
    ct_m, (g1_m, gt_m) = MiraFS.commit_cross_terms(
        ck_m, M, acc_m.U, acc_m.W, inc_m.u, inc_m.w, rng=random.Random(5),
        assume_sat=assume_sat)
    ct_t, (g1_t, gt_t) = VanillaFS.commit_cross_terms(
        ck, S, acc.U, acc.W, t2.u, t2.w, rng=random.Random(5),
        assume_sat=assume_sat)
    assert len(ct_t) == len(ct_m) == S.get_degree_for_folding() - 1
    for a, b in zip(ct_t, ct_m):
        assert torch.equal(a, limbs16_to_words(np.asarray(b)))
    assert same(g1_t, g1_m)
    assert same(gt_t, gt_m)


def test_impl_argument_overrides_the_knob(monkeypatch):
    """An explicit route wins over MIRA_FOLD_EVAL, as mira_tpu's `_impl`
    does: the native VM runs and the column evaluator is never built."""
    monkeypatch.setenv("MIRA_FOLD_EVAL", "xla")
    S = CircuitRunner(K, TwoGateCircuit(1), [], BN254_G1).collect_structure()
    Ws, _, ch, _ = _inputs(S, 3)
    got = S._eval_full("homogeneous", Ws, ch, impl="native")
    assert set(S._cache()) == {("native_fold", "homogeneous")}
    assert torch.equal(got, S._eval_full("homogeneous", Ws, ch))
    assert ("column", "homogeneous", "cpu") in S._cache()


@pytest.mark.parametrize("circuit_cls", [TwoGateCircuit, FiboCircuit,
                                         LookupCircuit])
@pytest.mark.parametrize("route", ROUTES, ids=lambda r: r or "unset")
def test_tampered_witness_fails_every_route(circuit_cls, route, monkeypatch):
    """Row 0 of advice column 0 is read by a gate in each circuit: one word
    changed there, or in E, fails the gate evaluation (before any commitment
    is checked) under every route, which finds the honest trace's rows
    zero."""
    S, ck, (trace, _) = _traces(circuit_cls)
    if route is None:
        monkeypatch.delenv("MIRA_FOLD_EVAL", raising=False)
    else:
        monkeypatch.setenv("MIRA_FOLD_EVAL", route)
    lf = S.lf
    acc = trace.to_relax(S.k)
    assert not S._eval_full("compressed", trace.w.W, trace.u.challenges).any()
    assert torch.equal(S._eval_full("homogeneous", acc.W.W,
                                    list(acc.U.challenges) + [acc.U.u]), acc.W.E)

    bad_w = ts.PlonkWitness(lf, [tamper_word(lf, acc.W.W[0], 0)] + acc.W.W[1:])
    with pytest.raises(ts.SatError, match="gate evaluation mismatch on 1/"):
        S.is_sat(ck, port_poseidon.create_ro(BN254_FQ), trace.u, bad_w)
    bad = ts.RelaxedPlonkWitness(lf, bad_w.W, acc.W.E)
    with pytest.raises(ts.SatError, match="relaxed gate evaluation != E on 1/"):
        S.is_sat_relaxed(ck, acc.U, bad)
    bad = ts.RelaxedPlonkWitness(lf, acc.W.W, tamper_word(lf, acc.W.E, 5))
    with pytest.raises(ts.SatError, match="relaxed gate evaluation != E on 1/"):
        S.is_sat_relaxed(ck, acc.U, bad)


def test_missing_library_raises(monkeypatch):
    """No native library: the native route raises, and no other route runs
    in its place."""
    monkeypatch.setattr(ne, "available", lambda: False)
    S = CircuitRunner(K, TwoGateCircuit(1), [], BN254_G1).collect_structure()
    Ws, Ws2, ch, ch2 = _inputs(S, 3)
    with pytest.raises(RuntimeError, match="libmiraeval"):
        S._native_fold_evaluator()
    with pytest.raises(RuntimeError, match="libmiraeval"):
        S._eval_full("homogeneous", Ws, ch, impl="native")
    monkeypatch.setenv("MIRA_FOLD_EVAL", "native")
    with pytest.raises(RuntimeError, match="libmiraeval"):
        S._eval_full("compressed", Ws, ch[:-1])
    assert not S._cache()


def test_unknown_route_raises(monkeypatch):
    S, _ = _structures(MulCircuit)
    Ws, _, ch, _ = _inputs(S, 3)
    with pytest.raises(ValueError, match="MIRA_FOLD_EVAL"):
        S._eval_full("homogeneous", Ws, ch, impl="jnp")
    monkeypatch.setenv("MIRA_FOLD_EVAL", "Pallas")
    with pytest.raises(ValueError, match="MIRA_FOLD_EVAL"):
        S._eval_full("homogeneous", Ws, ch)
    assert ts.fold_eval_impl("native") == "native"
    monkeypatch.delenv("MIRA_FOLD_EVAL")
    assert ts.fold_eval_impl() == "pallas"
