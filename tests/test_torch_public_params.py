"""The host work of the port's public parameters, which grows with 2^k,
against mira_tpu's: the permutation matrix kept sparse (identity entries
implied), the structure digest's fixed-column and permutation hashes fed
from words and from vectorised JSON text, `is_sat_perm` on the sparse
matrix, the k=17 Poseidon/trivial pair's pp digests, and the mock key's
weights read from its digest with numpy.  Every comparison is exact."""

import hashlib
import json
import random
from types import SimpleNamespace

import numpy as np
import pytest

from mira_tpu.curves.host import BN254_G1 as MIRA_BN254_G1
from mira_tpu.fields.limbs import limb_field as mira_limb_field
from mira_tpu.plonk.structure import SatError as MiraSatError
from mira_tpu.table.runner import CircuitRunner as MiraRunner
from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN
from mira_tpu_torch.ivc.public_params import _fixed_bytes, _sha3_hex
from mira_tpu_torch.ops.mock_commitment import MockCommitmentKey
from mira_tpu_torch.plonk.structure import SatError
from mira_tpu_torch.table.circuit import PermutationMatrix, _json_triples
from mira_tpu_torch.table.runner import CircuitRunner

from test_nifs import K, FiboCircuit, MulCircuit, TwoGateCircuit

P = BN254_G1.scalar_modulus


class LookupInstanceCircuit:
    """A gate, a lookup into a fixed table column, copies between advice
    cells and two instance rows: every kind of entry the permutation and
    the fixed columns hold."""

    def __init__(self, seed=0):
        self.seed = seed

    @staticmethod
    def configure(cs):
        q, t = cs.fixed_column(), cs.fixed_column()
        a, b = cs.advice_column(), cs.advice_column()
        for col in (a, b):
            cs.enable_equality(col)
        qe, te, ae, be = (cs.query(x) for x in (q, t, a, b))
        cs.create_gate("square", [qe * (ae * ae - be)])
        cs.lookup("range", [ae], [te])
        return q, t, a, b

    def synthesize(self, config, ctx):
        q, t, a, b = config
        tab = ctx.table
        rng = random.Random(self.seed)
        for row in range(8):
            tab.assign_fixed(t, row, row + 1)
        vals = [rng.randrange(1, 9) for _ in range(6)]
        vals[3], vals[4] = vals[0], vals[1]  # the copied cells' rows
        cells = []
        for row, v in enumerate(vals):
            tab.assign_fixed(q, row, 1 if row % 2 else P - 1)
            cells.append((tab.assign_advice(a, row, v), tab.assign_advice(b, row, v * v)))
        tab.copy(cells[0][0].cell, cells[3][0].cell)
        tab.copy(cells[1][1].cell, cells[4][1].cell)
        tab.constrain_instance(cells[0][0].cell, 0)
        tab.constrain_instance(cells[5][1].cell, 1)
        self.instance = [cells[0][0].value, cells[5][1].value]


CIRCUITS = [MulCircuit, TwoGateCircuit, FiboCircuit, LookupInstanceCircuit]


def _structures(circuit_cls, seed=0):
    inst = [0, 0] if circuit_cls is LookupInstanceCircuit else []
    t = CircuitRunner(K, circuit_cls(seed), inst, BN254_G1)
    m = MiraRunner(K, circuit_cls(seed), inst, MIRA_BN254_G1)
    return t, m, t.collect_structure(), m.collect_structure()


@pytest.mark.parametrize("circuit_cls", CIRCUITS)
def test_permutation_matrix_matches_mira(circuit_cls):
    _, _, S_t, S_m = _structures(circuit_cls)
    P_t = S_t.permutation_matrix
    assert isinstance(P_t, PermutationMatrix)
    assert list(P_t) == S_m.permutation_matrix and P_t == S_m.permutation_matrix
    assert len(P_t) == len(S_m.permutation_matrix)


@pytest.mark.parametrize("circuit_cls", CIRCUITS)
def test_structure_hashes_match_mira(circuit_cls):
    """The fixed and permutation hashes of the structure digest equal the
    reference's expressions (mira_tpu/ivc/public_params.py:218-227) on
    mira_tpu's structure, the permutation also in chunks of 1, 3 and 7
    indices."""
    _, _, S_t, S_m = _structures(circuit_cls)
    want_fixed = hashlib.sha3_256(b"".join(
        v.to_bytes(32, "little") for col in S_m.fixed_columns for v in col)).hexdigest()
    assert _sha3_hex(_fixed_bytes(S_t)) == want_fixed
    want_perm = hashlib.sha3_256(
        json.dumps(sorted(S_m.permutation_matrix)).encode()).hexdigest()
    assert _sha3_hex(S_t.permutation_matrix.json_chunks("cpu")) == want_perm
    for chunk in (1, 3, 7):
        assert _sha3_hex(S_t.permutation_matrix.json_chunks("cpu", chunk)) == want_perm


@pytest.mark.parametrize("values", [
    [0], [9], [10], [99], [100], [9999], [10000], [123456789],
    [10 ** 12 - 1, 10 ** 12], [2 ** 62, 0, 1], [5, 10 ** 7, 2],
])
def test_json_triples_match_json_dumps(values):
    i = np.array(values, dtype=np.int64)
    j, v = i[::-1].copy(), i // 2 + 1
    want = json.dumps(list(zip(i.tolist(), j.tolist(), v.tolist())))[1:-1].encode()
    assert _json_triples(i, j, v) == want


def test_sparse_permutation_with_general_weights():
    """Explicit entries of any weight and order, one index repeated, sort
    and serialise as the reference's list does."""
    entries = [(5, 2, 1), (2, 5, 1), (9, 9, 3), (3, 9, 1), (9, 3, 1), (0, 11, 1)]
    Pm = PermutationMatrix(*(np.array(c) for c in zip(*entries)), 12)
    full = list(Pm)
    assert full[: len(entries)] == entries and len(full) == len(Pm) == 6 + 7
    for chunk in (1, 2, 4, 64):
        assert b"".join(Pm.json_chunks("cpu", chunk)) == json.dumps(sorted(full)).encode()


def _witness(runner, S, lf_encode, tamper=None):
    """Round 0 of a witness: the padded advice columns (a cell tampered)."""
    nrow = 1 << S.k
    cols = [list(c) + [0] * (nrow - len(c)) for c in runner.collect_witness()]
    flat = [v % S.modulus for c in cols for v in c]
    if tamper is not None:
        flat[tamper] = (flat[tamper] + 1) % S.modulus
    return lf_encode(flat)


@pytest.mark.parametrize("circuit_cls", [MulCircuit, FiboCircuit, LookupInstanceCircuit])
def test_is_sat_perm_matches_mira_on_a_tampered_witness(circuit_cls):
    """Honest witnesses pass in both packages; a witness with a copied cell
    changed fails in both, with the same count of mismatched entries."""
    t_runner, m_runner, S_t, S_m = _structures(circuit_cls)
    inst = getattr(t_runner.circuit, "instance", [])
    moved = sorted({i for i, j, _ in S_m.permutation_matrix
                    if i != j and i >= S_m.num_io})
    lf_m = mira_limb_field(P)
    for tamper in (None, moved[0] - S_m.num_io, moved[-1] - S_m.num_io):
        U = SimpleNamespace(instance=list(inst))
        W_t = SimpleNamespace(W=[_witness(t_runner, S_t, S_t.lf.encode, tamper)])
        W_m = SimpleNamespace(W=[np.asarray(_witness(m_runner, S_m, lf_m.encode, tamper))])
        if tamper is None:
            S_t.is_sat_perm(U, W_t)
            S_m.is_sat_perm(U, W_m)
            continue
        with pytest.raises(SatError) as got:
            S_t.is_sat_perm(U, W_t)
        with pytest.raises(MiraSatError) as want:
            S_m.is_sat_perm(U, W_m)
        assert str(got.value) == str(want.value)


def test_pp_digests_match_mira_k17():
    """digest_1 and digest_2 of the k=17 Poseidon/trivial pair with mock
    keys equal mira_tpu's: the same bytes hashed in the same order."""
    from mira_tpu.curves.host import GRUMPKIN as MIRA_GRUMPKIN
    from mira_tpu.ivc.public_params import CircuitSide as MiraSide
    from mira_tpu.ivc.public_params import PublicParams as MiraPP
    from mira_tpu.ivc.step_circuit import TrivialCircuit as MiraTrivial
    from mira_tpu.ops.mock_commitment import MockCommitmentKey as MiraMock
    from mira_tpu.workloads.poseidon import PoseidonStepCircuit as MiraPoseidon
    from mira_tpu_torch.ivc.public_params import CircuitSide, PublicParams
    from mira_tpu_torch.ivc.step_circuit import TrivialCircuit
    from mira_tpu_torch.workloads.poseidon import PoseidonStepCircuit

    pp = PublicParams(
        CircuitSide(PoseidonStepCircuit(P, 1),
                    MockCommitmentKey(BN254_G1, 21, b"bn256", "cpu"), 17),
        CircuitSide(TrivialCircuit(1),
                    MockCommitmentKey(GRUMPKIN, 21, b"grumpkin", "cpu"), 17),
        BN254_G1, GRUMPKIN)
    mpp = MiraPP(
        MiraSide(MiraPoseidon(P, 1), MiraMock(MIRA_BN254_G1, 21, b"bn256"), 17),
        MiraSide(MiraTrivial(1), MiraMock(MIRA_GRUMPKIN, 21, b"grumpkin"), 17),
        MIRA_BN254_G1, MIRA_GRUMPKIN)
    for mine, theirs in ((pp.digest_1, mpp.digest_1), (pp.digest_2, mpp.digest_2)):
        assert (mine.x.v, mine.y.v, mine.is_inf) == (theirs.x.v, theirs.y.v, theirs.is_inf)


@pytest.mark.parametrize("curve", [BN254_G1, GRUMPKIN], ids=["bn254", "grumpkin"])
def test_mock_key_weights_from_the_digest(curve):
    """The numpy weights equal mira_tpu's list (each 16-byte chunk of the
    digest mod r) at k = 10, and the list is built only when read."""
    key = MockCommitmentKey(curve, 10, b"bn256", device="cpu")
    assert key._weights is None
    seed = hashlib.shake_256(b"mira-mock-ck" + b"bn256").digest(16 << 10)
    want = [int.from_bytes(seed[16 * i : 16 * (i + 1)], "little") % curve.scalar_modulus
            for i in range(1 << 10)]
    got = [int(lo) | int(hi) << 64 for lo, hi in key._w64[:, :2]]
    assert got == want and not key._w64[:, 2:].any()
    assert key.weights == want
