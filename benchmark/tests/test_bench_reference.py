"""The plain reference: its Poseidon and curve arithmetic against the
program's at small sizes, its MSM against naive sums, its gate and copy
checks on small tables, and its sources importing nothing of the program,
of the JAX package or of JAX."""

import ast
import glob
import os
import random

import numpy as np
import pytest

from harness.cell import BENCH
from reference import curves, decider, keys, msm, poseidon
from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN, AffinePoint
from mira_tpu_torch.curves.svdw import svdw_constants
from mira_tpu_torch.ops.commitment import _key_rows
from mira_tpu_torch.fields.host import field
from mira_tpu_torch.fields.params import BN254_FQ, BN254_FR
from mira_tpu_torch.ops.poseidon import PoseidonHash, create_ro, get_spec
from mira_tpu_torch.polynomial.expression import Challenge, Const, Poly, Query, Scaled
from mira_tpu_torch.workloads.poseidon import PoseidonStepCircuit

BLOCKED = {"jax", "jaxlib", "flax", "mira_tpu", "mira_tpu_torch"}


@pytest.mark.parametrize("p", [BN254_FR, BN254_FQ])
@pytest.mark.parametrize("spec", [(3, 2, 4, 3), (5, 4, 10, 10)])
@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 8, 9])
def test_sponge_matches_the_program(p, spec, n):
    t, rate, r_f, r_p = spec
    F = field(p)
    vals = [random.Random(n * 7 + t).randrange(p) for _ in range(n)]
    h = PoseidonHash(get_spec(p, t, rate, r_f, r_p))
    h.update([F(v) for v in vals])
    want = h.squeeze(F, 128).v
    assert poseidon.Sponge(p, t, r_f, r_p).absorb(vals).squeeze(128) == want


def test_hash_chain_is_the_step_circuit():
    sc = PoseidonStepCircuit(BN254_FR, 1)
    z = 987654321987654321
    want = sc.process_step(sc.process_step([z], 17, BN254_FR), 17, BN254_FR)
    assert poseidon.hash_chain(z, BN254_FR, [3, 2, 4, 3], 4) == want[0]
    assert create_ro(BN254_FR).spec.t == 5


@pytest.mark.parametrize("ours,theirs", [(curves.BN254, BN254_G1), (curves.GRUMPKIN, GRUMPKIN)])
def test_curves(ours, theirs):
    g = AffinePoint.generator(theirs)
    assert ours.generator == (g.x.v, g.y.v) and ours.on_curve(ours.generator)
    assert (ours.p, ours.r, ours.b % ours.p) == (theirs.base_modulus, theirs.scalar_modulus,
                                                 theirs.b % theirs.base_modulus)
    k = 123456789123456789
    pk = g.scalar_mul(k)
    assert ours.mul(ours.generator, k) == (pk.x.v, pk.y.v)
    assert ours.mul(ours.generator, ours.r) is None
    assert ours.add(ours.generator, ours.mul(ours.generator, ours.r - 1)) is None


@pytest.mark.parametrize("ours,theirs,label", [(curves.BN254, BN254_G1, "bn256"),
                                               (curves.GRUMPKIN, GRUMPKIN, "grumpkin")])
def test_key_rows_are_the_programs(ours, theirs, label, tmp_path):
    assert keys.svdw_constants(ours.p, ours.b) == svdw_constants(theirs.base_modulus, 0,
                                                                 theirs.b)
    path = str(tmp_path / "k" / "8-svdw.npy")
    keys.ensure_key(ours, label, 8, path)
    rows = np.load(path)
    assert rows.dtype == np.uint32 and rows.shape == (256, 2, 16)
    assert np.array_equal(rows, _key_rows(theirs, label.encode(), 0, 256))
    xs, ys = msm.key_coords(rows[:4])
    for x, y in zip(xs, ys):
        pt = tuple(sum(int(w) << (64 * i) for i, w in enumerate(v)) for v in (x, y))
        assert ours.on_curve(pt)


def test_a_key_grows_from_a_smaller_one(tmp_path):
    """A key of 2^k rows made from a smaller one beside it (its new rows
    alone) or cut from a larger one equals the key made whole."""
    keys.ensure_key(curves.GRUMPKIN, "grumpkin", 6, str(tmp_path / "6-svdw.npy"))
    keys.ensure_key(curves.GRUMPKIN, "grumpkin", 9, str(tmp_path / "9-svdw.npy"))
    whole = keys.make_rows(curves.GRUMPKIN, b"grumpkin", 1 << 9)
    assert np.array_equal(np.load(tmp_path / "9-svdw.npy"), whole)
    assert np.array_equal(keys.make_rows(curves.GRUMPKIN, b"grumpkin", 1 << 9, start=300),
                          whole[300:])
    keys.ensure_key(curves.GRUMPKIN, "grumpkin", 7, str(tmp_path / "7-svdw.npy"))  # from 9
    assert np.array_equal(np.load(tmp_path / "7-svdw.npy"), whole[:128])


@pytest.mark.parametrize("curve", [curves.BN254, curves.GRUMPKIN])
@pytest.mark.parametrize("montgomery", [False, True])
def test_msm_against_a_naive_sum(curve, montgomery):
    rng = random.Random(5)
    n = 40
    ks = [rng.randrange(1, curve.r) for _ in range(n)]
    pts = [curve.mul(curve.generator, k) for k in ks]
    pts[3] = None  # a point at infinity in the key
    ss = [rng.randrange(curve.r) for _ in range(n)]
    ss[5] = 0
    rows = np.zeros((n, 2, 16), dtype=np.uint32)
    for i, pt in enumerate(pts):
        for c, v in enumerate((0, 0) if pt is None else pt):
            rows[i, c] = [(v >> (16 * j)) & 0xFFFF for j in range(16)]
    xs, ys = msm.key_coords(rows)
    enc = [(s * 2**256) % curve.r if montgomery else s for s in ss]
    words = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in enc),
                          dtype="<i4").reshape(n, 8)
    want = curve.mul(curve.generator,
                     sum(s * k for s, k, pt in zip(ss, ks, pts) if pt is not None))
    assert msm.msm_words(curve, words, xs, ys, montgomery) == want


class _S:
    """A small structure: 1 selector, 1 fixed column, 2 advice columns."""

    def __init__(self, k=3):
        self.k = k
        n = 1 << k
        self.curve = BN254_G1
        self.selectors = [[i % 2 == 0 for i in range(n)]]
        self.fixed_columns = [[i + 1 for i in range(n)]]
        self.num_advice_columns = 2

    def num_lookups(self):
        return 0


def test_evaluate_on_a_small_table():
    S, p = _S(), BN254_FR
    n = 1 << S.k
    a = [random.Random(i).randrange(p) for i in range(2 * n)]
    W0 = decider.to_mont(a, p)
    expr = Poly(Query(0)) * (Poly(Query(2)) * Poly(Query(3, 1)) - Poly(Query(1))) \
        + Scaled(Challenge(0), 5) + Const(3)
    got = decider.evaluate(expr, decider.Columns(S, [W0]), [11])
    want = [((1 if i % 2 == 0 else 0) * (a[i] * a[n + (i + 1) % n] - (i + 1)) + 55 + 3) % p
            for i in range(n)]
    assert list(got) == want


def test_copy_check_counts_broken_copies():
    S, p = _S(), BN254_FR
    n = 1 << S.k

    class P:
        i = np.array([1, 2 + 3, 2 + 9], dtype=np.int64)
        j = np.array([2 + 3, 2 + 9, 1], dtype=np.int64)
        v = np.ones(3, dtype=np.int64)

    S.permutation_matrix = P
    vals = [7] * (2 * n)
    assert decider.copy_rows_wrong(S, [0, 7], decider.to_mont(vals, p)) == 0
    vals[9] = 8
    assert decider.copy_rows_wrong(S, [0, 7], decider.to_mont(vals, p)) == 2


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(BENCH, "reference", "*.py")) + \
        glob.glob(os.path.join(BENCH, "configs", "*.ref.py"))
    names = {os.path.basename(f) for f in files}
    assert {"pairing.py", "groth16.py", "decider.py", "snarkstar-b1.ref.py",
            "poseidon-k17.ref.py"} <= names
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in BLOCKED, (path, name)


def test_the_harness_imports_no_jax():
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True):
        if os.sep + "tests" + os.sep in path:
            continue
        for name in _imports(path):
            assert name.split(".")[0] not in {"jax", "jaxlib", "flax", "mira_tpu"}, (path, name)
