"""The snarkstar-b1 configuration's reference and the harness's hooks for it:
the plain pairing against the program's, the plain Groth16 verifier on the
program's proofs, the plain Merkle replay against the program's tree,
`decide_more` on accumulators folded by the program's `GtAccumulator`,
the start state and per-side key sizes of the harness."""

import os
import random

import pytest

from harness import runner
from harness.cell import BENCH, ck_k, load_module, read_json
from reference import curves, decider, groth16, pairing
from mira_tpu_torch.curves.host import BN254_G1, AffinePoint, G2Point
from mira_tpu_torch.curves.pairing import pairing as program_pairing
from mira_tpu_torch.fields.host import field
from mira_tpu_torch.fields.params import BN254_FQ, BN254_FR
from mira_tpu_torch.gadgets.merkle import INDEX_LIMIT, Tree
from mira_tpu_torch.snark import groth16 as program_groth16
from mira_tpu_torch.workloads import snarkstar

CONFIGS = os.path.join(BENCH, "configs")
CFG = read_json(os.path.join(CONFIGS, "snarkstar-b1.json"))
REF = load_module(os.path.join(CONFIGS, "snarkstar-b1.ref.py"), "bench_ref_snarkstar_test")
FQ = field(BN254_FQ)


def _g2(q: G2Point):
    return REF.g2(q)


@pytest.fixture(scope="module")
def proofs():
    """A small Groth16 circuit's key and three proofs made by the program."""
    rng = random.Random(11)
    r1cs, z = program_groth16.benchmark_r1cs(20)
    pk = program_groth16.setup(r1cs, rng)
    public = z[1:r1cs.num_public + 1]
    return pk.vk, [(program_groth16.prove(pk, r1cs, z, rng), list(public)) for _ in range(3)]


def test_the_pairing_is_bilinear_and_the_programs():
    rng = random.Random(7)
    a, b = rng.randrange(1, BN254_FR), rng.randrange(1, BN254_FR)
    g1, g2 = AffinePoint.generator(BN254_G1), G2Point.generator(FQ)
    pa, qb = g1.scalar_mul(a), g2.scalar_mul(b)
    mine = pairing.pairing(decider.point(pa), _g2(qb))
    assert pairing.to_layout(mine) == [int(e.v) for e in program_pairing(pa, qb).elements]
    base = pairing.pairing(curves.BN254.generator, pairing.G2_GEN)
    assert mine == pairing.power(base, a * b % BN254_FR) != pairing.one()
    assert pairing.power(base, BN254_FR) == pairing.one()
    assert pairing.from_layout(pairing.to_layout(mine)) == mine


def test_the_plain_verifier_takes_the_programs_proofs(proofs):
    vk_program, items = proofs
    vk = REF.verifying_key(vk_program)
    for pf, public in items:
        assert program_groth16.verify(vk_program, pf, public)
        assert groth16.verify(vk, groth16.Proof(decider.point(pf.a), _g2(pf.b),
                                                decider.point(pf.c)), public)
    pf, public = items[0]
    a = curves.BN254.add(decider.point(pf.a), curves.BN254.generator)
    assert not groth16.verify(vk, groth16.Proof(a, _g2(pf.b), decider.point(pf.c)), public)
    assert not groth16.verify(vk, groth16.Proof(decider.point(pf.a), _g2(pf.b),
                                                decider.point(pf.c)), [public[0] + 1, public[1]])


def test_the_merkle_replay_is_the_programs_tree():
    rng = random.Random(3)
    tree = Tree(BN254_FR)
    mine = REF.Tree(BN254_FR, CFG["primary"]["depth"], CFG["primary"]["node_hash"])
    assert mine.root() == tree.root()
    updates = [(rng.randrange(INDEX_LIMIT), rng.randrange(BN254_FR)) for _ in range(4)]
    updates.append((updates[0][0] ^ 1, 5))  # the sibling of a leaf already set
    for index, value in updates:
        tree.update_leaf(index, value)
        mine.set_leaf(index, value)
        assert mine.root() == tree.root()
    start = 2
    z0 = [REF.Tree(BN254_FR, 32, [5, 4, 10, 10]).root()]
    inputs = {"updates": [list(u) for u in updates], "start": 0}
    moduli = (BN254_FR, BN254_FQ)
    assert REF.z_after(CFG, moduli, "primary", z0, 5, inputs) == [tree.root()]
    assert REF.z_after(CFG, moduli, "primary", z0, 6, inputs) == [None]  # one update short
    assert REF.z_after(CFG, moduli, "primary", [z0[0] + 1], 5, inputs) == [None]
    inputs["start"] = start
    assert REF.z_after(CFG, moduli, "primary", z0, 3, inputs) == [None]  # z0 is not that root
    assert REF.z_after(CFG, moduli, "secondary", [9], 3, inputs) == [9]


class _Folded:
    """What decide_more reads: the folded primary instance and the system's
    record of the proofs fed."""

    def __init__(self, acc, vk, items):
        U = type("U", (), {})()
        U.g1_elements, U.g2_elements = [acc.A, acc.C, acc.vkx], [acc.B]
        U.u, U.gt_element = acc.u, acc.gt
        trace = type("T", (), {"U": U})()
        self.primary = type("P", (), {"relaxed_trace": trace})()
        self.vk, self.items = vk, items

    def folded_proofs(self):
        return self.vk, self.items


def test_decide_more_judges_a_folded_accumulator(proofs):
    vk, items = proofs
    rng = random.Random(5)
    acc = program_groth16.GtAccumulator(vk)
    for pf, public in items[:2]:
        acc.fold(pf, public, rng.randrange(1, BN254_FR))
    assert acc.check()
    folded = _Folded(acc, vk, items)
    assert REF.decide_more(folded, folded, CFG) == {"gt_accumulator": 0, "groth16_proofs": 0}
    U = folded.primary.relaxed_trace.U
    U.gt_element = U.gt_element.mul(program_pairing(AffinePoint.generator(BN254_G1),
                                                    G2Point.generator(FQ)))
    assert REF.decide_more(folded, folded, CFG)["gt_accumulator"] == 1
    bad = program_groth16.Proof(items[2][0].a.add(AffinePoint.generator(BN254_G1)),
                                items[2][0].b, items[2][0].c)
    folded.items = items[:2] + [(bad, items[2][1])]
    assert REF.decide_more(folded, folded, CFG)["groth16_proofs"] == 1


class _Plain:
    """A system without a draw of its own."""

    def moduli(self):
        return BN254_FR, BN254_FQ


def test_the_poseidon_start_state_is_unchanged():
    """poseidon-k17's system has no draw of its own, so z0 is one field
    element a side, the values the parent harness drew for this seed."""
    z0 = runner.start_state(_Plain(), random.Random(2147483801))
    assert z0 == {
        "primary": [11753104668180225732355809865289204095689060328667921877571202889726088086242],
        "secondary": [2050147123779787099896465219353634252051600470763132096295064728526643565853]}
    ivc_system = load_module(os.path.join(BENCH, "systems", "ivc.py"), "bench_system_ivc_t")
    assert not hasattr(ivc_system.System, "draw_z0")


def test_a_side_may_carry_its_own_key_size(tmp_path):
    poseidon = read_json(os.path.join(CONFIGS, "poseidon-k17.json"))
    assert [ck_k(poseidon, s) for s in ("primary", "secondary")] == [21, 21]
    assert [ck_k(CFG, s) for s in ("primary", "secondary")] == [23, 24]
    ivc_system = load_module(os.path.join(BENCH, "systems", "ivc.py"), "bench_system_ivc_k")
    for cfg, names in ((poseidon, ["21-svdw.npy", "21-svdw.npy"]),
                       (CFG, ["23-svdw.npy", "24-svdw.npy"])):
        system = ivc_system.System(cfg, "cpu", str(tmp_path))
        assert [os.path.basename(system.key_file(s)) for s in ("primary", "secondary")] == names
    assert os.path.dirname(system.key_file("secondary")).endswith(
        os.path.join(".cache", "ck", "grumpkin", "grumpkin"))


def test_the_configuration_states_the_programs_shapes():
    g = CFG["primary"]["groth16"]
    assert CFG["reduced"] == [] and CFG["k"] == 19
    assert (g["num_g1"], g["num_g2"]) == (3 * g["batch"], g["batch"])
    assert (g["gt_degree"], g["gt_cross_terms"]) == (2, 2)
    assert snarkstar.table_sizes(g["batch"]) == (CFG["k"], CFG["k"])
    assert snarkstar.ck_sizes(g["batch"]) == (ck_k(CFG, "primary"), ck_k(CFG, "secondary"))
