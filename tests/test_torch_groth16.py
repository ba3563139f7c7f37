"""The real-proof SnarkStar pieces of the port against mira_tpu: the host
NTT, Groth16 setup/prove/verify from one seeded rng, the snarkjs bundle
format, the mock commitment key, and tests/test_groth16_fold.py's
real-proof fold run by both packages on the same circuits, key and proofs:
the accumulators must be equal step for step, and a tampered Gt element
must fail the port's decider.  Exact equality throughout."""

import random

import pytest

from mira_tpu.curves.host import BN254_G1 as MIRA_BN254_G1
from mira_tpu.curves.host import AffinePoint as MiraPoint
from mira_tpu.fields.params import BN254_FQ, BN254_FR
from mira_tpu.nifs.vanilla import VanillaFS as MiraFS
from mira_tpu.ops import ntt as mira_ntt
from mira_tpu.ops.commitment import CommitmentKey as MiraKey
from mira_tpu.ops.mock_commitment import MockCommitmentKey as MiraMockKey
from mira_tpu.plonk import structure as ms
from mira_tpu.snark import conversion as mira_conversion
from mira_tpu.snark import groth16 as mira_g16
from mira_tpu.table.runner import CircuitRunner as MiraRunner
from mira_tpu_torch.convert import relaxed_trace_from_mira, to_plain
from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN, AffinePoint, G2Point, Tuple12
from mira_tpu_torch.fields.host import field
from mira_tpu_torch.fields.limbs import limb_field
from mira_tpu_torch.nifs.vanilla import VanillaFS
from mira_tpu_torch.ops import ntt
from mira_tpu_torch.ops.commitment import CommitmentKey
from mira_tpu_torch.ops.mock_commitment import MockCommitmentKey
from mira_tpu_torch.plonk.structure import SatError
from mira_tpu_torch.snark import conversion
from mira_tpu_torch.snark import groth16 as g16
from mira_tpu_torch.table.runner import CircuitRunner

from test_nifs import K, MulCircuit
from torch_port_helpers import relaxed_trace_to_mira, same, to_mira
from test_torch_nifs import ro, ro_t


@pytest.mark.parametrize("log_n", [0, 1, 3, 5])
def test_host_ntt_matches_mira(log_n):
    modulus = BN254_FR
    rng = random.Random(log_n)
    vals = [rng.randrange(modulus) for _ in range(1 << log_n)]
    for inverse in (False, True):
        assert (ntt.get_omega(modulus, log_n, inverse)
                == mira_ntt.get_omega(modulus, log_n, inverse))
        got = ntt.ntt_host(vals, modulus, inverse)
        assert got == mira_ntt.ntt_host(vals, modulus, inverse)
    assert ntt.ntt_host(ntt.ntt_host(vals, modulus), modulus, True) == vals


def test_host_ntt_rejects_bad_sizes():
    with pytest.raises(ValueError):
        ntt.ntt_host([1, 2, 3], BN254_FR)
    with pytest.raises(ValueError):
        ntt.get_omega(BN254_FR, 29)
    with pytest.raises(ValueError):  # Fq has 2-adicity 1
        ntt.get_omega(BN254_FQ, 2)


def fields_of(obj):
    """A Groth16 key or proof as plain data, so that the port's objects
    compare with mira_tpu's (other classes all the way down)."""
    return to_plain(obj)


def items_of(items):
    return [(fields_of(p), pub) for p, pub in items]


@pytest.fixture(scope="module")
def proofs():
    """One benchmark circuit, its keys and two proofs, made by each package
    from random.Random(3)."""
    out = {}
    for name, mod in (("port", g16), ("mira", mira_g16)):
        rng = random.Random(3)
        r1cs, z = mod.benchmark_r1cs(20)
        pk = mod.setup(r1cs, rng)
        pub = z[1 : r1cs.num_public + 1]
        out[name] = (r1cs, z, pk, pub,
                     [(mod.prove(pk, r1cs, z, rng), list(pub)) for _ in range(2)])
    return out


def test_groth16_matches_mira_and_verifies(proofs):
    r1cs, z, pk, pub, items = proofs["port"]
    m_r1cs, m_z, m_pk, _, m_items = proofs["mira"]
    assert r1cs.rows == m_r1cs.rows and z == m_z and r1cs.is_satisfied(z)
    assert fields_of(pk.vk) == fields_of(m_pk.vk)
    for name in ("beta_g1", "delta_g1", "a_query", "b_g1_query", "b_g2_query",
                 "h_query", "l_query"):
        assert same(getattr(pk, name), getattr(m_pk, name)), name
    assert items_of(items) == items_of(m_items)
    assert all(g16.verify(pk.vk, p, pub) for p, _ in items)
    bad = g16.Proof(a=items[0][0].a, b=items[0][0].b, c=items[1][0].a)
    assert not g16.verify(pk.vk, bad, pub)
    with pytest.raises(ValueError):
        g16.prove(pk, r1cs, [1] + z[1:-1] + [z[-1] + 1], random.Random(0))


def test_host_g2_msm_matches_mira():
    """The port's Jacobian Pippenger G2 MSM against mira_tpu's affine
    double-and-add sum: zero scalars, a scalar of r, duplicate, opposite and
    identity points."""
    rng = random.Random(5)
    F = field(BN254_FQ)
    base = [G2Point.random(rng, F) for _ in range(4)]
    pts = base + [base[0], base[1].neg(), G2Point.identity(F), base[2]]
    sc = [rng.randrange(BN254_FR) for _ in pts]
    sc[1], sc[3] = 0, BN254_FR
    want = mira_g16._g2_msm(sc, to_mira(pts))
    assert same(g16._g2_msm(sc, pts), want)
    assert g16._g2_msm([1, 1], [base[0], base[0].neg()]).is_inf
    with pytest.raises(ValueError):
        g16._g2_msm([0, BN254_FR], base[:2])


def test_gt_accumulator_folds_real_proofs(proofs):
    _, _, pk, _, items = proofs["port"]
    acc = g16.GtAccumulator(pk.vk)
    for r, (pf, pub) in zip((5, 11), items):
        acc.fold(pf, pub, r)
    assert acc.check()
    acc.gt = acc.gt.mul(Tuple12.generator(field(BN254_FQ)))
    assert not acc.check()


def test_proof_bundle_round_trips_with_mira(proofs, tmp_path):
    _, _, pk, _, items = proofs["port"]
    conversion.save_proof_bundle(str(tmp_path / "port.json"), pk.vk, items)
    vk, got = mira_conversion.load_proof_bundle(str(tmp_path / "port.json"))
    assert fields_of(vk) == fields_of(pk.vk) and items_of(got) == items_of(items)
    mira_conversion.save_proof_bundle(str(tmp_path / "mira.json"), vk, got)
    vk, got = conversion.load_proof_bundle(str(tmp_path / "mira.json"))
    assert vk == pk.vk and got == items


@pytest.mark.parametrize("curve", [BN254_G1, GRUMPKIN], ids=["bn254", "grumpkin"])
def test_mock_key_matches_mira(curve):
    mine = MockCommitmentKey(curve, 6, b"t", device="cpu")
    theirs = MiraMockKey(to_mira(curve), 6, b"t")
    rng = random.Random(1)
    vals = [rng.randrange(curve.scalar_modulus) for _ in range(50)]
    want = mine.commit_ints(vals)
    assert same(want, theirs.commit_ints(vals))
    v = limb_field(curve.scalar_modulus).encode(vals)
    assert mine.commit_device(v) == want
    assert mine.commit_device_many([v, v], defer=True)() == [want, want]
    with pytest.raises(ValueError):
        mine.commit_ints([1] * 65)


def _runner(cls, circuit, ctx):
    curve = BN254_G1 if cls is CircuitRunner else MIRA_BN254_G1
    return cls(K, circuit, [], curve, ctx.num_g1, ctx.num_g2, ctx.gt_degree,
               ctx.num_gt_cross_terms)


def test_real_proofs_fold_matches_mira(proofs):
    """tests/test_groth16_fold.py's fold of two real proofs, by the port and
    by mira_tpu: the fresh instances carry the proofs' elements, the folded
    accumulators are equal, each passes the real-pairing Gt decider (the
    last one mira_tpu's as well), and a tampered Gt element raises
    SatError."""
    ctxs = {}
    for name, mod in (("port", g16), ("mira", mira_g16)):
        _, _, pk, _, items = proofs[name]
        ctxs[name] = mod.Groth16FoldContext(pk.vk, batch_size=1)
        ctxs[name].push_proofs(list(items))
    S_t = _runner(CircuitRunner, MulCircuit(1), ctxs["port"]).collect_structure()
    S_m = _runner(MiraRunner, MulCircuit(1), ctxs["mira"]).collect_structure()
    S_t.groth16_ctx, S_m.groth16_ctx = ctxs["port"], ctxs["mira"]
    advice = [_runner(MiraRunner, MulCircuit(s), ctxs["mira"]).collect_witness()
              for s in (1, 2)]
    ck_m = MiraKey.setup(MIRA_BN254_G1, K + 2, b"test")
    ck_t = CommitmentKey(BN254_G1, ck_m._limbs, device="cpu")
    pp_m, _ = MiraFS.setup_params(MiraPoint.generator(MIRA_BN254_G1), S_m)
    pp_t, vp = VanillaFS.setup_params(AffinePoint.generator(BN254_G1), S_t)

    items = proofs["port"][4]
    traces = []
    for i, adv in enumerate(advice):
        tt = VanillaFS.generate_plonk_trace(ck_t, [], adv, pp_t, ro_t())
        tm = MiraFS.generate_plonk_trace(ck_m, [], adv, pp_m, ro())
        assert tt.u.g1_elements[0] == items[i][0].a
        assert tt.u.g2_elements[0] == items[i][0].b
        assert same(tt.u.W_commitments, tm.u.W_commitments)
        assert same(tt.u.g1_elements, tm.u.g1_elements)
        traces.append((tt, tm))

    acc_m = ms.RelaxedPlonkTrace(
        ms.RelaxedPlonkInstance.new(S_m.curve, S_m.num_io, S_m.num_challenges,
                                    len(S_m.round_sizes), S_m.num_g1_elems,
                                    S_m.num_g2_elems),
        ms.RelaxedPlonkWitness.zeros(S_m.lf, S_m.k, S_m.round_sizes))
    acc_t = relaxed_trace_from_mira(acc_m)
    S_t.is_sat_relaxed(ck_t, acc_t.U, acc_t.W)  # u = 0, gt = 1 = R(0)

    rng_m, rng_t = random.Random(7), random.Random(7)
    for tt, tm in traces:
        prev_t = acc_t
        acc_m, proof_m = MiraFS.prove(ck_m, pp_m, ro(), acc_m, tm, rng=rng_m)
        acc_t, proof_t = VanillaFS.prove(ck_t, pp_t, ro_t(), acc_t, tt, rng=rng_t)
        assert same(proof_t[1], proof_m[1])  # the real Gt cross terms
        assert same(acc_t.U, acc_m.U)
        S_t.is_sat_relaxed(ck_t, acc_t.U, acc_t.W)  # with the real-pairing Gt check
        assert VanillaFS.verify(vp, ro_t(), ro_t(), prev_t.U, tt.u, proof_t) == acc_t.U
    assert rng_t.random() == rng_m.random()  # no placeholder draws on either
    # the port's accumulator, carried back, passes mira_tpu's decider too
    back = relaxed_trace_to_mira(acc_t)
    S_m.is_sat_relaxed(ck_m, back.U, back.W)

    acc_t.U.gt_element = acc_t.U.gt_element.mul(Tuple12.generator(field(BN254_FQ)))
    with pytest.raises(SatError, match="Gt"):
        S_t.is_sat_relaxed(ck_t, acc_t.U, acc_t.W)


@pytest.mark.slow
def test_snarkstar_real_proofs_two_steps():
    """The SnarkStar IVC on the CPU with mock keys, real Groth16 proofs and
    two fold steps, as tests/test_groth16_fold.py runs mira_tpu's: the
    strict verify inside run() includes the real-pairing Gt decider."""
    from mira_tpu_torch.workloads import snarkstar

    secs = snarkstar.run(steps=2, batch_size=1, real_proofs=True,
                         num_constraints=20, device="cpu")
    assert len(secs["fold_steps"]) == 2


def test_merkle_step_circuit_matches_mira():
    """SnarkStar's primary step circuit: the same updates give the same
    roots and the same tape signals as mira_tpu's."""
    from mira_tpu.ivc import step_folding_circuit as mira_sfc
    from mira_tpu.workloads.merkle import MerkleTreeUpdateCircuit as MiraMerkle
    from mira_tpu_torch.ivc.step_folding_circuit import MAIN_GATE_T
    from mira_tpu_torch.workloads.merkle import MerkleTreeUpdateCircuit

    assert MAIN_GATE_T == mira_sfc.MAIN_GATE_T
    mine, theirs = MerkleTreeUpdateCircuit(BN254_FR, 2), MiraMerkle(BN254_FR, 2)
    for circuit in (mine, theirs):
        rng = random.Random(4)
        for _ in range(3):
            circuit.random_update_leaves(rng)
    assert mine.update_leaves([(5, 9)]) == theirs.update_leaves([(5, 9)])
    for _ in range(4):
        assert (mine.process_step([0], 0, BN254_FR)
                == theirs.process_step([0], 0, BN254_FR))
        assert mine.tape_signals() == theirs.tape_signals()
        mine.pop_front_proof_batch()
        theirs.pop_front_proof_batch()
    with pytest.raises(ValueError):
        mine.update_leaves([])
