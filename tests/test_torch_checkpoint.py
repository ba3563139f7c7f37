"""The IVC checkpoint (mira_tpu_torch/ivc/checkpoint.py) against mira_tpu's:
one file format for both packages.

Small traces folded by both packages from the same seeds (a BN254 side,
and a Grumpkin side with TensorStar's secondary shape: 23 G1, 2 G2, Gt
degree 3, 12 Gt cross terms) are saved by one package and loaded by the
other; the loaded instances, group elements and witnesses must equal the
source's exactly.  The reference's own round trip (tests/test_ivc.py:
restore, resume, verify) runs on the port at k=17 with mock keys."""

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mira_tpu.curves.host import BN254_G1 as MIRA_BN254_G1
from mira_tpu.curves.host import GRUMPKIN as MIRA_GRUMPKIN
from mira_tpu.curves.host import AffinePoint as MiraPoint
from mira_tpu.ivc import checkpoint as mira_checkpoint
from mira_tpu.nifs.vanilla import VanillaFS as MiraFS
from mira_tpu.ops.commitment import CommitmentKey as MiraKey
from mira_tpu.ops.poseidon import create_ro
from mira_tpu.plonk import structure as ms
from mira_tpu.table.runner import CircuitRunner as MiraRunner
from mira_tpu_torch.convert import limbs16_to_words, relaxed_trace_from_mira
from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN, AffinePoint, Tuple12
from mira_tpu_torch.fields.host import field
from mira_tpu_torch.ivc import checkpoint
from mira_tpu_torch.nifs.vanilla import VanillaFS
from mira_tpu_torch.ops import poseidon as port_poseidon
from mira_tpu_torch.ops.commitment import CommitmentKey
from mira_tpu_torch.table.runner import CircuitRunner

from test_nifs import K, FiboCircuit, MulCircuit
from torch_port_helpers import same

# TensorStar's secondary side (workloads/tensorstar.py)
SHAPE = dict(num_g1=23, num_g2=2, gt_degree=3, gt_cross_terms=12)


def fold_both(curve_t, curve_m, circuit_cls, shape, seed):
    """The same two traces folded into a zero accumulator by both packages
    (the same key, seeded SPS and Gt draws); returns, per package, the
    structure, the key, the folded relaxed trace and one more fresh trace."""
    args = (shape["num_g1"], shape["num_g2"], shape["gt_degree"],
            shape["gt_cross_terms"]) if shape else ()
    m_runners = [MiraRunner(K, circuit_cls(seed + i), [], curve_m, *args)
                 for i in range(3)]
    t_runner = CircuitRunner(K, circuit_cls(seed), [], curve_t, *args)
    S_m, S_t = m_runners[0].collect_structure(), t_runner.collect_structure()
    ck_m = MiraKey.setup(curve_m, K + 2, b"ckpt")
    ck_t = CommitmentKey(curve_t, ck_m._limbs, device="cpu")
    pp_m, _ = MiraFS.setup_params(MiraPoint.generator(curve_m), S_m)
    pp_t, _ = VanillaFS.setup_params(AffinePoint.generator(curve_t), S_t)
    base = curve_t.base_modulus
    gt_m, gt_t = random.Random(seed), random.Random(seed)
    traces = []
    for r in m_runners:
        adv = r.collect_witness()
        traces.append((
            VanillaFS.generate_plonk_trace(ck_t, [], adv, pp_t,
                                           port_poseidon.create_ro(base)),
            MiraFS.generate_plonk_trace(ck_m, [], adv, pp_m, create_ro(base))))
    acc_m = ms.RelaxedPlonkTrace(
        ms.RelaxedPlonkInstance.new(S_m.curve, S_m.num_io, S_m.num_challenges,
                                    len(S_m.round_sizes), S_m.num_g1_elems,
                                    S_m.num_g2_elems),
        ms.RelaxedPlonkWitness.zeros(S_m.lf, S_m.k, S_m.round_sizes))
    acc_t = relaxed_trace_from_mira(acc_m)
    for tt, tm in traces[:2]:
        acc_m, _ = MiraFS.prove(ck_m, pp_m, create_ro(base), acc_m, tm, rng=gt_m)
        acc_t, _ = VanillaFS.prove(ck_t, pp_t, port_poseidon.create_ro(base),
                                   acc_t, tt, rng=gt_t)
    return (S_t, ck_t, acc_t, traces[2][0]), (S_m, ck_m, acc_m, traces[2][1])


@pytest.fixture(scope="module")
def folded():
    """Both packages' IVC-shaped state: a folded primary side over BN254, a
    folded secondary side over Grumpkin with TensorStar's G1/G2/Gt shape,
    and a pending secondary trace."""
    p_t, p_m = fold_both(BN254_G1, MIRA_BN254_G1, FiboCircuit, None, 3)
    s_t, s_m = fold_both(GRUMPKIN, MIRA_GRUMPKIN, MulCircuit, SHAPE, 5)
    return {"port": _ivc_like(p_t, s_t, BN254_G1, GRUMPKIN),
            "mira": _ivc_like(p_m, s_m, MIRA_BN254_G1, MIRA_GRUMPKIN)}


def _ivc_like(primary, secondary, curve_1, curve_2):
    (S1, ck1, acc1, _), (S2, ck2, acc2, fresh2) = primary, secondary
    pp = SimpleNamespace(
        primary_curve=curve_1, secondary_curve=curve_2,
        primary=SimpleNamespace(S=S1, ck=ck1), secondary=SimpleNamespace(S=S2, ck=ck2))
    return SimpleNamespace(
        pp=pp, step=3,
        primary=SimpleNamespace(relaxed_trace=acc1, z_0=[11], z_i=[12345]),
        secondary=SimpleNamespace(relaxed_trace=acc2, z_0=[22], z_i=[2 ** 250 + 7]),
        secondary_trace=fresh2)


def _blank(src):
    """A fresh IVC-like object with `src`'s public parameters."""
    return SimpleNamespace(pp=src.pp, step=0, primary=SimpleNamespace(),
                           secondary=SimpleNamespace(), secondary_trace=None)


def _same_state(t, m):
    """The port's IVC-like state equals mira_tpu's: z values, step,
    instances (commitments, G1/G2/Gt elements) and witnesses exactly."""
    assert t.step == m.step
    for a, b in ((t.primary, m.primary), (t.secondary, m.secondary)):
        assert (a.z_0, a.z_i) == (b.z_0, b.z_i)
        assert same(a.relaxed_trace.U, b.relaxed_trace.U)
        for x, y in zip(a.relaxed_trace.W.W, b.relaxed_trace.W.W):
            assert torch.equal(x, limbs16_to_words(np.asarray(y)))
        assert torch.equal(a.relaxed_trace.W.E,
                           limbs16_to_words(np.asarray(b.relaxed_trace.W.E)))
    assert same(t.secondary_trace.u, m.secondary_trace.u)
    assert len(t.secondary_trace.w.W) == len(m.secondary_trace.w.W)
    for x, y in zip(t.secondary_trace.w.W, m.secondary_trace.w.W):
        assert torch.equal(x, limbs16_to_words(np.asarray(y)))


def test_folded_states_are_equal_and_not_trivial(folded):
    _same_state(folded["port"], folded["mira"])
    U = folded["port"].secondary.relaxed_trace.U
    assert len(U.g1_elements) == 23 and len(U.g2_elements) == 2
    assert not any(p.is_inf for p in U.g1_elements + U.g2_elements)
    assert U.gt_element != Tuple12.one(field(GRUMPKIN.base_modulus))


def test_mira_saves_port_loads(folded, tmp_path):
    path = str(tmp_path / "mira.npz")
    mira_checkpoint.save(folded["mira"], path)
    got = checkpoint.load(_blank(folded["port"]), path)
    _same_state(got, folded["mira"])


def test_port_saves_mira_loads(folded, tmp_path):
    path = str(tmp_path / "port.npz")
    checkpoint.save(folded["port"], path)
    got = mira_checkpoint.load(_blank(folded["mira"]), path)
    _same_state(folded["port"], got)
    _same_state(checkpoint.load(_blank(folded["port"]), path), folded["mira"])


def test_files_have_the_same_keys_and_dtypes(folded, tmp_path):
    mira_checkpoint.save(folded["mira"], str(tmp_path / "m.npz"))
    checkpoint.save(folded["port"], str(tmp_path / "t.npz"))
    with np.load(tmp_path / "m.npz") as m, np.load(tmp_path / "t.npz") as t:
        assert sorted(m.files) == sorted(t.files)
        for key in m.files:
            assert (t[key].dtype, t[key].shape) == (m[key].dtype, m[key].shape), key
            assert np.array_equal(t[key], m[key]), key


@pytest.mark.parametrize("key,bad", [
    ("pr_W0", lambda a: a[:-1]),
    ("sr_Ew", lambda a: a.reshape(-1, 8, 2)),
    ("st_W0", lambda a: a.astype(np.uint64)),
    ("sr_W0", lambda a: a[:, :8]),
])
def test_malformed_witness_array_raises(folded, tmp_path, key, bad):
    path = str(tmp_path / "c.npz")
    checkpoint.save(folded["port"], path)
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    d[key] = bad(d[key])
    np.savez_compressed(path, **d)
    with pytest.raises(ValueError):
        checkpoint.load(_blank(folded["port"]), path)


def _k17_pp():
    from mira_tpu_torch.ivc.public_params import CircuitSide, PublicParams
    from mira_tpu_torch.ivc.step_circuit import TrivialCircuit
    from mira_tpu_torch.ops.mock_commitment import MockCommitmentKey

    return PublicParams(
        CircuitSide(TrivialCircuit(arity=1),
                    MockCommitmentKey(BN254_G1, 21, b"bn256", "cpu"), 17),
        CircuitSide(TrivialCircuit(arity=1),
                    MockCommitmentKey(GRUMPKIN, 21, b"grumpkin", "cpu"), 17),
        BN254_G1, GRUMPKIN)


def _same_ivc_state(a, b):
    assert a.step == b.step
    for x, y in ((a.primary, b.primary), (a.secondary, b.secondary)):
        assert (x.z_0, x.z_i) == (y.z_0, y.z_i)
        assert x.relaxed_trace.U == y.relaxed_trace.U
        assert all(torch.equal(p, q) for p, q in
                   zip(x.relaxed_trace.W.W, y.relaxed_trace.W.W))
        assert torch.equal(x.relaxed_trace.W.E, y.relaxed_trace.W.E)
    assert a.secondary_trace.u == b.secondary_trace.u
    assert all(torch.equal(p, q) for p, q in
               zip(a.secondary_trace.w.W, b.secondary_trace.w.W))


def test_ivc_checkpoint_roundtrip(tmp_path):
    """tests/test_ivc.py's round trip on the port (a k=17 trivial IVC on
    the CPU, mock keys): load_checkpoint into a second IVC and IVC.resume
    both restore the saved state, and both verify."""
    from mira_tpu_torch.ivc.ivc import IVC
    from mira_tpu_torch.ivc.step_circuit import TrivialCircuit

    pp = _k17_pp()
    ivc = IVC(pp, TrivialCircuit(arity=1), [11], TrivialCircuit(arity=1), [22])
    path = str(tmp_path / "ivc_ckpt.npz")
    ivc.save_checkpoint(path)

    ivc2 = IVC(pp, TrivialCircuit(arity=1), [11], TrivialCircuit(arity=1), [22])
    ivc2.load_checkpoint(path)
    _same_ivc_state(ivc2, ivc)
    ivc2.verify(strict=False)

    ivc3 = IVC.resume(pp, TrivialCircuit(arity=1), TrivialCircuit(arity=1), path)
    _same_ivc_state(ivc3, ivc)
    ivc3.verify(strict=False)


@pytest.mark.slow
def test_resumed_ivc_folds_on_like_the_uninterrupted(tmp_path):
    """A k=17 IVC resumed from a checkpoint folds one more step to the same
    accumulators as the IVC that never stopped, and verifies strictly."""
    from mira_tpu_torch.ivc.ivc import IVC
    from mira_tpu_torch.ivc.step_circuit import TrivialCircuit

    pp = _k17_pp()
    ivc = IVC(pp, TrivialCircuit(arity=1), [11], TrivialCircuit(arity=1), [22])
    path = str(tmp_path / "ivc_ckpt.npz")
    ivc.save_checkpoint(path)
    resumed = IVC.resume(pp, TrivialCircuit(arity=1), TrivialCircuit(arity=1), path)
    ivc.fold_step()
    resumed.fold_step()
    _same_ivc_state(resumed, ivc)
    resumed.verify(strict=True)
