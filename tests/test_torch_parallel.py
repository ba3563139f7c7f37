"""The multi-device fold of the port (mira_tpu_torch/parallel/) on groups of
2 and 4 gloo ranks on the CPU, each rank a process started by `run_spmd`
with one torch thread: sharded MSMs, the distributed NTT and a k=9
VanillaFS fold with a mesh equal the port's single-device results and
mira_tpu's (its sharded MSM on its 8-device CPU mesh, its `ntt`, its
single-device prove on the host runtime), exactly."""

import os
import random

import numpy as np
import pytest
import torch

from mira_tpu.curves.host import msm_host
from mira_tpu.curves.jax_curve import jacobian_ops as mira_jacobian_ops
from mira_tpu.fields.limbs import limb_field as mira_limb_field
from mira_tpu.fields.params import BN254_FQ, BN254_FR
from mira_tpu.nifs.vanilla import VanillaFS as MiraFS
from mira_tpu.ops.commitment import CommitmentKey as MiraKey
from mira_tpu.ops.msm import encode_scalars as mira_encode_scalars
from mira_tpu.ops.ntt import ntt as mira_ntt
from mira_tpu.ops.poseidon import create_ro as mira_ro
from mira_tpu.parallel.mesh import make_mesh as mira_make_mesh
from mira_tpu.parallel.msm import sharded_msm as mira_sharded_msm
from mira_tpu.parallel.msm import sharded_msm_host as mira_sharded_msm_host
from mira_tpu.plonk import structure as ms
from mira_tpu.workloads.demo import demo_structure as mira_demo_structure
from mira_tpu_torch.convert import relaxed_trace_plain, to_plain
from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN, AffinePoint
from mira_tpu_torch.curves.torch_curve import jacobian_ops
from mira_tpu_torch.fields.limbs import limb_field
from mira_tpu_torch.ops.msm import encode_scalars
from mira_tpu_torch.parallel import dryrun
from mira_tpu_torch.parallel.mesh import Mesh, make_mesh, run_spmd
from mira_tpu_torch.parallel.msm import sharded_msm, sharded_msm_host
from mira_tpu_torch.parallel.ntt import distributed_ntt

from torch_port_helpers import to_mira

K = dryrun.K
NPTS = 64  # divides over 2, 4 and mira_tpu's 8 devices
LOG_NS = (6, 8)


def _msm_input(curve, seed):
    """NPTS random bases with a duplicate pair and an identity lane; zero,
    1, r - 1 and 16 (a carried signed digit) among the seeded scalars."""
    rng = random.Random(seed)
    pts = [AffinePoint.random(curve, rng) for _ in range(NPTS)]
    pts[7] = pts[6]
    pts[5] = AffinePoint.identity(curve)
    r = curve.scalar_modulus
    nrng = np.random.default_rng(seed)
    sc = [int.from_bytes(nrng.bytes(32), "little") % r for _ in range(NPTS)]
    sc[:4] = [0, 1, r - 1, 16]
    return sc, pts


def _plain_points(pts):
    return [None if q.is_inf else (q.x.v, q.y.v) for q in pts]


def _inputs():
    """Plain inputs of the ranks: both curves through "native", BN254 also
    through "lane" (the bit-serial plain version: its cost is its 254 steps,
    so one curve is enough); the NTT vectors; the fold at k = 9."""
    msm_in = []
    for i, (curve, methods) in enumerate(((BN254_G1, ("native", "lane", "auto")),
                                          (GRUMPKIN, ("native",)))):
        sc, pts = _msm_input(curve, 30 + i)
        msm_in.append((curve.name, sc, _plain_points(pts), methods))
    rng = np.random.default_rng(7)
    ntt_in = [(BN254_FR, [int.from_bytes(rng.bytes(32), "little") % BN254_FR
                          for _ in range(1 << log_n)]) for log_n in LOG_NS]
    return {"msm": msm_in, "ntt": ntt_in, "fold_k": K}


INPUTS = _inputs()


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def mesh_out(request):
    return run_spmd(dryrun.mesh_results, request.param, "cpu", INPUTS)


@pytest.fixture(scope="module")
def msm_want():
    """Per MSM input, the host MSM; for BN254 also mira_tpu's sharded MSM
    (method "native") on its 8-device CPU mesh, which must equal it (20 s a
    curve on the CPU, so once)."""
    want = []
    for name, sc, pts, _ in INPUTS["msm"]:
        curve = {"bn254": BN254_G1, "grumpkin": GRUMPKIN}[name]
        mpts = [to_mira(AffinePoint.identity(curve) if q is None else
                        AffinePoint(curve, q[0], q[1], False)) for q in pts]
        host = to_plain(msm_host(sc, mpts))
        if name == "bn254":
            mops = mira_jacobian_ops(name)
            out = mira_sharded_msm(mira_encode_scalars(sc, curve.scalar_modulus),
                                   mops.encode_points(mpts), to_mira(curve),
                                   mira_make_mesh(8), method="native")
            assert to_plain(mops.decode_points(tuple(c[None] for c in out))[0]) == host
        want.append(host)
    return want


def test_sharded_msm_matches_mira_mesh_and_host(mesh_out, msm_want):
    for (_, _, _, methods), got, want in zip(INPUTS["msm"], mesh_out["msm"],
                                             msm_want):
        for method, mine in zip(methods, got):
            assert tuple(mine) == want, method


def test_distributed_ntt_matches_mira(mesh_out):
    lf = mira_limb_field(BN254_FR)
    for (p, vals), (fwd, inv) in zip(INPUTS["ntt"], mesh_out["ntt"]):
        a = lf.encode(vals)
        assert fwd == lf.decode(mira_ntt(a, p))
        assert inv == lf.decode(mira_ntt(a, p, inverse=True))


@pytest.fixture(scope="module")
def single_fold():
    """The port's single-device fold on the CPU and mira_tpu's on its host
    runtime (the dryrun's reference values), as plain data."""
    S, ck, trace, folded = dryrun.demo_fold(None, "cpu", K)
    S.is_sat_relaxed(ck, folded.U, folded.W)
    S_m, advice = mira_demo_structure(K)
    ck_m = MiraKey.setup(to_mira(BN254_G1), K + 2, dryrun.LABEL)
    pp_m, _ = MiraFS.setup_params(to_mira(AffinePoint.generator(BN254_G1)), S_m)
    trace_m = MiraFS.generate_plonk_trace(ck_m, [], advice, pp_m, mira_ro(BN254_FQ))
    zero = ms.RelaxedPlonkTrace(
        ms.RelaxedPlonkInstance.new(S_m.curve, S_m.num_io, S_m.num_challenges,
                                    len(S_m.round_sizes), S_m.num_g1_elems,
                                    S_m.num_g2_elems),
        ms.RelaxedPlonkWitness.zeros(S_m.lf, S_m.k, S_m.round_sizes))
    folded_m = MiraFS.prove(ck_m, pp_m, mira_ro(BN254_FQ), zero, trace_m,
                            rng=random.Random(1))[0]
    return {"trace_u": to_plain(trace.u), "folded": relaxed_trace_plain(folded),
            "mira_trace_u": to_plain(trace_m.u),
            "mira_folded": relaxed_trace_plain(folded_m)}


def test_mesh_fold_matches_single_device_and_mira(mesh_out, single_fold):
    """Instance for instance and witness for witness: the mesh's SPS trace
    and fold (the same on every rank, checked inside) == the port's single
    device fold (which satisfies is_sat_relaxed) == mira_tpu's.  Each rank
    evaluated its block of the cross terms with the fold evaluator's row
    range (the only evaluator its structure built)."""
    fold = mesh_out["fold"]
    assert fold["evaluators"] == ["fold"]  # each rank's rows through FoldEvaluator
    assert fold["trace_u"] == single_fold["trace_u"] == single_fold["mira_trace_u"]
    for part in ("U", "W", "E"):
        assert fold["folded"][part] == single_fold["folded"][part], part
        assert fold["folded"][part] == single_fold["mira_folded"][part], part
    assert any(any(v) for v in fold["folded"]["W"])


def test_world_one_mesh_in_process():
    """make_mesh(1) starts this process's group of one; the sharded MSM and
    the distributed NTT then equal the single-device ones.  Leaving the
    block takes the group down and restores the environment."""
    from mira_tpu_torch.ops.ntt import ntt

    env = dict(os.environ)
    with make_mesh(1, "cpu") as mesh:
        assert (mesh.size, mesh.rank) == (1, 0)
        sc, pts = _msm_input(BN254_G1, 3)
        ops = jacobian_ops("bn254")
        s = encode_scalars(sc, BN254_G1.scalar_modulus)
        P = ops.encode_points(pts)
        got = ops.decode_points(tuple(c[None] for c in
                                      sharded_msm(s, P, BN254_G1, mesh)))
        assert to_plain(got[0]) == to_plain(msm_host(sc, [to_mira(q) for q in pts]))
        lf = limb_field(BN254_FR)
        a = lf.encode(INPUTS["ntt"][0][1])
        assert torch.equal(distributed_ntt(a, BN254_FR, mesh), ntt(a, BN254_FR))
        with pytest.raises(ValueError):
            make_mesh(2, "cpu")
        joined = make_mesh(1, "cpu")  # joins the group; closing it is a no-op
        joined.close()
        assert torch.distributed.is_initialized()
    assert not torch.distributed.is_initialized()
    assert dict(os.environ) == env


@pytest.mark.parametrize("curve", [BN254_G1, GRUMPKIN], ids=["bn254", "grumpkin"])
@pytest.mark.parametrize("nshards", [2, 8])
def test_sharded_msm_host_matches_mira(curve, nshards):
    """The host scaling engine: native shards on a thread pool, summed on the
    host == mira_tpu's sharded_msm_host == the host MSM."""
    sc, pts = _msm_input(curve, 40 + nshards)
    mpts = [to_mira(q) for q in pts]
    ops = jacobian_ops(curve.name)
    got = sharded_msm_host(encode_scalars(sc, curve.scalar_modulus),
                           ops.encode_points(pts), curve, nshards)
    mops = mira_jacobian_ops(curve.name)
    theirs = mira_sharded_msm_host(mira_encode_scalars(sc, curve.scalar_modulus),
                                   mops.encode_points(mpts), to_mira(curve), nshards)
    assert to_plain(got) == to_plain(theirs) == to_plain(msm_host(sc, mpts))
    with pytest.raises(ValueError):
        sharded_msm_host(encode_scalars(sc[:6], curve.scalar_modulus),
                         tuple(c[:6] for c in ops.encode_points(pts)), curve, 4)


def test_shapes_that_do_not_split_raise():
    """A mesh of 4 cannot split 2^3 elements into an (8 = 2 x 4) NTT's
    factors, nor 6 points; both raise before any collective."""
    mesh = Mesh(4, 0, torch.device("cpu"))
    lf = limb_field(BN254_FR)
    with pytest.raises(ValueError):
        distributed_ntt(lf.encode(list(range(8))), BN254_FR, mesh)
    ops = jacobian_ops("bn254")
    pts = ops.encode_points([AffinePoint.generator(BN254_G1)] * 6)
    with pytest.raises(ValueError):
        sharded_msm(encode_scalars([1] * 6, BN254_G1.scalar_modulus), pts,
                    BN254_G1, mesh)
    with pytest.raises(ValueError):
        sharded_msm(encode_scalars([1] * 4, BN254_G1.scalar_modulus),
                    tuple(c[:4] for c in pts), BN254_G1, mesh, method="bogus")


def test_mesh_rows_and_rowwise():
    mesh = Mesh(4, 2, torch.device("cpu"))
    assert mesh.rows(16) == (8, 12)
    assert mesh.rows(10) == (0, 10)  # not divisible: every rank does all rows


def test_dryrun_entry_point_on_one_cpu_rank(capsys):
    """`python -m mira_tpu_torch.parallel.dryrun --devices 1 --device cpu`:
    all four parts pass on a group of one in this process, which is taken
    down again."""
    assert dryrun.main(["--devices", "1", "--device", "cpu"]) == 0
    assert "all verified" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()
