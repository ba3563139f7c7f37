"""The non-IVC baselines of the port (mira_tpu_torch/pcs/{kzg,ipa}.py,
workloads/merkle_baseline.py) against mira_tpu's: tests/test_pcs.py's
cases run through both packages on the same seeded inputs, each
commitment, evaluation and proof equal to mira_tpu's; and the Merkle
baseline at k=13 with both backends gives mira_tpu's column commitments."""

import dataclasses
import random

import numpy as np
import pytest

from mira_tpu.curves.host import GRUMPKIN as MIRA_GRUMPKIN
from mira_tpu.fields.limbs import ints_to_limbs as mira_ints_to_limbs
from mira_tpu.fields.limbs import limbs_to_ints as mira_limbs_to_ints
from mira_tpu.pcs import ipa as mira_ipa
from mira_tpu.pcs import kzg as mira_kzg
from mira_tpu.workloads import merkle_baseline as mira_baseline
from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN
from mira_tpu_torch.fields.limbs import ints_to_limbs, limbs_to_ints
from mira_tpu_torch.pcs import ipa, kzg
from mira_tpu_torch.workloads import merkle_baseline

from torch_port_helpers import same

R = BN254_G1.scalar_modulus
RG = GRUMPKIN.scalar_modulus


def test_limb_helpers_match_mira():
    rng = random.Random(3)
    vals = [0, 1, R - 1, (1 << 256) - 1] + [rng.randrange(1 << 256) for _ in range(60)]
    got = ints_to_limbs(vals)
    want = mira_ints_to_limbs(vals)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert limbs_to_ints(got) == mira_limbs_to_ints(want) == vals


@pytest.fixture(scope="module")
def kzg_srs():
    return kzg.KzgSrs.setup(32), mira_kzg.KzgSrs.setup(32)


def test_kzg_srs_matches_mira(kzg_srs):
    mine, theirs = kzg_srs
    assert same(mine.g1_powers, theirs.g1_powers)
    assert same(mine.g2, theirs.g2) and same(mine.tau_g2, theirs.tau_g2)


def test_kzg_commit_open_verify(kzg_srs):
    mine, theirs = kzg_srs
    rng = random.Random(0)
    coeffs = [rng.randrange(R) for _ in range(17)]
    C = kzg.kzg_commit(mine, coeffs)
    assert same(C, mira_kzg.kzg_commit(theirs, coeffs))
    z = rng.randrange(R)
    y, pi = kzg.kzg_open(mine, coeffs, z)
    y_m, pi_m = mira_kzg.kzg_open(theirs, coeffs, z)
    assert y == y_m and same(pi, pi_m)
    assert kzg.kzg_verify(mine, C, z, y, pi)
    assert not kzg.kzg_verify(mine, C, z, (y + 1) % R, pi)
    assert not kzg.kzg_verify(mine, C, z, y, mine.g1_powers[3])
    # constant polynomial: identity witness
    y0, pi0 = kzg.kzg_open(mine, [5], z)
    assert y0 == 5 and kzg.kzg_verify(mine, kzg.kzg_commit(mine, [5]), z, y0, pi0)


def test_kzg_srs_cache_is_mira_layout(tmp_path):
    """The port's SRS cache file is mira_tpu's, and each package reads the
    other's."""
    port_dir, mira_dir = str(tmp_path / "port"), str(tmp_path / "mira")
    mine = kzg.KzgSrs.load_or_setup_cache(8, cache_dir=port_dir)
    mira_kzg.KzgSrs.load_or_setup_cache(8, cache_dir=mira_dir)
    name = next((tmp_path / "port").iterdir()).name
    a = np.load(tmp_path / "port" / name)
    b = np.load(tmp_path / "mira" / name)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    back = mira_kzg.KzgSrs.load_or_setup_cache(8, cache_dir=port_dir)
    assert same(back.g1_powers, mine.g1_powers)
    again = kzg.KzgSrs.load_or_setup_cache(8, cache_dir=mira_dir)
    assert again.g1_powers == mine.g1_powers and again.tau_g2 == mine.tau_g2


def test_ipa_commit_open_verify():
    rng = random.Random(1)
    mine = ipa.IpaSrs.setup(GRUMPKIN, 5, device="cpu")
    theirs = mira_ipa.IpaSrs.setup(MIRA_GRUMPKIN, 5)
    assert same(mine.gens, theirs.gens) and same(mine.u, theirs.u)
    coeffs = [rng.randrange(RG) for _ in range(29)]
    C = ipa.ipa_commit(mine, coeffs)
    assert same(C, mira_ipa.ipa_commit(theirs, coeffs))
    z = rng.randrange(RG)
    y, pf = ipa.ipa_open(mine, coeffs, z)
    y_m, pf_m = mira_ipa.ipa_open(theirs, coeffs, z)
    assert y == y_m and same(pf.l_points, pf_m.l_points)
    assert same(pf.r_points, pf_m.r_points) and pf.a_final == pf_m.a_final
    assert ipa.ipa_verify(mine, C, z, y, pf, len(coeffs))
    assert not ipa.ipa_verify(mine, C, z, (y + 1) % RG, pf, len(coeffs))
    bad = dataclasses.replace(pf, a_final=(pf.a_final + 1) % RG)
    assert not ipa.ipa_verify(mine, C, z, y, bad, len(coeffs))


@pytest.mark.parametrize("backend", ["kzg", "ipa"])
def test_merkle_baseline_matches_mira(backend, monkeypatch):
    """merkle_baseline.run at k=13: the port's column commitments equal
    mira_tpu's (mira_tpu's run returns none, so its commitments are caught
    where its baseline makes them)."""
    got = merkle_baseline.run(backend, k=13, device="cpu")
    module = mira_kzg if backend == "kzg" else mira_ipa
    name = f"{backend}_commit"
    seen = []
    orig = getattr(module, name)

    def record(srs, coeffs):
        seen.append(orig(srs, coeffs))
        return seen[-1]

    monkeypatch.setattr(module, name, record)
    mira_baseline.run(backend, k=13)
    # the baseline commits every column first (KZG's openings commit their
    # quotients after that)
    assert len(seen) >= len(got) and same(got, seen[: len(got)])
