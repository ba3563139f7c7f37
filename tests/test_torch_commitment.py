"""Port CommitmentKey against mira_tpu's: one key file set up by mira_tpu,
loaded by the port from the same cache; commitments equal; commit_delta
equals a full commit; the lazy delta commitment fails once, cleanly."""

import random
import types

import numpy as np
import pytest
import torch

from mira_tpu.curves.host import BN254_G1, GRUMPKIN, AffinePoint
from mira_tpu.fields.limbs import limb_field as jax_limb_field
from mira_tpu.ops.commitment import CommitmentKey as MiraKey
from mira_tpu_torch.fields.limbs import limb_field
from mira_tpu_torch.ops.commitment import CommitmentKey, LazyPoint
from mira_tpu_torch.table.packed import DeviceWitness

import torch_port_helpers  # noqa: F401  (sizes torch's thread pool)

K = 6
CURVES = [BN254_G1, GRUMPKIN]
IDS = ["bn254", "grumpkin"]


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ck"))


def keys(curve, cache_dir):
    label = f"torch-test-{curve.name}"
    theirs = MiraKey.load_or_setup_cache(curve, K, label, cache_dir=cache_dir)
    mine = CommitmentKey.load_or_setup_cache(curve, K, label, cache_dir=cache_dir)
    return theirs, mine


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
def test_same_key_file_same_commitments(curve, cache_dir):
    theirs, mine = keys(curve, cache_dir)
    assert np.array_equal(theirs._limbs, mine._limbs)
    rng = random.Random(3)
    r = curve.scalar_modulus
    vals = [rng.randrange(r) for _ in range(1 << K)]
    vals[:3] = [0, 1, r - 1]
    assert mine.commit_ints(vals) == theirs.commit_ints(vals)
    short = vals[:37]
    lf, jlf = limb_field(r), jax_limb_field(r)
    assert mine.commit_device(lf.encode(short)) == \
        theirs.commit_device(jlf.encode(short))
    with pytest.raises(ValueError):
        mine.commit_ints(vals + [1])


def test_prefix_of_a_larger_key(cache_dir):
    big = MiraKey.load_or_setup_cache(BN254_G1, K + 1, "torch-prefix",
                                      cache_dir=cache_dir)
    small = CommitmentKey.load_or_setup_cache(BN254_G1, K, "torch-prefix",
                                              cache_dir=cache_dir)
    assert np.array_equal(small._limbs, big._limbs[: 1 << K])


def test_corrupted_key_file_raises(tmp_path):
    key = MiraKey.load_or_setup_cache(BN254_G1, 3, "torch-bad",
                                      cache_dir=str(tmp_path))
    path = tmp_path / "bn254" / "torch-bad" / "3-svdw.npy"
    arr = np.load(path)
    arr[2, 1, 0] ^= 1
    np.save(path, arr)
    with pytest.raises(ValueError):
        CommitmentKey.load_or_setup_cache(BN254_G1, 3, "torch-bad",
                                          cache_dir=str(tmp_path))
    assert len(key) == 8


def _device_witness(lf, ncols, nrow, seed):
    rng = np.random.default_rng(seed)
    p = lf.modulus
    template = [int(x) % p for x in rng.integers(0, 1 << 62, size=ncols * nrow)]
    template[5] = 0
    positions = np.sort(rng.choice(ncols * nrow, size=19, replace=False))
    vals = [int(x) % p for x in rng.integers(0, 1 << 62, size=len(positions))]
    tmpl = lf.encode(template)
    pos = torch.from_numpy(positions)
    token = types.SimpleNamespace(
        uid=seed, packed_template=np.asarray(template, dtype=object).astype(str))
    dw = DeviceWitness(lf, token, tmpl, tmpl[pos], pos, positions,
                       lf.to_plain(lf.encode(vals)), ncols, nrow)
    full = list(template)
    for i, v in zip(positions, vals):
        full[i] = v
    return dw, full


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
def test_commit_delta_equals_full_commit(curve, cache_dir):
    _, mine = keys(curve, cache_dir)
    lf = limb_field(curve.scalar_modulus)
    dw, full = _device_witness(lf, 4, 16, seed=7)
    assert dw.encode_mont(lf).shape == (64, 8)
    assert lf.decode(dw.encode_mont(lf)) == full
    lazy = mine.commit_delta(dw)
    assert isinstance(lazy, LazyPoint)
    assert lazy == mine.commit_ints(full)
    # a second key object reads the persisted template commitment
    _, again = keys(curve, cache_dir)
    assert again.commit_delta(dw) == mine.commit_ints(full)


def test_lazy_point_failed_decode_raises_once():
    calls = []

    def thunk():
        calls.append(1)
        raise ValueError("decode failed")

    pt = LazyPoint(BN254_G1, thunk)
    with pytest.raises(ValueError):
        pt.x
    with pytest.raises(RuntimeError):
        pt.is_inf
    with pytest.raises(RuntimeError):
        pt == pt  # noqa: B015
    assert calls == [1]


def _delta_commit(key, seed=7):
    lf = limb_field(key.curve.scalar_modulus)
    dw, full = _device_witness(lf, 4, 16, seed=seed)
    return key.commit_delta(dw), key.commit_ints(full), dw


def test_derived_files_keyed_by_the_key(tmp_path):
    """A template commitment written for one key is not read for another
    key of the same curve and label (a regenerated key file), and mira_tpu's
    .cache/fbtab files are never read."""
    cache = str(tmp_path / "ck")
    a = CommitmentKey.load_or_setup_cache(BN254_G1, K, "keyed", cache_dir=cache)
    got, want, dw = _delta_commit(a)
    assert got == want
    written = list((tmp_path / "torch_derived").rglob("ctmpl-*.npy"))
    assert len(written) == 1
    # the key file is replaced by another key's points (same curve, label)
    other = CommitmentKey.setup(BN254_G1, K, b"another label")
    np.save(tmp_path / "ck" / "bn254" / "keyed" / f"{K}-svdw.npy", other._limbs)
    # and mira_tpu's derived-artifact directory holds a wrong template point
    fb = tmp_path / "fbtab" / "bn254" / "keyed"
    fb.mkdir(parents=True)
    g = AffinePoint.generator(BN254_G1)
    np.save(fb / written[0].name, np.stack([
        np.frombuffer(v.to_bytes(32, "little"), "<u2").astype(np.uint32)
        for v in (g.x.v, g.y.v, 0)]))
    b = CommitmentKey.load_or_setup_cache(BN254_G1, K, "keyed", cache_dir=cache)
    assert b._aux_dir != a._aux_dir
    got_b, want_b, _ = _delta_commit(b)
    assert got_b == want_b != want
    assert len(list((tmp_path / "torch_derived").rglob("ctmpl-*.npy"))) == 2


def test_corrupted_template_commit_raises(tmp_path):
    """A persisted template commitment that was altered raises on load
    instead of being used; multiples tables are never written to disk."""
    cache = str(tmp_path / "ck")
    key = CommitmentKey.load_or_setup_cache(GRUMPKIN, 8, "lane", cache_dir=cache)
    got, want, _ = _delta_commit(key)
    assert got == want
    lf = limb_field(GRUMPKIN.scalar_modulus)
    v = lf.encode(list(range(1, 257)))
    assert key.commit_device_many([v, v]) == [key.commit_device(v)] * 2
    assert set(key._fb_tables) == {256} and len(key._delta_cache) == 1
    path, = (tmp_path / "torch_derived").rglob("*.npy")
    assert path.name.startswith("ctmpl-")
    point = np.load(path)
    point[0, 0] ^= 1
    np.save(path, point)
    again = CommitmentKey.load_or_setup_cache(GRUMPKIN, 8, "lane", cache_dir=cache)
    with pytest.raises(ValueError, match="corrupted template commitment"):
        _delta_commit(again)


@pytest.mark.parametrize("curve", [BN254_G1, GRUMPKIN], ids=["bn254", "grumpkin"])
def test_key_grows_from_a_cached_smaller_key(curve, tmp_path):
    """A key of 2^k' cached under a label is the first rows of the key of
    2^k: loading 2^k generates only the rows past it, and the result equals
    mira_tpu's key made in one go."""
    cache = str(tmp_path / "ck")
    small = CommitmentKey.load_or_setup_cache(curve, 5, "grow", cache_dir=cache)
    big = CommitmentKey.load_or_setup_cache(curve, 8, "grow", cache_dir=cache)
    assert np.array_equal(big._limbs[:32], small._limbs)
    assert np.array_equal(big._limbs, MiraKey.setup(curve, 8, b"grow")._limbs)
    assert (tmp_path / "ck" / curve.name / "grow" / "8-svdw.npy").exists()
