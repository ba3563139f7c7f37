"""The fixed-base MSM's plain versions against mira_tpu, and the commitment
layer's fixed-base configuration: the multiples table equals mira_tpu's
`precompute_fixed_table` (decoded), the MSM equals mira_tpu's host MSMs on
adversarial inputs (duplicate bases, a zero scalar, an identity lane,
scalars 1, r - 1 and 2^250 - 1), commitments through tables equal those
through the bucket MSM, and tables are built only where mira_tpu builds
them.  The table build's kernel algorithm (`fixed_table_model`: mixed
additions, one inversion per block of lanes) equals mira_tpu's table and the
plain version, with blocks of no, one and only identity lanes.  Exact
equality throughout."""

import random
import types

import numpy as np
import pytest
import torch

from mira_tpu.curves.host import msm_host
from mira_tpu.curves.jax_curve import jacobian_ops as jax_jacobian_ops
from mira_tpu.ops.native_msm import msm_native
from mira_tpu.ops.pallas_msm import precompute_fixed_table
from mira_tpu_torch.convert import limbs16_to_words
from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN, AffinePoint
from mira_tpu_torch.curves.torch_curve import jacobian_ops
from mira_tpu_torch.fields.limbs import limb_field
from mira_tpu_torch.ops import commitment as commitment_mod
from mira_tpu_torch.ops import cuda_msm
from mira_tpu_torch.ops.commitment import CommitmentKey
from mira_tpu_torch.ops.msm import (
    TABLE_BLOCK,
    encode_scalars,
    fixed_table_model,
    msm_fixed_plain,
    precompute_fixed_table_plain,
    signed_digits,
)
from mira_tpu_torch.table.packed import DeviceWitness

from torch_port_helpers import same, to_mira  # also sizes torch's thread pool

CURVES = [BN254_G1, GRUMPKIN]
IDS = ["bn254", "grumpkin"]


def adversarial(curve, n, seed):
    """Seven distinct bases repeated, an exact (scalar, point) duplicate
    pair, an identity lane; scalars 0, 1, r - 1 and 2^250 - 1 (every raw
    5-bit digit 31, so the carry runs through every window)."""
    rng = random.Random(seed)
    base = [AffinePoint.random(curve, rng) for _ in range(7)]
    pts = [base[i % 7] for i in range(n - 1)] + [AffinePoint.identity(curve)]
    r = curve.scalar_modulus
    sc = [rng.randrange(r) for _ in range(n)]
    sc[:4] = [0, 1, r - 1, (1 << 250) - 1]
    sc[10] = sc[3]  # bases 3 and 10 are equal too
    return sc, pts


def fixed_msm(curve, sc, pts, window):
    ops = jacobian_ops(curve.name)
    table = cuda_msm.fixed_table(ops.encode_points(pts), curve, window)
    out = cuda_msm.msm_fixed(encode_scalars(sc, curve.scalar_modulus), table,
                             curve, window)
    return ops.decode_points(tuple(c[None] for c in out))[0]


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
@pytest.mark.parametrize("window", [3, 5])
def test_plain_table_matches_mira(curve, window):
    rng = random.Random(window)
    pts = [AffinePoint.random(curve, rng) for _ in range(256)]
    mine = precompute_fixed_table_plain(jacobian_ops(curve.name).encode_points(pts),
                                        curve, window)
    theirs = np.asarray(precompute_fixed_table(
        jax_jacobian_ops(curve.name).encode_points(to_mira(pts)),
        to_mira(curve), window))
    ntab = 1 << (window - 1)
    assert mine.shape == (256, ntab, 2, 8)
    lf = limb_field(curve.base_modulus)
    for v in range(ntab):
        for c in range(2):  # x then y; mira_tpu stacks all x planes first
            want = lf.decode(limbs16_to_words(theirs[c * ntab + v].T))
            assert lf.decode(mine[:, v, c]) == want
    assert lf.decode(mine[7, 2, 0]) == [pts[7].scalar_mul(3).x.v]


def _mira_table(curve, pts, window, lf):
    """mira_tpu's XLA table of pts, decoded: [lane][v] = (x, y)."""
    ntab = 1 << (window - 1)
    theirs = np.asarray(precompute_fixed_table(
        jax_jacobian_ops(curve.name).encode_points(to_mira(pts)),
        to_mira(curve), window))
    cols = [[lf.decode(limbs16_to_words(theirs[c * ntab + v].T)) for c in range(2)]
            for v in range(ntab)]
    return [[(cols[v][0][i], cols[v][1][i]) for v in range(ntab)]
            for i in range(len(pts))]


# kernel 3b's lanes at a block of 4: a block of live lanes, one with an
# identity lane, one of identity lanes only, a last block of two lanes
MODEL_IDENTITY = {"none": (), "one": (5,), "only": (8, 9, 10, 11)}


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
@pytest.mark.parametrize("window", [5, 6])
def test_table_model_vs_mira_and_plain(curve, window):
    """fixed_table_model at a block of 4 over 14 lanes (blocks of no, one
    and only identity lanes, and a last block of two): mira_tpu's table on
    the live lanes, the plain version on every lane ((0, 0) for the
    identity)."""
    rng = random.Random(window)
    pts = [AffinePoint.random(curve, rng) for _ in range(14)]
    for lanes in MODEL_IDENTITY.values():
        for i in lanes:
            pts[i] = AffinePoint.identity(curve)
    model = fixed_table_model(pts, curve, window, block=4)
    lf = limb_field(curve.base_modulus)
    plain = precompute_fixed_table_plain(
        jacobian_ops(curve.name).encode_points(pts), curve, window)
    ntab = 1 << (window - 1)
    assert model == [[(lf.decode(plain[i, v, 0:1])[0], lf.decode(plain[i, v, 1:2])[0])
                      for v in range(ntab)] for i in range(len(pts))]
    live = [i for i, P in enumerate(pts) if not P.is_inf]
    assert [model[i] for i in live] == _mira_table(curve, [pts[i] for i in live],
                                                   window, lf)
    assert all(model[i] == [(0, 0)] * ntab for i in (5, 8, 9, 10, 11))


@pytest.mark.parametrize("n", [1, 2, TABLE_BLOCK + 3])
def test_table_model_kernel_block(n):
    """At the kernel's own block: one lane, two, and a width that leaves a
    second block of three lanes; the last lane the identity."""
    curve = BN254_G1
    rng = random.Random(n)
    pts = [AffinePoint.random(curve, rng) for _ in range(n - 1)]
    pts.append(AffinePoint.identity(curve))
    model = fixed_table_model(pts, curve, 5)
    lf = limb_field(curve.base_modulus)
    plain = precompute_fixed_table_plain(
        jacobian_ops(curve.name).encode_points(pts), curve, 5)
    xs = lf.decode(plain[:, :, 0].reshape(-1, 8))
    ys = lf.decode(plain[:, :, 1].reshape(-1, 8))
    assert [c for row in model for c in row] == list(zip(xs, ys))


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
@pytest.mark.parametrize("window", [5, 6])
def test_plain_fixed_msm_256_vs_host(curve, window):
    sc, pts = adversarial(curve, 256, seed=window)
    assert same(fixed_msm(curve, sc, pts, window), msm_host(sc, to_mira(pts)))


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
def test_plain_fixed_msm_1000_vs_native(curve):
    """A width that is not a multiple of the TPU kernel's 256-lane block."""
    sc, pts = adversarial(curve, 1000, seed=3)
    assert same(fixed_msm(curve, sc, pts, 5), msm_native(sc, to_mira(pts)))


def test_plain_fixed_msm_edge_cases():
    """All-zero scalars and an identity-only table give the identity; P and
    -P, and P twice, fold exactly; a 256-bit scalar whose carry reaches the
    extra window at w = 5 acts as itself mod r."""
    curve = BN254_G1
    P = AffinePoint.random(curve, random.Random(9))
    ident = AffinePoint.identity(curve)
    for w in (5, 6):
        assert fixed_msm(curve, [0, 0], [P, P], w) == ident
        assert fixed_msm(curve, [5, 7], [ident, ident], w) == ident
        assert fixed_msm(curve, [1, 1], [P, P.neg()], w) == ident
        assert fixed_msm(curve, [1, 1], [P, P], w) == P.double()
    ops = jacobian_ops(curve.name)
    table = cuda_msm.fixed_table(ops.encode_points([P, P.double()]), curve, 5)
    s = torch.full((2, 8), -1, dtype=torch.int32)  # 2^256 - 1 in both lanes
    assert signed_digits(s, 52)[0, 51] == 2  # the carry reached window 51
    out = msm_fixed_plain(s, table, curve, 5)
    want = P.scalar_mul(3 * (((1 << 256) - 1) % curve.scalar_modulus))
    assert ops.decode_points(tuple(c[None] for c in out))[0] == want


def test_signed_digits_recompose_window6():
    rng = random.Random(4)
    r = BN254_G1.scalar_modulus
    vals = [0, 1, r - 1, (1 << 252) - 1] + [rng.randrange(r) for _ in range(40)]
    d = signed_digits(encode_scalars(vals, r), 44, window=6)
    assert int(d.min()) >= -32 and int(d.max()) <= 31
    assert int(d[:, 43].abs().max()) == 0  # the extra window gets no carry
    for v, row in zip(vals, d.tolist()):
        assert sum(x << (6 * w) for w, x in enumerate(row)) == v


def test_carry_thresholds_window6_match_sequential_recoding():
    """The kernel's closed-form carries at w = 6, where the last window's
    threshold exceeds 2^256 and is clamped."""
    rng = random.Random(12)
    vals = [rng.randrange(BN254_G1.scalar_modulus) for _ in range(30)] + [
        (1 << 253) - 1, (1 << 252) - 1]
    thr = cuda_msm.carry_thresholds(44, 6)
    d = signed_digits(encode_scalars(vals, BN254_G1.scalar_modulus), 44, 6)
    assert all(int(x) == 0xFFFFFFFF for x in thr[43])
    for v, row in zip(vals, d.tolist()):
        carry = 0
        for w in range(44):
            t = sum(int(thr[w, k]) << (32 * k) for k in range(8))
            assert int((v % (1 << (6 * w))) > t) == carry
            raw = (v >> (6 * w)) & 63
            assert row[w] == raw + carry - 64 * int(raw + carry >= 32)
            carry = int(raw + carry >= 32)


# -- the commitment layer -----------------------------------------------------
K = 9  # 512 key points: widths of 256 and 512 build tables


@pytest.fixture(scope="module")
def key_dir(tmp_path_factory):
    # derived artifacts go to a sibling of the key directory
    return str(tmp_path_factory.mktemp("fixed") / "ck")


def fresh_key(curve, key_dir):
    return CommitmentKey.load_or_setup_cache(curve, K, f"fixed-{curve.name}",
                                             cache_dir=key_dir, device="cpu")


def _vec(lf, n, seed):
    rng = np.random.default_rng(seed)
    vals = [int(x) % lf.modulus for x in rng.integers(0, 1 << 62, size=n)]
    vals[:3] = [0, 1, lf.modulus - 1]
    return vals, lf.encode(vals)


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
def test_table_commitments_equal_bucket_commitments(curve, key_dir):
    """commit_device_many builds a width's table on its second sighting
    (the first runs the bucket MSM) and then commits through it; every
    commitment equals the bucket MSM's.  A width that pads to the key size
    (300 -> 512) shares that width's table."""
    ck = fresh_key(curve, key_dir)
    lf = limb_field(curve.scalar_modulus)
    (a, va), (b, vb) = _vec(lf, 256, 1), _vec(lf, 300, 2)
    want_a, want_b = ck.commit_ints(a), ck.commit_ints(b)
    assert ck.commit_device_many([va]) == [want_a]
    assert ck._fb_tables == {}
    assert ck.commit_device_many([va, vb]) == [want_a, want_b]
    assert set(ck._fb_tables) == {256}
    assert ck._fb_tables[256][0] == 6
    decode = ck.commit_device_many([va, vb, vb], defer=True)
    assert decode() == [want_a, want_b, want_b]
    assert set(ck._fb_tables) == {256, 512}
    assert ck.table_shapes() == [(256, 6), (512, 6)]
    assert ck.fb_skipped == 0


def test_full_width_commits_never_build_tables(key_dir):
    """One-shot commits (the zero step, templates, the decider) take the
    bucket MSM however often a width recurs; narrow widths never build."""
    ck = fresh_key(BN254_G1, key_dir)
    lf = limb_field(BN254_G1.scalar_modulus)
    vals, v = _vec(lf, 512, 3)
    for _ in range(3):
        assert ck.commit_device(v) == ck.commit_ints(vals)
    small_vals, small = _vec(lf, 100, 4)
    for _ in range(3):
        assert ck.commit_device_many([small]) == [ck.commit_ints(small_vals)]
    assert ck._fb_tables == {} and ck._fb_seen == {}


def test_table_that_does_not_fit_runs_the_bucket_msm(tmp_path, monkeypatch):
    ck = fresh_key(GRUMPKIN, str(tmp_path / "ck"))
    lf = limb_field(GRUMPKIN.scalar_modulus)
    vals, v = _vec(lf, 256, 5)
    monkeypatch.setattr(commitment_mod, "_free_bytes", lambda device: 1 << 19)
    want = ck.commit_ints(vals)
    assert ck.commit_device_many([v, v, v]) == [want] * 3
    assert ck._fb_tables == {} and ck.fb_skipped == 2


def _device_witness(lf, ncols, nrow, seed):
    rng = np.random.default_rng(seed)
    p = lf.modulus
    template = [int(x) % p for x in rng.integers(0, 1 << 62, size=ncols * nrow)]
    positions = np.sort(rng.choice(ncols * nrow, size=40, replace=False))
    vals = [int(x) % p for x in rng.integers(0, 1 << 62, size=len(positions))]
    vals[0] = template[positions[1]]  # a write of an unchanged value
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
def test_commit_delta_through_its_table(curve, key_dir):
    ck = fresh_key(curve, key_dir)
    lf = limb_field(curve.scalar_modulus)
    dw, full = _device_witness(lf, 4, 128, seed=11)
    assert ck.commit_delta(dw) == ck.commit_ints(full)
    _, table, points = ck._delta_cache[11]
    assert points is None and table.shape == (40, 16, 2, 8)
    assert ck.commit_delta(dw) == ck.commit_ints(full)  # the cached table
    assert ck.table_shapes() == [(40, 5)]
    ck.release_device_cache()
    assert ck.table_shapes() == []
    assert ck.commit_delta(dw) == ck.commit_ints(full)  # a rebuilt table
