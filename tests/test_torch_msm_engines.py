"""The plain versions of the generic-base MSM engines of the port
(ops/msm.py: kernels 4 and 5, the shared-Horner Pippenger; kernels 6 and 7,
the per-lane double-and-add) against mira_tpu's native and host MSMs, the
routes mira_tpu pins equal to its Pallas kernels (their interpret mode takes
minutes); `pippenger_msm_model`, kernels 4 and 5's chunked algorithm (a w = 5
table per chunk of bases, window sums added over the chunks, one Horner),
against both; the `msm(method=)` dispatcher;
CommitmentKey(generic_method=) on a k=8 key, with the same commitment for
every method and as mira_tpu's; and kernel 7's parts of its bases
(`lane_parts`) within kernel 1's record limit.  Exact equality throughout."""

import random

import numpy as np
import pytest
import torch

from mira_tpu.curves.host import msm_host
from mira_tpu.ops.commitment import CommitmentKey as MiraKey
from mira_tpu.ops.native_msm import msm_native
from mira_tpu_torch.convert import to_plain
from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN, AffinePoint
from mira_tpu_torch.curves.torch_curve import jacobian_ops
from mira_tpu_torch.fields.limbs import limb_field
from mira_tpu_torch.ops import commitment as commitment_mod
from mira_tpu_torch.ops import msm as msm_mod
from mira_tpu_torch.ops.commitment import CommitmentKey
from mira_tpu_torch.ops.msm import (
    METHODS,
    encode_scalars,
    msm,
    msm_pippenger_plain,
    pippenger_msm_model,
    pippenger_windows,
    signed_digits,
    unsigned_digits,
)

from torch_port_helpers import to_mira

CURVES = [BN254_G1, GRUMPKIN]
IDS = ["bn254", "grumpkin"]
ENGINES = ["pippenger", "pippenger-u4", "window", "lane"]
# the per-lane plain versions cost their 254 (64) steps whatever N is
SIZES = {"pippenger": 256, "pippenger-u4": 256, "window": 64, "lane": 64}


def _input(curve, n, seed):
    """Seeded bases with duplicates (outside the TPU Pippenger kernels'
    precondition of distinct bases, exact here) and two identity padding
    lanes; scalars 0, 1, r - 1, 16 (signed digit -16 with a carry), 16 in
    every 5-bit window, 2^250 - 1 (every raw digit maximal), the rest seeded
    by numpy."""
    rng = random.Random(seed)
    base = [AffinePoint.random(curve, rng) for _ in range(16)]
    pts = [base[i % 13] for i in range(n - 2)] + [AffinePoint.identity(curve)] * 2
    r = curve.scalar_modulus
    nrng = np.random.default_rng(seed)
    sc = [int.from_bytes(nrng.bytes(32), "little") % r for _ in range(n)]
    every = sum(16 << (5 * k) for k in range(50)) % r
    sc[:6] = [0, 1, r - 1, 16, every, (1 << 250) - 1]
    return sc, pts


def _run(method, curve, sc, pts):
    ops = jacobian_ops(curve.name)
    out = msm(encode_scalars(sc, curve.scalar_modulus), ops.encode_points(pts),
              curve, method)
    return ops.decode_points(tuple(c[None] for c in out))[0]


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
@pytest.mark.parametrize("method", ENGINES)
def test_plain_engine_matches_mira_native_msm(method, curve):
    n = SIZES[method]
    sc, pts = _input(curve, n, seed=n + len(method))
    want = msm_native(sc, [to_mira(q) for q in pts])
    assert to_plain(_run(method, curve, sc, pts)) == to_plain(want)


@pytest.mark.parametrize("method", ENGINES)
def test_plain_engine_small_cases_match_mira_host_msm(method):
    """P + P, P + (-P), and digit 16 on equal bases (-16 with a carry)
    beside an identity base: against mira_tpu's pure-Python host MSM."""
    curve = BN254_G1
    P = AffinePoint.random(curve, random.Random(3))
    ident = AffinePoint.identity(curve)
    for sc, pts in (([1, 1], [P, P]), ([1, 1], [P, P.neg()]),
                    ([16, 16, 5], [P, P, ident])):
        want = msm_host(sc, [to_mira(q) for q in pts])
        assert to_plain(_run(method, curve, sc, pts)) == to_plain(want), (sc, pts)


def _decode(curve, out):
    return jacobian_ops(curve.name).decode_points(tuple(c[None] for c in out))[0]


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
@pytest.mark.parametrize("signed", [True, False], ids=["signed", "u4"])
@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_pippenger_model_matches_plain_and_mira(chunk, signed, curve):
    """Kernels 4/5's chunked algorithm at chunks of 1, 3 and 8 bases over
    6, 11 and 19 bases (three to six chunks, the last one short): a
    duplicate base and an opposite pair across chunk borders, an opposite
    pair inside one, two identity lanes, the edge scalars of `_input`,
    against the plain version and mira_tpu's native MSM on the same seeded
    inputs."""
    n = {1: 6, 3: 11, 8: 19}[chunk]
    sc, pts = _input(curve, 19, seed=100 + chunk)
    pts[3] = pts[1]
    pts[2] = pts[0].neg()
    pts[7] = pts[8].neg()
    keep = list(range(n - 2)) + [17, 18]  # the identity lanes last
    sc, pts = [sc[i] for i in keep], [pts[i] for i in keep]
    s = encode_scalars(sc, curve.scalar_modulus)
    P = jacobian_ops(curve.name).encode_points(pts)
    got = _decode(curve, pippenger_msm_model(s, P, curve, signed, chunk))
    assert got == _decode(curve, msm_pippenger_plain(s, P, curve, signed))
    assert to_plain(got) == to_plain(msm_native(sc, [to_mira(q) for q in pts]))


@pytest.mark.parametrize("signed", [True, False], ids=["signed", "u4"])
@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_pippenger_model_small_cases_match_mira_host_msm(chunk, signed):
    """`test_plain_engine_small_cases_match_mira_host_msm`'s cases through
    the model: P + P, P + (-P) and digit 16 on equal bases beside an
    identity base, each pair in one chunk or split across two."""
    curve = BN254_G1
    ops = jacobian_ops(curve.name)
    P = AffinePoint.random(curve, random.Random(3))
    ident = AffinePoint.identity(curve)
    for sc, pts in (([1, 1], [P, P]), ([1, 1], [P, P.neg()]),
                    ([16, 16, 5], [P, P, ident])):
        want = msm_host(sc, [to_mira(q) for q in pts])
        got = _decode(curve, pippenger_msm_model(
            encode_scalars(sc, curve.scalar_modulus), ops.encode_points(pts),
            curve, signed, chunk))
        assert to_plain(got) == to_plain(want), (sc, pts)


def test_pippenger_chunks_cover_the_bases():
    """The chunks of kernels 4 and 5: consecutive, at most `chunk` bases,
    covering every base once; the scratch of a call is set by its largest
    chunk, not by its width; a chunk below 1 raises."""
    from mira_tpu_torch.ops import cuda_msm

    for n, chunk in ((1, 1), (5, 2), (255, 256), (256, 256), (257, 256),
                     (768, 256), (1 << 21, 1 << 19)):
        parts = cuda_msm.pippenger_chunks(n, chunk)
        assert [c0 for c0, _ in parts] == list(range(0, n, chunk))
        assert sum(nc for _, nc in parts) == n
        assert all(1 <= nc <= chunk for _, nc in parts)
    assert cuda_msm.pippenger_chunks(0, 4) == []
    with pytest.raises(ValueError):
        cuda_msm.pippenger_chunks(8, 0)
    # a 2^20-base call in chunks of 2^18 (four chunks' partials) needs less
    # than the whole width's table alone
    assert cuda_msm.pippenger_scratch_bytes(52, 1 << 18, 4 * 1536) < (1 << 20) * 1024


def test_recoding_edges():
    """The digits kernels 4 and 5 take: signed 5-bit digits in [-16, 15]
    that rebuild the scalar (16 becomes -16 with a carry; r - 1 and
    2^256 - 1 carry into the extra window), and raw 4-bit digits."""
    r = BN254_G1.scalar_modulus
    vals = [0, 1, 15, 16, 31, 32, r - 1, (1 << 250) - 1, (1 << 256) - 1]
    words = torch.from_numpy(np.frombuffer(
        b"".join(v.to_bytes(32, "little") for v in vals), "<i4").reshape(-1, 8).copy())
    nwin = pippenger_windows(254, True)
    assert nwin == 52 and pippenger_windows(254, False) == 64
    for window, nw in ((5, nwin), (5, 53)):
        d = signed_digits(words, nw, window)
        assert int(d.min()) >= -16 and int(d.max()) <= 15
        for v, row in zip(vals, d.tolist()):
            if v < 1 << (window * nw - 1):
                assert sum(x << (window * k) for k, x in enumerate(row)) == v
    assert signed_digits(words, nwin, 5)[3, :2].tolist() == [-16, 1]
    u = unsigned_digits(words, 64, 4)
    for v, row in zip(vals, u.tolist()):
        assert sum(x << (4 * k) for k, x in enumerate(row)) == v


def test_dispatcher_takes_the_plain_version_on_the_cpu(monkeypatch):
    """A CPU tensor never reaches a kernel wrapper; an unknown method
    raises."""
    from mira_tpu_torch.ops import cuda_msm

    def boom(*_a, **_k):
        raise AssertionError("a kernel wrapper was called for a CPU tensor")

    for name in ("msm_cuda", "msm_pippenger_cuda", "msm_lane_cuda"):
        monkeypatch.setattr(cuda_msm, name, boom)
    sc, pts = _input(BN254_G1, 8, seed=1)
    want = to_plain(msm_host(sc, [to_mira(q) for q in pts]))
    for method in ("bucket", "pippenger", "pippenger-u4"):
        assert to_plain(_run(method, BN254_G1, sc, pts)) == want
    with pytest.raises(ValueError):
        _run("pippenger-u5", BN254_G1, sc, pts)
    assert METHODS == ("bucket", "pippenger", "pippenger-u4", "window", "lane")


@pytest.fixture(scope="module")
def k8_keys():
    mira = MiraKey.setup(to_mira(BN254_G1), 8, b"engines")
    return mira, mira._limbs


@pytest.mark.parametrize("method", METHODS)
def test_commitment_key_generic_method(method, k8_keys):
    """Every generic-base commit of a k=8 key by `method` equals mira_tpu's
    commitment (its key's points through its native MSM): the one-shot
    commit of 256 values and commit_ints."""
    mira, limbs = k8_keys
    ck = CommitmentKey(BN254_G1, limbs, device="cpu", generic_method=method)
    vals = [int(v) for v in np.random.default_rng(8).integers(0, 1 << 62, 256)]
    vals[:3] = [0, 1, BN254_G1.scalar_modulus - 1]
    want = to_plain(msm_native(vals, mira.points))
    v = limb_field(BN254_G1.scalar_modulus).encode(vals)
    assert to_plain(ck.commit_device(v)) == want
    if method in ("bucket", "pippenger"):
        assert to_plain(ck.commit_ints(vals[:40])) == to_plain(
            msm_native(vals[:40], mira.points[:40]))


def test_commitment_key_routes_every_generic_commit(monkeypatch, k8_keys):
    """commit_device, commit_ints and a first sighting in
    commit_device_many (no table yet) all take the key's generic_method;
    an unknown method raises, given to the key or set on it."""
    seen = []

    def spy(scalars, points, curve, method="bucket"):
        seen.append(method)
        return msm_mod.msm(scalars, points, curve, method)

    monkeypatch.setattr(commitment_mod, "msm", spy)
    ck = CommitmentKey(BN254_G1, k8_keys[1], device="cpu",
                       generic_method="pippenger-u4")
    v = limb_field(BN254_G1.scalar_modulus).encode(list(range(1, 300)))
    ck.commit_device(v[:256])
    ck.commit_ints(list(range(10)))
    ck.commit_device_many([v[:256]])
    assert seen == ["pippenger-u4"] * 3
    with pytest.raises(ValueError):
        CommitmentKey(BN254_G1, ck._limbs, device="cpu", generic_method="pallas")
    with pytest.raises(ValueError):
        ck.generic_method = "pallas"
    assert ck.generic_method == "pippenger-u4"


# the most bases kernel 1 takes in one call at 254 bits: c = 16, 17 windows,
# n x 17 records below 2^31
BUCKET_ONE_PART = ((1 << 31) - 1) // 17


@pytest.mark.parametrize("n, records, nparts", [
    (0, 1 << 31, 0), (1, 1 << 31, 1), (1 << 21, 1 << 31, 1),
    (BUCKET_ONE_PART, 1 << 31, 1), (BUCKET_ONE_PART + 1, 1 << 31, 2),
    (1 << 28, 1 << 31, 3), (120, 4096, 2), (300, 4096, 5), (301, 4096, 5)])
def test_lane_parts_within_kernel_1s_record_limit(n, records, nparts):
    """Kernel 7's parts (kernel 1's C calls over consecutive parts of the
    bases): they cover [0, n) in order, none empty, each part's records at
    its own window stay below the limit, and so pass `check_bucket_records`;
    an n one past what one call of kernel 1 takes gives two parts."""
    from mira_tpu_torch.ops import cuda_msm
    from mira_tpu_torch.ops.msm import bucket_window, num_windows

    parts = cuda_msm.lane_parts(n, 254, records)
    assert len(parts) == nparts
    assert [c0 for c0, _ in parts] == [sum(nc for _, nc in parts[:i])
                                       for i in range(nparts)]
    assert sum(nc for _, nc in parts) == n
    for _, nc in parts:
        nwin = num_windows(254, bucket_window(nc))
        assert nc >= 1 and nc * nwin < records
        cuda_msm.check_bucket_records(nc, nwin)
    if n == BUCKET_ONE_PART + 1:
        assert bucket_window(n) == 16
        with pytest.raises(ValueError):
            cuda_msm.check_bucket_records(n, num_windows(254, 16))
