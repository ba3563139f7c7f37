"""The host-side index arithmetic of the bucket MSM on the card
(csrc/msm_bucket.cu, kernel 1) against mira_tpu: the window choice, signed
c-bit digits and their closed-form carries up to c = 20, the sorted (window,
bucket) layout, the equal-segment split with its head slots and merge
levels, and the whole algorithm run on host points (ops/msm.py
`bucket_msm_model`) against mira_tpu's native and host MSMs on both curves
at N = 1, 2 and 255, on inputs outside any precondition: all-equal scalars
(one bucket per window holds every point), all zero, scalars below 2^c,
r - 1, duplicate and opposite bases, identity lanes.  Exact equality."""

import random

import numpy as np
import pytest
import torch

from mira_tpu.curves.host import msm_host
from mira_tpu.ops.native_msm import msm_native
from mira_tpu.ops.pallas_msm import _bucket_carry_tables
from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN, AffinePoint
from mira_tpu_torch.ops import cuda_msm
from mira_tpu_torch.ops.msm import (
    BUCKET_MAX_WINDOW,
    MERGE_FIRST,
    MERGE_SEG,
    SEG,
    bucket_layout,
    bucket_msm_model,
    bucket_window,
    encode_scalars,
    magnitudes_with_bit,
    merge_levels,
    num_windows,
    segment_runs,
    signed_digits,
)

from torch_port_helpers import same, to_mira

CURVES = [BN254_G1, GRUMPKIN]
IDS = ["bn254", "grumpkin"]
CASES = ["random", "all_equal", "all_zero", "below_2c", "r_minus_1",
         "dup_opposite", "identity_lanes"]


def _case(curve, n, case, seed=0):
    """(scalars, points) of one edge case at width n."""
    rng = random.Random(seed * 1000 + n)
    r = curve.scalar_modulus
    base = [AffinePoint.random(curve, rng) for _ in range(5)]
    pts = [base[i % 5] for i in range(n)]
    nrng = np.random.default_rng(seed * 1000 + n)
    sc = [int.from_bytes(nrng.bytes(32), "little") % r for _ in range(n)]
    c = bucket_window(n)
    if case == "all_equal":
        sc = [sc[0]] * n
    elif case == "all_zero":
        sc = [0] * n
    elif case == "below_2c":
        sc = [s % (1 << c) for s in sc]
    elif case == "r_minus_1":
        sc = [r - 1] * n
    elif case == "dup_opposite":
        # P, -P with equal scalars cancel; P, P with equal scalars double
        pts = [base[(i // 2) % 5].neg() if i % 4 == 1 else base[(i // 2) % 5]
               for i in range(n)]
        sc = [sc[i - i % 2] for i in range(n)]
    elif case == "identity_lanes":
        pts = [AffinePoint.identity(curve) if i % 3 == 0 else p
               for i, p in enumerate(pts)]
    return sc, pts


def _mira_words(limbs16):
    """mira_tpu's (nwin, 16) 16-bit limbs -> ints."""
    return [sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in limbs16]


def test_bucket_window_is_the_designs_choice():
    """c = 12 at 2^17 and 15 at 2^21: one below the corrected bound's best
    (13 and 17: a running bucket sum), because the kernel's per-bit bucket
    sums add each bucket (c - 1) / 2 times; never below 2 or above
    BUCKET_MAX_WINDOW, and non-decreasing in N."""
    assert bucket_window(1 << 17) == 12
    assert bucket_window(1 << 21) == 15
    cs = [bucket_window(n) for n in range(1, 1 << 12, 7)] + [
        bucket_window(1 << k) for k in range(12, 25)]
    assert cs == sorted(cs) and min(cs) >= 2 and max(cs) <= BUCKET_MAX_WINDOW

    def bound(n, c):
        return num_windows(254, c) * (10 * n + 28 * (1 << (c - 1)))

    def design(n, c):
        return num_windows(254, c) * (10 * n + 14 * (c - 1) * (1 << (c - 2)))

    assert min(range(2, 21), key=lambda c: bound(1 << 17, c)) == 13
    assert min(range(2, 21), key=lambda c: bound(1 << 21, c)) == 17
    for n in (1, 255, 1 << 17, 1 << 21):
        c = bucket_window(n)
        assert all(design(n, c) <= design(n, k) for k in range(2, BUCKET_MAX_WINDOW + 1))


@pytest.mark.parametrize("c", list(range(2, 21)))
def test_signed_digits_width_c_vs_mira_carries(c):
    """At every width c up to 20: the port's carry thresholds equal
    mira_tpu's closed-form recoding tables (which keep the low 256 bits of a
    threshold past 2^256, where the port clamps it: no carry can arrive
    there), the sequential digits equal the closed form digit by digit, lie
    in [-2^(c-1), 2^(c-1) - 1] and recompose the scalar."""
    r = BN254_G1.scalar_modulus
    nwin = num_windows(254, c)
    half = 1 << (c - 1)
    true = [(half - 1) * ((1 << (c * w)) - 1) // ((1 << c) - 1) for w in range(nwin)]
    thr_mira = _mira_words(_bucket_carry_tables(254, c)[0])
    thr = [sum(int(v) << (32 * k) for k, v in enumerate(row))
           for row in cuda_msm.carry_thresholds(nwin, c)]
    assert thr_mira == [t % (1 << 256) for t in true]
    assert thr == [min(t, (1 << 256) - 1) for t in true]
    rng = random.Random(c)
    vals = [0, 1, r - 1, (1 << c) - 1, 1 << (c - 1), (1 << 253) - 1] + [
        rng.randrange(r) for _ in range(26)]
    d = signed_digits(encode_scalars(vals, r), nwin, c)
    assert int(d.min()) >= -half and int(d.max()) <= half - 1
    for v, row in zip(vals, d.tolist()):
        assert sum(x << (c * w) for w, x in enumerate(row)) == v
        for w, x in enumerate(row):
            carry = int((v % (1 << (c * w))) > true[w])
            raw = (v >> (c * w)) & ((1 << c) - 1)
            t = raw + carry
            assert x == t - (1 << c) * int(t >= half)


@pytest.mark.parametrize("case", CASES)
def test_layout_holds_every_nonzero_digit_once(case):
    """The sorted records: bucket ids non-decreasing, offsets the scan of
    their counts, and the records are exactly the (point, window) pairs with
    a nonzero digit on a live lane, each in its (window, |digit|) bucket
    with its sign."""
    curve = BN254_G1
    n = 255
    sc, pts = _case(curve, n, case)
    c = bucket_window(n)
    nwin = num_windows(254, c)
    nb = 1 << (c - 1)
    live = torch.tensor([not p.is_inf for p in pts])
    s = encode_scalars(sc, curve.scalar_modulus)
    offsets, records = bucket_layout(s, live, c, nwin)
    ids = records[:, 0]
    assert bool((ids[1:] >= ids[:-1]).all())
    assert offsets[0] == 0 and int(offsets[-1]) == records.shape[0]
    assert torch.equal(offsets[1:] - offsets[:-1],
                       torch.bincount(ids, minlength=nwin * nb))
    d = signed_digits(s, nwin, c)
    want = sorted((w * nb + abs(x) - 1, (i << 1) | int(x < 0))
                  for i, row in enumerate(d.tolist()) if not pts[i].is_inf
                  for w, x in enumerate(row) if x)
    assert sorted(map(tuple, records.tolist())) == want


def test_segment_runs_and_merge_levels():
    """Runs that cross a segment boundary become the next segment's head;
    every other run is owned by the segment holding its first entry; -1
    slots form no run; the merge levels shrink by MERGE_SEG to one."""
    keys = [3, 3, 3, 5, 5, -1, 7, 7, 7, 7, 9]
    runs = segment_runs(keys, 4)
    assert runs == [[(3, 0, 3, False), (5, 3, 4, False)],
                    [(5, 4, 5, True), (7, 6, 8, False)],
                    [(7, 8, 10, True), (9, 10, 11, False)]]
    owners = [k for seg in runs for k, _, _, head in seg if not head]
    assert owners == [3, 5, 7, 9]
    assert merge_levels(1) == [1]
    assert merge_levels(100, 8, 8) == [100, 13, 2, 1]
    assert merge_levels(SEG * 3) == [96, 48, 6, 1]
    assert MERGE_FIRST == 2 and MERGE_SEG == 8
    for c in (2, 5, 13, 16):
        mags = [magnitudes_with_bit(k, c) for k in range(c)]
        for k, m in enumerate(mags):
            assert m == [v for v in range(1, (1 << (c - 1)) + 1) if v >> k & 1]
            assert cuda_msm.bits_groups(c) * cuda_msm.RB_SPAN >= len(m)


@pytest.mark.parametrize("n, nwin, fits", [
    (1 << 24, 17, True),  # the widest commit of the paths, c = 16
    ((1 << 31) - 1, 1, True),
    (1 << 30, 2, False),  # exactly 2^31 records
    (1 << 27, 17, False),  # the first power of two past the limit
])
def test_bucket_record_limit(n, nwin, fits):
    """Kernel 1 counts records in 32 bits: n x nwin >= 2^31 raises."""
    if fits:
        cuda_msm.check_bucket_records(n, nwin)
    else:
        with pytest.raises(ValueError, match="2\\^31"):
            cuda_msm.check_bucket_records(n, nwin)


def test_reduce_scratch_counts_every_level():
    """reduce_tmp_points matches the levels of msm_common.cuh
    reduce_windows: nothing past one level, then nwin * ceil(n / 1024) per
    level until one part is left."""
    assert cuda_msm.reduce_tmp_points(52, 5) == 1
    assert cuda_msm.reduce_tmp_points(52, 1024) == 1
    assert cuda_msm.reduce_tmp_points(52, 1025) == 52 * 2
    assert cuda_msm.reduce_tmp_points(52, 32768) == 52 * 32
    assert cuda_msm.reduce_tmp_points(3, 1 << 21) == 3 * (2048 + 2)


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
@pytest.mark.parametrize("n", [1, 2, 255])
@pytest.mark.parametrize("case", CASES)
def test_bucket_model_vs_mira_native(curve, n, case):
    """The kernel's algorithm on host points equals mira_tpu's native MSM
    (and its host MSM at the small widths)."""
    sc, pts = _case(curve, n, case, seed=1)
    got = bucket_msm_model(sc, pts, curve, bucket_window(n))
    assert same(got, msm_native(sc, to_mira(pts)))
    if n <= 2:
        assert same(got, msm_host(sc, to_mira(pts)))


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
@pytest.mark.parametrize("case", ["random", "all_equal", "dup_opposite"])
def test_bucket_model_deep_merges(curve, case):
    """Short segments and merge runs (4 and 2 in place of SEG and
    MERGE_SEG) put every bucket across many segments and the heads through
    several merge levels; the sum is unchanged."""
    sc, pts = _case(curve, 255, case, seed=2)
    got = bucket_msm_model(sc, pts, curve, 4, seg=4, merge_first=2, merge_seg=2)
    assert same(got, msm_native(sc, to_mira(pts)))
