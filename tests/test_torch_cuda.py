"""Kernels against their plain versions on the card.  Every test here needs
a CUDA device and skips without one; the file imports nothing of jax, so it
runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py -q
"""

import random

import numpy as np
import pytest
import torch

from mira_tpu.curves.host import BN254_G1, GRUMPKIN, AffinePoint
from mira_tpu.fields.params import BN254_FQ, BN254_FR
from mira_tpu_torch.convert import msm_reference
from mira_tpu_torch.curves.torch_curve import jacobian_ops
from mira_tpu_torch.fields.limbs import limb_field
from mira_tpu_torch.ops import cuda_msm
from mira_tpu_torch.ops.msm import (
    encode_scalars,
    msm_fixed_plain,
    msm_plain,
    precompute_fixed_table_plain,
)
from mira_tpu_torch.table.runner import CircuitRunner

from torch_port_helpers import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda
CURVES = [BN254_G1, GRUMPKIN]
IDS = ["bn254", "grumpkin"]


def _vals(p, seed, n=257):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    vals[:5] = [0, 1, p - 1, p - 2, (1 << 256) % p]
    return vals


def test_field_kernel_matches_plain(cuda_device):  # noqa: F811
    from mira_tpu_torch import _build

    lib = _build.lib()
    for fid, p in ((0, BN254_FQ), (1, BN254_FR)):
        lf = limb_field(p)
        a = lf.encode(_vals(p, 7), cuda_device)
        b = lf.encode(_vals(p, 8), cuda_device)
        for op, want in ((0, lf.mul(a, b)), (1, lf.add(a, b)),
                         (2, lf.sub(a, b)), (3, lf.inv(a[:32]))):
            out = torch.empty_like(want)
            _build.check(lib.mira_field_test(
                fid, op, want.shape[0], a.data_ptr(), b.data_ptr(),
                out.data_ptr(), _build.stream_ptr(cuda_device)), "field_test")
            torch.cuda.synchronize()
            assert torch.equal(out, want)


def _adversarial(curve, n, seed):
    rng = random.Random(seed)
    base = [AffinePoint.random(curve, rng) for _ in range(8)]
    pts = [base[i % 7] for i in range(n - 1)] + [AffinePoint.identity(curve)]
    sc = [rng.randrange(curve.scalar_modulus) for _ in range(n)]
    sc[3] = sc[10]
    sc[5] = 0
    return sc, pts


def _run(fn, curve, sc, pts, dev):
    ops = jacobian_ops(curve.name)
    s = encode_scalars(sc, curve.scalar_modulus, dev)
    P = ops.encode_points(pts, dev)
    return ops.decode_points(tuple(c[None] for c in fn(s, P, curve)))[0], s, P


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
@pytest.mark.parametrize("n", [1, 2, 255, 2117, 4096])
def test_bucket_kernel_matches_plain_and_host(curve, n, cuda_device):  # noqa: F811
    sc, pts = _adversarial(curve, max(n, 11), seed=n)
    sc, pts = sc[:n], pts[-n:]
    got, s, P = _run(cuda_msm.msm, curve, sc, pts, cuda_device)
    assert got == _run(msm_plain, curve, sc, pts, cuda_device)[0]
    assert got == msm_reference(s, P, curve)


def test_bucket_kernel_identity_cases(cuda_device):  # noqa: F811
    P = AffinePoint.random(BN254_G1, random.Random(3))
    ident = AffinePoint.identity(BN254_G1)
    for sc, pts, want in (([0, 0], [P, P], ident), ([3], [ident], ident),
                          ([1, 1], [P, P], P.double()),
                          ([1, 1], [P, P.neg()], ident)):
        assert _run(cuda_msm.msm, BN254_G1, sc, pts, cuda_device)[0] == want


class _Fibo:
    """q * (a + a.next - b) = 0: a rotated query, as tests/test_nifs.py."""

    @staticmethod
    def configure(cs):
        q = cs.fixed_column()
        a, b = cs.advice_column(), cs.advice_column()
        cs.create_gate("fibo", [cs.query(q) * (cs.query(a) + cs.query(a, 1)
                                               - cs.query(b))])
        return q, a, b

    def synthesize(self, config, ctx):
        q, a, b = config
        t = ctx.table
        f0, f1 = 3, 5
        for row in range(10):
            t.assign_fixed(q, row, 1)
            t.assign_advice(a, row, f0)
            t.assign_advice(b, row, f0 + f1)
            f0, f1 = f1, f0 + f1
        t.assign_advice(a, 10, f0)


def test_fold_eval_kernel_matches_plain(cuda_device):  # noqa: F811
    S = CircuitRunner(4, _Fibo(), [], BN254_G1).collect_structure()
    lf = limb_field(S.modulus)
    rng = np.random.default_rng(1)
    p = S.modulus
    Ws1, Ws2 = ([[int(x) % p for x in rng.integers(0, 1 << 62, size=sz)]
                 for sz in S.round_sizes] for _ in range(2))
    ch1 = [int(x) % p for x in rng.integers(0, 1 << 62, size=S.num_challenges + 1)]
    ch2 = list(reversed(ch1))
    js = list(range(S.get_degree_for_folding()))
    want = S.fold_evaluator("cpu").fold_eval_multi(
        [lf.encode(w) for w in Ws1], [lf.encode(w) for w in Ws2], js, ch1, ch2)
    got = S.fold_evaluator(cuda_device).fold_eval_multi(
        [lf.encode(w, cuda_device) for w in Ws1],
        [lf.encode(w, cuda_device) for w in Ws2], js, ch1, ch2)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
@pytest.mark.parametrize("window", [5, 6])
@pytest.mark.parametrize("n", [1, 255, 2117, 4096])
def test_fixed_kernels_match_plain_and_host(curve, window, n, cuda_device):  # noqa: F811
    """The multiples table and the fixed-base MSM against their plain
    versions and the host MSM: duplicate bases, a zero scalar, an identity
    lane, and scalars 1, r - 1 and 2^250 - 1 (every raw 5-bit digit
    maximal, so the carry runs into the extra window)."""
    sc, pts = _adversarial(curve, max(n, 11), seed=n + window)
    sc[:3] = [1, curve.scalar_modulus - 1, (1 << 250) - 1]
    sc, pts = sc[:n], pts[-n:]
    ops = jacobian_ops(curve.name)
    P = ops.encode_points(pts, cuda_device)
    table = cuda_msm.fixed_table_cuda(P, curve, window)
    plain_table = precompute_fixed_table_plain(P, curve, window)
    torch.cuda.synchronize()
    assert torch.equal(table, plain_table)
    s = encode_scalars(sc, curve.scalar_modulus, cuda_device)
    got = ops.decode_points(tuple(
        c[None] for c in cuda_msm.msm_fixed_cuda(s, table, curve, window)))[0]
    plain = ops.decode_points(tuple(
        c[None] for c in msm_fixed_plain(s, table, curve, window)))[0]
    assert got == plain == msm_reference(s, P, curve)


def test_fixed_kernel_identity_cases(cuda_device):  # noqa: F811
    P = AffinePoint.random(BN254_G1, random.Random(3))
    ident = AffinePoint.identity(BN254_G1)
    ops = jacobian_ops("bn254")
    for sc, pts, want in (([0, 0], [P, P], ident), ([3], [ident], ident),
                          ([1, 1], [P, P], P.double()),
                          ([1, 1], [P, P.neg()], ident)):
        table = cuda_msm.fixed_table(ops.encode_points(pts, cuda_device),
                                     BN254_G1, 5)
        s = encode_scalars(sc, BN254_G1.scalar_modulus, cuda_device)
        out = cuda_msm.msm_fixed(s, table, BN254_G1, 5)
        assert ops.decode_points(tuple(c[None] for c in out))[0] == want


def test_fixed_kernels_reject_other_windows(cuda_device):  # noqa: F811
    ops = jacobian_ops("bn254")
    P = ops.encode_points([AffinePoint.generator(BN254_G1)], cuda_device)
    with pytest.raises(ValueError):
        cuda_msm.fixed_table(P, BN254_G1, 4)
