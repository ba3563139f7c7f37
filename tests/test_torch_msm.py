"""Port curve ops and the plain bucket MSM against mira_tpu: torch_curve vs
jax_curve and the host group law, msm_plain vs msm_host / the C++ Pippenger
on bench.py's adversarial input (duplicate bases, an exact (scalar, point)
duplicate, a zero scalar, an identity lane).  Exact equality."""

import random
from types import SimpleNamespace

import pytest
import torch

from mira_tpu.curves.host import msm_host
from mira_tpu.curves.jax_curve import jacobian_ops as jax_jacobian_ops
from mira_tpu.ops.native_msm import msm_native
from mira_tpu_torch import _build
from mira_tpu_torch.convert import limbs16_to_words
from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN, AffinePoint
from mira_tpu_torch.curves.torch_curve import jacobian_ops
from mira_tpu_torch.ops import cuda_msm
from mira_tpu_torch.ops.msm import encode_scalars, msm, msm_plain, signed_digits

from torch_port_helpers import same, to_mira  # also sizes torch's thread pool


CURVES = [BN254_G1, GRUMPKIN]
IDS = ["bn254", "grumpkin"]


def adversarial(curve, n, seed):
    rng = random.Random(seed)
    base = [AffinePoint.random(curve, rng) for _ in range(8)]
    pts = [base[i % 7] for i in range(n - 1)] + [AffinePoint.identity(curve)]
    sc = [rng.randrange(curve.scalar_modulus) for _ in range(n)]
    sc[3] = sc[10]  # exact (scalar, point) duplicate pair
    sc[5] = 0
    return sc, pts


def run_msm(fn, curve, sc, pts, device="cpu"):
    ops = jacobian_ops(curve.name)
    out = fn(encode_scalars(sc, curve.scalar_modulus, device),
             ops.encode_points(pts, device), curve)
    return ops.decode_points(tuple(c[None] for c in out))[0]


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
def test_add_double_vs_jax_curve_and_host(curve):
    rng = random.Random(1)
    a = [AffinePoint.random(curve, rng) for _ in range(12)]
    b = [AffinePoint.random(curve, rng) for _ in range(12)]
    a += [AffinePoint.identity(curve), b[0], b[1], b[2].neg()]
    b += [b[0], AffinePoint.identity(curve), b[1], b[2]]
    ops, jops = jacobian_ops(curve.name), jax_jacobian_ops(curve.name)
    A, B = ops.encode_points(a), ops.encode_points(b)
    JA, JB = jops.encode_points(to_mira(a)), jops.encode_points(to_mira(b))
    assert all(torch.equal(x, limbs16_to_words(y)) for x, y in zip(A, JA))
    got = ops.decode_points(ops.add(A, B))
    assert got == [x.add(y) for x, y in zip(a, b)]
    assert same(got, jops.decode_points(jops.add(JA, JB)))
    dbl = ops.decode_points(ops.double(A))
    assert dbl == [x.double() for x in a]
    assert same(dbl, jops.decode_points(jops.double(JA)))


def test_signed_digits_recompose():
    rng = random.Random(3)
    vals = [0, 1, BN254_G1.scalar_modulus - 1] + [
        rng.randrange(BN254_G1.scalar_modulus) for _ in range(61)]
    d = signed_digits(encode_scalars(vals, BN254_G1.scalar_modulus), 52)
    assert int(d.min()) >= -16 and int(d.max()) <= 15
    for v, row in zip(vals, d.tolist()):
        assert sum(x << (5 * w) for w, x in enumerate(row)) == v


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
def test_plain_msm_256_vs_host(curve):
    sc, pts = adversarial(curve, 256, seed=99)
    assert same(run_msm(msm_plain, curve, sc, pts), msm_host(sc, to_mira(pts)))


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
def test_plain_msm_4096_vs_native(curve):
    sc, pts = adversarial(curve, 4096, seed=7)
    assert same(run_msm(msm_plain, curve, sc, pts),
                msm_native(sc, to_mira(pts)))


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
def test_msm_edge_widths(curve):
    """Empty-of-work inputs: all-zero scalars and all-identity lanes give the
    identity; one point gives s*P; the wrapper routes CPU tensors to the
    plain version."""
    rng = random.Random(5)
    P = AffinePoint.random(curve, rng)
    ident = AffinePoint.identity(curve)
    assert run_msm(msm, curve, [0, 0], [P, P]) == ident
    assert run_msm(msm, curve, [5, 7], [ident, ident]) == ident
    s = rng.randrange(curve.scalar_modulus)
    assert run_msm(msm, curve, [s], [P]) == P.scalar_mul(s)
    assert run_msm(msm, curve, [1, 1], [P, P]) == P.double()
    assert run_msm(msm, curve, [1, 1], [P, P.neg()]) == ident


def test_kernel_field_ids_reject_other_moduli():
    """The kernels know BN254 Fq and Fr only; any other modulus raises before
    a launch rather than running in the wrong field."""
    assert _build.field_id(BN254_G1.base_modulus) == 0
    assert _build.field_id(GRUMPKIN.base_modulus) == 1
    with pytest.raises(ValueError):
        _build.field_id((1 << 255) - 19)
    other = SimpleNamespace(base_modulus=(1 << 255) - 19,
                            scalar_modulus=BN254_G1.scalar_modulus)
    zero = torch.zeros(4, 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_msm.msm_cuda(zero, (zero, zero, zero), other)


def test_carry_thresholds_match_sequential_recoding():
    """The kernel's closed-form carries equal the sequential recoding."""
    rng = random.Random(11)
    vals = [rng.randrange(BN254_G1.scalar_modulus) for _ in range(40)] + [
        (1 << 253) - 1, 0x7BDEF7BDEF7BDEF]
    thr = cuda_msm.carry_thresholds(52)
    d = signed_digits(encode_scalars(vals, BN254_G1.scalar_modulus), 52)
    for v, row in zip(vals, d.tolist()):
        carry = 0
        for w in range(52):
            t = sum(int(thr[w, k]) << (32 * k) for k in range(8))
            closed = int((v % (1 << (5 * w))) > t)
            assert closed == carry
            raw = (v >> (5 * w)) & 31
            assert row[w] == raw + carry - 32 * int(raw + carry >= 16)
            carry = int(raw + carry >= 16)

