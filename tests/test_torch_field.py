"""Port field arithmetic (mira_tpu_torch/fields/limbs.py) against mira_tpu's
limb field and the host golden field, for Fr and Fq: exact equality."""

import numpy as np
import pytest
import torch

from mira_tpu.fields.host import field
from mira_tpu.fields.limbs import limb_field as jax_limb_field
from mira_tpu.fields.params import BN254_FQ, BN254_FR
from mira_tpu_torch.convert import limbs16_to_words, words_to_limbs16
from mira_tpu_torch.fields.limbs import Lz, _contract, limb_field

import torch_port_helpers  # noqa: F401  (sizes torch's thread pool)


MODULI = {"fr": BN254_FR, "fq": BN254_FQ}


def _vals(p, seed, n=96):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    vals[:6] = [0, 1, p - 1, p - 2, (p - 1) // 2, (1 << 256) % p]
    return vals


@pytest.mark.parametrize("name", sorted(MODULI))
def test_encode_matches_mira_limbs(name):
    p = MODULI[name]
    vals = _vals(p, 1)
    mine = limb_field(p).encode(vals)
    theirs = jax_limb_field(p).encode(vals)
    assert torch.equal(mine, limbs16_to_words(theirs))
    assert np.array_equal(words_to_limbs16(mine), np.asarray(theirs))
    assert limb_field(p).decode(mine) == vals


@pytest.mark.parametrize("name", sorted(MODULI))
@pytest.mark.parametrize("op", ["add", "sub", "mul", "square", "neg", "double"])
def test_ops_vs_mira_and_host(name, op):
    p = MODULI[name]
    F = field(p)
    lf, jlf = limb_field(p), jax_limb_field(p)
    av, bv = _vals(p, 2), list(reversed(_vals(p, 3)))
    a, b = lf.encode(av), lf.encode(bv)
    if op in ("add", "sub", "mul"):
        got = getattr(lf, op)(a, b)
        ref = getattr(jlf, op)(jlf.encode(av), jlf.encode(bv))
        host = [getattr(F(x), {"add": "__add__", "sub": "__sub__",
                               "mul": "__mul__"}[op])(F(y)).v
                for x, y in zip(av, bv)]
    else:
        got = getattr(lf, op)(a)
        ref = getattr(jlf, op)(jlf.encode(av))
        host = [{"square": lambda x: x * x % p, "neg": lambda x: -x % p,
                 "double": lambda x: 2 * x % p}[op](x) for x in av]
    assert lf.decode(got) == host
    assert torch.equal(got, limbs16_to_words(ref))


@pytest.mark.parametrize("name", sorted(MODULI))
def test_inv_plain_conversions(name):
    p = MODULI[name]
    lf = limb_field(p)
    vals = _vals(p, 4, 16)
    a = lf.encode(vals)
    assert lf.decode(lf.inv(a)) == [pow(v, -1, p) if v else 0 for v in vals]
    plain = lf.to_plain(a)
    assert lf.decode(lf.from_plain(plain)) == vals
    assert torch.equal(lf.encode_raw16(words_to_limbs16(plain)), a)


@pytest.mark.parametrize("name", sorted(MODULI))
def test_lazy_bounds_extremes(name):
    """Lazy values at their limb bounds (all limbs +-(2^16+8)) summed to the
    largest weight a product accepts still multiply exactly."""
    p = MODULI[name]
    lf = limb_field(p)
    rinv = pow(1 << 256, -1, p)

    def value(t):
        return sum(int(t[i]) << (16 * i) for i in range(17))

    for sign in (1, -1):
        x = Lz(lf, torch.full((3, 17), sign * ((1 << 16) + 8), dtype=torch.int64))
        for terms in (4, 5, 16, 17, 32):
            s = x
            for _ in range(terms - 1):
                s = s + x
            assert s.w == terms
            pairs = [(s, x), (lf.settle(s), lf.settle(s))]
            if terms <= 5:
                pairs.append((s, s))  # weights multiply to <= 96
            for a, b in pairs:
                want = value(a.t[0]) * value(b.t[0]) * rinv % p
                assert lf.decode(lf.canon(a * b))[0] == want * rinv % p


@pytest.mark.parametrize("name", sorted(MODULI))
def test_contraction_exact_at_bound(name):
    """The product's contraction (one multiply-add per column) equals the
    exact integer product at column values whose magnitudes sum to about the
    bound of a product, 289 * 96 * (2^16+8)^2."""
    lf = limb_field(MODULI[name])
    table = lf._c("cpu")["cmont"]
    rng = np.random.default_rng(9)
    T = torch.from_numpy(rng.integers(-(1 << 41), 1 << 41, size=(64, 33)))
    T[0] = (1 << 41) - 1
    T[1] = -(1 << 41)
    want = np.asarray(T.numpy(), dtype=object) @ np.asarray(table.numpy(), dtype=object)
    assert _contract(T, table).tolist() == want.tolist()


def test_long_lazy_chain_matches_host():
    p = BN254_FQ
    lf = limb_field(p)
    av, bv = _vals(p, 5, 32), _vals(p, 6, 32)
    x, y = lf.lz(lf.encode(av)), lf.lz(lf.encode(bv))
    acc, ref = x, list(av)
    for _ in range(20):
        acc = acc * y - x - x - x + acc * acc
        ref = [(r * b - 3 * a + r * r) % p for r, a, b in zip(ref, av, bv)]
    assert lf.decode(lf.canon(acc)) == ref

