"""The row-wise field linear combination (mira_tpu_torch/ops/field_lincomb.py)
on the CPU: its plain version against host integers, against the combine
and the witness fold as the port wrote them before (lazy-limb products, E
subtracted first), and against mira_tpu's XLA programs
`_combine_slices_sat_jit`, `_combine_slices_jit` and `_witness_fold_jit`
on seeded rows with edge values; `to_plain`; the by-value coefficient
packing; the wrapper's refusals.  The
kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py)."""

import ctypes

import numpy as np
import pytest
import torch

from mira_tpu.fields.limbs import limb_field as jax_limb_field
from mira_tpu.fields.params import BN254_FQ, BN254_FR
from mira_tpu.nifs.vanilla import _combine_slices_jit, _combine_slices_sat_jit
from mira_tpu.plonk.structure import _witness_fold_jit
from mira_tpu_torch.convert import limbs16_to_words
from mira_tpu_torch.fields.limbs import NUM_WORDS, limb_field, words_to_ints
from mira_tpu_torch.nifs.vanilla import (
    _inv_vandermonde,
    _inv_vandermonde_inner,
    combine_slices,
    combine_slices_sat,
)
from mira_tpu_torch.ops import field_lincomb as fl
from mira_tpu_torch.plonk.structure import PlonkWitness, RelaxedPlonkWitness

import torch_port_helpers  # noqa: F401  (sizes torch's thread pool)

MODULI = {"fr": BN254_FR, "fq": BN254_FQ}
N = 67  # rows: not a multiple of any block


def _vals(p, seed, n=N):
    """Seeded values with 0, 1 and p - 1 at places that move with the seed."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    for i, v in enumerate((0, 1, p - 1)):
        vals[(seed * 7 + 23 * i) % n] = v
    return vals


def _coefs(p, K, J, seed):
    rng = np.random.default_rng(seed)
    cs = [[int.from_bytes(rng.bytes(32), "little") % p for _ in range(J)]
          for _ in range(K)]
    cs[0][0] = 0
    cs[-1][-1] = p - 1
    if J > 1:
        cs[0][1] = 1
    return cs


def _inputs(p, J, seed):
    vals = [_vals(p, seed + j) for j in range(J)]
    return vals, [limb_field(p).encode(v) for v in vals]


@pytest.mark.parametrize("name", sorted(MODULI))
@pytest.mark.parametrize("K, J", [(1, 1), (1, 2), (4, 5), (5, 6), (7, 8), (3, 16)])
@pytest.mark.parametrize("plain", [False, True], ids=["mont", "plain"])
def test_plain_version_equals_host_integers(name, K, J, plain):
    p = MODULI[name]
    vals, xs = _inputs(p, J, K + J)
    cs = _coefs(p, K, J, 3 * K + J)
    want = [[sum(c * v[i] for c, v in zip(row, vals)) % p for i in range(N)]
            for row in cs]
    got = fl.lincomb(p, xs, cs, plain=plain)
    assert len(got) == K
    if plain:
        assert [words_to_ints(q) for q in got] == want
        assert all(torch.equal(q, limb_field(p).to_plain(o))
                   for o, q in zip(fl.lincomb(p, xs, cs), got))
    else:
        assert [limb_field(p).decode(o) for o in got] == want


@pytest.mark.parametrize("name", sorted(MODULI))
@pytest.mark.parametrize("n", [0, 1, N])
def test_to_plain_equals_limb_field(name, n):
    """to_plain (one input, coefficient 1, plain output) == the host
    integers == `LimbField.to_plain`, edge values among the rows."""
    p = MODULI[name]
    lf = limb_field(p)
    vals = _vals(p, n + 3)[:n]
    x = lf.encode(vals) if n else torch.zeros(0, NUM_WORDS, dtype=torch.int32)
    got = fl.to_plain(p, x)
    assert got.shape == (n, NUM_WORDS)
    assert words_to_ints(got) == vals
    assert torch.equal(got, lf.to_plain(x))


def _combine_sat_before(lf, evals, E):
    """The combine as the port computed it before the kernel: the d - 1
    differences Q_j - E first, then sum_j invM[k][j] * diff_j."""
    d = len(evals) + 1
    invM = _inv_vandermonde_inner(lf.modulus, d)
    diffs = [lf.lz(e) - lf.lz(E) for e in evals]
    outs = []
    for k in range(d - 1):
        acc = None
        for c, v in zip(invM[k], diffs):
            if c:
                t = v * lf.lz_const(c, v.shape, v.t.device)
                acc = t if acc is None else acc + t
        outs.append(lf.canon(acc))
    return outs + [lf.zero(E.shape[:-1])]


@pytest.mark.parametrize("name", sorted(MODULI))
@pytest.mark.parametrize("d", [5, 6])
def test_combine_sat_equals_the_form_before_and_mira(name, d):
    """combine_slices_sat (E folded into its coefficient) == the subtracted
    form == mira_tpu's `_combine_slices_sat_jit`."""
    p = MODULI[name]
    lf, jlf = limb_field(p), jax_limb_field(p)
    vals, evals = _inputs(p, d - 1, 10 * d)
    E_vals = _vals(p, 99 + d)
    E = lf.encode(E_vals)
    terms = combine_slices_sat(lf, evals, E)
    assert len(terms) == d
    before = _combine_sat_before(lf, evals, E)
    assert all(torch.equal(a, b) for a, b in zip(terms, before))
    theirs = _combine_slices_sat_jit(p, d)([jlf.encode(v) for v in vals],
                                          jlf.encode(E_vals))
    assert all(torch.equal(a, limbs16_to_words(np.asarray(b)))
               for a, b in zip(terms, theirs))


@pytest.mark.parametrize("name", sorted(MODULI))
@pytest.mark.parametrize("d", [4, 6])
def test_combine_equals_mira(name, d):
    """combine_slices (all d + 1 points) == mira_tpu's `_combine_slices_jit`
    and the host sums of invV's rows."""
    p = MODULI[name]
    lf, jlf = limb_field(p), jax_limb_field(p)
    vals, evals = _inputs(p, d + 1, 5 * d)
    terms = combine_slices(lf, evals)
    theirs = _combine_slices_jit(p, d)([jlf.encode(v) for v in vals])
    assert len(terms) == d
    assert all(torch.equal(a, limbs16_to_words(np.asarray(b)))
               for a, b in zip(terms, theirs))
    invV = _inv_vandermonde(p, d)
    want = [[sum(c * v[i] for c, v in zip(invV[k], vals)) % p for i in range(N)]
            for k in range(1, d + 1)]
    assert [lf.decode(t) for t in terms] == want


@pytest.mark.parametrize("name", sorted(MODULI))
@pytest.mark.parametrize("n_rounds, n_terms", [(1, 5), (2, 6)])
def test_witness_fold_equals_mira(name, n_rounds, n_terms):
    """RelaxedPlonkWitness.fold == mira_tpu's `_witness_fold_jit`, rounds of
    other lengths than E, r drawn from the seed and r = p - 1."""
    p = MODULI[name]
    lf, jlf = limb_field(p), jax_limb_field(p)
    rng = np.random.default_rng(n_rounds * 10 + n_terms)
    for r in (int.from_bytes(rng.bytes(16), "little"), p - 1):
        W1 = [_vals(p, 40 + i, N + 5 * i) for i in range(n_rounds)]
        W2 = [_vals(p, 50 + i, N + 5 * i) for i in range(n_rounds)]
        E = _vals(p, 60)
        Ts = [_vals(p, 70 + k) for k in range(n_terms)]
        folded = RelaxedPlonkWitness(lf, [lf.encode(w) for w in W1], lf.encode(E)).fold(
            PlonkWitness(lf, [lf.encode(w) for w in W2]), [lf.encode(t) for t in Ts], r)
        rpows = [pow(r, k + 1, p) for k in range(n_terms)]
        W_m, E_m = _witness_fold_jit(p, n_rounds, n_terms)(
            tuple(jlf.encode(w) for w in W1), tuple(jlf.encode(w) for w in W2),
            jlf.encode(E), tuple(jlf.encode(t) for t in Ts), jlf.const(r % p, (1,)),
            jlf.encode(rpows))
        assert all(torch.equal(a, limbs16_to_words(np.asarray(b)))
                   for a, b in zip(folded.W, W_m))
        assert torch.equal(folded.E, limbs16_to_words(np.asarray(E_m)))
        assert lf.decode(folded.E) == [
            (E[i] + sum(rp * t[i] for rp, t in zip(rpows, Ts))) % p for i in range(N)]


def test_args_struct_has_the_kernels_layout():
    """`LincombArgs` as csrc/field_lincomb.cu lays it out: 16 input and 16
    output pointers, 96 coefficients of 8 words, n, J, K, the plain flag."""
    assert ctypes.sizeof(fl.LincombArgs) == 3352
    assert fl.LincombArgs.coefs.offset == 32 * 8
    assert fl.LincombArgs.n.offset == 32 * 8 + 96 * 32
    assert fl.LincombArgs.plain.offset == 3344


def _unpack(p, args):
    """The coefficients of packed launch parameters, as plain ints."""
    raw = bytes(args.coefs)[: args.K * args.J * 4 * NUM_WORDS]
    words = np.frombuffer(raw, dtype="<i4").reshape(-1, NUM_WORDS)
    rinv = pow(limb_field(p).r_mod_p, -1, p)
    vals = [v * rinv % p for v in words_to_ints(words)]
    assert all(v < p for v in words_to_ints(words))  # canonical Montgomery form
    return [vals[k * args.J : (k + 1) * args.J] for k in range(args.K)]


@pytest.mark.parametrize("J", range(1, fl.MAX_J + 1))
def test_coefficient_packing_round_trips(J):
    """Every (K, J) one launch takes packs its coefficients (any sign, 0,
    1, p - 1, p, above p) so that they read back as the integers mod p;
    one coefficient more does not pack."""
    rng = np.random.default_rng(J)
    for p in MODULI.values():
        for K in range(1, min(fl.MAX_K, fl.MAX_COEFS // J) + 1):
            cs = [[int.from_bytes(rng.bytes(40), "little") - (1 << 300)
                   for _ in range(J)] for _ in range(K)]
            cs[0][0], cs[-1][-1] = p, p - 1
            cs[0][-1] = 1 if (K, J) != (1, 1) else cs[0][-1]
            cs[-1][0] = 0 if (K, J) != (1, 1) else cs[-1][0]
            args = fl.pack_args(p, cs)
            assert (args.K, args.J) == (K, J)
            assert _unpack(p, args) == [[c % p for c in row] for row in cs]
        K = min(fl.MAX_K, fl.MAX_COEFS // J) + 1
        with pytest.raises(ValueError, match="do not fit one launch"):
            fl.pack_args(p, [[1] * J] * K)


def _ok(n=5):
    return torch.zeros(n, NUM_WORDS, dtype=torch.int32)


@pytest.mark.parametrize("case", ["dtype", "width", "rank", "rows", "devices",
                                  "too_many", "too_many_outputs", "coef_row",
                                  "none"])
def test_wrapper_refuses_bad_inputs(case):
    p = BN254_FR
    inputs, cs = [_ok(), _ok()], [[1, 2]]
    if case == "dtype":
        inputs[1] = inputs[1].to(torch.int64)
    elif case == "width":
        inputs[1] = torch.zeros(5, 16, dtype=torch.int32)
    elif case == "rank":
        inputs[1] = torch.zeros(5 * NUM_WORDS, dtype=torch.int32)
    elif case == "rows":
        inputs[1] = _ok(6)
    elif case == "devices":
        inputs[1] = torch.empty(5, NUM_WORDS, dtype=torch.int32, device="meta")
    elif case == "too_many":
        inputs, cs = [_ok()] * (fl.MAX_J + 1), [[1] * (fl.MAX_J + 1)]
    elif case == "too_many_outputs":
        inputs, cs = [_ok()] * 6, [[1] * 6] * (fl.MAX_COEFS // 6 + 1)
    elif case == "coef_row":
        cs = [[1, 2], [3]]
    else:
        inputs = []
    with pytest.raises(ValueError, match="field_lincomb"):
        fl.lincomb(p, inputs, cs)


def test_empty_calls():
    p = BN254_FQ
    assert fl.lincomb(p, [_ok()], []) == []
    assert fl.lincomb(p, [_ok(0)], [[3]])[0].shape == (0, NUM_WORDS)
