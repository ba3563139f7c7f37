"""Shared helpers of the port's tests (tests/test_torch_*.py).

Importing this module also sizes torch's intra-op thread pool: under
pytest-xdist every worker would otherwise start one thread per core, and
several workers on one machine then oversubscribe the cores many times over.
"""

import os

import pytest
import torch

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _workers > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _workers))


def k17_trivial_pp():
    """Public parameters of the smallest IVC the tests build: the trivial
    step circuit on both curves at k=17 (the step-folding circuit needs
    ~100k rows), mock 2^21 keys, on the CPU."""
    from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN
    from mira_tpu_torch.ivc.public_params import CircuitSide, PublicParams
    from mira_tpu_torch.ivc.step_circuit import TrivialCircuit
    from mira_tpu_torch.ops.mock_commitment import MockCommitmentKey

    return PublicParams(
        CircuitSide(TrivialCircuit(arity=1),
                    MockCommitmentKey(BN254_G1, 21, b"bn256", "cpu"), 17),
        CircuitSide(TrivialCircuit(arity=1),
                    MockCommitmentKey(GRUMPKIN, 21, b"grumpkin", "cpu"), 17),
        BN254_G1, GRUMPKIN)


def same(a, b):
    """Equality of host values across the two packages (field elements,
    points, Gt tuples, dataclasses of them, lists): compared as plain data,
    since an object of one package never equals the other's."""
    from mira_tpu_torch.convert import to_plain

    return to_plain(a) == to_plain(b)


def mira_from_plain(d):
    """mira_tpu's object for plain data made by `convert.to_plain` (the way
    back across the boundary; it imports mira_tpu, so it lives here and not in
    the port)."""
    from mira_tpu.curves.host import (
        BN254_G1, GRUMPKIN, AffinePoint, Fq2, G2Point, Tuple12)
    from mira_tpu.fields.host import field

    if isinstance(d, list):
        return [mira_from_plain(x) for x in d]
    if isinstance(d, dict):
        return {k: mira_from_plain(x) for k, x in d.items()}
    if not isinstance(d, tuple):
        return d
    tag = d[0]
    if tag == "F":
        return field(d[1])(d[2])
    if tag == "curve":
        return {"bn254": BN254_G1, "grumpkin": GRUMPKIN}[d[1]]
    if tag == "G1":
        return AffinePoint(mira_from_plain(("curve", d[1])), d[2], d[3], d[4])
    if tag == "Fq2":
        F = field(d[1])
        return Fq2(F(d[2]), F(d[3]))
    if tag == "Gt":
        F = field(d[1])
        return Tuple12([F(e) for e in d[2]], F)
    if tag == "G2":
        F = field(d[1])
        return G2Point(Fq2(F(d[2][0]), F(d[2][1])), Fq2(F(d[3][0]), F(d[3][1])),
                       d[4])
    if tag == "poly":
        from mira_tpu.polynomial.univariate import UnivariatePoly

        return UnivariatePoly(d[2], d[1])
    raise ValueError(f"unknown plain tag {tag!r}")


def to_mira(v):
    """mira_tpu's own object for a host value of either package."""
    from mira_tpu_torch.convert import to_plain

    return mira_from_plain(to_plain(v))


def expression_to_mira(e):
    """A port gate expression rebuilt from mira_tpu's node classes (the
    expression folds itself; only ints and query indices cross)."""
    from mira_tpu.polynomial import expression as me

    return e.evaluate(me.Const,
                      lambda q: me.Poly(me.Query(q.index, q.rotation)),
                      me.Challenge, me.Neg, me.Sum, me.Product, me.Scaled)


def relaxed_trace_to_mira(t):
    """Port RelaxedPlonkTrace -> mira_tpu's (loads jax, so it lives here and
    not in the port)."""
    import dataclasses

    import jax.numpy as jnp

    from mira_tpu.fields.limbs import limb_field as jax_limb_field
    from mira_tpu.plonk import structure as ms
    from mira_tpu_torch.convert import words_to_limbs16

    lf = jax_limb_field(t.W.lf.modulus)
    W = ms.RelaxedPlonkWitness(
        lf, [jnp.asarray(words_to_limbs16(x)) for x in t.W.W],
        jnp.asarray(words_to_limbs16(t.W.E)))
    U = ms.RelaxedPlonkInstance(**{
        f.name: to_mira(getattr(t.U, f.name))
        for f in dataclasses.fields(ms.RelaxedPlonkInstance)})
    return ms.RelaxedPlonkTrace(U, W)


def plonk_trace_to_mira(t):
    """Port PlonkTrace -> mira_tpu's (loads jax, so it lives here)."""
    import dataclasses

    import jax.numpy as jnp

    from mira_tpu.fields.limbs import limb_field as jax_limb_field
    from mira_tpu.plonk import structure as ms
    from mira_tpu_torch.convert import words_to_limbs16

    U = ms.PlonkInstance(**{f.name: to_mira(getattr(t.u, f.name))
                            for f in dataclasses.fields(ms.PlonkInstance)})
    lf = jax_limb_field(t.w.lf.modulus)
    return ms.PlonkTrace(U, ms.PlonkWitness(
        lf, [jnp.asarray(words_to_limbs16(w)) for w in t.w.W]))


def tamper_word(lf, t, index):
    """A copy of the word tensor t with its value at `index` plus one."""
    t = t.clone()
    t[index] = lf.encode([(lf.decode(t[index : index + 1])[0] + 1) % lf.modulus])[0]
    return t


def accumulator_to_mira(acc):
    """Port ProtoGalaxy Accumulator -> mira_tpu's."""
    from mira_tpu.nifs.protogalaxy import Accumulator

    return Accumulator(list(acc.betas), relaxed_trace_to_mira(acc.trace), acc.e)


def proof_to_mira(proof):
    """Port ProtoGalaxyProof -> mira_tpu's."""
    from mira_tpu.nifs.protogalaxy import ProtoGalaxyProof

    return ProtoGalaxyProof(to_mira(proof.poly_F), to_mira(proof.poly_K))


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none.  Decided
    when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)
