"""The port's device NTT (mira_tpu_torch/ops/ntt.py) on the CPU against
mira_tpu: `ntt`, `coset_ntt` and `coset_intt` vs the reference's `ntt` (its
XLA route on the CPU) and `ntt_host` for log n 1..10, forward and inverse;
the reference's known-answer vector; and the four-step kernel's index
algebra (the n1 * n2 split, both sub-transforms through the bit reversal,
the two-table mid twiddle, odd log n) as a plain-PyTorch model held to
`ntt_host`, so that only the CUDA itself is left for the card.  Inputs come
from numpy seeds; all comparisons are on decoded integers, exact."""

import numpy as np
import pytest
import torch

from mira_tpu.fields.limbs import limb_field as jax_limb_field
from mira_tpu.ops import ntt as mira_ntt
from mira_tpu_torch.convert import limbs16_to_words
from mira_tpu_torch.fields.limbs import limb_field
from mira_tpu_torch.fields.params import BN254_FQ, BN254_FR
from mira_tpu_torch.ops import cuda_ntt, ntt

from test_ntt import REFERENCE_FFT_VECTOR
import torch_port_helpers  # noqa: F401  (sizes torch's thread pool)

P = BN254_FR
LF = limb_field(P)


def _vals(n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    vals[: min(n, 4)] = [0, P - 1, 1, P - 1][: min(n, 4)]
    return vals


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("log_n", range(1, 11))
def test_ntt_matches_mira_and_host(log_n, inverse):
    vals = _vals(1 << log_n, log_n)
    got = ntt.ntt(LF.encode(vals), P, inverse)
    theirs = mira_ntt.ntt(jax_limb_field(P).encode(vals), P, inverse)
    assert torch.equal(got, limbs16_to_words(np.asarray(theirs)))
    assert LF.decode(got) == mira_ntt.ntt_host(vals, P, inverse)


def test_known_answer_vector():
    want = [int(s) for s in REFERENCE_FFT_VECTOR]
    assert LF.decode(ntt.ntt(LF.encode(list(range(8))), P)) == want
    assert ntt.ntt_host(list(range(8)), P) == want


@pytest.mark.parametrize("log_n", [1, 4, 7])
def test_coset_transforms_match_mira(log_n):
    vals = _vals(1 << log_n, 100 + log_n)
    jlf = jax_limb_field(P)
    into = ntt.coset_ntt(LF.encode(vals), P)
    assert torch.equal(into, limbs16_to_words(
        np.asarray(mira_ntt.coset_ntt(jlf.encode(vals), P))))
    back = ntt.coset_intt(LF.encode(vals), P)
    assert torch.equal(back, limbs16_to_words(
        np.asarray(mira_ntt.coset_intt(jlf.encode(vals), P))))
    assert LF.decode(ntt.coset_intt(into, P)) == vals


def test_sizes_and_engines_are_checked():
    a = LF.encode([1, 2, 3])
    with pytest.raises(ValueError):
        ntt.ntt(a, P)
    with pytest.raises(ValueError):
        ntt.ntt(LF.encode([1, 2]), P, engine="xla")
    with pytest.raises(ValueError):  # Fq has 2-adicity 1
        ntt.ntt(limb_field(BN254_FQ).encode([1, 2, 3, 4]), BN254_FQ)
    one = LF.encode([5])
    assert ntt.ntt(one, P) is one
    fq = limb_field(BN254_FQ)
    assert fq.decode(ntt.ntt(fq.encode([3, 5]), BN254_FQ)) == [8, BN254_FQ - 2]
    # the kernels' wrappers take CUDA tensors only, and nothing past 2^24
    with pytest.raises(ValueError):
        cuda_ntt.ntt_fourstep_cuda(LF.encode([1, 2, 3, 4]), P)
    with pytest.raises(ValueError):
        cuda_ntt.ntt_stage_cuda(LF.encode([1, 2]), P)


def test_long_power_table_is_the_outer_product():
    w = ntt.get_omega(P, 14)
    got = ntt.power_table(P, w, 1 << 13, "cpu")
    idx = [0, 1, 4095, 4096, 4097, 8191]
    assert LF.decode(got[idx]) == [pow(w, i, P) for i in idx]


def fourstep_model(a, modulus, inverse):
    """csrc/ntt_fourstep.cu in plain PyTorch, index for index: kernel 1 takes
    column i1 of the (n2, n1) view, transforms it over i2, multiplies by
    mid_a[e mod n2] * mid_b[e div n2] with e = i1 * k2 and writes row i1 of
    tmp (n1, n2); kernel 2 takes column k2 of tmp, transforms it over i1 and
    writes X[k1 * n2 + k2], times the inverse's 1/n."""
    lf = limb_field(modulus)
    n = a.shape[0]
    log_n = n.bit_length() - 1
    l1 = log_n // 2
    l2 = log_n - l1
    n1, n2 = 1 << l1, 1 << l2
    tw1, tw2, mid_a, mid_b = cuda_ntt._fourstep_tables(modulus, log_n, inverse, "cpu")
    assert (tw1.shape[0], tw2.shape[0], mid_a.shape[0], mid_b.shape[0]) == (
        n2 // 2, max(n1 // 2, 1), n2, n1)
    tmp = torch.empty(n1, n2, 8, dtype=torch.int32)
    k2 = torch.arange(n2)
    for i1 in range(n1):
        col = a[i1 + n1 * torch.arange(n2)]
        col = ntt.transform_plain(col, tw1, modulus)
        e = i1 * k2
        mid = lf.mul(mid_a[e & (n2 - 1)], mid_b[e >> l2])
        tmp[i1] = lf.mul(col, mid)
    out = torch.empty(n, 8, dtype=torch.int32)
    for c in range(n2):
        col = ntt.transform_plain(tmp[:, c], tw2, modulus)
        if inverse:
            col = lf.mul(col, cuda_ntt._scale(modulus, n, "cpu"))
        out[c + n2 * torch.arange(n1)] = col
    return out


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("log_n", [2, 3, 4, 5, 8, 9])
def test_fourstep_index_algebra_vs_host(log_n, inverse):
    vals = _vals(1 << log_n, 200 + log_n)
    got = fourstep_model(LF.encode(vals), P, inverse)
    assert LF.decode(got) == ntt.ntt_host(vals, P, inverse)
