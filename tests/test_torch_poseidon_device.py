"""The port's batched Poseidon sponge (mira_tpu_torch/ops/poseidon_device.py)
on the CPU: its plain version against mira_tpu's
`ops.poseidon_device.poseidon_hash_batch` and against the host sponge for the
(t, rate, L) cases of the reference's tests; the spec's constants against
mira_tpu's; and the kernel's constant table against the layout csrc/poseidon.cu
reads.  Inputs come from numpy seeds; comparisons are on decoded integers,
exact."""

import numpy as np
import pytest
import torch

from mira_tpu.fields.host import field as mira_field
from mira_tpu.fields.limbs import limb_field as jax_limb_field
from mira_tpu.ops import poseidon as mira_poseidon
from mira_tpu.ops.poseidon_device import poseidon_hash_batch as mira_hash_batch
from mira_tpu_torch.convert import limbs16_to_words
from mira_tpu_torch.fields.limbs import limb_field
from mira_tpu_torch.fields.params import BN254_FQ, BN254_FR
from mira_tpu_torch.ops import cuda_poseidon
from mira_tpu_torch.ops.poseidon_device import (
    IV,
    poseidon_hash_batch,
    spec_constants,
)

import torch_port_helpers  # noqa: F401  (sizes torch's thread pool)

# tests/test_poseidon_device.py:50 and tests/test_pallas_poseidon.py:70, plus
# the narrowest sponge, an empty input and a three-chunk input
CASES = [(3, 2, 2), (3, 2, 3), (5, 4, 4), (5, 4, 6), (2, 1, 1), (3, 2, 0),
         (4, 3, 7)]


def _inputs(modulus, n, length, seed):
    rng = np.random.default_rng(seed)
    vals = [[int.from_bytes(rng.bytes(32), "little") % modulus
             for _ in range(length)] for _ in range(n)]
    if length:
        vals[0] = [0] * length
        vals[1] = [modulus - 1] * length
    lf = limb_field(modulus)
    flat = lf.encode([v for row in vals for v in row]).reshape(n, length, 8)
    return vals, flat


def _host_state1(vals, modulus, t, rate, r_f=10, r_p=10):
    """mira_tpu's host sponge output without bit truncation."""
    F = mira_field(modulus)
    h = mira_poseidon.PoseidonHash(mira_poseidon.get_spec(modulus, t, rate, r_f, r_p))
    h.update([F(v) for v in vals])
    buf, h.buf = h.buf, []
    for j in range(0, len(buf), rate):
        h.permutation(buf[j : j + rate])
    if len(buf) % rate == 0:
        h.permutation([])
    return h.state[1].v


@pytest.mark.parametrize("t,rate,length", CASES)
def test_plain_matches_host_sponge(t, rate, length):
    vals, flat = _inputs(BN254_FR, 5, length, 7 + t + length)
    got = limb_field(BN254_FR).decode(
        poseidon_hash_batch(flat, BN254_FR, t=t, rate=rate))
    assert got == [_host_state1(v, BN254_FR, t, rate) for v in vals]


def test_plain_matches_host_sponge_other_rounds_and_field():
    vals, flat = _inputs(BN254_FQ, 3, 3, 11)
    got = limb_field(BN254_FQ).decode(
        poseidon_hash_batch(flat, BN254_FQ, t=3, rate=2, r_f=4, r_p=3))
    assert got == [_host_state1(v, BN254_FQ, 3, 2, 4, 3) for v in vals]


def test_plain_matches_mira_device_batch():
    """The merkle-node shape through mira_tpu's batched device sponge (the
    one shape its own tests compile on the CPU)."""
    vals, flat = _inputs(BN254_FR, 3, 2, 42)
    jlf = jax_limb_field(BN254_FR)
    theirs = mira_hash_batch(
        jlf.encode([v for row in vals for v in row]).reshape(3, 2, -1), BN254_FR)
    got = poseidon_hash_batch(flat, BN254_FR)
    assert torch.equal(got, limbs16_to_words(np.asarray(theirs)))


@pytest.mark.parametrize("t,rate", [(3, 2), (5, 4)])
def test_constants_match_mira_and_kernel_layout(t, rate):
    r_f = r_p = 10
    spec = mira_poseidon.get_spec(BN254_FR, t, rate, r_f, r_p)
    c = spec_constants(BN254_FR, t, rate, r_f, r_p)
    assert c["start"] == [[x.v for x in row] for row in spec.constants_start]
    assert c["partial"] == [x.v for x in spec.constants_partial]
    assert c["end"] == [[x.v for x in row] for row in spec.constants_end]
    assert c["mds"] == [[x.v for x in row] for row in spec.mds]
    assert c["pre"] == [[x.v for x in row] for row in spec.pre_sparse_mds]
    assert c["rows"] == [[x.v for x in m.row] for m in spec.sparse_matrices]
    assert c["cols"] == [[x.v for x in m.col_hat] for m in spec.sparse_matrices]
    # the kernel's table: the count csrc/poseidon.cu expects, in its order
    half = r_f // 2
    table = cuda_poseidon._constants(BN254_FR, t, rate, r_f, r_p, "cpu")
    assert table.shape == ((half + 1) * t + r_p + (half - 1) * t + 2 * t * t
                           + r_p * t + r_p * (t - 1) + 1, 8)
    lf = limb_field(BN254_FR)
    mds_at = (half + 1) * t + r_p + (half - 1) * t
    assert lf.decode(table[:t]) == c["start"][0]
    assert lf.decode(table[mds_at : mds_at + t]) == c["mds"][0]
    assert lf.decode(table[-1:]) == [IV]
    assert lf.decode(table[-1 - (t - 1) : -1]) == c["cols"][-1]


def test_arguments_are_checked():
    _, flat = _inputs(BN254_FR, 2, 2, 1)
    with pytest.raises(ValueError):
        poseidon_hash_batch(flat, BN254_FR, t=3, rate=3)
    with pytest.raises(ValueError):
        poseidon_hash_batch(flat[0], BN254_FR)
    with pytest.raises(ValueError):  # the kernel's wrapper takes CUDA tensors
        cuda_poseidon.poseidon_hash_batch_cuda(flat, BN254_FR)


@pytest.mark.parametrize("t, lanes", [(2, 2), (3, 4), (4, 4), (5, 8)])
def test_lane_route_widths(t, lanes):
    assert cuda_poseidon.lanes_per_hash(t) == lanes


# (hashes, width, SMs): an H100's 132 SMs, and a card of one
RULE_CASES = [(1, 3, 132), (1 << 13, 3, 132), (8448, 3, 132), (8449, 3, 132),
              (1 << 14, 3, 132), (1 << 20, 3, 132), (4224, 5, 132),
              (4225, 5, 132), (16896, 2, 132), (16897, 2, 132), (64, 4, 1),
              (65, 4, 1), (0, 3, 132)]


@pytest.mark.parametrize("n, t, sms", RULE_CASES)
def test_route_rule(n, t, sms):
    """The lane route exactly while the batch's lanes fill at most two warps
    on each of the card's SM sub-partitions; the rule reads nothing else."""
    lanes = cuda_poseidon.lanes_per_hash(t)
    want = "lanes" if n * lanes <= 4 * 2 * 32 * sms else "thread"
    assert cuda_poseidon.poseidon_route(n, t, sms) == want


def test_route_rule_on_a_merkle_tree():
    """A 2^20-leaf tree (t = 3) on 132 SMs: its levels of 2^14 hashes and
    more on the thread route, the 14 levels of 2^13 hashes and fewer on the
    lane route."""
    routes = [cuda_poseidon.poseidon_route(1 << k, 3, 132) for k in range(20)]
    assert routes == ["lanes"] * 14 + ["thread"] * 6
