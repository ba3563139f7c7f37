"""Batched Poseidon on the device (port of mira_tpu/ops/poseidon_device.py).

The transcript sponge is sequential (host: ops/poseidon.py), but batch
hashing (Merkle levels, leaf commitments) is N independent fixed-length
sponges.  `poseidon_hash_batch` runs them on the device of its input: a CPU
tensor takes the plain PyTorch version below, a CUDA tensor the kernel of
ops/cuda_poseidon.py (csrc/poseidon.cu).  Both follow the host permutation's
optimized-constant schedule (start / pre-sparse MDS / sparse partial rounds /
end, reference src/poseidon/poseidon_hash.rs:174-254) and are bit-exact with
it: the output is state[1] before any bit truncation.

Field elements are (…, 8) int32 Montgomery word tensors; the constants are
Montgomery-encoded once per (spec, device).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..fields.limbs import NUM_WORDS, limb_field
from .poseidon import get_spec

IV = 1 << 64  # the capacity element's start value (PSE `State::default()`)


def spec_constants(modulus: int, t: int, rate: int, r_f: int, r_p: int):
    """The spec's constants as lists of ints, in the order the kernel's table
    keeps them: start rows, partial constants, end rows, MDS, pre-sparse MDS,
    sparse rows, sparse columns."""
    spec = get_spec(modulus, t, rate, r_f, r_p)

    def rows(rs):
        return [[c.v for c in row] for row in rs]

    return {
        "start": rows(spec.constants_start),
        "partial": [c.v for c in spec.constants_partial],
        "end": rows(spec.constants_end),
        "mds": rows(spec.mds),
        "pre": rows(spec.pre_sparse_mds),
        "rows": rows([m.row for m in spec.sparse_matrices]),
        "cols": rows([m.col_hat for m in spec.sparse_matrices]),
    }


@lru_cache(maxsize=None)
def _plain_constants(modulus: int, t: int, rate: int, r_f: int, r_p: int,
                     device: str):
    lf = limb_field(modulus)
    c = spec_constants(modulus, t, rate, r_f, r_p)

    def enc(rs, width):
        flat = [v for row in rs for v in row]
        return lf.encode(flat, device).reshape(len(rs), width, NUM_WORDS)

    return {
        "start": enc(c["start"], t),
        "partial": lf.encode(c["partial"], device),
        "end": enc(c["end"], t),
        "mds": enc(c["mds"], t),
        "pre": enc(c["pre"], t),
        "rows": enc(c["rows"], t),
        "cols": enc(c["cols"], t - 1),
    }


def poseidon_hash_batch_plain(values: torch.Tensor, modulus: int, t: int = 3,
                              rate: int = 2, r_f: int = 10, r_p: int = 10):
    """(N, L, 8) Montgomery inputs -> (N, 8) Montgomery state[1], in plain
    PyTorch on the device of `values` (the counterpart of mira_tpu's
    `_hash_batch_jit`).  The state is a (t, N) lazy array between rounds."""
    lf = limb_field(modulus)
    dev = values.device
    n, num_inputs = values.shape[0], values.shape[1]
    c = _plain_constants(modulus, t, rate, r_f, r_p, str(dev))
    half = r_f // 2

    def pow5(x):
        s = x.square()
        return s.square() * x

    def mat_vec(m, state):
        # m: (t, t, 8); state: (t, N) lazy -> (t, N) lazy
        prod = lf.lz(m)[:, :, None] * state[None]  # (t, t, N)
        acc = prod[:, 0]
        for j in range(1, t):
            acc = acc + prod[:, j]
        return lf.settle(acc)

    def full_round(state, consts):
        return mat_vec(c["mds"], pow5(state) + lf.lz(consts)[:, None])

    def permutation(state, inputs):
        """state: (t, N) lazy; inputs: (k, N, 8) words, k < t."""
        k = inputs.shape[0]
        add = torch.zeros(t, n, NUM_WORDS, dtype=torch.int32, device=dev)
        add[1 : 1 + k] = inputs
        if 1 + k < t:  # the `1` pad marker in the first unused slot
            add[1 + k] = lf.one((n,), dev)
        state = state + lf.lz(c["start"][0])[:, None] + lf.lz(add)
        for r in range(1, half):
            state = full_round(state, c["start"][r])
        state = mat_vec(c["pre"], pow5(state) + lf.lz(c["start"][half])[:, None])
        for r in range(r_p):
            s0 = pow5(state[0]) + lf.lz(c["partial"][r])
            row, col = lf.lz(c["rows"][r]), lf.lz(c["cols"][r])
            new0 = row[0] * s0
            for j in range(1, t):
                new0 = new0 + row[j] * state[j]
            rest = col[:, None] * s0[None] + state[1:]
            state = lf.settle(_stack_lz(lf, [new0[None], rest]))
        for r in range(half - 1):
            state = full_round(state, c["end"][r])
        return mat_vec(c["mds"], pow5(state))

    state0 = torch.zeros(t, n, NUM_WORDS, dtype=torch.int32, device=dev)
    state0[0] = lf.const(IV, (n,), dev)
    state = lf.lz(state0)
    xs = values.transpose(0, 1)  # (L, N, 8)
    for i in range(0, num_inputs, rate):
        state = permutation(state, xs[i : i + rate])
    if num_inputs % rate == 0:
        state = permutation(state, xs[:0])
    return lf.canon(state[1])


def _stack_lz(lf, parts):
    """Concatenate lazy values along their first axis (equal limb counts)."""
    from ..fields.limbs import Lz

    settled = [lf.settle(p) for p in parts]
    return Lz(lf, torch.cat([p.t for p in settled], dim=0), 1)


def poseidon_hash_batch(values: torch.Tensor, modulus: int, t: int = 3,
                        rate: int = 2, r_f: int = 10, r_p: int = 10):
    """values: (N, L, 8) Montgomery word tensor.  Returns the (N, 8)
    Montgomery state[1] outputs, the field elements the host sponge produces
    before bit truncation, on the device of `values`."""
    if (values.dim() != 3 or values.shape[2] != NUM_WORDS
            or values.dtype != torch.int32):
        raise ValueError("poseidon_hash_batch: expects an (N, L, 8) int32 "
                         "word tensor")
    if rate != t - 1 or r_f < 2 or r_f % 2:
        raise ValueError("poseidon_hash_batch: needs rate == t - 1 and an "
                         "even r_f >= 2")
    if values.device.type == "cpu":
        return poseidon_hash_batch_plain(values, modulus, t, rate, r_f, r_p)
    from .cuda_poseidon import poseidon_hash_batch_cuda

    return poseidon_hash_batch_cuda(values, modulus, t, rate, r_f, r_p)
