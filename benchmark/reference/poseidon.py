"""A plain Poseidon sponge over a prime field, in Python integers.

The constants come from the canonical Grain LFSR of the Poseidon paper (the
round constants, then a Cauchy MDS matrix from 2t further samples), and the
permutation is the textbook one: per round, add the round's constants, apply
x^5 (to every word in a full round, to the first in a partial one), multiply
by the MDS matrix.  The sponge follows Mira's `poseidon_hash.rs`: the state
starts as [2^64, 0, ...]; absorbed words are buffered; `squeeze` permutes
the buffer in blocks of `rate`, each block added to state[1..] with a 1 in
the slot after its last word, and one empty block more where the buffer's
length is a multiple of `rate`; the output is state[1] cut to its low bits.

No round constant is moved across a linear layer and no sparse matrix is
used, so this shares no arithmetic with an optimised implementation.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence


def _grain_bits(num_bits: int, t: int, r_f: int, r_p: int):
    """The self-shrunk bit stream of the 80-bit Grain LFSR seeded with the
    instance's description (prime field, x^5, field size, t, R_F, R_P)."""
    state = []
    for value, width in ((1, 2), (0, 4), (num_bits, 12), (t, 12), (r_f, 10), (r_p, 10)):
        state += [(value >> (width - 1 - i)) & 1 for i in range(width)]
    state += [1] * 30

    def raw():
        new = state[62] ^ state[51] ^ state[38] ^ state[23] ^ state[13] ^ state[0]
        state.pop(0)
        state.append(new)
        return new

    for _ in range(160):
        raw()
    while True:
        if raw():
            yield raw()
        else:
            raw()


@lru_cache(maxsize=None)
def constants(p: int, t: int, r_f: int, r_p: int):
    """(round constants [R_F + R_P][t], MDS [t][t]) of the instance."""
    n = p.bit_length()
    bits = _grain_bits(n, t, r_f, r_p)

    def sample():
        v = 0
        for _ in range(n):
            v = (v << 1) | next(bits)
        return v

    rc = []
    for _ in range(r_f + r_p):
        row = []
        while len(row) < t:
            v = sample()
            if v < p:
                row.append(v)
        rc.append(row)
    while True:
        vals = [sample() % p for _ in range(2 * t)]
        if len(set(vals)) == 2 * t:
            break
    xs, ys = vals[:t], vals[t:]
    mds = [[pow((xs[i] + ys[j]) % p, p - 2, p) for j in range(t)] for i in range(t)]
    return rc, mds


def permute(state: List[int], p: int, t: int, r_f: int, r_p: int) -> List[int]:
    rc, mds = constants(p, t, r_f, r_p)
    half = r_f // 2
    for r in range(r_f + r_p):
        state = [(s + c) % p for s, c in zip(state, rc[r])]
        if r < half or r >= half + r_p:
            state = [pow(s, 5, p) for s in state]
        else:
            state[0] = pow(state[0], 5, p)
        state = [sum(m * s for m, s in zip(row, state)) % p for row in mds]
    return state


class Sponge:
    """Mira's sponge over GF(p) with width t = rate + 1."""

    def __init__(self, p: int, t: int, r_f: int, r_p: int):
        self.p, self.t, self.r_f, self.r_p = p, t, r_f, r_p
        self.rate = t - 1
        self.state = [(1 << 64) % p] + [0] * (t - 1)
        self.buf: List[int] = []

    def absorb(self, values: Sequence[int]) -> "Sponge":
        self.buf.extend(v % self.p for v in values)
        return self

    def _block(self, block: Sequence[int]):
        s = list(self.state)
        for i, v in enumerate(block):
            s[1 + i] = (s[1 + i] + v) % self.p
        if len(block) + 1 < self.t:
            s[1 + len(block)] = (s[1 + len(block)] + 1) % self.p
        self.state = permute(s, self.p, self.t, self.r_f, self.r_p)

    def squeeze(self, num_bits: int) -> int:
        buf, self.buf = self.buf, []
        for i in range(0, len(buf), self.rate):
            self._block(buf[i : i + self.rate])
        if len(buf) % self.rate == 0:
            self._block([])
        return self.state[1] & ((1 << num_bits) - 1)


def hash_chain(z: int, p: int, spec, times: int) -> int:
    """z hashed `times` times, each a fresh sponge over [z] squeezed to 255
    bits (the Poseidon step circuit's function)."""
    t, _rate, r_f, r_p = spec
    for _ in range(times):
        z = Sponge(p, t, r_f, r_p).absorb([z]).squeeze(255) % p
    return z
