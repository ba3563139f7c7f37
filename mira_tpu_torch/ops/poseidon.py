"""Poseidon permutation: spec (constant) generation + host sponge.

The reference consumes a fork of the PSE ``poseidon`` crate whose ``Spec`` is
generated from the Grain LFSR exactly as in the canonical Poseidon reference
implementation, then optimized per Appendix B of the Poseidon paper into
``start``/``partial``/``end`` constants plus a sparse-MDS factorization.

Bit-exactness anchor: hashing pallas-base 0..5 with T=3/RATE=2/R_F=4/R_P=3 and
squeezing 128 bits must equal 277726250230731218669330566268314254439
(reference: src/poseidon/poseidon_hash.rs:263-281).

The sponge orchestration (`update`/`output`/`permutation`) mirrors
src/poseidon/poseidon_hash.rs:187-254 including the implicit
padding: `pre_round` adds F::ONE at the state slot following the inputs, and an
extra empty permutation runs when the buffered input is an exact multiple of
RATE.

Copied from mira_tpu/ops/poseidon.py; the port imports nothing of mira_tpu.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple, Type

from ..fields.host import Fp


# ---------------------------------------------------------------------------
# Grain LFSR (canonical Poseidon parameter generation)
# ---------------------------------------------------------------------------


class Grain:
    """80-bit Grain LFSR emitting self-shrunk bits, seeded with the Poseidon
    instance description (field tag, sbox, n, t, R_F, R_P)."""

    STATE = 80

    def __init__(self, num_bits: int, t: int, r_f: int, r_p: int):
        bits = [True] * self.STATE

        def set_bits(offset: int, length: int, value: int):
            # values are placed MSB-first within their bit window
            for i in range(length):
                bits[offset + length - 1 - i] = bool((value >> i) & 1)

        set_bits(0, 2, 1)  # field type: prime
        set_bits(2, 4, 0)  # sbox: x^5
        set_bits(6, 12, num_bits)
        set_bits(18, 12, t)
        set_bits(30, 10, r_f)
        set_bits(40, 10, r_p)
        # bits 50..79 stay 1
        self.state = bits
        # discard first 160 raw bits
        for _ in range(160):
            self._raw_bit()

    def _raw_bit(self) -> bool:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new)
        return new

    def next_bit(self) -> bool:
        """Self-shrinking filter: evaluate raw bits in pairs, emit the second
        of a pair only when the first is 1."""
        while True:
            if self._raw_bit():
                return self._raw_bit()
            self._raw_bit()

    def take(self, n: int) -> List[bool]:
        return [self.next_bit() for _ in range(n)]

    def next_field_element(self, cls: Type[Fp]) -> Fp:
        """Rejection-sampled field element; bits interpreted MSB-first."""
        num_bits = cls.PARAMS.num_bits
        while True:
            v = 0
            for bit in self.take(num_bits):
                v = (v << 1) | int(bit)
            if v < cls.P:
                return cls(v)

    def next_field_element_without_rejection(self, cls: Type[Fp]) -> Fp:
        num_bits = cls.PARAMS.num_bits
        v = 0
        for bit in self.take(num_bits):
            v = (v << 1) | int(bit)
        return cls(v)


# ---------------------------------------------------------------------------
# Matrix helpers (dense, tiny T x T)
# ---------------------------------------------------------------------------


def mat_mul(a: List[List[Fp]], b: List[List[Fp]]) -> List[List[Fp]]:
    t = len(a)
    return [
        [sum((a[i][k] * b[k][j] for k in range(t)), a[0][0].zero()) for j in range(t)]
        for i in range(t)
    ]


def mat_vec(m: List[List[Fp]], v: Sequence[Fp]) -> List[Fp]:
    z = v[0].zero()
    return [sum((mij * vj for mij, vj in zip(row, v)), z) for row in m]


def mat_invert(m: List[List[Fp]]) -> List[List[Fp]]:
    t = len(m)
    one, zero = m[0][0].one(), m[0][0].zero()
    aug = [[m[i][j] for j in range(t)] + [one if i == j else zero for j in range(t)] for i in range(t)]
    for col in range(t):
        piv = next(r for r in range(col, t) if not aug[r][col].is_zero())
        aug[col], aug[piv] = aug[piv], aug[col]
        inv = aug[col][col].invert()
        aug[col] = [x * inv for x in aug[col]]
        for r in range(t):
            if r != col and not aug[r][col].is_zero():
                f = aug[r][col]
                aug[r] = [x - f * y for x, y in zip(aug[r], aug[col])]
    return [row[t:] for row in aug]


def mat_transpose(m: List[List[Fp]]) -> List[List[Fp]]:
    t = len(m)
    return [[m[j][i] for j in range(t)] for i in range(t)]


def mat_identity(cls: Type[Fp], t: int) -> List[List[Fp]]:
    return [[cls(1) if i == j else cls(0) for j in range(t)] for i in range(t)]


# ---------------------------------------------------------------------------
# Spec: round constants + MDS + Appendix-B optimization
# ---------------------------------------------------------------------------


class SparseMDSMatrix:
    """Sparse factor M'' of the MDS factorization: applied as
    new[0] = <row, state>; new[i+1] = col_hat[i] * state[0] + state[i+1]."""

    def __init__(self, row: List[Fp], col_hat: List[Fp]):
        self.row = row
        self.col_hat = col_hat


class Spec:
    """Poseidon constants for a (field, T, RATE, r_f, r_p) instance."""

    def __init__(self, cls: Type[Fp], t: int, rate: int, r_f: int, r_p: int):
        assert rate == t - 1
        self.field_cls = cls
        self.t = t
        self.rate = rate
        self.r_f = r_f
        self.r_p = r_p

        constants, mds = self._grain_generate(cls, t, r_f, r_p)
        self.mds = mds
        self.constants_start, self.constants_partial, self.constants_end = (
            self._optimize_constants(constants, mds)
        )
        self.sparse_matrices, self.pre_sparse_mds = self._sparse_matrices(mds)

    # -- generation ---------------------------------------------------------
    def _grain_generate(self, cls, t, r_f, r_p):
        grain = Grain(cls.PARAMS.num_bits, t, r_f, r_p)
        constants = [
            [grain.next_field_element(cls) for _ in range(t)] for _ in range(r_f + r_p)
        ]
        # Cauchy MDS from 2T unique unrejected samples
        while True:
            vals = [grain.next_field_element_without_rejection(cls) for _ in range(2 * t)]
            if len({v.v for v in vals}) == len(vals):
                xs, ys = vals[:t], vals[t:]
                break
        mds = [[(xs[i] + ys[j]).invert() for j in range(t)] for i in range(t)]
        return constants, mds

    def _optimize_constants(self, constants, mds):
        """Move constants across the linear layers (Poseidon paper App. B /
        reference sage `calc_equivalent_constants`)."""
        r_p = self.r_p
        cls = self.field_cls
        inv_mds = mat_invert(mds)
        half = self.r_f // 2

        # start has half+1 rows: raw first row, inv-mds-moved rows 1..half-1,
        # and the residue of the partial-round constant migration at [half].
        start: List[List[Fp]] = [constants[0]]
        for row in constants[1:half]:
            start.append(mat_vec(inv_mds, row))

        acc = list(constants[half + r_p])
        partial = [cls(0)] * r_p
        # consume rows half+r_p-1 down to half, migrating each constant row up
        for i, row in enumerate(reversed(constants[half : half + r_p])):
            tmp = mat_vec(inv_mds, acc)
            partial[r_p - 1 - i] = tmp[0]
            tmp[0] = cls(0)
            acc = [tj + cj for tj, cj in zip(tmp, row)]
        start.append(mat_vec(inv_mds, acc))

        end: List[List[Fp]] = [
            mat_vec(inv_mds, row) for row in constants[half + r_p + 1 :]
        ]
        assert len(start) == half + 1 and len(end) == half - 1
        return start, partial, end

    def _sparse_matrices(self, mds):
        """Factor M^T repeatedly into M' (dense inner block) and M'' (sparse),
        per the reference sage `calc_equivalent_matrices`."""
        t, r_p = self.t, self.r_p
        mds_t = mat_transpose(mds)
        acc = [row[:] for row in mds_t]
        sparse: List[SparseMDSMatrix] = []
        for _ in range(r_p):
            m_prime, m_double_prime = self._factorise(acc)
            sparse.append(m_double_prime)
            acc = mat_mul(mds_t, m_prime)
        sparse.reverse()
        return sparse, mat_transpose(acc)

    def _factorise(self, m):
        """m = m' * m'' in the transposed domain; returns (m', sparse m'')."""
        t = self.t
        cls = self.field_cls
        m_prime = mat_identity(cls, t)
        for i in range(1, t):
            for j in range(1, t):
                m_prime[i][j] = m[i][j]
        w = [m[i][0] for i in range(1, t)]
        m_hat = [[m[i][j] for j in range(1, t)] for i in range(1, t)]
        w_hat = mat_vec(mat_invert(m_hat), w)
        # applied as: new[0] = m00*s0 + <w_hat, s[1:]>; new[i+1] = v[i]*s0 + s[i+1]
        return m_prime, SparseMDSMatrix([m[0][0]] + w_hat, list(m[0][1:]))


@lru_cache(maxsize=None)
def get_spec(modulus: int, t: int, rate: int, r_f: int, r_p: int) -> Spec:
    from ..fields.host import field

    return Spec(field(modulus), t, rate, r_f, r_p)


# ---------------------------------------------------------------------------
# Host sponge (the off-circuit random oracle)
# ---------------------------------------------------------------------------


class PoseidonHash:
    """Off-circuit Poseidon sponge, mirroring the reference's buffering and
    permutation schedule (src/poseidon/poseidon_hash.rs)."""

    def __init__(self, spec: Spec):
        self.spec = spec
        cls = spec.field_cls
        # Sponge IV: the capacity element starts at 2^64 (PSE poseidon crate
        # `State::default()`), validated by the reference known-answer vector.
        self.state = [cls(1 << 64)] + [cls(0)] * (spec.t - 1)
        self.buf: List[Fp] = []

    # -- absorb API (ROTrait) ----------------------------------------------
    def update(self, elements: Sequence[Fp]) -> "PoseidonHash":
        self.buf.extend(elements)
        return self

    def absorb_field(self, fe: Fp) -> "PoseidonHash":
        return self.update([fe])

    def absorb_point(self, point) -> "PoseidonHash":
        """Affine point -> (x, y); infinity -> (0, 0)
        (reference poseidon_hash.rs:129-143)."""
        cls = self.spec.field_cls
        if point.is_identity():
            return self.update([cls(0), cls(0)])
        return self.update([point.x, point.y])

    def absorb_g2_point(self, point) -> "PoseidonHash":
        cls = self.spec.field_cls
        if point.is_inf:
            return self.update([cls(0)] * 4)
        return self.update([point.x.c0, point.x.c1, point.y.c0, point.y.c1])

    def absorb_fp12_tuple(self, tuple12) -> "PoseidonHash":
        return self.update(list(tuple12.elements))

    # -- squeeze ------------------------------------------------------------
    def output(self, out_cls: Type[Fp], num_bits: int) -> Fp:
        buf, self.buf = self.buf, []
        rate = self.spec.rate
        exact = len(buf) % rate == 0
        for i in range(0, len(buf), rate):
            self.permutation(buf[i : i + rate])
        if exact:
            self.permutation([])
        out = self.state[1]
        return out_cls(out.v & ((1 << num_bits) - 1))

    def squeeze(self, out_cls: Type[Fp], num_bits: int) -> Fp:
        return self.output(out_cls, num_bits)

    # -- permutation --------------------------------------------------------
    def permutation(self, inputs: Sequence[Fp]):
        spec = self.spec
        cls = spec.field_cls
        t = spec.t
        half = spec.r_f // 2

        def pow5(x: Fp) -> Fp:
            s = x.square()
            return s.square() * x

        state = self.state

        # pre-round: add inputs + first start constants + the `1` pad marker
        pre = spec.constants_start[0]
        state[0] = state[0] + pre[0]
        for i in range(len(inputs)):
            state[1 + i] = state[1 + i] + inputs[i] + pre[1 + i]
        for idx, j in enumerate(range(1 + len(inputs), t)):
            pad = cls(1) if idx == 0 else cls(0)
            state[j] = state[j] + pad + pre[j]

        # first half of full rounds
        for consts in spec.constants_start[1:half]:
            state = [pow5(s) + c for s, c in zip(state, consts)]
            state = mat_vec(spec.mds, state)
        state = [pow5(s) + c for s, c in zip(state, spec.constants_start[half])]
        state = mat_vec(spec.pre_sparse_mds, state)

        # partial rounds
        for const, sparse in zip(spec.constants_partial, spec.sparse_matrices):
            state[0] = pow5(state[0]) + const
            new0 = sum((ri * si for ri, si in zip(sparse.row, state)), cls(0))
            state = [new0] + [
                ch * state[0] + state[i + 1] for i, ch in enumerate(sparse.col_hat)
            ]

        # second half of full rounds
        for consts in spec.constants_end:
            state = [pow5(s) + c for s, c in zip(state, consts)]
            state = mat_vec(spec.mds, state)
        state = [pow5(s) for s in state]
        state = mat_vec(spec.mds, state)

        self.state = state


def create_ro(base_modulus: int, t: int = 5, rate: int = 4, r_f: int = 10, r_p: int = 10) -> "PoseidonHash":
    """Random oracle over a curve's base field (IVC default T=5/RATE=4/
    R_F=R_P=10, reference examples/trivial/main.rs:24-25,72-73)."""
    return PoseidonHash(get_spec(base_modulus, t, rate, r_f, r_p))
