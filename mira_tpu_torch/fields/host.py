"""Host-side (CPU, Python-int) prime field elements.

This is the golden reference implementation the TPU limb kernels are tested
against, and the workhorse for the sequential protocol layer (transcripts,
circuit synthesis bookkeeping).  Field elements are immutable wrappers over
Python ints; each modulus gets its own class via :func:`field`.

Semantics mirror the `ff::PrimeField` trait surface the reference consumes
(reference: src/util.rs, src/fft.rs).

Copied from mira_tpu/fields/host.py; the port imports nothing of mira_tpu.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Iterable, List, Type

from .params import FieldParams, field_params


class Fp:
    """Base class for a prime field element; subclassed per modulus."""

    __slots__ = ("v",)

    # class attributes injected by field():
    P: int = 0
    PARAMS: FieldParams = None  # type: ignore

    def __init__(self, v: int | "Fp" = 0):
        if isinstance(v, Fp):
            v = v.v
        self.v = v % self.P

    # -- constructors -------------------------------------------------------
    @classmethod
    def zero(cls) -> "Fp":
        return cls(0)

    @classmethod
    def one(cls) -> "Fp":
        return cls(1)

    @classmethod
    def from_u128(cls, v: int) -> "Fp":
        return cls(v)

    @classmethod
    def from_str_vartime(cls, s: str) -> "Fp":
        return cls(int(s))

    @classmethod
    def from_bytes_le(cls, b: bytes) -> "Fp":
        v = int.from_bytes(b, "little")
        assert v < cls.P, "non-canonical repr"
        return cls(v)

    @classmethod
    def from_uniform_bytes(cls, b: bytes) -> "Fp":
        """512-bit little-endian integer reduced mod p (ff `FromUniformBytes<64>`)."""
        return cls(int.from_bytes(b, "little"))

    @classmethod
    def random(cls, rng) -> "Fp":
        return cls(rng.randrange(cls.P))

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o):
        return type(self)((self.v + _val(o)) % self.P)

    __radd__ = __add__

    def __sub__(self, o):
        return type(self)((self.v - _val(o)) % self.P)

    def __rsub__(self, o):
        return type(self)((_val(o) - self.v) % self.P)

    def __mul__(self, o):
        return type(self)((self.v * _val(o)) % self.P)

    __rmul__ = __mul__

    def __neg__(self):
        return type(self)(-self.v % self.P)

    def __pow__(self, e: int):
        return type(self)(pow(self.v, e, self.P))

    def square(self):
        return type(self)((self.v * self.v) % self.P)

    def double(self):
        return type(self)((self.v * 2) % self.P)

    def invert(self):
        if self.v == 0:
            raise ZeroDivisionError("inversion of zero field element")
        return type(self)(pow(self.v, -1, self.P))

    def invert_or_zero(self):
        return self.zero() if self.v == 0 else self.invert()

    def sqrt(self):
        """Tonelli-Shanks; returns the even root's class representative
        (the root r with r <= p - r is NOT enforced -- callers pick)."""
        p = self.P
        if self.v == 0:
            return type(self)(0)
        if pow(self.v, (p - 1) // 2, p) != 1:
            return None
        pr = self.PARAMS
        if p % 4 == 3:
            return type(self)(pow(self.v, (p + 1) // 4, p))
        # Tonelli-Shanks using the field's 2-adic root of unity
        s, t = pr.s, (p - 1) >> pr.s
        z = pr.root_of_unity  # primitive 2^s root: a non-residue generator
        m, c, u, r = s, z, pow(self.v, t, p), pow(self.v, (t + 1) // 2, p)
        while u != 1:
            # find least i with u^(2^i) == 1
            i, t2 = 0, u
            while t2 != 1:
                t2 = (t2 * t2) % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, (b * b) % p
            u, r = (u * c) % p, (r * b) % p
        return type(self)(r)

    # -- comparisons / hashing ---------------------------------------------
    def __eq__(self, o):
        return isinstance(o, Fp) and o.P == self.P and o.v == self.v

    def __hash__(self):
        return hash((self.P, self.v))

    def __bool__(self):
        return self.v != 0

    def is_zero(self) -> bool:
        return self.v == 0

    def __repr__(self):
        return f"{type(self).__name__}({self.v})"

    # -- encodings ----------------------------------------------------------
    def to_bytes_le(self, n: int | None = None) -> bytes:
        n = n if n is not None else (self.PARAMS.num_bits + 7) // 8
        return self.v.to_bytes(n, "little")

    def to_repr(self) -> bytes:
        """32-byte little-endian canonical repr (ff `to_repr`)."""
        return self.v.to_bytes(32, "little")

    def to_bits_le(self, num_bits: int | None = None) -> List[bool]:
        """LE bit decomposition, mirroring fe_to_bits_le
        (reference src/util.rs:45-52)."""
        n = num_bits if num_bits is not None else self.PARAMS.num_bits
        return [bool((self.v >> i) & 1) for i in range(n)]


def _val(o) -> int:
    if isinstance(o, Fp):
        return o.v
    if isinstance(o, int):
        return o
    raise TypeError(f"cannot coerce {type(o)} to field element")


@lru_cache(maxsize=None)
def field(modulus: int) -> Type[Fp]:
    """Return (and cache) the element class for a given prime modulus."""
    params = field_params(modulus)
    cls = type(
        params.name.replace("::", "_").replace(":", "_"),
        (Fp,),
        {"__slots__": (), "P": modulus, "PARAMS": params},
    )
    return cls


def bits_to_fe_le(cls: Type[Fp], bits: Iterable[bool]) -> Fp:
    """LE bits -> field element (reference src/util.rs:54-57)."""
    v = 0
    for i, b in enumerate(bits):
        if b:
            v |= 1 << i
    return cls(v)


def fe_to_fe(src: Fp, dst_cls: Type[Fp]) -> Fp:
    """Transfer a value between fields via its LE bit repr truncated to the
    destination capacity (reference src/util.rs:76-86)."""
    # reference: input.to_repr() bits -> BigUint -> mod dst modulus
    return dst_cls(src.v % dst_cls.P)
