"""Univariate polynomial + Lagrange/cyclic-subgroup helpers (host ints);
port of mira_tpu/polynomial/univariate.py, on the port's ops/ntt.py.

Mirrors the reference's src/polynomial/{univariate,lagrange}.rs.
"""

from __future__ import annotations

from typing import Iterator, List

from ..ops.ntt import get_omega


class UnivariatePoly:
    """Coefficients, ascending degree."""

    def __init__(self, coeffs: List[int], modulus: int):
        self.coeffs = list(coeffs)
        self.modulus = modulus

    def eval(self, x: int) -> int:
        p = self.modulus
        acc, xp = 0, 1
        for c in self.coeffs:
            acc = (acc + c * xp) % p
            xp = xp * x % p
        return acc

    def __iter__(self):
        return iter(self.coeffs)

    def __len__(self):
        return len(self.coeffs)


def iter_cyclic_subgroup(modulus: int, log_n: int) -> Iterator[int]:
    """1, w, w^2, ... for the order-2^log_n subgroup (lagrange.rs:23-27)."""
    g = get_omega(modulus, log_n)
    v = 1
    for _ in range(1 << log_n):
        yield v
        v = v * g % modulus


def eval_vanish_polynomial(modulus: int, log_n: int, x: int) -> int:
    """x^n - 1 (lagrange.rs:80-86)."""
    return (pow(x, 1 << log_n, modulus) - 1) % modulus


def eval_lagrange_polys_for_cyclic_group(modulus: int, x: int, log_n: int) -> List[int]:
    """[L_0(x), ..., L_{n-1}(x)] over the cyclic subgroup
    (lagrange.rs:52-76, incl. the on-domain special case)."""
    p = modulus
    n = 1 << log_n
    inv_n = pow(n, -1, p)
    zh = eval_vanish_polynomial(p, log_n, x)
    out = []
    for w in iter_cyclic_subgroup(p, log_n):
        diff = (x - w) % p
        if zh == 0 and diff == 0:
            out.append(1)
        else:
            out.append(w * inv_n % p * zh % p * pow(diff, -1, p) % p)
    return out
