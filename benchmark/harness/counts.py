"""The yardstick of the kernel metrics: the card's published peaks and the
least work of each problem, so that a roofline share belongs to the
problem and not to the route the program takes.

A bound is the larger of two times: every input byte read once and every
output byte written once, over the memory rate; and the least number of
Montgomery products of the best method known for the problem, each at the
least int32 multiply-adds of the known methods, over the card's
multiply-add rate.  A share above 100 % means the time left out work or the
count is stale, and `share_pct` raises.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM5 data sheet: 3.35 TB/s of HBM3; int32 multiply-adds at a
# quarter of the 67 TFLOP/s float32 figure (64 INT32 lanes per SM against
# 128 FP32 lanes at 2 flops per FMA).  Both at the card's full 700 W.
PEAKS = {"mem_bytes_per_s": 3.35e12, "int32_madd_per_s": 16.75e12}

LIMBS = 8  # 32-bit limbs of a 254-bit element
# One Montgomery product: a*b by two levels of Karatsuba (9 products of 2x2
# limbs: 36 32x32->64-bit products, a lo and a hi multiply-add each) and the
# Montgomery reduction (8 low products for the quotient digits, 64 products
# of q*p at two multiply-adds each).
MADD_PER_PRODUCT = 2 * 36 + LIMBS + 2 * LIMBS * LIMBS  # 208
AFFINE_ADD_PRODUCTS = 6  # batch-affine addition: 3 products + 3 for the shared inversion
DOUBLE_PRODUCTS = 7  # Jacobian doubling on a = 0: 2M + 5S
ELEMENT_BYTES = 32
POINT_BYTES = 64  # affine x, y


class StaleCount(RuntimeError):
    """A share above 100 %: the count of work is stale or the time misses work."""


def bound_s(nbytes: float, products: float, peaks: dict = PEAKS) -> float:
    """The least time of `nbytes` moved and `products` Montgomery products."""
    return max(nbytes / peaks["mem_bytes_per_s"],
               products * MADD_PER_PRODUCT / peaks["int32_madd_per_s"])


def glv_pippenger_products(n: int, scalar_bits: int = 254) -> int:
    """Montgomery products of an MSM of n points of `scalar_bits`-bit scalars
    by the best known method: GLV splits each scalar into two halves on the
    curve's endomorphism (one product per base for beta*x), then a
    signed-digit Pippenger over the 2n half-scalars at its best window c:
    per window 2n bucket additions and 2^c additions of the running sums,
    and c doublings a window to combine them."""
    if n <= 0:
        return 0
    half = (scalar_bits + 1) // 2 + 1  # signed digits need one bit more
    best = None
    for c in range(1, 24):
        nwin = math.ceil(half / c)
        cost = (nwin * (2 * n + (1 << c)) * AFFINE_ADD_PRODUCTS
                + nwin * c * DOUBLE_PRODUCTS)
        best = cost if best is None else min(best, cost)
    return best + n


def msm_bound_s(n: int, scalar_bits: int = 254) -> float:
    """An MSM of n points: the bases and scalars read once, one point out."""
    nbytes = n * (POINT_BYTES + ELEMENT_BYTES) + POINT_BYTES
    return bound_s(nbytes, glv_pippenger_products(n, scalar_bits))


def expression_products(expr) -> int:
    """Distinct products of an expression tree (Product and Scaled nodes,
    structurally equal subtrees counted once): what any evaluator of it per
    row must multiply."""
    seen = {}

    def key(e):
        k = seen.get(id(e))
        if k is not None:
            return k[0]
        kind = type(e).__name__
        if kind == "Const":
            k = ("c", e.value)
        elif kind == "Poly":
            k = ("q", e.query.index, e.query.rotation)
        elif kind == "Challenge":
            k = ("ch", e.index)
        elif kind == "Neg":
            k = ("n", key(e.a))
        elif kind in ("Sum", "Product"):
            k = (kind, key(e.a), key(e.b))
        elif kind == "Scaled":
            k = ("s", key(e.a), e.k)
        else:
            raise TypeError(f"unknown expression node {kind}")
        seen[id(e)] = (k, e)
        return k

    root = key(expr)
    distinct = set()

    def walk(k):
        if k in distinct:
            return
        distinct.add(k)
        for child in k[1:]:
            if isinstance(child, tuple):
                walk(child)

    walk(root)
    return sum(1 for k in distinct if k[0] in ("Product", "s"))


def expression_columns(expr) -> set:
    """The (index) of every column the expression reads."""
    out = set()

    def walk(e):
        kind = type(e).__name__
        if kind == "Poly":
            out.add(e.query.index)
        for name in ("a", "b"):
            child = getattr(e, name, None)
            if child is not None:
                walk(child)

    walk(expr)
    return out


def cross_terms_bound_s(expr, nrow: int, degree: int, num_static: int) -> float:
    """The cross terms T_1 .. T_{d-1} of a degree-d homogeneous gate
    polynomial over nrow rows, T_0 (= E) and T_d (= 0 on satisfied traces)
    being known: d - 1 evaluations of P(W1 + j W2) per row, each the
    expression's distinct products (the folded reads are additions: W1 + (j+1)
    W2 is W1 + j W2 + W2).  Bytes: each static column read once, each advice
    column of both witnesses once, d - 1 output columns."""
    points = max(degree - 1, 0)
    cols = expression_columns(expr)
    n_static = sum(1 for c in cols if c < num_static)
    n_advice = len(cols) - n_static
    nbytes = (n_static + 2 * n_advice + points) * nrow * ELEMENT_BYTES
    return bound_s(nbytes, expression_products(expr) * nrow * points)


def share_pct(bound: float, device_s: float, what: str) -> float:
    """bound / device time in %, refusing a share above 100 %."""
    if device_s <= 0:
        raise ValueError(f"{what}: no device time")
    share = 100.0 * bound / device_s
    if share > 100.0:
        raise StaleCount(f"{what}: {share:.3f} % of the roofline: the count of work is "
                         f"stale or the device time leaves out work")
    return share
