"""The count functions of the kernel metrics against hand counts at small
sizes, and a share above 100 % failing loudly."""

import pytest

from harness import counts
from mira_tpu_torch.polynomial.expression import Const, Poly, Query, Scaled


def q(i, rot=0):
    return Poly(Query(i, rot))


def test_a_product_costs_208_multiply_adds():
    # Karatsuba 9 x 4 word products (lo and hi), 8 quotient digits, 64 q*p products
    assert counts.MADD_PER_PRODUCT == 9 * 4 * 2 + 8 + 64 * 2 == 208


def test_msm_of_one_point_by_hand():
    # 128-bit signed halves; c = 2: 64 windows x (2 bucket adds + 4 running-sum
    # adds) x 6 products, 64 x 2 doublings x 7, one GLV product
    assert counts.glv_pippenger_products(1) == 64 * 6 * 6 + 64 * 2 * 7 + 1 == 3201
    assert counts.glv_pippenger_products(0) == 0


def test_msm_count_at_scale_is_the_best_window():
    n = 1 << 18
    got = counts.glv_pippenger_products(n)
    for c in (8, 12, 14, 15, 16, 17, 20):
        nwin = -(-128 // c)
        assert got <= nwin * (2 * n + (1 << c)) * 6 + nwin * c * 7 + n
    # far below the signed c-bit count of the same MSM without GLV
    assert got < 0.75 * 2 * (-(-255 // 16)) * n * 6


def test_msm_bound_is_the_larger_of_bytes_and_operations():
    n = 1000
    by_ops = counts.glv_pippenger_products(n) * 208 / 16.75e12
    by_bytes = (n * 96 + 64) / 3.35e12
    assert counts.msm_bound_s(n) == max(by_ops, by_bytes) == by_ops
    assert counts.bound_s(3.35e12, 0) == 1.0


def test_expression_products_count_distinct_products():
    a, b, c = q(3), q(4), q(5, 1)
    assert counts.expression_products(a * b + a * b) == 1  # structurally equal
    assert counts.expression_products((a * b) * c - Scaled(a, 3)) == 3
    assert counts.expression_products(a + b - c + Const(7)) == 0
    shared = a * b
    assert counts.expression_products(shared * shared + shared) == 2


def test_cross_terms_bound_by_hand():
    # two selectors/fixed columns (0, 1), advice 3 and 4; degree 3: 2 points
    expr = q(0) * q(3) * q(4) + q(1) * q(3)
    nrow = 1 << 4
    products = 3 * nrow * 2
    nbytes = (2 + 2 * 2 + 2) * nrow * 32
    want = max(nbytes / 3.35e12, products * 208 / 16.75e12)
    assert counts.cross_terms_bound_s(expr, nrow, 3, num_static=2) == pytest.approx(want)
    assert counts.expression_columns(expr) == {0, 1, 3, 4}


def test_share_above_100_percent_fails_loudly():
    assert counts.share_pct(1.0, 4.0, "x") == 25.0
    assert counts.share_pct(2.0, 2.0, "x") == 100.0
    with pytest.raises(counts.StaleCount, match="stale"):
        counts.share_pct(2.1, 2.0, "kernel")
    with pytest.raises(ValueError):
        counts.share_pct(1.0, 0.0, "kernel")
