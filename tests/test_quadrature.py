"""Quadrature exactness: every rule integrates its full polynomial degree."""
from math import factorial

import numpy as np
import pytest

from iifea.ops.quadrature import (
    facet_rule,
    interval_rule,
    tet_rule,
    triangle_rule,
)


def tri_exact(a, b):
    return factorial(a) * factorial(b) / factorial(a + b + 2)

def tet_exact(a, b, c):
    return factorial(a) * factorial(b) * factorial(c) / factorial(a + b + c + 3)


@pytest.mark.parametrize("deg", range(1, 9))
def test_triangle_exactness(deg):
    pts, wts = triangle_rule(deg)
    for a in range(deg + 1):
        for b in range(deg + 1 - a):
            approx = (wts * pts[:, 0] ** a * pts[:, 1] ** b).sum()
            assert abs(approx - tri_exact(a, b)) < 1e-12


@pytest.mark.parametrize("deg", range(1, 7))
def test_tet_exactness(deg):
    pts, wts = tet_rule(deg)
    for a in range(deg + 1):
        for b in range(deg + 1 - a):
            for c in range(deg + 1 - a - b):
                approx = (
                    wts * pts[:, 0] ** a * pts[:, 1] ** b * pts[:, 2] ** c
                ).sum()
                assert abs(approx - tet_exact(a, b, c)) < 1e-12


@pytest.mark.parametrize("deg", range(1, 8))
def test_interval_exactness(deg):
    pts, wts = interval_rule(deg)
    for a in range(deg + 1):
        assert abs((wts * pts[:, 0] ** a).sum() - 1 / (a + 1)) < 1e-13


def test_facet_rule_normalization():
    # 3D facet rule weights sum to 1 (physical area applied separately)
    _, w2 = facet_rule(2, 3)
    _, w3 = facet_rule(3, 3)
    assert abs(w2.sum() - 1) < 1e-13
    assert abs(w3.sum() - 1) < 1e-13
