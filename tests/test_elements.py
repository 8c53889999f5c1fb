"""Reference element tables: nodal property, partition of unity, derivatives."""
import numpy as np
import pytest

from iifea.ops.reference_elements import ReferenceElement


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("deg", [1, 2])
def test_partition_of_unity_and_nodal(dim, deg):
    el = ReferenceElement(dim, deg)
    rng = np.random.default_rng(0)
    pts = rng.random((7, dim)) * 0.3
    V = el.tabulate(pts)
    assert np.allclose(V.sum(1), 1.0)
    G = el.tabulate_grad(pts)
    assert np.allclose(G.sum(1), 0.0)
    H = el.tabulate_hess(pts)
    assert np.allclose(H.sum(1), 0.0)
    N = el.tabulate(el.node_coords)
    assert np.allclose(N, np.eye(el.n_nodes), atol=1e-13)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("deg", [1, 2])
def test_gradients_match_finite_differences(dim, deg):
    el = ReferenceElement(dim, deg)
    rng = np.random.default_rng(1)
    pts = rng.random((5, dim)) * 0.25
    G = el.tabulate_grad(pts)
    eps = 1e-6
    for d in range(dim):
        dp = pts.copy()
        dp[:, d] += eps
        dm = pts.copy()
        dm[:, d] -= eps
        fd = (el.tabulate(dp) - el.tabulate(dm)) / (2 * eps)
        assert np.allclose(G[:, :, d], fd, atol=1e-8)


@pytest.mark.parametrize("dim", [2, 3])
def test_hessian_matches_fd(dim):
    el = ReferenceElement(dim, 2)
    rng = np.random.default_rng(2)
    pts = rng.random((4, dim)) * 0.25
    H = el.tabulate_hess(pts)
    eps = 1e-5
    for d in range(dim):
        dp = pts.copy(); dp[:, d] += eps
        dm = pts.copy(); dm[:, d] -= eps
        fd = (el.tabulate_grad(dp) - el.tabulate_grad(dm)) / (2 * eps)
        assert np.allclose(H[:, :, :, d], fd, atol=1e-7)


def test_facet_points_lie_on_facet():
    for dim in (2, 3):
        el = ReferenceElement(dim, 1)
        n_facets = dim + 1
        fpts = np.full((3, dim - 1), 0.25)
        for lf in range(n_facets):
            cp = el.facet_to_cell_points(lf, fpts)
            lam = np.hstack([1 - cp.sum(1, keepdims=True), cp])
            # the barycentric coordinate opposite the facet vanishes
            assert np.allclose(lam[:, lf], 0.0, atol=1e-13)
