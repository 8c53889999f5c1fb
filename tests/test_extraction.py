"""Extraction operator: layout, parity semantics, adjointness."""
import os

import numpy as np
import jax.numpy as jnp
import pytest

from iifea.ops.extraction import ExtractionOperator

REF = "/root/reference/meshes/square/Linear/R0"


def test_mv_rmv_adjoint():
    rng = np.random.default_rng(0)
    fg = rng.integers(0, 10, 30)
    bg = rng.integers(0, 6, 30)
    w = rng.standard_normal(30)
    # deduplicate keys like the loader does
    M = ExtractionOperator.from_triples(fg, bg, w, 10, 6)
    x = jnp.asarray(rng.standard_normal(6))
    y = jnp.asarray(rng.standard_normal(10))
    assert np.isclose(float(y @ M.mv(x)), float(x @ M.rmv(y)))


def test_multifield_block_layout():
    # scalar pattern fg0<-bg0*2, replicated over 2 fields with bg block offset
    M = ExtractionOperator.from_triples(
        np.array([0]), np.array([0]), np.array([2.0]),
        n_fg_nodes=2, n_bg_nodes=3, n_fields=2,
    )
    # bg layout: field f block offset f*m (common.py:703)
    u_b = jnp.arange(6.0)  # bg dofs [f0: 0,1,2 | f1: 3,4,5]
    u_f = M.mv(u_b)
    # fg layout interleaved: node0 field0, node0 field1, ...
    assert u_f.shape == (4,)
    assert float(u_f[0]) == 2.0 * 0.0   # node0 f0 <- bg node0 f0 (=0)
    assert float(u_f[1]) == 2.0 * 3.0   # node0 f1 <- bg node0 f1 (=3)
    assert float(u_f[2]) == 0.0


def test_insert_semantics_last_value_wins():
    M = ExtractionOperator.from_triples(
        np.array([1, 1]), np.array([2, 2]), np.array([5.0, 7.0]),
        n_fg_nodes=3, n_bg_nodes=4,
    )
    u = jnp.zeros(4).at[2].set(1.0)
    assert float(M.mv(u)[1]) == 7.0


def test_identity_extraction():
    M = ExtractionOperator.identity(5)
    x = jnp.arange(5.0)
    assert np.allclose(np.asarray(M.mv(x)), np.asarray(x))
    assert np.allclose(np.asarray(M.rmv(x)), np.asarray(x))


@pytest.mark.skipif(not os.path.exists(REF), reason="reference data not mounted")
def test_reference_csv_roundtrip():
    M = ExtractionOperator.from_exop_csv(REF + "/ExOp_Cons.csv", 37)
    tri = np.loadtxt(REF + "/ExOp_Cons.csv")
    Msp = M.to_scipy()
    for fg, bg, w in tri:
        assert np.isclose(Msp[int(fg) - 1, int(bg) - 1], w)
    # interpolation rows reproduce constants where fully supported
    ones = np.asarray(M.mv(jnp.ones(M.n_bg_dofs)))
    rows = np.asarray(Msp.sum(axis=1)).ravel()
    covered = np.abs(rows - 1) < 1e-12
    assert np.allclose(ones[covered], 1.0)


def test_locate_structured_box_matches_general():
    """Analytic Kuhn-tet location == the general bucket search, and the
    interpolation weights it feeds reproduce linear functions exactly."""
    import numpy as np
    from iifea.mesh.generators import (
        box_mesh,
        locate_cells,
        locate_structured_box,
        transfer_matrix_simplex,
    )

    mesh = box_mesh((-1.0, -0.5, 0.25), (1.0, 1.5, 2.25), 4, 3, 5)
    rng = np.random.default_rng(11)
    pts = rng.uniform([-1, -0.5, 0.25], [1, 1.5, 2.25], size=(200, 3))
    # include points outside and on vertices
    pts = np.vstack([pts, [[2.0, 0, 0]], mesh.coords[:5]])
    cells_fast, ref = locate_structured_box(mesh, pts)
    cells_gen = locate_cells(mesh, pts)
    assert (cells_fast < 0).sum() == 1 and (cells_gen < 0).sum() == 1
    inside = cells_fast >= 0
    # ties on shared faces may pick different (equally valid) tets; verify
    # geometrically instead: reconstruct the point from the tet + ref coords
    cc = mesh.cell_coords[cells_fast[inside]]
    rec = cc[:, 0] + np.einsum(
        "pd,pde->pe", ref[inside], cc[:, 1:] - cc[:, :1]
    )
    assert np.allclose(rec, pts[inside], atol=1e-12)
    assert np.all(ref[inside] >= -1e-12)
    assert np.all(ref[inside].sum(1) <= 1 + 1e-12)

    M = transfer_matrix_simplex(mesh, pts[:200])
    # P1 interpolation of a linear function is exact
    f = lambda x: 0.3 * x[:, 0] - 1.2 * x[:, 1] + 0.7 * x[:, 2] + 2.0
    import jax.numpy as jnp
    vals = np.asarray(M.mv(jnp.asarray(f(mesh.coords))))
    assert np.allclose(vals, f(pts[:200]), atol=1e-12)
