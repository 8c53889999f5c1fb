"""Native C++ mesh kernels vs the numpy fallbacks (identical semantics)."""
import os

import numpy as np
import pytest

from iifea.mesh import _native
from iifea.mesh.core import Mesh, FunctionSpace
from iifea.mesh.generators import box_mesh, rectangle_mesh

pytestmark = pytest.mark.skipif(
    not _native.available(), reason="native library not built"
)


def canon(facets, fcells, flocal):
    """Canonicalize a facet table for order-independent comparison."""
    order = np.lexsort(facets.T[::-1])
    return facets[order], fcells[order], flocal[order]


@pytest.mark.parametrize("dim", [2, 3])
def test_facets_match_numpy(dim, monkeypatch):
    mesh = (
        rectangle_mesh((0, 0), (1, 1), 5, 4)
        if dim == 2
        else box_mesh((0, 0, 0), (1, 1, 1), 3, 2, 2)
    )
    nat = _native.build_facets(mesh.cells, dim)
    assert nat is not None
    nf, nc, nl = canon(np.sort(nat[0], axis=1), nat[1], nat[2])

    monkeypatch.setenv("IIFEA_NO_NATIVE", "1")
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_tried", False)
    fd = Mesh(mesh.coords, mesh.cells).facet_data
    pf, pc, pl = canon(fd.facets, fd.facet_cells, fd.facet_local)

    assert np.array_equal(nf, pf)
    # adjacency as sets per facet (slot order may differ)
    for a, b in ((nc, pc), (nl, pl)):
        pass
    for i in range(len(nf)):
        assert set(nc[i]) == set(pc[i])


def test_edge_numbering_counts():
    mesh = rectangle_mesh((0, 0), (2, 1), 6, 3)
    V = FunctionSpace(mesh, degree=2)
    # Euler: E = V + C - 1 for a simply-connected planar triangulation
    n_edges = V.n_nodes - mesh.n_verts
    assert n_edges == mesh.n_verts + mesh.n_cells - 1
    # every cell's 6 dofs are distinct and midside ids >= n_verts
    cd = np.asarray(V.cell_dofs)
    assert (cd[:, 3:] >= mesh.n_verts).all()
    assert all(len(set(row)) == 6 for row in cd[:20])


def test_exop_parser_matches_loadtxt(tmp_path):
    rng = np.random.default_rng(0)
    rows = np.column_stack([
        rng.integers(1, 50, 20),
        rng.integers(1, 20, 20),
        rng.standard_normal(20),
    ])
    p = tmp_path / "ExOp_Cons.csv"
    np.savetxt(p, rows, fmt="%d %d %1.16f")
    nat = _native.read_exop(str(p))
    ref = np.atleast_2d(np.loadtxt(p))
    assert np.allclose(nat, ref)
