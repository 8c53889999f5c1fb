"""VTU/PVD field export round-trips (the reference's ParaView output role,
cut_shell.py:342-349, poisson.py:256-261)."""
import os

import numpy as np
import pytest

from iifea.mesh.generators import box_mesh, rectangle_mesh
from iifea.utils.fieldio import PVDSeries, read_vtu, write_vtu


@pytest.mark.parametrize("dim,degree,ctype", [
    (2, 1, 5), (2, 2, 22), (3, 1, 10), (3, 2, 24),
])
def test_vtu_roundtrip(tmp_path, dim, degree, ctype):
    from iifea.mesh.core import FunctionSpace

    mesh = (rectangle_mesh((0, 0), (1, 1), 3, 3) if dim == 2
            else box_mesh((0, 0, 0), (1, 1, 1), 2, 2, 2))
    V = FunctionSpace(mesh, degree=degree, n_fields=1)
    rng = np.random.default_rng(0)
    u = rng.standard_normal(V.n_nodes)
    vec = rng.standard_normal((V.n_nodes, dim))
    mat = rng.integers(1, 3, mesh.n_cells)
    p = tmp_path / f"f{dim}{degree}.vtu"
    write_vtu(p, V, point_data={"u": u, "v": vec},
              cell_data={"material": mat})
    out = read_vtu(p)
    assert out["cell_type"] == ctype
    assert out["cells"].shape == (mesh.n_cells, V.element.n_nodes)
    # nodal values and coordinates survive exactly (binary encoding)
    np.testing.assert_array_equal(out["point_data"]["u"], u)
    np.testing.assert_array_equal(
        out["points"][:, :dim], np.asarray(V.node_coords)
    )
    # 2D vectors are padded to 3 components for ParaView
    np.testing.assert_array_equal(out["point_data"]["v"][:, :dim], vec)
    np.testing.assert_array_equal(out["cell_data"]["material"], mat)
    # connectivity references the same coordinates (cell 0's nodes)
    np.testing.assert_array_equal(
        out["points"][out["cells"][0], :dim],
        np.asarray(V.node_coords)[np.asarray(V.cell_dofs)[0]],
    )


def test_vtu_interleaved_flat_vector(tmp_path):
    """Flat node-interleaved fg vectors (dof = node*nf + field) reshape to
    per-node components inside the writer."""
    from iifea.mesh.core import FunctionSpace

    mesh = rectangle_mesh((0, 0), (1, 1), 2, 2)
    V = FunctionSpace(mesh, degree=1, n_fields=2)
    u = np.arange(V.n_dofs, dtype=np.float64)  # node i -> (2i, 2i+1)
    p = tmp_path / "flat.vtu"
    write_vtu(p, V, point_data={"d": u})
    out = read_vtu(p)
    np.testing.assert_array_equal(
        out["point_data"]["d"][:, :2], u.reshape(-1, 2)
    )


def test_pvd_series(tmp_path):
    mesh = rectangle_mesh((0, 0), (1, 1), 2, 2)
    s = PVDSeries(str(tmp_path / "out" / "disp.pvd"))
    for k in range(3):
        s.write(0.5 * k, mesh, point_data={"u": np.full(mesh.n_verts, k)})
    pvd = open(s.path).read()
    assert pvd.count("<DataSet") == 3
    assert 'timestep="1.0"' in pvd
    f2 = os.path.join(os.path.dirname(s.path), "disp_000002.vtu")
    out = read_vtu(f2)
    np.testing.assert_array_equal(
        out["point_data"]["u"], np.full(mesh.n_verts, 2.0)
    )
