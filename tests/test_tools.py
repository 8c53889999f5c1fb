"""Round-trip tests for the offline mesh converter (tools/mesh_convert.py)."""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_exodus_netcdf3(path, points, blocks):
    """Minimal Exodus-II (netCDF3) writer for test fixtures."""
    from scipy.io import netcdf_file

    with netcdf_file(path, "w") as f:
        n = len(points)
        f.createDimension("num_nodes", n)
        for i, name in enumerate(["coordx", "coordy", "coordz"]):
            v = f.createVariable(name, "d", ("num_nodes",))
            v[:] = points[:, i]
        for b, (etype, conn) in enumerate(blocks, start=1):
            f.createDimension(f"num_el_in_blk{b}", conn.shape[0])
            f.createDimension(f"num_nod_per_el{b}", conn.shape[1])
            v = f.createVariable(
                f"connect{b}", "i",
                (f"num_el_in_blk{b}", f"num_nod_per_el{b}"),
            )
            v[:] = (conn + 1).astype(np.int32)  # exodus is 1-based
            v.elem_type = etype


def test_convert_linear_triangles(tmp_path):
    from iifea.mesh.io import read_mesh

    # two blocks over a 2x1 strip of 4 triangles, with an unused orphan node
    pts = np.array(
        [[0, 0, 0], [1, 0, 0], [2, 0, 0], [0, 1, 0], [1, 1, 0], [2, 1, 0],
         [9, 9, 9]],
        dtype=float,
    )
    blk1 = np.array([[0, 1, 4], [0, 4, 3]])
    blk2 = np.array([[1, 2, 5], [1, 5, 4]])
    exo = tmp_path / "test.exo"
    write_exodus_netcdf3(str(exo), pts, [("TRI3", blk1), ("TRI3", blk2)])

    out = tmp_path / "mesh.xdmf"
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "mesh_convert.py"),
         "--fi", str(exo), "--fo", str(out)],
        capture_output=True, text=True, cwd=tmp_path,
    )
    assert res.returncode == 0, res.stderr
    mesh = read_mesh(str(out))
    assert mesh.n_verts == 6          # orphan node dropped
    assert mesh.n_cells == 4
    assert mesh.dim == 2              # z pruned
    assert list(np.bincount(mesh.material)) == [0, 2, 2]
    assert np.isclose(mesh.cell_volumes.sum(), 2.0)


def test_convert_quadratic_with_exops(tmp_path):
    import h5py
    from iifea.mesh.io import read_mesh

    # one TRI6 cell: corners 0,1,2 + midsides 3,4,5
    pts = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0],
         [0.5, 0, 0], [0.5, 0.5, 0], [0, 0.5, 0]],
        dtype=float,
    )
    conn = np.array([[0, 1, 2, 3, 4, 5]])
    exo = tmp_path / "q.exo"
    write_exodus_netcdf3(str(exo), pts, [("TRI6", conn), ("TRI6", conn)])

    # MORIS-style extraction operator files (1-based fg ids, bg ids, weights)
    for tag, rows in (("0", [[1, 1], [2, 1]]), ("1", [[3, 2], [4, 2]])):
        with h5py.File(tmp_path / f"Global_Extraction_Operators.{tag}.hdf5",
                       "w") as f:
            idx = np.array(rows, dtype=np.int64)
            f.create_dataset("a_indices", data=idx)
            f.create_dataset("b_weights",
                             data=np.full((len(rows), 1), 0.5))

    out = tmp_path / "mesh.xdmf"
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "mesh_convert.py"),
         "--fi", str(exo), "--fo", str(out), "--CExOps", "True"],
        capture_output=True, text=True, cwd=tmp_path,
    )
    assert res.returncode == 0, res.stderr
    assert (tmp_path / "cell_nodes.csv").exists()
    mesh = read_mesh(str(out))
    assert mesh.n_cells == 2 and mesh.cells.shape[1] == 3
    assert mesh.cell_nodes is not None and mesh.cell_nodes.shape[1] == 6
    exop = np.loadtxt(tmp_path / "ExOp_Cons.csv")
    assert exop.shape == (2, 3)
    assert np.allclose(exop[:, 2], 0.5)
    both = np.loadtxt(tmp_path / "ExOp_Cons_Both.csv")
    assert both.shape == (4, 3)
