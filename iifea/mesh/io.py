"""Readers for the reference mesh pipeline artifacts.

Consumes the exact artifacts produced by the reference's offline converter
(mesh_convert.py): ``mesh.xdmf`` + ``mesh.h5`` (datasets data0=coords,
data1=connectivity, data2=cell material), ``cell_nodes.csv`` (Exodus TRI6/TET10
connectivity for quadratic spaces, mesh_convert.py:97-119) and
``ExOp_Cons.csv`` extraction triples ("%d %d %1.16f", 1-based ids,
mesh_convert.py:157). See SURVEY.md §2.3 N8: the MORIS/XTK generator itself is
out of scope; its outputs are the interchange format.
"""
from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET

import numpy as np

from iifea.mesh.core import Mesh


def _h5_datasets_from_xdmf(xdmf_path: str) -> dict[str, tuple[str, str]]:
    """Map logical names -> (h5 file, dataset path) from the XDMF index."""
    tree = ET.parse(xdmf_path)
    root = tree.getroot()
    out: dict[str, tuple[str, str]] = {}

    def data_item(el):
        txt = (el.text or "").strip()
        m = re.match(r"(.+?):(/.+)", txt)
        return (m.group(1), m.group(2)) if m else (txt, "")

    for geom in root.iter("Geometry"):
        out["coords"] = data_item(geom.find("DataItem"))
    for topo in root.iter("Topology"):
        out["cells"] = data_item(topo.find("DataItem"))
    for attr in root.iter("Attribute"):
        name = attr.get("Name", "attr")
        out[name] = data_item(attr.find("DataItem"))
    return out


def read_mesh(path: str) -> Mesh:
    """Read a mesh directory or .xdmf file (with sibling mesh.h5).

    Loads the 'material' cell attribute when present and ``cell_nodes.csv``
    (quadratic connectivity) when present in the same directory.
    """
    import h5py

    if os.path.isdir(path):
        xdmf = os.path.join(path, "mesh.xdmf")
    else:
        xdmf = path
    base = os.path.dirname(xdmf)
    dsets = _h5_datasets_from_xdmf(xdmf)

    def load(key):
        fname, dpath = dsets[key]
        with h5py.File(os.path.join(base, fname), "r") as f:
            return np.array(f[dpath])

    coords = load("coords")
    cells = load("cells")
    material = load("material").astype(np.int32) if "material" in dsets else None

    cell_nodes = None
    cn_path = os.path.join(base, "cell_nodes.csv")
    if os.path.exists(cn_path):
        cell_nodes = read_cell_nodes(cn_path)

    return Mesh(coords, cells, material, cell_nodes)


def read_cell_nodes(path: str) -> np.ndarray:
    """Exodus high-order connectivity, one row per cell (mesh_convert.py:109)."""
    return np.loadtxt(path, delimiter=",", dtype=np.int64).astype(np.int32)


def read_exop_triples(paths: str | list[str]) -> np.ndarray:
    """Read extraction triples (fg_exo_id, bg_id, weight), concatenating blocks.

    Mirrors readExOp's file loop (common.py:649-665): whitespace-delimited,
    ids 1-based. Returns a (nnz, 3) float64 array with raw 1-based ids.
    """
    from iifea.mesh import _native

    if isinstance(paths, str):
        paths = [paths]
    blocks = []
    for p in paths:
        data = None
        if _native.available():
            data = _native.read_exop(p)
        if data is None:
            data = np.atleast_2d(np.loadtxt(p, dtype=np.float64))
        blocks.append(data)
    return np.concatenate(blocks, axis=0)
