"""Mesh and function-space core.

Replaces DOLFIN's Mesh/FunctionSpace/dofmap runtime (SURVEY.md §2.3 N1) with
frozen numpy arrays prepared on host once, then consumed by jitted device
kernels. Topology extraction is fully vectorized (the reference loops over
facets in Python per demo, e.g. poisson.py:141-150 — a noted hot spot).

DOF numbering policy: *node ids are dof ids*. For degree-2 spaces read from the
reference mesh pipeline, the Exodus node ids in ``cell_nodes.csv`` are adopted
directly as global node ids, which eliminates the reference's
Exodus-to-FEniCS DOF conversion machinery entirely (common.py:714-877).
Vector fields interleave: global dof = node * n_fields + field. The extraction
operator's background block offsets (bg_id = node + field*m, common.py:703)
are handled in ops/extraction.py.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

from iifea.ops.reference_elements import (
    TET_FACETS,
    TRI_FACETS,
    ReferenceElement,
)


@dataclasses.dataclass(frozen=True)
class FacetData:
    """Unique codim-1 facets of a simplex mesh.

    facet_cells[f] = (c0, c1) adjacent cells, c1 = -1 on the boundary.
    facet_local[f] = local facet index of f within c0 / c1 (-1 if none).
    """

    facets: np.ndarray       # (n_facets, dim) vertex ids (sorted within row)
    facet_cells: np.ndarray  # (n_facets, 2) int32
    facet_local: np.ndarray  # (n_facets, 2) int32


class Mesh:
    """An immutable simplex mesh (triangles in 2D, tets in 3D)."""

    def __init__(
        self,
        coords: np.ndarray,
        cells: np.ndarray,
        material: np.ndarray | None = None,
        cell_nodes: np.ndarray | None = None,
    ):
        self.coords = np.asarray(coords, dtype=np.float64)
        self.cells = np.ascontiguousarray(cells, dtype=np.int32)
        self.dim = self.coords.shape[1]
        if self.cells.shape[1] != self.dim + 1:
            raise ValueError("cells must be simplices matching coord dim")
        self.n_cells = self.cells.shape[0]
        self.n_verts = self.coords.shape[0]
        if material is None:
            material = np.zeros(self.n_cells, dtype=np.int32)
        self.material = np.asarray(material).astype(np.int32)
        # Optional high-order (P2) connectivity with externally defined node
        # ids (Exodus TRI6/TET10 rows from cell_nodes.csv).
        self.cell_nodes = (
            None
            if cell_nodes is None
            else np.ascontiguousarray(cell_nodes, dtype=np.int32)
        )

    # -- geometry -----------------------------------------------------------

    @cached_property
    def cell_coords(self) -> np.ndarray:
        """(n_cells, dim+1, dim) vertex coordinates per cell."""
        return self.coords[self.cells]

    @cached_property
    def cell_volumes(self) -> np.ndarray:
        x = self.cell_coords
        e = x[:, 1:, :] - x[:, :1, :]  # (n_cells, dim, dim)
        det = np.linalg.det(e)
        fac = 2.0 if self.dim == 2 else 6.0
        return np.abs(det) / fac

    @cached_property
    def cell_diameters(self) -> np.ndarray:
        """UFL CellDiameter: max vertex-pair distance per cell."""
        x = self.cell_coords
        d = x[:, :, None, :] - x[:, None, :, :]
        return np.sqrt((d * d).sum(-1)).max(axis=(1, 2))

    def hmax(self) -> float:
        return float(self.cell_diameters.max())

    def hmin(self) -> float:
        return float(self.cell_diameters.min())

    # -- topology -----------------------------------------------------------

    @cached_property
    def facet_data(self) -> FacetData:
        """Unique-facet extraction: native C++ kernel (csrc/meshops.cpp) when
        built, pure-numpy fallback of identical semantics otherwise."""
        from iifea.mesh import _native

        nat = _native.build_facets(self.cells, self.dim)
        if nat is not None:
            facets, fcells, flocal = nat
            facets = np.sort(facets, axis=1)
            return FacetData(facets, fcells, flocal)
        local_facets = TRI_FACETS if self.dim == 2 else TET_FACETS
        nlf = local_facets.shape[0]
        # all (cell, local facet) incidences
        all_f = self.cells[:, local_facets]          # (nc, nlf, dim)
        all_f = all_f.reshape(-1, self.dim)          # (nc*nlf, dim)
        key = np.sort(all_f, axis=1)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        n_facets = uniq.shape[0]
        facet_cells = np.full((n_facets, 2), -1, dtype=np.int32)
        facet_local = np.full((n_facets, 2), -1, dtype=np.int32)
        cell_ids = np.repeat(
            np.arange(self.n_cells, dtype=np.int32), nlf
        )
        local_ids = np.tile(np.arange(nlf, dtype=np.int32), self.n_cells)
        # stable order: first adjacency encountered goes to slot 0
        order = np.argsort(inv, kind="stable")
        inv_s, cells_s, locals_s = inv[order], cell_ids[order], local_ids[order]
        first = np.ones(len(inv_s), dtype=bool)
        first[1:] = inv_s[1:] != inv_s[:-1]
        slot = np.where(first, 0, 1)
        facet_cells[inv_s, slot] = cells_s
        facet_local[inv_s, slot] = locals_s
        return FacetData(uniq.astype(np.int32), facet_cells, facet_local)

    @cached_property
    def num_facets(self) -> int:
        return self.facet_data.facets.shape[0]

    def classify_facets_by_material(self) -> np.ndarray:
        """The reference's standard facet classifier (poisson.py:141-150).

        marker = sum of adjacent cell materials (boundary facets count once):
          1 or 2 -> class 1 (boundary of hole / of block)
          4      -> class 2 (interior of block)
          3      -> class 3 (immersed interface: the Nitsche surface)
        """
        fd = self.facet_data
        m0 = self.material[fd.facet_cells[:, 0]]
        m1 = np.where(
            fd.facet_cells[:, 1] >= 0, self.material[fd.facet_cells[:, 1]], 0
        )
        marker = m0 + m1
        out = np.zeros(self.num_facets, dtype=np.int32)
        out[(marker == 1) | (marker == 2)] = 1
        out[marker == 4] = 2
        out[marker == 3] = 3
        return out

    def filter_small_cells(
        self, tol: float, block_id: int = 2, facet_class: np.ndarray | None = None,
        surf_id: int = 3,
    ) -> tuple[np.ndarray, np.ndarray | None, int, int]:
        """Small-cut-cell volume filter (biharmonic.py:134-155).

        Cells of the block subdomain with volume < tol * hmax^dim are removed
        from the subdomain (material -> 0); their interface facets are removed
        from the surface class (class -> 0). Returns the new material array,
        new facet classification, and elimination counts.
        """
        vol_limit = self.hmax() ** self.dim * tol
        material = self.material.copy()
        small = (self.cell_volumes < vol_limit) & (material == block_id)
        material[small] = 0
        n_cell_elim = int(small.sum())
        n_facet_elim = 0
        if facet_class is not None:
            facet_class = facet_class.copy()
            fd = self.facet_data
            adj_small = small[fd.facet_cells[:, 0]] | (
                (fd.facet_cells[:, 1] >= 0) & small[fd.facet_cells[:, 1]]
            )
            kill = adj_small & (facet_class == surf_id)
            n_facet_elim = int(kill.sum())
            facet_class[kill] = 0
        return material, facet_class, n_cell_elim, n_facet_elim


class FunctionSpace:
    """Scalar-node-based Lagrange space of degree 1 or 2, n_fields components.

    cell_dofs holds *node* ids, (n_cells, n_local_nodes); the flattened
    per-field dof ids are derived as node * n_fields + field.
    """

    def __init__(self, mesh: Mesh, degree: int = 1, n_fields: int = 1):
        self.mesh = mesh
        self.degree = int(degree)
        self.n_fields = int(n_fields)
        self.element = ReferenceElement(mesh.dim, self.degree)
        if self.degree == 1:
            self.cell_dofs = mesh.cells
            self.n_nodes = mesh.n_verts
            self.node_coords = mesh.coords
        else:
            if mesh.cell_nodes is not None:
                # Exodus node ids from cell_nodes.csv become global node ids.
                cn = mesh.cell_nodes
                if cn.shape[1] != self.element.n_nodes:
                    raise ValueError(
                        f"cell_nodes has {cn.shape[1]} columns, expected "
                        f"{self.element.n_nodes}"
                    )
                self.cell_dofs = cn
                self.n_nodes = int(cn.max()) + 1
            else:
                self.cell_dofs, self.n_nodes = _number_p2(mesh)
            self.node_coords = _p2_node_coords(
                mesh, self.cell_dofs, self.n_nodes
            )
        self.n_dofs = self.n_nodes * self.n_fields

    def flat_cell_dofs(self) -> np.ndarray:
        """(n_cells, n_local_nodes * n_fields) interleaved global dof ids."""
        return flat_dofs(self.cell_dofs, self.n_fields)


def flat_dofs(node_ids: np.ndarray, n_fields: int) -> np.ndarray:
    """Interleave node ids into per-field dof ids along a new trailing axis."""
    if n_fields == 1:
        return node_ids
    base = node_ids[..., :, None] * n_fields + np.arange(n_fields)
    out_shape = node_ids.shape[:-1] + (node_ids.shape[-1] * n_fields,)
    return base.reshape(out_shape).astype(np.int32)


def _number_p2(mesh: Mesh) -> tuple[np.ndarray, int]:
    """Number unique edges to create P2 node ids (vertices keep their ids)."""
    from iifea.mesh import _native

    el = ReferenceElement(mesh.dim, 2)
    nat = _native.number_edges(mesh.cells, el.edges, mesh.n_verts)
    if nat is not None:
        edge_ids, n_unique = nat
        cell_dofs = np.hstack([mesh.cells, edge_ids]).astype(np.int32)
        return cell_dofs, mesh.n_verts + n_unique
    edges = mesh.cells[:, el.edges]                 # (nc, ne, 2)
    key = np.sort(edges.reshape(-1, 2), axis=1)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    edge_ids = (mesh.n_verts + inv).reshape(mesh.n_cells, -1)
    cell_dofs = np.hstack([mesh.cells, edge_ids]).astype(np.int32)
    return cell_dofs, mesh.n_verts + uniq.shape[0]


def _p2_node_coords(
    mesh: Mesh, cell_dofs: np.ndarray, n_nodes: int
) -> np.ndarray:
    """Node coordinates for P2 (straight-sided): midpoints of edge vertices."""
    el = ReferenceElement(mesh.dim, 2)
    nv = mesh.dim + 1
    coords = np.zeros((n_nodes, mesh.dim))
    coords[cell_dofs[:, :nv].ravel()] = mesh.coords[mesh.cells.ravel()]
    mids = 0.5 * (
        mesh.coords[mesh.cells[:, el.edges[:, 0]]]
        + mesh.coords[mesh.cells[:, el.edges[:, 1]]]
    )  # (nc, ne, dim)
    coords[cell_dofs[:, nv:].ravel()] = mids.reshape(-1, mesh.dim)
    return coords
