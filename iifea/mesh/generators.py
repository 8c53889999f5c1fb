"""Mesh generation and runtime extraction-operator construction.

Covers three reference capabilities without external tooling:

* generateUnfittedMesh (common.py:53-93): overlapping fg/bg simplex meshes
  with optional rotation so boundaries are cut.
* PETScDMCollection.create_transfer_matrix (poisson_unfitted.py:134): runtime
  Lagrange interpolation matrix — bg basis functions evaluated at fg dof
  coordinates.
* the MORIS/XTK-style immersed-block setup (SURVEY.md §2.3 N8): a structured
  fg simplex mesh whose cells are classified inside/outside an immersed
  geometry, plus a structured tensor-product background grid, used for
  arbitrary-scale synthetic problems (bench.py's ≥1M-DOF target).
"""
from __future__ import annotations

import numpy as np

from iifea.mesh.core import Mesh
from iifea.ops.extraction import ExtractionOperator


def rectangle_mesh(p0, p1, nx: int, ny: int) -> Mesh:
    """Structured crossed-diagonal-free triangle mesh (2 tris per quad),
    matching DOLFIN RectangleMesh's default 'right' diagonal."""
    x = np.linspace(p0[0], p1[0], nx + 1)
    y = np.linspace(p0[1], p1[1], ny + 1)
    X, Y = np.meshgrid(x, y, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    v00, v10 = vid(i, j).ravel(), vid(i + 1, j).ravel()
    v01, v11 = vid(i, j + 1).ravel(), vid(i + 1, j + 1).ravel()
    t1 = np.stack([v00, v10, v11], axis=1)
    t2 = np.stack([v00, v11, v01], axis=1)
    cells = np.concatenate([t1, t2], axis=0)
    mesh = Mesh(coords, cells)
    mesh.structured = ("rect", np.asarray(p0, float), np.asarray(p1, float), nx, ny)
    return mesh


def box_mesh(p0, p1, nx: int, ny: int, nz: int) -> Mesh:
    """Structured tet mesh, 6 tets per hex (Kuhn triangulation)."""
    x = np.linspace(p0[0], p1[0], nx + 1)
    y = np.linspace(p0[1], p1[1], ny + 1)
    z = np.linspace(p0[2], p1[2], nz + 1)
    X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    i, j, k = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    c = {
        (a, b, d): vid(i + a, j + b, k + d).ravel()
        for a in (0, 1) for b in (0, 1) for d in (0, 1)
    }
    # Kuhn: 6 tets around the main diagonal (0,0,0)-(1,1,1)
    paths = [
        [(0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1)],
        [(0, 0, 0), (1, 0, 0), (1, 0, 1), (1, 1, 1)],
        [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 1, 1)],
        [(0, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)],
        [(0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1)],
        [(0, 0, 0), (0, 0, 1), (0, 1, 1), (1, 1, 1)],
    ]
    cells = np.concatenate(
        [np.stack([c[v] for v in p], axis=1) for p in paths], axis=0
    )
    mesh = Mesh(coords, cells)
    mesh.structured = (
        "box", np.asarray(p0, float), np.asarray(p1, float), nx, ny, nz
    )
    return mesh


def _rotate(coords: np.ndarray, angle_deg: float, axis: int = 2) -> np.ndarray:
    a = np.deg2rad(angle_deg)
    ca, sa = np.cos(a), np.sin(a)
    out = coords.copy()
    if coords.shape[1] == 2:
        out[:, 0] = ca * coords[:, 0] - sa * coords[:, 1]
        out[:, 1] = sa * coords[:, 0] + ca * coords[:, 1]
        return out
    ax = [(1, 2), (0, 2), (0, 1)][axis]
    u, v = coords[:, ax[0]].copy(), coords[:, ax[1]].copy()
    if axis == 1:  # match DOLFIN's rotate sense about y
        out[:, ax[0]] = ca * u + sa * v
        out[:, ax[1]] = -sa * u + ca * v
    else:
        out[:, ax[0]] = ca * u - sa * v
        out[:, ax[1]] = sa * u + ca * v
    return out


def generate_unfitted_mesh(
    L_f: float, L_b: float, N_f: int, N_b: int, dim: int = 2,
    rotate_f: bool = False, rotate_b: bool = False, angle: float = 30.0,
) -> tuple[Mesh, Mesh]:
    """generateUnfittedMesh parity (common.py:53-93). Note the reference's 2D
    foreground uses (N_f, N_b) divisions — reproduced verbatim."""
    if dim == 2:
        mesh_f = rectangle_mesh((-L_f / 2, -L_f / 2), (L_f / 2, L_f / 2), N_f, N_b)
        mesh_b = rectangle_mesh((-L_b / 2, -L_b / 2), (L_b / 2, L_b / 2), N_b, N_b)
        if rotate_f:
            mesh_f = Mesh(_rotate(mesh_f.coords, angle), mesh_f.cells)
        if rotate_b:
            mesh_b = Mesh(_rotate(mesh_b.coords, angle), mesh_b.cells)
    elif dim == 3:
        mesh_b = box_mesh(
            (-L_b / 2,) * 3, (L_b / 2,) * 3, N_b, N_b, N_b
        )
        mesh_f = box_mesh(
            (-L_f / 2,) * 3, (L_f / 2,) * 3, N_f, N_f, N_f
        )
        if rotate_f:
            cf = _rotate(_rotate(mesh_f.coords, angle, 2), angle, 1)
            mesh_f = Mesh(cf, mesh_f.cells)
        if rotate_b:
            cb = _rotate(_rotate(mesh_b.coords, angle, 2), angle, 1)
            mesh_b = Mesh(cb, mesh_b.cells)
    else:
        raise ValueError(f"Dimension of {dim} is not supported!")
    return mesh_f, mesh_b


# -- runtime extraction (transfer matrix) -------------------------------------


def transfer_matrix_simplex(
    mesh_b: Mesh, points: np.ndarray, degree: int = 1, n_fields: int = 1,
    tol: float = 1e-10, dtype=np.float64,
) -> ExtractionOperator:
    """Lagrange interpolation matrix from a simplex background space to points.

    The runtime analog of readExOp: row i holds the bg basis functions of the
    cell containing point i, evaluated there (create_transfer_matrix parity,
    poisson_unfitted.py:134). Points outside the bg mesh get zero rows.
    """
    from iifea.mesh.core import FunctionSpace

    Vb = FunctionSpace(mesh_b, degree=degree, n_fields=1)
    el = Vb.element
    points = np.asarray(points, dtype=np.float64)
    npts, dim = points.shape

    if getattr(mesh_b, "structured", None) is not None:
        locate = (
            locate_structured_rect if mesh_b.structured[0] == "rect"
            else locate_structured_box
        )
        cell_idx, ref = locate(mesh_b, points, tol)
        inside = cell_idx >= 0
        safe_cells = np.maximum(cell_idx, 0)
    else:
        cell_idx = locate_cells(mesh_b, points, tol)
        inside = cell_idx >= 0
        safe_cells = np.maximum(cell_idx, 0)
        verts = mesh_b.cell_coords[safe_cells]       # (np, dim+1, dim)
        e = np.swapaxes(verts[:, 1:, :] - verts[:, :1, :], 1, 2)
        Jinv = np.linalg.inv(e)
        ref = np.einsum("pde,pe->pd", Jinv, points - verts[:, 0, :])
    # basis values at reference coords (vectorized over points)
    vals = _tabulate_rows(el, ref)                    # (np, n_nodes)
    cols = np.asarray(Vb.cell_dofs)[safe_cells]       # (np, n_nodes)
    rows = np.repeat(np.arange(npts), vals.shape[1])
    mask = np.repeat(inside, vals.shape[1])
    v = vals.ravel()
    keep = mask & (np.abs(v) > 1e-14)
    return ExtractionOperator.from_triples(
        rows[keep], cols.ravel()[keep], v[keep],
        n_fg_nodes=npts, n_bg_nodes=Vb.n_nodes, n_fields=n_fields, dtype=dtype,
    )


def _tabulate_rows(el, ref_pts: np.ndarray) -> np.ndarray:
    return el.tabulate(ref_pts)


def locate_structured_rect(
    mesh: Mesh, points: np.ndarray, tol: float = 1e-10
) -> tuple[np.ndarray, np.ndarray]:
    """O(1) vectorized point location in a structured rectangle_mesh.

    Returns (cell ids, reference coordinates); outside points get id -1.
    """
    _, p0, p1, nx, ny = mesh.structured
    points = np.asarray(points, dtype=np.float64)
    rel = (points - p0) / (p1 - p0)
    inside = (rel.min(1) >= -tol) & (rel.max(1) <= 1 + tol)
    gx = np.clip(rel[:, 0] * nx, 0, nx * (1 - 1e-15))
    gy = np.clip(rel[:, 1] * ny, 0, ny * (1 - 1e-15))
    i = np.minimum(gx.astype(np.int64), nx - 1)
    j = np.minimum(gy.astype(np.int64), ny - 1)
    s = gx - i
    t = gy - j
    lower = s >= t  # triangle t1 = (v00, v10, v11) covers s >= t
    quad = i * ny + j
    cell = np.where(lower, quad, nx * ny + quad)
    # reference coords within each triangle (vertex order as in rectangle_mesh)
    ref_lower = np.stack([s - t, t], axis=1)   # verts (0,0),(1,0),(1,1)
    ref_upper = np.stack([s, t - s], axis=1)   # verts (0,0),(1,1),(0,1)
    ref = np.where(lower[:, None], ref_lower, ref_upper)
    return np.where(inside, cell, -1), ref


def locate_structured_box(
    mesh: Mesh, points: np.ndarray, tol: float = 1e-10
) -> tuple[np.ndarray, np.ndarray]:
    """O(1) vectorized point location in a box_mesh (Kuhn triangulation).

    The 6 tets of each hex are the regions x_α >= x_β >= x_γ of the local
    cube coordinates, one per axis permutation; the containing tet is read
    off an argsort and the reference coordinates are the consecutive
    differences of the sorted coordinates (the general-mesh bucket search
    in locate_cells is a Python loop — ~30 s per million points — where
    this is a handful of vectorized passes)."""
    _, p0, p1, nx, ny, nz = mesh.structured
    points = np.asarray(points, dtype=np.float64)
    rel = (points - p0) / (p1 - p0)
    inside = (rel.min(1) >= -tol) & (rel.max(1) <= 1 + tol)
    n = np.array([nx, ny, nz])
    g = np.clip(rel * n, 0, n * (1 - 1e-15))
    ijk = np.minimum(g.astype(np.int64), n - 1)
    s = g - ijk                                      # local cube coords
    order = np.argsort(-s, axis=1, kind="stable")    # (np, 3): α, β, γ
    # path index per axis-addition order (matches box_mesh's `paths` list)
    path_of = np.full(27, -1, dtype=np.int64)
    for p, (a, b_, c) in enumerate(
        [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]
    ):
        path_of[a * 9 + b_ * 3 + c] = p
    path = path_of[order[:, 0] * 9 + order[:, 1] * 3 + order[:, 2]]
    quad = (ijk[:, 0] * ny + ijk[:, 1]) * nz + ijk[:, 2]
    cell = path * (nx * ny * nz) + quad
    rows = np.arange(points.shape[0])
    d1 = s[rows, order[:, 0]]
    d2 = s[rows, order[:, 1]]
    d3 = s[rows, order[:, 2]]
    ref = np.stack([d1 - d2, d2 - d3, d3], axis=1)
    return np.where(inside, cell, -1), ref


def locate_cells(mesh: Mesh, points: np.ndarray, tol: float = 1e-10) -> np.ndarray:
    """Point location via a uniform bucket grid over cell bounding boxes.

    Returns the containing cell id per point, -1 if outside.
    """
    points = np.asarray(points)
    npts = points.shape[0]
    dim = mesh.dim
    lo = mesh.coords.min(0) - tol
    hi = mesh.coords.max(0) + tol
    n_buckets = max(int(round(mesh.n_cells ** (1.0 / dim))), 1)
    width = (hi - lo) / n_buckets

    def bucket_of(x):
        b = np.clip(((x - lo) / width).astype(np.int64), 0, n_buckets - 1)
        return b

    # cells -> buckets they overlap (by bbox)
    cc = mesh.cell_coords
    cmin = bucket_of(cc.min(1))
    cmax = bucket_of(cc.max(1))
    cell_list: dict[tuple, list[int]] = {}
    for c in range(mesh.n_cells):
        ranges = [range(cmin[c, d], cmax[c, d] + 1) for d in range(dim)]
        idx = [(i,) for i in ranges[0]]
        for r in ranges[1:]:
            idx = [t + (i,) for t in idx for i in r]
        for t in idx:
            cell_list.setdefault(t, []).append(c)

    e = np.swapaxes(cc[:, 1:, :] - cc[:, :1, :], 1, 2)
    Jinv = np.linalg.inv(e)
    x0 = cc[:, 0, :]

    out = np.full(npts, -1, dtype=np.int64)
    pb = bucket_of(points)
    for p in range(npts):
        cands = cell_list.get(tuple(pb[p]), ())
        for c in cands:
            lam = Jinv[c] @ (points[p] - x0[c])
            if lam.min() >= -tol and lam.sum() <= 1 + tol:
                out[p] = c
                break
    return out


# -- immersed-block problem generator (bench-scale synthetic) -----------------


def _snap_cut_boundary(mesh_f, angle: float, half_width: float):
    """Snap the staircase material interface onto the exact rotated square.

    The centroid classification of the synthetic generators leaves the
    immersed boundary as a staircase of mesh facets with O(h) re-entrant
    steps. For 2nd-order problems the Nitsche formulation is consistent on
    that polygon and rates are unaffected, but for the biharmonic the
    staircase corners destroy the H4 dual regularity the Aubin-Nitsche
    argument needs, capping the observed L2 rate at the energy rate (~1,
    measured round 3-4 'staircase boundary' note). Here every interface
    vertex is projected onto the nearest point of the exact rotated-square
    boundary, and material-2 cells that collapse (all three vertices on one
    side line, or folded over it) are demoted to material 1 — they are
    zero-area boundary slivers. The resulting interface facets lie ON the
    exact square sides (up to O(h) chamfers at the four convex corners),
    which restores the duality gain.

    The reference gets this for free: its MORIS/XTK foregrounds are cut to
    conform to the geometry (SURVEY N8). This is the synthetic-generator
    analog.
    """
    coords = np.array(mesh_f.coords, dtype=np.float64, copy=True)
    cells = np.asarray(mesh_f.cells)
    material = np.array(mesh_f.material, copy=True)
    in2 = material == 2
    c2 = cells[in2]
    # interface edges: edges of material-2 cells not shared by two of them
    e = np.concatenate([c2[:, [0, 1]], c2[:, [1, 2]], c2[:, [2, 0]]])
    e = np.sort(e, axis=1)
    _, inv, counts = np.unique(
        e, axis=0, return_inverse=True, return_counts=True
    )
    bverts = np.unique(e[counts[inv] == 1])

    a = np.deg2rad(angle)
    ca, sa = np.cos(a), np.sin(a)
    R = np.array([[ca, sa], [-sa, ca]])
    uv = coords[bverts] @ R.T
    # nearest point on the square |u|_inf = half_width: push the larger
    # coordinate to the side, clamp the other into the side segment
    au, av = np.abs(uv[:, 0]), np.abs(uv[:, 1])
    major_u = au >= av
    snapped = uv.copy()
    snapped[major_u, 0] = np.sign(uv[major_u, 0]) * half_width
    snapped[major_u, 1] = np.clip(uv[major_u, 1], -half_width, half_width)
    snapped[~major_u, 1] = np.sign(uv[~major_u, 1]) * half_width
    snapped[~major_u, 0] = np.clip(uv[~major_u, 0], -half_width, half_width)
    coords[bverts] = snapped @ R

    # demote collapsed/folded material-2 slivers (their area is (near) zero:
    # they lie on the boundary line, so removing them leaves the domain
    # unchanged). Threshold: a small fraction of the median cell area.
    p = coords[cells[in2]]
    area2 = 0.5 * (
        (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
        - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1])
    )
    tol = 0.02 * np.median(np.abs(area2))
    drop = np.flatnonzero(in2)[area2 <= tol]
    material[drop] = 1
    out = type(mesh_f)(coords, cells, material)
    return out


def immersed_square_problem(
    n_fg: int,
    n_bg: int,
    L: float = 2.0,
    angle: float = 30.0,
    half_width: float = 0.6,
    degree: int = 1,
    n_fields: int = 1,
    dtype=np.float64,
):
    """Synthetic analog of the reference's square meshes at arbitrary scale.

    Foreground: structured triangle mesh over [-L/2, L/2]²; cells whose
    centroid lies inside a rotated square of half-width ``half_width`` are the
    block (material 2), the rest material 1 — the MORIS/XTK classification
    role. Background: coarser structured simplex grid over the same domain;
    M is built at runtime by Lagrange interpolation.

    Returns (mesh_f, M) ready for PoissonProblem-style assembly.
    """
    mesh_f = rectangle_mesh((-L / 2, -L / 2), (L / 2, L / 2), n_fg, n_fg)
    cent = mesh_f.cell_coords.mean(1)
    a = np.deg2rad(angle)
    ca, sa = np.cos(a), np.sin(a)
    u = ca * cent[:, 0] + sa * cent[:, 1]
    v = -sa * cent[:, 0] + ca * cent[:, 1]
    material = np.where(
        (np.abs(u) <= half_width) & (np.abs(v) <= half_width), 2, 1
    ).astype(np.int32)
    mesh_f = Mesh(mesh_f.coords, mesh_f.cells, material)
    mesh_b = rectangle_mesh((-L / 2, -L / 2), (L / 2, L / 2), n_bg, n_bg)

    from iifea.mesh.core import FunctionSpace

    Vf = FunctionSpace(mesh_f, degree=degree, n_fields=1)
    M = transfer_matrix_simplex(
        mesh_b, np.asarray(Vf.node_coords), degree=degree, n_fields=n_fields,
        dtype=dtype,
    )
    return mesh_f, M


def immersed_cube_problem(
    n_fg: int,
    n_bg: int,
    L: float = 2.0,
    angle: float = 30.0,
    half_width: float = 0.6,
    degree: int = 1,
    n_fields: int = 1,
    dtype=np.float64,
):
    """3D analog of immersed_square_problem: a rotated cube immersed in a
    structured tet block (the reference's cube workloads, poisson --dim 3).

    Background node ids follow box_mesh row-major numbering
    (id = (i·(n_bg+1) + j)·(n_bg+1) + k), the layout StencilOperator3D
    expects.
    """
    from iifea.mesh.core import FunctionSpace

    mesh_f = box_mesh((-L / 2,) * 3, (L / 2,) * 3, n_fg, n_fg, n_fg)
    cent = mesh_f.cell_coords.mean(1)
    a = np.deg2rad(angle)
    ca, sa = np.cos(a), np.sin(a)
    # rotate about z then y (generate_unfitted_mesh convention)
    u = ca * cent[:, 0] + sa * cent[:, 1]
    v = -sa * cent[:, 0] + ca * cent[:, 1]
    w = cent[:, 2]
    u2 = ca * u + sa * w
    w2 = -sa * u + ca * w
    material = np.where(
        (np.abs(u2) <= half_width) & (np.abs(v) <= half_width)
        & (np.abs(w2) <= half_width), 2, 1
    ).astype(np.int32)
    mesh_f = Mesh(mesh_f.coords, mesh_f.cells, material)
    mesh_b = box_mesh((-L / 2,) * 3, (L / 2,) * 3, n_bg, n_bg, n_bg)

    Vf = FunctionSpace(mesh_f, degree=degree, n_fields=1)
    M = transfer_matrix_simplex(
        mesh_b, np.asarray(Vf.node_coords), degree=degree, n_fields=n_fields,
        dtype=dtype,
    )
    return mesh_f, M


def immersed_square_bspline_problem(
    n_fg: int,
    n_bg: int,
    L: float = 2.0,
    angle: float = 30.0,
    half_width: float = 0.6,
    fg_degree: int = 2,
    bg_degree: int = 2,
    n_fields: int = 1,
    dtype=np.float64,
    snap_boundary: bool = False,
):
    """Synthetic analog of the reference's *Quadratic* square workloads: a
    rotated immersed square in a P2 simplex foreground, extracted to a
    C1 tensor-product B-spline background (the space the reference's
    Quadratic ExOp CSVs encode — their weights are exactly such basis
    values). Unlike the CSV artifacts, the control net here is a KNOWN
    lattice, which is what lets 4th-order (biharmonic) solves run on device
    through the stencil-probe + multigrid path.

    Returns (mesh_f, M, lattice_shape): lattice_shape is the control-net
    shape (ncp_x, ncp_y) in the row-major ordering StencilOperator2D
    expects. ncp = n_bg + bg_degree; pick n_bg = 2^m - bg_degree + 1 to get
    a 2^m+1 net that coarsens all the way down.

    Pick ``n_fg`` a MULTIPLE of ``n_bg`` (nested grids): then every fg cell
    lies inside one knot span, the spline restricted there is a single
    polynomial, and the P2 interpolation-based extraction reproduces the
    background space exactly. Straddling grids interpolate across the
    spline's C1 knot lines and inject an O(h) H2-norm interpolation crime
    that caps 4th-order convergence rates at ~1 (measured, round 3).
    """
    from iifea.mesh.bspline import BSplineSpace2D
    from iifea.mesh.core import FunctionSpace

    mesh_f = rectangle_mesh((-L / 2, -L / 2), (L / 2, L / 2), n_fg, n_fg)
    cent = mesh_f.cell_coords.mean(1)
    a = np.deg2rad(angle)
    ca, sa = np.cos(a), np.sin(a)
    u = ca * cent[:, 0] + sa * cent[:, 1]
    v = -sa * cent[:, 0] + ca * cent[:, 1]
    material = np.where(
        (np.abs(u) <= half_width) & (np.abs(v) <= half_width), 2, 1
    ).astype(np.int32)
    mesh_f = Mesh(mesh_f.coords, mesh_f.cells, material)
    if snap_boundary:
        # exact-polygon immersed boundary (see _snap_cut_boundary): needed
        # for the biharmonic's L2 duality rate; off by default for parity
        # with the staircase rows measured in earlier rounds
        mesh_f = _snap_cut_boundary(mesh_f, angle, half_width)

    space = BSplineSpace2D(
        bg_degree, (n_bg, n_bg), (-L / 2, -L / 2), (L / 2, L / 2)
    )
    Vf = FunctionSpace(mesh_f, degree=fg_degree, n_fields=1)
    M = space.transfer_matrix(
        np.asarray(Vf.node_coords), n_fields=n_fields, dtype=dtype
    )
    return mesh_f, M, space.ncp


def immersed_cube_bspline_problem(
    n_fg: int,
    n_bg: int,
    L: float = 2.0,
    angle: float = 30.0,
    half_width: float = 0.6,
    fg_degree: int = 2,
    bg_degree: int = 2,
    n_fields: int = 1,
    dtype=np.float64,
):
    """3D analog of immersed_square_bspline_problem: a rotated immersed cube
    in a P2 tet foreground, extracted to a C1 tensor-product B-spline box
    background. Fills the gap left by the stripped cube-Quadratic ExOp CSVs
    in this checkout (reference biharmonic --dim 3, biharmonic.py:230-231):
    a runtime-generated quadratic background at ANY refinement level.

    Returns (mesh_f, M, lattice_shape) with lattice_shape = ncp.
    """
    from iifea.mesh.bspline import BSplineSpace3D
    from iifea.mesh.core import FunctionSpace

    mesh_f = box_mesh((-L / 2,) * 3, (L / 2,) * 3, n_fg, n_fg, n_fg)
    cent = mesh_f.cell_coords.mean(1)
    a = np.deg2rad(angle)
    ca, sa = np.cos(a), np.sin(a)
    u = ca * cent[:, 0] + sa * cent[:, 1]
    v = -sa * cent[:, 0] + ca * cent[:, 1]
    w = cent[:, 2]
    u2 = ca * u + sa * w
    w2 = -sa * u + ca * w
    material = np.where(
        (np.abs(u2) <= half_width) & (np.abs(v) <= half_width)
        & (np.abs(w2) <= half_width), 2, 1
    ).astype(np.int32)
    mesh_f = Mesh(mesh_f.coords, mesh_f.cells, material)

    space = BSplineSpace3D(
        bg_degree, (n_bg,) * 3, (-L / 2,) * 3, (L / 2,) * 3
    )
    Vf = FunctionSpace(mesh_f, degree=fg_degree, n_fields=1)
    M = space.transfer_matrix(
        np.asarray(Vf.node_coords), n_fields=n_fields, dtype=dtype
    )
    return mesh_f, M, space.ncp
