"""Batched FEM assembly engine (the DOLFIN-assembler replacement).

Design (SURVEY.md §7): static mesh arrays -> vmapped per-cell / per-facet
residual kernels (JAX autodiff supplies consistent Jacobians, replacing UFL
``derivative``) -> pre-sorted transpose-gather scatter (replacing the PETSc
matrix stash). The global foreground matrix is never materialized on the
product path: operators are applied as gather -> batched-block matvec ->
plane-sum, all shape-static and jit-compiled.

Memory layout is **struct-of-planes (SoA)**: every materialized device array
carries the long element/dof axis as its minormost dimension. Element
blocks are (ne, ne, nE), dof tables (ne, nE), quadrature geometry
(nq, ..., nE): dense contiguous planes, so elementwise kernels stream them
at memory bandwidth and no layout with tiny minor dims is ever padded out. Kernels
are written per element and vmapped with ``in_axes=-1 / out_axes=-1``.

Geometry is affine (all reference meshes are straight-sided simplices), so the
per-cell Jacobian is constant: physical basis gradients are
``gphi_ref @ Jinv`` and Hessians ``Jinvᵀ Href Jinv`` exactly.

Kernel protocol
---------------
A *cell kernel* is ``kernel(u_loc, aux_loc, ctx, params) -> r_loc`` where

  u_loc   (nb, n_fields)  local solution dofs
  aux_loc {name: (nb, n_fields)} extra discrete fields (e.g. u_old)
  ctx     CellCtx: phi (nq,nb), gphi (nq,nb,dim) physical, w (nq,) = wq*|detJ|,
          x (nq,dim) physical quadrature points, h (scalar CellDiameter),
          hess (nq,nb,dim,dim) physical second derivatives (degree-2 only)
  params  problem parameters pytree (time, penalties, ...)

and returns the local residual (nb, n_fields). A *facet kernel* has the same
signature with FacetCtx (adds the outward unit normal ``n`` (dim,)). Facet
terms are one-sided ('+' restriction): the '+' cell is the one with the larger
material marker, matching the reference's reliance on DOLFIN's ordering
("as the block ID > the outside ID ... the positive cells" poisson.py:166).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from iifea.mesh.core import FunctionSpace, flat_dofs
from iifea.ops import quadrature
from iifea.ops.reference_elements import TET_FACETS, TRI_FACETS


class CellCtx(NamedTuple):
    phi: jnp.ndarray
    gphi: jnp.ndarray
    w: jnp.ndarray
    x: jnp.ndarray
    h: jnp.ndarray
    hess: jnp.ndarray | None
    # basis Laplacian planes (nq, nb) — populated instead of the full hess
    # when the domain was built with with_hessian="lap"; Laplacian-only
    # kernels (biharmonic) must prefer it: the 4D hess carries tiny (dim,dim)
    # trailing axes and is ~dim² times larger
    lap: jnp.ndarray | None = None


class FacetCtx(NamedTuple):
    phi: jnp.ndarray
    gphi: jnp.ndarray
    w: jnp.ndarray
    x: jnp.ndarray
    h: jnp.ndarray
    n: jnp.ndarray
    hess: jnp.ndarray | None
    lap: jnp.ndarray | None = None


def lap_phi(ctx):
    """Basis Laplacian (nq, nb): the precomputed plane when available, else
    the trace of the full physical Hessian."""
    if ctx.lap is not None:
        return ctx.lap
    return jnp.einsum("qbdd->qb", ctx.hess)


def _register_dataclass_pytree(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    static = tuple(getattr(cls, "_static_fields", ()))
    dyn = [f for f in fields if f not in static]

    def flatten(obj):
        return (
            tuple(getattr(obj, f) for f in dyn),
            tuple(getattr(obj, f) for f in static),
        )

    def unflatten(aux, leaves):
        kw = dict(zip(dyn, leaves))
        kw.update(zip(static, aux))
        return cls(**kw)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


@_register_dataclass_pytree
@dataclasses.dataclass
class CellDomain:
    """Integration domain over a selected set of cells (SoA: nE minormost)."""

    eldofsT: jnp.ndarray      # (ne, nE) flattened dof ids, ne = nb*nFields
    JinvT: jnp.ndarray        # (dim, dim, nE)
    wdetT: jnp.ndarray        # (nq, nE)
    xqT: jnp.ndarray          # (nq, dim, nE)
    h: jnp.ndarray            # (nE,)
    phi: jnp.ndarray          # (nq, nb) static table
    gphi_ref: jnp.ndarray     # (nq, nb, dim)
    hess_ref: jnp.ndarray     # (nq, nb, dim, dim)
    scat_gidx: jnp.ndarray    # (Kmax, T) transpose-gather indices (+1,
                              # 0 = padding) — scatter-free assembly
    scat_touched: jnp.ndarray | None  # touched dof ids (compact table) or None
    # "full": ctx.hess = Jinvᵀ Href Jinv (nq,nb,dim,dim per element);
    # "lap": ctx.lap = tr(hess) only — avoids materializing the 4D hess
    # (see CellCtx.lap)
    hess_mode: str = "full"

    _static_fields = ("hess_mode",)

    @property
    def n_elem(self) -> int:
        return self.wdetT.shape[-1]

    def ctx(self) -> CellCtx:
        data, make_ctx = self.per_elem()
        return make_ctx(data)

    def per_elem(self):
        """(leading-nE-last leaves, chunk -> Ctx builder).

        Only the O(nE) geometry travels through chunked evaluation; the
        static basis tables are closed over, so intermediates inside autodiff
        stay bounded by the chunk size instead of the full element count."""
        data = (self.JinvT, self.wdetT, self.xqT, self.h)

        def make_ctx(d):
            JinvT, wdetT, xqT, h = d
            nE = wdetT.shape[-1]
            gphi = jnp.einsum("qbd,deE->qbeE", self.gphi_ref, JinvT)
            hess = lap = None
            if self.hess_ref.size:
                if self.hess_mode == "lap":
                    # lap[q,b,E] = Σ_{d,e} Href[q,b,d,e] G[d,e,E] with
                    # G = Jinv Jinvᵀ (affine). Unrolled over the tiny (d,e)
                    # dims as plane FMAs over the element axis (file header)
                    dim_ = JinvT.shape[0]
                    G = [
                        [
                            sum(JinvT[d, c] * JinvT[e, c]
                                for c in range(dim_))
                            for e in range(dim_)
                        ]
                        for d in range(dim_)
                    ]
                    href = self.hess_ref
                    lap = sum(
                        href[:, :, d, e, None] * G[d][e][None, None, :]
                        for d in range(dim_)
                        for e in range(dim_)
                    )
                else:
                    # hess_phys[c,f] = Σ_{d,e} Jinv[d,c] Href[d,e] Jinv[e,f]
                    hess = jnp.einsum(
                        "dcE,qbde,efE->qbcfE", JinvT, self.hess_ref, JinvT
                    )
            phi = jnp.broadcast_to(
                self.phi[..., None], self.phi.shape + (nE,)
            )
            return CellCtx(phi, gphi, wdetT, xqT, h, hess, lap)

        return data, make_ctx


@_register_dataclass_pytree
@dataclasses.dataclass
class FacetDomain:
    """One-sided ('+') integration domain over a set of facets (SoA)."""

    eldofsT: jnp.ndarray      # (ne, nF) plus-cell flattened dof ids
    phiT: jnp.ndarray         # (nq, nb, nF)  per-facet tables
    gphiT: jnp.ndarray        # (nq, nb, dim, nF) physical gradients
    hessT: jnp.ndarray        # (nq, nb, dim, dim, nF) physical hessians —
                              # or (nq, nb, nF) Laplacian planes ("lap" mode)
    wT: jnp.ndarray           # (nq, nF) = wq * facet measure
    xqT: jnp.ndarray          # (nq, dim, nF)
    h: jnp.ndarray            # (nF,) plus-cell diameter
    normalT: jnp.ndarray      # (dim, nF) outward unit normal of plus cell
    scat_gidx: jnp.ndarray
    scat_touched: jnp.ndarray | None
    hess_mode: str = "full"   # see CellDomain.hess_mode

    _static_fields = ("hess_mode",)

    @property
    def n_elem(self) -> int:
        return self.wT.shape[-1]

    def ctx(self) -> FacetCtx:
        data, make_ctx = self.per_elem()
        return make_ctx(data)

    def per_elem(self):
        """(nE-last leaves, chunk -> Ctx builder); see CellDomain.per_elem."""
        has_hess = bool(self.hessT.size)
        data = (self.phiT, self.gphiT, self.wT, self.xqT, self.h,
                self.normalT) + ((self.hessT,) if has_hess else ())

        def make_ctx(d):
            phi, gphi, w, xq, h, normal = d[:6]
            hess = lap = None
            if has_hess:
                if self.hess_mode == "lap":
                    lap = d[6]
                else:
                    hess = d[6]
            return FacetCtx(phi, gphi, w, xq, h, normal, hess, lap)

        return data, make_ctx


def _scatter_cache(flat_eldofs: np.ndarray, n_dofs: int):
    """Transpose-gather index table: scatter-add as a pure gather+plane-sum.

    Scatter-adds conflict on shared dofs; instead, for each output dof we
    precompute the
    (padded) list of positions in the SoA-flattened per-element residual
    array (index = a*nE + e for local dof a of element e) that contribute to
    it. Device-side accumulation is then ``concat([0], data)[gidx].sum(0)``
    — gathers and a small reduction, deterministic and free of atomics.
    Index 0 is the zero sentinel (stored indices are shifted by +1). The
    table is (Kmax, T): plane-major so the dof axis is minormost.

    Domains that touch only a small fraction of the dofs (boundary-facet
    terms: thousands of facets vs millions of dofs) get a COMPACT table over
    their touched dofs plus the touched-id list — otherwise every operator
    application would pay a full-width (Kmax, n_dofs) gather to scatter a
    sliver of data. Returns (gidx, touched); touched is None for full-width.
    """
    ids = np.ascontiguousarray(flat_eldofs.T).ravel()   # a*nE + e order
    uniq = np.unique(ids) if ids.size else np.zeros(0, np.int64)
    if uniq.size < n_dofs // 2:
        touched = uniq.astype(np.int32)
        remap = np.zeros(n_dofs, dtype=np.int64)
        remap[uniq] = np.arange(uniq.size)
        cols = remap[ids]
        width = uniq.size
    else:
        touched = None
        cols = ids
        width = n_dofs
    order = np.argsort(cols, kind="stable")
    sorted_cols = cols[order]
    counts = np.bincount(cols, minlength=width)
    kmax = max(int(counts.max()) if counts.size else 1, 1)
    starts = np.zeros(width, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    pos = np.arange(cols.size, dtype=np.int64) - starts[sorted_cols]
    gidx = np.zeros((kmax, width), dtype=np.int32)
    gidx[pos, sorted_cols] = (order + 1).astype(np.int32)
    return jnp.asarray(gidx), (
        jnp.asarray(touched) if touched is not None else None
    )


def gather_scatter(gidx: jnp.ndarray, data_flat: jnp.ndarray) -> jnp.ndarray:
    """Accumulate SoA-flattened (a*nE+e) element data into dof planes."""
    padded = jnp.concatenate([jnp.zeros(1, data_flat.dtype), data_flat])
    return padded[gidx].sum(axis=0)


def scatter_into(y, domain, data_flat):
    """y += scatter(data) honoring the domain's compact touched-dof table."""
    contrib = gather_scatter(domain.scat_gidx, data_flat)
    if domain.scat_touched is None:
        return y + contrib
    # unique indices: XLA lowers this to an efficient one-pass scatter-add
    return y.at[..., domain.scat_touched].add(contrib)


def scatter_into_multi(Y, domain, data):
    """Stacked variant: data (k, positions); Y (k, n_dofs)."""
    k = data.shape[0]
    padded = jnp.concatenate([jnp.zeros((k, 1), data.dtype), data], axis=1)
    contrib = jnp.take(padded, domain.scat_gidx, axis=1).sum(axis=1)
    if domain.scat_touched is None:
        return Y + contrib
    return Y.at[:, domain.scat_touched].add(contrib)


# jacfwd element batches above this size are evaluated through lax.map:
# the tangent-batched per-element intermediates scale as
# (tangents x elements x kernel temps) and OOM HBM at bench scale
_DEFAULT_JAC_CHUNK = 262144


def _auto_chunk(chunk):
    if chunk is None:
        env = os.environ.get("IIFEA_ASSEMBLY_CHUNK")
        # env "0" disables chunking, same as passing chunk=0
        return (int(env) or None) if env else _DEFAULT_JAC_CHUNK
    return None if chunk == 0 else chunk


def _chunk_last(tree, chunk: int, nE: int):
    """Pad (edge-replicating) and split the trailing element axis into
    lax.map-able (n_chunks, ..., chunk) leaves."""
    pad = (-nE) % chunk

    def prep(a):
        if pad:
            # edge-replicate: padded elements stay valid geometry (no 1/h
            # infinities feeding NaNs); their outputs are sliced away.
            tail = jnp.broadcast_to(a[..., -1:], a.shape[:-1] + (pad,))
            a = jnp.concatenate([a, tail], axis=-1)
        a = a.reshape(a.shape[:-1] + ((nE + pad) // chunk, chunk))
        return jnp.moveaxis(a, -2, 0)

    return jax.tree_util.tree_map(prep, tree)


def build_cell_domain(
    space: FunctionSpace,
    cell_ids: np.ndarray,
    quad_degree: int,
    with_hessian: bool | str = False,   # True | False | "lap" (CellCtx.lap)
    dtype=np.float64,
) -> CellDomain:
    mesh = space.mesh
    dim = mesh.dim
    cell_ids = np.asarray(cell_ids, dtype=np.int64)
    qp, wq = quadrature.cell_rule(dim, quad_degree)
    el = space.element
    phi = el.tabulate(qp)
    gphi_ref = el.tabulate_grad(qp)
    hess_ref = (
        el.tabulate_hess(qp) if with_hessian else np.zeros((0, 0, 0, 0))
    )
    verts = mesh.cell_coords[cell_ids]          # (nE, dim+1, dim)
    e = verts[:, 1:, :] - verts[:, :1, :]       # rows: edge vectors
    J = np.swapaxes(e, 1, 2)                    # dx/dxi (nE, dim, dim)
    detJ = np.linalg.det(J)
    Jinv = np.linalg.inv(J)
    wdet = np.abs(detJ)[:, None] * wq[None, :]
    bary = np.hstack([1 - qp.sum(1, keepdims=True), qp])  # (nq, dim+1)
    xq = np.einsum("qv,Evd->Eqd", bary, verts)
    eldofs = np.asarray(space.cell_dofs)[cell_ids]
    fl = flat_dofs(eldofs, space.n_fields)
    gidx, touched = _scatter_cache(fl, space.n_dofs)
    dom = CellDomain(
        eldofsT=jnp.asarray(np.ascontiguousarray(fl.T)),
        JinvT=jnp.asarray(
            np.ascontiguousarray(np.moveaxis(Jinv, 0, -1)).astype(dtype)
        ),
        wdetT=jnp.asarray(np.ascontiguousarray(wdet.T).astype(dtype)),
        xqT=jnp.asarray(
            np.ascontiguousarray(np.moveaxis(xq, 0, -1)).astype(dtype)
        ),
        h=jnp.asarray(mesh.cell_diameters[cell_ids].astype(dtype)),
        phi=jnp.asarray(phi.astype(dtype)),
        gphi_ref=jnp.asarray(gphi_ref.astype(dtype)),
        hess_ref=jnp.asarray(hess_ref.astype(dtype)),
        scat_gidx=gidx,
        scat_touched=touched,
        hess_mode="lap" if with_hessian == "lap" else "full",
    )
    dom.flat_eldofs_np = fl  # host copy: avoids device downloads in setup paths
    return dom


def build_facet_domain(
    space: FunctionSpace,
    facet_ids: np.ndarray,
    quad_degree: int,
    with_hessian: bool | str = False,   # True | False | "lap" (FacetCtx.lap)
    dtype=np.float64,
) -> FacetDomain:
    """Builds the '+'-restricted facet domain for interior-facet (dS) or
    exterior-facet (ds) measures.

    For interior facets the '+' cell is the adjacent cell with the larger
    material marker (ties broken by slot order), reproducing the reference's
    orientation convention (poisson.py:166). For boundary facets the only
    adjacent cell is used.
    """
    mesh = space.mesh
    dim = mesh.dim
    fd = mesh.facet_data
    facet_ids = np.asarray(facet_ids, dtype=np.int64)
    c0 = fd.facet_cells[facet_ids, 0]
    c1 = fd.facet_cells[facet_ids, 1]
    m0 = mesh.material[c0]
    m1 = np.where(c1 >= 0, mesh.material[np.maximum(c1, 0)], -(2**30))
    take1 = m1 > m0
    plus_cell = np.where(take1, c1, c0)
    plus_local = np.where(
        take1, fd.facet_local[facet_ids, 1], fd.facet_local[facet_ids, 0]
    )

    local_facets = TRI_FACETS if dim == 2 else TET_FACETS
    el = space.element
    fqp, fwq = quadrature.facet_rule(dim, quad_degree)
    nq = fqp.shape[0]

    # cell-reference coordinates of facet quadrature points, per local facet id
    ref_pts = np.stack(
        [el.facet_to_cell_points(lf, fqp) for lf in range(len(local_facets))]
    )  # (n_local_facets, nq, dim)
    phi_tab = np.stack([el.tabulate(p) for p in ref_pts])
    gphi_tab = np.stack([el.tabulate_grad(p) for p in ref_pts])
    hess_tab = (
        np.stack([el.tabulate_hess(p) for p in ref_pts])
        if with_hessian
        else None
    )

    verts = mesh.cell_coords[plus_cell]           # (nF, dim+1, dim)
    e = verts[:, 1:, :] - verts[:, :1, :]
    J = np.swapaxes(e, 1, 2)
    Jinv = np.linalg.inv(J)

    # facet geometry in the plus cell's local ordering
    fverts = np.take_along_axis(
        verts, local_facets[plus_local][:, :, None].astype(np.int64), axis=1
    )  # (nF, dim, dim)
    if dim == 2:
        t = fverts[:, 1] - fverts[:, 0]
        meas = np.linalg.norm(t, axis=1)
        nrm = np.stack([t[:, 1], -t[:, 0]], axis=1) / meas[:, None]
    else:
        a = fverts[:, 1] - fverts[:, 0]
        b = fverts[:, 2] - fverts[:, 0]
        cr = np.cross(a, b)
        nn = np.linalg.norm(cr, axis=1)
        meas = 0.5 * nn
        nrm = cr / nn[:, None]
    # orient outward from the plus cell
    centroid = verts.mean(axis=1)
    fcent = fverts.mean(axis=1)
    flip = np.einsum("fd,fd->f", nrm, fcent - centroid) < 0
    nrm[flip] *= -1.0

    # physical quadrature points on the facet
    lam0 = 1 - fqp.sum(1, keepdims=True)
    fbary = np.hstack([lam0, fqp])                # (nq, dim)
    xq = np.einsum("qv,Fvd->Fqd", fbary, fverts)

    phi = phi_tab[plus_local]                     # (nF, nq, nb)
    gphi = np.einsum("Fqbd,Fde->Fqbe", gphi_tab[plus_local], Jinv)
    if with_hessian == "lap":
        # store Laplacian planes only: tr(Jinvᵀ Href Jinv) = Href : (JinvJinvᵀ)
        G = np.einsum("Fdc,Fec->Fde", Jinv, Jinv)
        hess = np.einsum("Fqbde,Fde->Fqb", hess_tab[plus_local], G)
    elif with_hessian:
        # hess_phys[c,f] = sum_{d,e} Jinv[d,c] Href[d,e] Jinv[e,f] (affine map)
        hess = np.einsum(
            "Fdc,Fqbde,Fef->Fqbcf", Jinv, hess_tab[plus_local], Jinv
        )
    else:
        hess = np.zeros((0, 0, 0, 0, 0))

    w = fwq[None, :] * meas[:, None]
    eldofs = np.asarray(space.cell_dofs)[plus_cell]
    fl = flat_dofs(eldofs, space.n_fields)
    gidx, touched = _scatter_cache(fl, space.n_dofs)

    def soa(a):
        return jnp.asarray(
            np.ascontiguousarray(np.moveaxis(a, 0, -1)).astype(dtype)
        )

    dom = FacetDomain(
        eldofsT=jnp.asarray(np.ascontiguousarray(fl.T)),
        phiT=soa(phi),
        gphiT=soa(gphi),
        hessT=soa(hess) if with_hessian else jnp.asarray(hess.astype(dtype)),
        wT=soa(w),
        xqT=soa(xq),
        h=jnp.asarray(mesh.cell_diameters[plus_cell].astype(dtype)),
        normalT=soa(nrm),
        scat_gidx=gidx,
        scat_touched=touched,
        hess_mode="lap" if with_hessian == "lap" else "full",
    )
    dom.flat_eldofs_np = fl
    return dom


# -- residual / jacobian / operator application ------------------------------


class Term(NamedTuple):
    domain: CellDomain | FacetDomain
    kernel: Callable


class Form:
    """A sum of integral terms over cell/facet domains (a UFL-form analog).

    Registered as a pytree (kernels and sizes are static aux data) so Forms
    and operators built from them can be passed straight into jitted solvers.
    """

    def __init__(self, space: FunctionSpace, terms: list[Term]):
        self.space = space
        self.terms = tuple(terms)
        self.n_dofs = space.n_dofs
        self.n_fields = space.n_fields

    def tree_flatten(self):
        domains = tuple(t.domain for t in self.terms)
        kernels = tuple(t.kernel for t in self.terms)
        return domains, (kernels, self.n_dofs, self.n_fields)

    @classmethod
    def tree_unflatten(cls, aux, domains):
        kernels, n_dofs, n_fields = aux
        obj = object.__new__(cls)
        obj.space = None
        obj.terms = tuple(Term(d, k) for d, k in zip(domains, kernels))
        obj.n_dofs = n_dofs
        obj.n_fields = n_fields
        return obj

    # All methods are pure functions of (u, aux, params): jit at call sites.

    def _gather(self, domain, vec):
        ne, nE = domain.eldofsT.shape
        nb = ne // self.n_fields
        return vec[domain.eldofsT].reshape(nb, self.n_fields, nE)

    def _scatter_into(self, y, domain, r_loc):
        nE = r_loc.shape[-1]
        return scatter_into(y, domain, r_loc.reshape(-1, nE).reshape(-1))

    def residual(self, u, aux=None, params=None, chunk=None):
        """Assembled residual. ``chunk`` as in jacobian_blocks: kernels with
        heavy per-quadrature-point work (e.g. the biharmonic MMS source =
        nested autodiff Hessians) hold per-element intermediates that OOM
        HBM unchunked at million-element scale (round-4f biharmonic
        workload bench, ResourceExhausted inside Form.residual)."""
        chunk = _auto_chunk(chunk)
        aux = aux or {}
        r = jnp.zeros(self.n_dofs, dtype=u.dtype)
        for dom, kern in self.terms:
            if dom.n_elem == 0:  # empty facet class (e.g. coarse meshes)
                continue
            u_loc = self._gather(dom, u)
            aux_loc = {k: self._gather(dom, v) for k, v in aux.items()}
            vker = jax.vmap(kern, in_axes=(-1, -1, -1, None), out_axes=-1)
            nE = u_loc.shape[-1]
            if chunk is None or nE <= chunk:
                r_loc = vker(u_loc, aux_loc, dom.ctx(), params)
            else:
                data, make_ctx = dom.per_elem()
                tree_c = _chunk_last((u_loc, aux_loc, data), chunk, nE)

                def one(chunk_tree, vker=vker, make_ctx=make_ctx):
                    ul, al, d = chunk_tree
                    return vker(ul, al, make_ctx(d), params)

                rc = jax.lax.map(one, tree_c)     # (nch, nb, nF, chunk)
                r_loc = jnp.moveaxis(rc, 0, -2).reshape(
                    rc.shape[1], rc.shape[2], -1
                )[..., :nE]
            r = self._scatter_into(r, dom, r_loc)
        return r

    def jacobian_blocks(self, u, aux=None, params=None, chunk=None):
        """Per-term dense element Jacobians K (ne, ne, nE), ne = nb*nF.

        This is the engine's ``derivative(res, u)`` (common.py:434):
        forward-mode autodiff of each local residual kernel.

        ``chunk``: evaluate elements in lax.map segments of this size. The
        jacfwd graph holds tangent-batched per-element intermediates; at
        million-element scale (bench) those exceed HBM unless bounded.
        ``None`` auto-chunks at _DEFAULT_JAC_CHUNK (observed: the unchunked
        elasticity/biharmonic workload benches plan 18-25 GB tangent
        broadcasts at ~750k elements and OOM the 16 GB chip at compile
        time); pass 0 to force a single unchunked evaluation.
        """
        chunk = _auto_chunk(chunk)
        aux = aux or {}
        blocks = []
        for dom, kern in self.terms:
            if dom.n_elem == 0:
                ne = dom.eldofsT.shape[0]
                blocks.append(jnp.zeros((ne, ne, 0), dtype=u.dtype))
                continue
            u_loc = self._gather(dom, u)
            aux_loc = {k: self._gather(dom, v) for k, v in aux.items()}

            def local_jac(ul, al, c, kern=kern):
                nb, nF = ul.shape

                def flat_res(uf):
                    return kern(uf.reshape(nb, nF), al, c, params).reshape(-1)

                return jax.jacfwd(flat_res)(ul.reshape(-1))

            nE = u_loc.shape[-1]
            vjac = jax.vmap(local_jac, in_axes=(-1, -1, -1), out_axes=-1)
            data, make_ctx = dom.per_elem()
            if chunk is None or nE <= chunk:
                K = vjac(u_loc, aux_loc, make_ctx(data))
            else:
                tree_c = _chunk_last((u_loc, aux_loc, data), chunk, nE)

                def one(chunk_tree):
                    ul, al, d = chunk_tree
                    return vjac(ul, al, make_ctx(d))

                Kc = jax.lax.map(one, tree_c)        # (nch, ne, ne, chunk)
                K = jnp.moveaxis(Kc, 0, -2).reshape(
                    Kc.shape[1], Kc.shape[2], -1
                )[..., :nE]
            blocks.append(K)
        return blocks

    def jacobian_and_residual(self, u, aux=None, params=None, chunk=None):
        """One fused pass per term: (blocks, assembled residual).

        The dof gathers, quadrature geometry, and kernel subexpressions are
        shared between the primal and the jacfwd tangents (XLA CSE), saving
        a full assembly sweep vs calling jacobian_blocks + residual.
        ``chunk=None`` auto-chunks (see jacobian_blocks); 0 disables."""
        chunk = _auto_chunk(chunk)
        aux = aux or {}
        blocks = []
        r = jnp.zeros(self.n_dofs, dtype=u.dtype)
        for dom, kern in self.terms:
            if dom.n_elem == 0:
                ne = dom.eldofsT.shape[0]
                blocks.append(jnp.zeros((ne, ne, 0), dtype=u.dtype))
                continue
            u_loc = self._gather(dom, u)
            aux_loc = {k: self._gather(dom, v) for k, v in aux.items()}

            def local(ul, al, c, kern=kern):
                nb, nF = ul.shape

                def flat_res(uf):
                    return kern(uf.reshape(nb, nF), al, c, params).reshape(-1)

                uf = ul.reshape(-1)
                return jax.jacfwd(flat_res)(uf), flat_res(uf)

            nE = u_loc.shape[-1]
            vloc = jax.vmap(local, in_axes=(-1, -1, -1), out_axes=(-1, -1))
            data, make_ctx = dom.per_elem()
            if chunk is None or nE <= chunk:
                K, rl = vloc(u_loc, aux_loc, make_ctx(data))
            else:
                tree_c = _chunk_last((u_loc, aux_loc, data), chunk, nE)

                def one(chunk_tree):
                    ul, al, d = chunk_tree
                    return vloc(ul, al, make_ctx(d))

                Kc, rc = jax.lax.map(one, tree_c)
                K = jnp.moveaxis(Kc, 0, -2).reshape(
                    Kc.shape[1], Kc.shape[2], -1
                )[..., :nE]
                rl = jnp.moveaxis(rc, 0, -2).reshape(rc.shape[1], -1)[:, :nE]
            blocks.append(K)
            r = scatter_into(r, dom, rl.reshape(-1, nE).reshape(-1))
        return blocks, r

    # The tiny-ne contractions below are unrolled as elementwise FMAs over
    # the long element axis rather than einsum: the unrolled form keeps
    # every operand a dense (nE,) plane and fuses into one elementwise
    # pass, where a batched dot_general with a 3..18-wide contraction
    # would put the tiny dims minormost.

    def matvec(self, blocks, x):
        """Apply the (foreground) linearized operator: y = A_f x."""
        y = jnp.zeros(self.n_dofs, dtype=x.dtype)
        for (dom, _), K in zip(self.terms, blocks):
            if dom.n_elem == 0:
                continue
            xe = x[dom.eldofsT]                           # (ne, nE)
            ne = xe.shape[0]
            ye = sum(K[:, b, :] * xe[b][None, :] for b in range(ne))
            y = scatter_into(y, dom, ye.reshape(-1))
        return y

    def matvec_multi(self, blocks, X):
        """Multi-RHS operator application, stacked: (k, n_dofs) -> (k, n_dofs)."""
        k = X.shape[0]
        Y = jnp.zeros((k, self.n_dofs), dtype=X.dtype)
        for (dom, _), K in zip(self.terms, blocks):
            if dom.n_elem == 0:
                continue
            xe = X[:, dom.eldofsT]                        # (k, ne, nE)
            ne = xe.shape[1]
            ye = sum(
                K[None, :, b, :] * xe[:, b, None, :] for b in range(ne)
            )                                             # (k, ne, nE)
            Y = scatter_into_multi(Y, dom, ye.reshape(k, -1))
        return Y

    def matvec_t(self, blocks, x):
        """Apply the transposed operator: y = A_fᵀ x (condition estimation)."""
        y = jnp.zeros(self.n_dofs, dtype=x.dtype)
        for (dom, _), K in zip(self.terms, blocks):
            if dom.n_elem == 0:
                continue
            xe = x[dom.eldofsT]
            ne = xe.shape[0]
            ye = sum(K[a, :, :] * xe[a][None, :] for a in range(ne))
            y = scatter_into(y, dom, ye.reshape(-1))
        return y


jax.tree_util.register_pytree_node_class(Form)


def integrate(domain, kernel, u, aux=None, params=None, n_fields=1):
    """Evaluate a scalar functional ∫ kernel over a cell/facet domain.

    ``kernel(u_loc, aux_loc, ctx, params) -> scalar`` per element. This is the
    engine's ``assemble(inner(e, e)*dx_custom)`` (error norms, poisson.py:216-224).
    """
    aux = aux or {}
    ne, nE = domain.eldofsT.shape
    nb = ne // n_fields

    def gather(vec):
        return vec[domain.eldofsT].reshape(nb, n_fields, nE)

    u_loc = gather(u)
    aux_loc = {k: gather(v) for k, v in aux.items()}
    vals = jax.vmap(kernel, in_axes=(-1, -1, -1, None), out_axes=0)(
        u_loc, aux_loc, domain.ctx(), params
    )
    return vals.sum()
