"""2D/3D biharmonic problem with Nitsche boundary conditions.

Weak-form parity with demos/biharmonic.py:200-212 (k fixed = 2, quadrature
degree k — biharmonic.py:79,159):

  A(u,v) = ∫ Δu Δv dx
         − ∫ Δu⁺ (∇v⁺·n⁺) dS + ∫ (∇(Δu⁺)·n⁺) v⁺ dS
         + sgn ∫ (∇(Δv⁺)·n⁺) u⁺ dS − sgn ∫ Δv⁺ (∇u⁺·n⁺) dS
         + β h⁻¹ ∫ (∇u⁺·n⁺)(∇v⁺·n⁺) dS + α h⁻³ ∫ u⁺ v⁺ dS
  b(v)   = ∫ f v dx + (same adjoint/penalty terms with u -> u_exact)

For degree-2 elements on affine simplices, third derivatives vanish
identically, so the ∇(Δ·) terms are exactly zero — the same value FFC
produces for the reference's P2 spaces; they are therefore omitted from the
kernels (documented here for parity audit).

The default is the *nonsymmetric* variant (sgn = -1, biharmonic.py:59), and
f = Δ²u_exact comes from nested JAX Hessians (biharmonic.py:29-34).

Includes the small-cut-cell volume filter (biharmonic.py:134-155) via
Mesh.filter_small_cells.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from iifea.mesh.core import FunctionSpace, Mesh
from iifea.ops.assembly import (
    Form,
    Term,
    build_cell_domain,
    build_facet_domain,
    integrate,
    lap_phi,
)


def u_exact_fn(dim: int):
    if dim == 2:
        def u_ex(x):  # biharmonic.py:39
            return jnp.cos(0.05 * jnp.pi * x[0] + 0.1) * jnp.cos(
                0.05 * jnp.pi * x[1] + 0.1
            )
    else:
        def u_ex(x):  # biharmonic.py:41
            return (
                jnp.cos(jnp.pi * x[0] + 0.5)
                * jnp.cos(jnp.pi * x[1] + 0.5)
                * jnp.cos(jnp.pi * x[2] + 0.5)
            )
    return u_ex


def lap_fn(f):
    return lambda x: jnp.trace(jax.hessian(f)(x))


class BiharmonicProblem:
    def __init__(
        self,
        mesh: Mesh,
        sym: bool = False,
        beta_value: float = 5.0,
        alpha_value: float = 5.0,
        filter_tol: float = 1e-5,
        block_id: int = 2,
        surf_id: int = 3,
        u_exact=None,
        dtype=None,
    ):
        if dtype is None:
            dtype = np.float64 if jax.config.jax_enable_x64 else np.float32
        k = 2  # biharmonic.py:79
        self.mesh = mesh
        self.space = FunctionSpace(mesh, degree=k, n_fields=1)
        self.sgn = 1.0 if sym else -1.0
        self.beta = float(beta_value)
        self.alpha = float(alpha_value)
        self.u_ex = u_exact or u_exact_fn(mesh.dim)
        self.lap_u_ex = lap_fn(self.u_ex)
        self.f = lap_fn(self.lap_u_ex)  # Δ²u (biharmonic.py:32-34)

        fclass = mesh.classify_facets_by_material()
        material, fclass, n_cell_elim, n_facet_elim = mesh.filter_small_cells(
            filter_tol, block_id, fclass, surf_id
        )
        self.elim_counts = (n_cell_elim, n_facet_elim)
        cells = np.where(material == block_id)[0]
        facets = np.where(fclass == surf_id)[0]
        # "lap": only the basis Laplacian is ever used below — shipping the
        # full 4D Hessian through the chunked assembly scan OOMs at bench
        # scale (21x lane-padding on the tiny (dim,dim) axes, round 4)
        self.cell_dom = build_cell_domain(
            self.space, cells, k, with_hessian="lap", dtype=dtype
        )
        self.facet_dom = build_facet_domain(
            self.space, facets, k, with_hessian="lap", dtype=dtype
        )
        self.form = Form(
            self.space,
            [
                Term(self.cell_dom, self._cell_kernel()),
                Term(self.facet_dom, self._facet_kernel()),
            ],
        )

    def _cell_kernel(self):
        f = self.f

        def kern(u_loc, aux_loc, ctx, params):
            U = u_loc[:, 0]
            lphi = lap_phi(ctx)
            lap_u = lphi @ U
            fx = jax.vmap(f)(ctx.x)
            r = jnp.einsum("q,q,qb->b", ctx.w, lap_u, lphi)
            r = r - jnp.einsum("q,q,qb->b", ctx.w, fx, ctx.phi)
            return r[:, None]

        return kern

    def _facet_kernel(self):
        u_ex, lap_u_ex = self.u_ex, self.lap_u_ex
        sgn, beta, alpha = self.sgn, self.beta, self.alpha
        grad_u_ex = jax.grad(u_ex)

        def kern(u_loc, aux_loc, ctx, params):
            U = u_loc[:, 0]
            n = ctx.n
            h = ctx.h
            lphi = lap_phi(ctx)
            gphin = jnp.einsum("qbd,d->qb", ctx.gphi, n)
            uq = ctx.phi @ U
            lap_u = lphi @ U
            gun = gphin @ U
            gq = jax.vmap(u_ex)(ctx.x)
            ggn = jnp.einsum("qd,d->q", jax.vmap(grad_u_ex)(ctx.x), n)

            w = ctx.w
            # − ∫ Δu (∇v·n)  (biharmonic.py:201)
            r = -jnp.einsum("q,q,qb->b", w, lap_u, gphin)
            # − sgn ∫ Δv (∇u·n − ∇g·n)  (:204, :210)
            r = r - sgn * jnp.einsum("q,q,qb->b", w, gun - ggn, lphi)
            # + β h⁻¹ ∫ (∇u·n − ∇g·n)(∇v·n)  (:205, :211)
            r = r + (beta / h) * jnp.einsum("q,q,qb->b", w, gun - ggn, gphin)
            # + α h⁻³ ∫ (u − g) v  (:206, :212)
            r = r + (alpha / h**3) * jnp.einsum("q,q,qb->b", w, uq - gq, ctx.phi)
            return r[:, None]

        return kern

    # -- error norms (biharmonic.py:240-269) -----------------------------------

    def error_norms(self, u_f: jnp.ndarray):
        u_ex, lap_u_ex = self.u_ex, self.lap_u_ex
        grad_u_ex = jax.grad(u_ex)

        def make(fn):
            return lambda u_loc, aux_loc, ctx, params: fn(u_loc, ctx)

        def e_sq(u_loc, ctx):
            e = ctx.phi @ u_loc[:, 0] - jax.vmap(u_ex)(ctx.x)
            return jnp.einsum("q,q->", ctx.w, e**2)

        def ge_sq(u_loc, ctx):
            ge = jnp.einsum("qbd,b->qd", ctx.gphi, u_loc[:, 0]) - jax.vmap(
                grad_u_ex
            )(ctx.x)
            return jnp.einsum("q,qd->", ctx.w, ge**2)

        def edge_sq(u_loc, ctx):
            e = ctx.phi @ u_loc[:, 0] - jax.vmap(u_ex)(ctx.x)
            return jnp.einsum("q,q->", ctx.w, e**2) / ctx.h

        def lap_e_sq(u_loc, ctx):
            lphi = lap_phi(ctx)
            e = lphi @ u_loc[:, 0] - jax.vmap(lap_u_ex)(ctx.x)
            return jnp.einsum("q,q->", ctx.w, e**2)

        def ex_sq(u_loc, ctx):
            g = jax.vmap(u_ex)(ctx.x)
            return jnp.einsum("q,q->", ctx.w, g**2)

        def gex_sq(u_loc, ctx):
            g = jax.vmap(grad_u_ex)(ctx.x)
            return jnp.einsum("q,qd->", ctx.w, g**2)

        def edge_ex_sq(u_loc, ctx):
            g = jax.vmap(u_ex)(ctx.x)
            return jnp.einsum("q,q->", ctx.w, g**2) / ctx.h

        def lap_ex_sq(u_loc, ctx):
            g = jax.vmap(lap_u_ex)(ctx.x)
            return jnp.einsum("q,q->", ctx.w, g**2)

        cd, fd = self.cell_dom, self.facet_dom
        nL2 = integrate(cd, make(e_sq), u_f)
        nH10 = integrate(cd, make(ge_sq), u_f)
        nEdge = integrate(fd, make(edge_sq), u_f)
        nH20 = integrate(cd, make(lap_e_sq), u_f)
        L2 = integrate(cd, make(ex_sq), u_f)
        H10 = integrate(cd, make(gex_sq), u_f)
        edge = integrate(fd, make(edge_ex_sq), u_f)
        H20 = integrate(cd, make(lap_ex_sq), u_f)

        nH1 = nL2 + nH10 + nEdge
        nH2 = nH1 + nH20
        H1 = L2 + H10 + edge
        H2 = H1 + H20
        return {
            "L2": float(jnp.sqrt(nL2)),
            "H1": float(jnp.sqrt(nH1)),
            "H2": float(jnp.sqrt(nH2)),
            "L2_rel": float(jnp.sqrt(nL2) / jnp.sqrt(L2)),
            "H1_rel": float(jnp.sqrt(nH1) / jnp.sqrt(H1)),
            "H2_rel": float(jnp.sqrt(nH2) / jnp.sqrt(H2)),
        }
