"""Geometrically nonlinear Kirchhoff-Love shell (St. Venant-Kirchhoff).

Parity with demos/cut_shell.py:178-314 and demos/pinned_shell.py:104-214:

* midsurface map X = F(ξ) (parabolic tab F=[ξ0,ξ1,½(1−ξ0²)], cut_shell.py:178;
  flat square for the pinned variant, pinned_shell.py:109);
* shell differential geometry from scratch: covariant bases, metric a,
  curvature b via the derivative of the unit normal (shellGeometry,
  cut_shell.py:207-223), local Cartesian via Gram-Schmidt (cartesian,
  :232-249), Voigt strains (:259-260);
* SVK energy: W = ½(ε̄·n̄ + κ̄·m̄) J_vol, n̄ = h D ε̄, m̄ = h³ D κ̄ /12
  (:270-284) — the residual is the energy gradient (dWint = derivative(Wint),
  :286) and the Jacobian its Hessian, both by nested JAX autodiff at cell
  level (forward-over-reverse), replacing UFL's second variation;
* follower pressure load dWext = −P·t (a2 · v) dx (non-conservative,
  :311) and penalty edge pinning with the reference-surface J_surf (:312).

The curvature needs second parametric derivatives: for degree-2 fields on
affine cells these are the physical Hessian tables; the analytic reference
surface contributes via jax.jacfwd of F.
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
)


def unit(v):
    return v / jnp.sqrt(v @ v)


def shell_geometry(dx, ddx):
    """(a0, a1, a2, a, b) from first/second parametric derivatives of the
    midsurface map (shellGeometry, cut_shell.py:207-223).

    dx: (3, 2) columns are covariant bases; ddx: (3, 2, 2).
    """
    a0, a1 = dx[:, 0], dx[:, 1]
    c = jnp.cross(a0, a1)
    norm_c = jnp.sqrt(c @ c)
    a2 = c / norm_c
    a = jnp.array([[a0 @ a0, a0 @ a1], [a1 @ a0, a1 @ a1]])
    # d a2 / d xi_beta via the quotient rule
    dc = jnp.stack(
        [
            jnp.cross(ddx[:, 0, b], a1) + jnp.cross(a0, ddx[:, 1, b])
            for b in range(2)
        ],
        axis=1,
    )  # (3, 2)
    da2 = (dc - jnp.outer(a2, a2 @ dc)) / norm_c
    b_mat = -jnp.array(
        [[a0 @ da2[:, 0], a0 @ da2[:, 1]], [a1 @ da2[:, 0], a1 @ da2[:, 1]]]
    )
    return a0, a1, a2, a, b_mat


def cartesian(T, a, a0, a1):
    """Change of basis to the local Cartesian frame (cut_shell.py:232-249)."""
    ac = jnp.linalg.inv(a)
    a0c = ac[0, 0] * a0 + ac[0, 1] * a1
    a1c = ac[1, 0] * a0 + ac[1, 1] * a1
    e0 = unit(a0)
    e1 = unit(a1 - e0 * (a1 @ e0))
    ea = jnp.array([[e0 @ a0c, e0 @ a1c], [e1 @ a0c, e1 @ a1c]])
    return ea @ T @ ea.T


def voigt(T):
    return jnp.array([T[0, 0], T[1, 1], 2.0 * T[0, 1]])


class KLShellProblem:
    """Cut/pinned Kirchhoff-Love SVK shell on an immersed 2D parametric mesh.

    surface_fn: ξ (2,) -> X (3,) analytic midsurface (reference config).
    Residual params: {'t': load factor} for the follower pressure variant.
    """

    def __init__(
        self,
        mesh: Mesh,
        surface_fn,
        E: float = 3e4,
        nu: float = 0.3,
        h_th: float = 0.03,
        pressure: float = 2.0,          # follower load magnitude (cut_shell.py:293)
        areal_force: float | None = None,  # fixed vertical load (pinned_shell.py:52)
        pin_alpha: float = 1e5,         # alpha_d (cut_shell.py:290)
        pin_mode: str = "boundary",     # 'boundary' (cut) | 'interface' (pinned)
        pin_alpha_scale: str = "hmin",  # E/hmin (cut) | h_th*E/h_facet (pinned)
        use_jvol: bool = True,
        block_id: int = 2,
        dtype=None,
    ):
        if dtype is None:
            dtype = np.float64 if jax.config.jax_enable_x64 else np.float32
        k = 2
        self.mesh = mesh
        self.space = FunctionSpace(mesh, degree=k, n_fields=3)
        self.E, self.nu, self.h_th = float(E), float(nu), float(h_th)
        self.pressure = float(pressure)
        self.areal_force = areal_force
        self.pin_alpha = float(pin_alpha)
        self.pin_mode = pin_mode
        self.pin_alpha_scale = pin_alpha_scale
        self.use_jvol = use_jvol
        self.surface_fn = surface_fn
        self.dX = jax.jacfwd(surface_fn)
        self.ddX = jax.jacfwd(self.dX)
        # material matrix D (cut_shell.py:270-272)
        self.D = (E / (1.0 - nu * nu)) * jnp.array(
            [[1.0, nu, 0.0], [nu, 1.0, 0.0], [0.0, 0.0, 0.5 * (1.0 - nu)]]
        )
        self.hmin = mesh.hmin()

        qd = 2 * k  # quadrature_degree k*2 (cut_shell.py:110-120)
        cells = np.where(mesh.material == block_id)[0]
        self.cell_dom = build_cell_domain(
            self.space, cells, qd, with_hessian=True, dtype=dtype
        )
        terms = [Term(self.cell_dom, self._cell_kernel())]

        pin_facets = self._pin_facets()
        if len(pin_facets):
            self.pin_dom = build_facet_domain(
                self.space, pin_facets, qd, dtype=dtype
            )
            terms.append(Term(self.pin_dom, self._pin_kernel()))
        self.form = Form(self.space, terms)

    # -- facet selection -------------------------------------------------------

    def _pin_facets(self):
        mesh = self.mesh
        fd = mesh.facet_data
        if self.pin_mode == "interface":
            # pinned_shell.py:212-214: dS on the immersed boundary (class 3)
            return np.where(mesh.classify_facets_by_material() == 3)[0]
        # cut_shell.py:93-98: exterior facets with midpoint x = ±1
        bdry = fd.facet_cells[:, 1] < 0
        mid = mesh.coords[fd.facets].mean(axis=1)
        pinned = bdry & (
            np.isclose(np.abs(mid[:, 0]), 1.0, atol=1e-6)
        )
        return np.where(pinned)[0]

    # -- kernels ---------------------------------------------------------------

    def _geometry_at(self, xi, u_q, gu_q, hu_q):
        """Deformed + reference shell quantities at one quadrature point.

        u_q (3,), gu_q (3,2), hu_q (3,2,2) are the displacement and its
        parametric derivatives.
        """
        dXq = self.dX(xi)          # (3,2)
        ddXq = self.ddX(xi)        # (3,2,2)
        A0, A1, A2, A, B = shell_geometry(dXq, ddXq)
        a0, a1, a2, a, b = shell_geometry(dXq + gu_q, ddXq + hu_q)
        return (A0, A1, A2, A, B), (a0, a1, a2, a, b)

    def _energy_density(self, xi, gu_q, hu_q):
        """SVK strain energy per unit reference area (cut_shell.py:225-284)."""
        dXq = self.dX(xi)
        ref, cur = self._geometry_at(xi, None, gu_q, hu_q)
        A0, A1, A2, A, B = ref
        a0, a1, a2, a, b = cur
        epsilon = 0.5 * (a - A)
        kappa = B - b
        epsilonBar = cartesian(epsilon, A, A0, A1)
        kappaBar = cartesian(kappa, A, A0, A1)
        eV, kV = voigt(epsilonBar), voigt(kappaBar)
        nBar = self.h_th * (self.D @ eV)
        mBar = (self.h_th**3) * (self.D @ kV) / 12.0
        W = 0.5 * (eV @ nBar + kV @ mBar)
        if self.use_jvol:
            g = dXq.T @ dXq
            W = W * jnp.sqrt(jnp.linalg.det(g))  # J_vol (cut_shell.py:191)
        return W

    def _cell_kernel(self):
        pressure = self.pressure
        areal = self.areal_force

        def kern(u_loc, aux_loc, ctx, params):
            nq = ctx.phi.shape[0]

            def Wtotal(ul):
                total = 0.0
                for q in range(nq):
                    gu = jnp.einsum("bd,bf->fd", ctx.gphi[q], ul)
                    hu = jnp.einsum("bde,bf->fde", ctx.hess[q], ul)
                    total = total + ctx.w[q] * self._energy_density(
                        ctx.x[q], gu, hu
                    )
                return total

            r = jax.grad(Wtotal)(u_loc)  # internal-energy variation (:286)

            for q in range(nq):
                gu = jnp.einsum("bd,bf->fd", ctx.gphi[q], u_loc)
                hu = jnp.einsum("bde,bf->fde", ctx.hess[q], u_loc)
                _, cur = self._geometry_at(ctx.x[q], None, gu, hu)
                a2 = cur[2]
                if areal is None:
                    # follower pressure dWext = −P·t (a2·v) dx (:311)
                    t = params["t"]
                    r = r - ctx.w[q] * pressure * t * jnp.einsum(
                        "b,f->bf", ctx.phi[q], a2
                    )
                else:
                    # fixed load −f·v dx, f = (0,0,areal) (pinned_shell.py:212)
                    f = jnp.array([0.0, 0.0, areal])
                    r = r - ctx.w[q] * jnp.einsum("b,f->bf", ctx.phi[q], f)
            return r

        return kern

    def _pin_kernel(self):
        alpha, E, h_th = self.pin_alpha, self.E, self.h_th
        hmin = self.hmin
        dX = self.dX
        scale_mode = self.pin_alpha_scale
        use_jsurf = self.use_jvol

        def kern(u_loc, aux_loc, ctx, params):
            # penalty: scale · (u − u_pre)·v [J_surf] ds, u_pre = 0
            nq = ctx.phi.shape[0]
            r = jnp.zeros_like(u_loc)
            for q in range(nq):
                uq = ctx.phi[q] @ u_loc  # (3,)
                if scale_mode == "hmin":
                    scale = alpha * E / hmin          # cut_shell.py:312
                else:
                    scale = alpha * h_th * E / ctx.h  # pinned_shell.py:213
                w = ctx.w[q]
                if use_jsurf:
                    dXq = dX(ctx.x[q])
                    g = dXq.T @ dXq
                    ginv = jnp.linalg.inv(g)
                    N = ctx.n
                    w = w * jnp.sqrt(
                        jnp.linalg.det(g) * (N @ (ginv @ N))
                    )  # J_surf (cut_shell.py:193)
                r = r + w * scale * jnp.einsum("b,f->bf", ctx.phi[q], uq)
            return r

        return kern

    # -- point evaluation (tracker points, cut_shell.py:396-398) ---------------

    def evaluate(self, u_f: jnp.ndarray, points: np.ndarray) -> np.ndarray:
        from iifea.mesh.generators import locate_cells

        mesh = self.mesh
        pts = np.atleast_2d(points)
        cells = locate_cells(mesh, pts, tol=1e-9)
        out = np.zeros((len(pts), 3))
        u = np.asarray(u_f).reshape(-1, 3)
        el = self.space.element
        cd = np.asarray(self.space.cell_dofs)
        for i, (p, c) in enumerate(zip(pts, cells)):
            if c < 0:
                out[i] = np.nan
                continue
            verts = mesh.cell_coords[c]
            J = (verts[1:] - verts[:1]).T
            ref = np.linalg.solve(J, p - verts[0])
            phi = el.tabulate(ref[None, :])[0]
            out[i] = phi @ u[cd[c]]
        return out
