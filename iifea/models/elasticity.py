"""2D linear elasticity of a plate with a hole (Kirsch problem).

Weak-form parity with demos/linear_elasticity.py:

  A_h = ∫_plate σ(u) : ∇v dx                                 (:247)
  traction (Neumann) from the exact stress on top/right edges  (:251-252)
  normal-direction Nitsche + penalty on the symmetry edges     (:254-258):
      -sgn (σ(v)n·n)(u·n - g) - (σ(u)n·n)(v·n) + β h⁻¹ (u·n - g)(v·n),
      β = 10 μ, g = 0
  res = A_h + nitsche + penalty - L_h                          (:261)

Material parameters replicate the reference *verbatim*, including its use of
the bulk modulus K in place of λ in the constitutive law (the demo calls
``problem(u, K, mu)`` with ``problem(u, lam, mu)`` — linear_elasticity.py:232,
:57-62): σ = 2 μ ε + K tr(ε) I.

The Kirsch exact solution (:29-55) is implemented in closed form with JAX so
its stress enters the traction terms and the error norm by autodiff-free
evaluation, exactly as the UFL expression does.
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
)

HOLE_ID, PLATE_ID, RIM_ID = 1, 2, 3
LEFT_ID, BOTTOM_ID, TOP_ID, RIGHT_ID = 5, 6, 7, 8


def classify_elasticity_facets(mesh: Mesh, plate_extent: float = 4.0):
    """The signed facet classifier of linear_elasticity.py:160-197.

    marker = (|marker| + material) * (-1)^c_count over adjacent cells:
    boundary facets get -material; interior get the material sum. Exterior
    plate facets are split by midpoint coordinates into left/bottom/top/right.
    """
    fd = mesh.facet_data
    c0, c1 = fd.facet_cells[:, 0], fd.facet_cells[:, 1]
    m0 = mesh.material[c0]
    has2 = c1 >= 0
    m1 = np.where(has2, mesh.material[np.maximum(c1, 0)], 0)
    marker = np.where(has2, m0 + m1, -m0)

    out = np.zeros(mesh.num_facets, dtype=np.int32)
    out[marker == 4] = PLATE_ID
    out[(marker == 2) | (marker == -1)] = HOLE_ID
    out[marker == 3] = RIM_ID

    # boundary facets of the plate: classify by midpoint (reference uses
    # exact float equality on coordinates; we use a tight tolerance)
    bdry = marker == -2
    fverts = mesh.coords[fd.facets]
    mid = fverts.mean(axis=1)
    tol = 1e-12
    out[bdry & (np.abs(mid[:, 0]) < tol)] = LEFT_ID
    out[bdry & (np.abs(mid[:, 1]) < tol)] = BOTTOM_ID
    out[bdry & (np.abs(mid[:, 1] - plate_extent) < tol)] = TOP_ID
    out[bdry & (np.abs(mid[:, 0] - plate_extent) < tol)] = RIGHT_ID
    return out


def kirsch_exact(R, sig_inf, E, nu, x_origin=0.0, y_origin=0.0):
    """Analytic Kirsch fields (linear_elasticity.py:29-55), including the
    reference's +tol regularization of 1/r."""
    tol = 0.0001

    def fields(x):
        xs = x[0] - x_origin
        ys = x[1] - y_origin
        r = jnp.sqrt(xs * xs + ys * ys)
        theta = jnp.arctan(ys / xs)
        sig_rr = sig_inf * (1 - (R / (r + tol)) ** 2)
        sig_tt = sig_inf * (1 + (R / (r + tol)) ** 2)
        sig_polar = jnp.array([[sig_rr, 0.0], [0.0, sig_tt]])
        c, s = jnp.cos(theta), jnp.sin(theta)
        Q = jnp.array([[c, -s], [s, c]])
        sig_cart = Q @ sig_polar @ Q.T
        eps_cart = (1 / E) * (
            (1 + nu) * sig_cart - nu * jnp.trace(sig_cart) * jnp.eye(2)
        )
        C1 = (1 + nu) * (1 - 2 * nu) * sig_inf / E
        C2 = (1 + nu) * R * R * sig_inf / E
        u_r = C1 * r + C2 / r
        u_cart = Q @ jnp.array([u_r, 0.0])
        return sig_cart, eps_cart, u_cart

    return fields


def sigma_of(K_bulk, mu):
    """σ = 2 μ sym(∇u) + K tr(ε) I (linear_elasticity.py:57-62 as called)."""

    def sigma(grad_u):
        eps = 0.5 * (grad_u + grad_u.T)
        return 2.0 * mu * eps + K_bulk * jnp.trace(eps) * jnp.eye(2)

    return sigma


class ElasticityProblem:
    def __init__(
        self,
        mesh: Mesh,
        k: int = 1,
        E: float = 200e9,
        nu: float = 0.3,
        sym: bool = True,
        hole_radius: float = 1.0,
        sig_inf: float = 1e6,
        plate_extent: float = 4.0,
        dtype=None,
    ):
        if dtype is None:
            dtype = np.float64 if jax.config.jax_enable_x64 else np.float32
        self.mesh = mesh
        self.space = FunctionSpace(mesh, degree=k, n_fields=2)
        # material constants exactly as linear_elasticity.py:109-111
        lam = (E * nu) / ((1 + nu) * (1 - nu))
        K_bulk = E / (3 * (1 - 2 * nu))
        mu = (3 / 2) * (K_bulk - lam)
        self.K_bulk, self.mu = K_bulk, mu
        self.sgn = 1.0 if sym else -1.0
        self.beta = 10.0 * mu  # linear_elasticity.py:238
        self.sigma = sigma_of(K_bulk, mu)
        self.exact = kirsch_exact(hole_radius, sig_inf, E, nu)

        fclass = classify_elasticity_facets(mesh, plate_extent)
        cells = np.where(mesh.material == PLATE_ID)[0]
        self.cell_dom = build_cell_domain(self.space, cells, k, dtype=dtype)
        dom = lambda ids: build_facet_domain(
            self.space, ids, k, dtype=dtype
        )
        self.neumann_dom = dom(
            np.where((fclass == TOP_ID) | (fclass == RIGHT_ID))[0]
        )
        self.sym_dom = dom(
            np.where((fclass == LEFT_ID) | (fclass == BOTTOM_ID))[0]
        )
        self.form = Form(
            self.space,
            [
                Term(self.cell_dom, self._cell_kernel()),
                Term(self.neumann_dom, self._traction_kernel()),
                Term(self.sym_dom, self._nitsche_kernel()),
            ],
        )

    def _cell_kernel(self):
        sigma = self.sigma

        def kern(u_loc, aux_loc, ctx, params):
            # grad u (nq, 2 fields, dim): gu[f,d] = du_f/dx_d
            gu = jnp.einsum("qbd,bf->qfd", ctx.gphi, u_loc)
            sig = jax.vmap(sigma)(gu)                  # (nq, 2, 2)
            # r[b,f] = Σ_q w σ : ∇(φ_b e_f) = Σ_q w σ[f,d] ∇φ_b[d]
            return jnp.einsum("q,qfd,qbd->bf", ctx.w, sig, ctx.gphi)

        return kern

    def _traction_kernel(self):
        exact = self.exact

        def kern(u_loc, aux_loc, ctx, params):
            def t_of(x):
                sig, _, _ = exact(x)
                return sig

            sig_ex = jax.vmap(t_of)(ctx.x)             # (nq, 2, 2)
            tr = jnp.einsum("qfd,d->qf", sig_ex, ctx.n)
            # res includes -L_h: traction enters negatively
            return -jnp.einsum("q,qf,qb->bf", ctx.w, tr, ctx.phi)

        return kern

    def _nitsche_kernel(self):
        sigma, sgn, beta = self.sigma, self.sgn, self.beta

        def kern(u_loc, aux_loc, ctx, params):
            n = ctx.n
            gu = jnp.einsum("qbd,bf->qfd", ctx.gphi, u_loc)
            sig_u = jax.vmap(sigma)(gu)
            sigu_nn = jnp.einsum("qfd,f,d->q", sig_u, n, n)
            un = jnp.einsum("qb,bf,f->q", ctx.phi, u_loc, n)  # u·n
            # test-function quantities: v = φ_b e_f
            phin = jnp.einsum("qb,f->qbf", ctx.phi, n)        # (v·n) factor
            # σ(v)n·n for v = φ_b e_f: 2μ sym(∇v)(n,n)+K div(v) with
            # ∇v[f,d] = e_f ∂φ_b/∂x_d handled by autodiff-free algebra:
            # σ(v)[i,j] = μ(δ_if ∂φ_b/∂x_j + δ_jf ∂φ_b/∂x_i)+K ∂φ_b/∂x_f δ_ij
            gphin = jnp.einsum("qbd,d->qb", ctx.gphi, n)
            K_bulk, mu = self.K_bulk, self.mu
            sigv_nn = 2 * mu * jnp.einsum("qb,f->qbf", gphin, n) \
                + K_bulk * ctx.gphi  # (qbf): K ∂φ_b/∂x_f from δ_ij n_i n_j = 1
            sigv_nn = jnp.einsum("qbf->qbf", sigv_nn)
            # assemble the three terms (linear_elasticity.py:257-258)
            r = -sgn * jnp.einsum("q,qbf,q->bf", ctx.w, sigv_nn, un)
            r = r - jnp.einsum("q,q,qbf->bf", ctx.w, sigu_nn, phin)
            r = r + (self.beta / ctx.h) * jnp.einsum(
                "q,q,qbf->bf", ctx.w, un, phin
            )
            return r

        return kern

    # -- stress error norm (linear_elasticity.py:340-344) ----------------------

    def stress_error_norm(self, u_f: jnp.ndarray) -> float:
        sigma, exact = self.sigma, self.exact

        def err(u_loc, aux_loc, ctx, params):
            gu = jnp.einsum("qbd,bf->qfd", ctx.gphi, u_loc)
            sig = jax.vmap(sigma)(gu)
            sig_ex = jax.vmap(lambda x: exact(x)[0])(ctx.x)
            e = sig - sig_ex
            return jnp.einsum("q,qfd->", ctx.w, e * e)

        def ref(u_loc, aux_loc, ctx, params):
            sig_ex = jax.vmap(lambda x: exact(x)[0])(ctx.x)
            return jnp.einsum("q,qfd->", ctx.w, sig_ex * sig_ex)

        num = integrate(self.cell_dom, err, u_f, n_fields=2)
        den = integrate(self.cell_dom, ref, u_f, n_fields=2)
        return float(jnp.sqrt(num / den))


# -- synthetic immersed elasticity (manufactured solution) ---------------------


def sigma_nd(lam, mu, dim):
    """Standard isotropic σ = 2 μ ε + λ tr(ε) I in any dimension (the
    synthetic workload uses the textbook λ, not the reference demo's
    K-for-λ call quirk documented above)."""

    def sigma(grad_u):
        eps = 0.5 * (grad_u + grad_u.T)
        return 2.0 * mu * eps + lam * jnp.trace(eps) * jnp.eye(dim)

    return sigma


def u_exact_elasticity(dim: int):
    """Smooth manufactured displacement field (divergence-free-ish mix so
    both μ and λ terms are exercised)."""
    if dim == 2:
        def u_ex(x):
            return jnp.array([
                jnp.sin(jnp.pi * x[0]) * jnp.cos(jnp.pi * x[1]),
                jnp.cos(jnp.pi * x[0]) * jnp.sin(jnp.pi * x[1]) * 0.5,
            ])
    else:
        def u_ex(x):
            return jnp.array([
                jnp.sin(jnp.pi * x[0]) * jnp.cos(jnp.pi * x[1]) * x[2],
                jnp.cos(jnp.pi * x[0]) * jnp.sin(jnp.pi * x[2]) * 0.5,
                jnp.sin(jnp.pi * x[1]) * jnp.cos(jnp.pi * x[2]) * 0.25,
            ])
    return u_ex


def body_force_of(u_ex, sigma):
    """f = −div σ(u_exact) by nested autodiff — the UFL-symbolic-source
    replacement (cf. models/poisson.py source_fn)."""

    def sig_at(x):
        return sigma(jax.jacobian(u_ex)(x))

    def f(x):
        J = jax.jacfwd(sig_at)(x)          # J[i, j, d] = ∂σ_ij/∂x_d
        return -jnp.einsum("ijj->i", J)

    return f


class ImmersedElasticityProblem:
    """Vector elasticity on an immersed block with full-vector Nitsche
    Dirichlet BCs and a manufactured solution.

    The synthetic-lattice analog of the reference's vector workload
    (linear_elasticity.py): same operator class (2-/3-field symmetric
    elliptic system projected through M), but posed on the generated
    immersed square/cube (mesh/generators.py) whose background IS a known
    lattice — which is what lets the linear solve run on device through the
    block geometric multigrid (solve_ksp pc='mg', n_fields=dim) instead of
    host LU. Weak form (symmetric Nitsche):

      ∫ σ(u):∇v dx − ∫_Γ (σ(u)n)·v dS − sgn ∫_Γ (σ(v)n)·(u−g) dS
        + β h⁻¹ ∫_Γ (u−g)·v dS − ∫ f·v dx
    """

    def __init__(
        self,
        mesh: Mesh,
        k: int = 1,
        E: float = 1.0,
        nu: float = 0.3,
        sym: bool = True,
        beta_value: float = 20.0,
        block_id: int = 2,
        surf_id: int = 3,
        u_exact=None,
        dtype=None,
    ):
        if dtype is None:
            dtype = np.float64 if jax.config.jax_enable_x64 else np.float32
        dim = mesh.dim
        self.mesh = mesh
        self.space = FunctionSpace(mesh, degree=k, n_fields=dim)
        lam = (E * nu) / ((1 + nu) * (1 - 2 * nu))
        mu = E / (2 * (1 + nu))
        self.lam, self.mu = lam, mu
        self.sgn = 1.0 if sym else -1.0
        # coercivity needs β ≳ C·(2μ+λ); scale the user constant by it
        self.beta = float(beta_value) * (2 * mu + lam)
        self.sigma = sigma_nd(lam, mu, dim)
        self.u_ex = u_exact or u_exact_elasticity(dim)
        self.f = body_force_of(self.u_ex, self.sigma)

        cells = np.where(mesh.material == block_id)[0]
        fclass = mesh.classify_facets_by_material()
        facets = np.where(fclass == surf_id)[0]
        self.cell_dom = build_cell_domain(self.space, cells, k, dtype=dtype)
        self.facet_dom = build_facet_domain(self.space, facets, k, dtype=dtype)
        self.form = Form(
            self.space,
            [
                Term(self.cell_dom, self._cell_kernel()),
                Term(self.facet_dom, self._nitsche_kernel()),
            ],
        )

    def _cell_kernel(self):
        sigma, f = self.sigma, self.f

        def kern(u_loc, aux_loc, ctx, params):
            gu = jnp.einsum("qbd,bf->qfd", ctx.gphi, u_loc)
            sig = jax.vmap(sigma)(gu)                       # (nq, dim, dim)
            r = jnp.einsum("q,qfd,qbd->bf", ctx.w, sig, ctx.gphi)
            fx = jax.vmap(f)(ctx.x)                         # (nq, dim)
            return r - jnp.einsum("q,qf,qb->bf", ctx.w, fx, ctx.phi)

        return kern

    def _nitsche_kernel(self):
        sigma, sgn, beta = self.sigma, self.sgn, self.beta
        lam, mu, u_ex = self.lam, self.mu, self.u_ex

        def kern(u_loc, aux_loc, ctx, params):
            n = ctx.n
            gu = jnp.einsum("qbd,bf->qfd", ctx.gphi, u_loc)
            sig_u = jax.vmap(sigma)(gu)
            tr_u = jnp.einsum("qid,d->qi", sig_u, n)        # σ(u)n (nq, dim)
            uq = jnp.einsum("qb,bf->qf", ctx.phi, u_loc)    # u (nq, dim)
            gq = jax.vmap(u_ex)(ctx.x)                      # g (nq, dim)
            e = uq - gq                                     # u − g

            # σ(v)n for v = φ_b e_f contracted against a vector e_i:
            #   (σ(v)n)_i = μ(δ_if ∇φ_b·n + n_f ∂_i φ_b) + λ ∂_f φ_b n_i
            # ⇒ Σ_i (σ(v)n)_i e_i
            #   = μ[(∇φ_b·n) e_f + (∇φ_b·e) n_f] + λ (∇φ_b)_f (n·e)
            gphin = jnp.einsum("qbd,d->qb", ctx.gphi, n)    # ∇φ·n
            gphie = jnp.einsum("qbd,qd->qb", ctx.gphi, e)   # ∇φ·e
            ne = jnp.einsum("d,qd->q", n, e)                # n·e
            sigv_e = (
                mu * (jnp.einsum("qb,qf->qbf", gphin, e)
                      + jnp.einsum("qb,f->qbf", gphie, n))
                + lam * jnp.einsum("qbf,q->qbf", ctx.gphi, ne)
            )

            w = ctx.w
            # consistency: −∫ (σ(u)n)·v
            r = -jnp.einsum("q,qf,qb->bf", w, tr_u, ctx.phi)
            # adjoint consistency: −sgn ∫ (σ(v)n)·(u − g)
            r = r - sgn * jnp.einsum("q,qbf->bf", w, sigv_e)
            # penalty: β h⁻¹ ∫ (u − g)·v
            r = r + (beta / ctx.h) * jnp.einsum(
                "q,qf,qb->bf", w, e, ctx.phi
            )
            return r

        return kern

    # -- error norms ------------------------------------------------------------

    def error_norms(self, u_f: jnp.ndarray):
        u_ex = self.u_ex
        ju_ex = jax.jacobian(u_ex)

        def e_sq(u_loc, aux_loc, ctx, params):
            uq = jnp.einsum("qb,bf->qf", ctx.phi, u_loc)
            eq = uq - jax.vmap(u_ex)(ctx.x)
            return jnp.einsum("q,qf->", ctx.w, eq**2)

        def ge_sq(u_loc, aux_loc, ctx, params):
            gu = jnp.einsum("qbd,bf->qfd", ctx.gphi, u_loc)
            ge = gu - jax.vmap(ju_ex)(ctx.x)
            return jnp.einsum("q,qfd->", ctx.w, ge**2)

        def ex_sq(u_loc, aux_loc, ctx, params):
            g = jax.vmap(u_ex)(ctx.x)
            return jnp.einsum("q,qf->", ctx.w, g**2)

        def gex_sq(u_loc, aux_loc, ctx, params):
            g = jax.vmap(ju_ex)(ctx.x)
            return jnp.einsum("q,qfd->", ctx.w, g**2)

        cd = self.cell_dom
        nf = self.space.n_fields
        nL2 = integrate(cd, e_sq, u_f, n_fields=nf)
        nH10 = integrate(cd, ge_sq, u_f, n_fields=nf)
        L2 = integrate(cd, ex_sq, u_f, n_fields=nf)
        H10 = integrate(cd, gex_sq, u_f, n_fields=nf)
        return {
            "L2": float(jnp.sqrt(nL2 / L2)),
            "H10": float(jnp.sqrt(nH10 / H10)),
        }
