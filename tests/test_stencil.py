"""Stencil extraction vs the general matrix-free operator."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from iifea.mesh.generators import immersed_square_problem
from iifea.models.poisson import PoissonProblem
from iifea.ops.projection import BackgroundOperator
from iifea.ops.stencil import StencilOperator2D


def test_stencil_matches_general_operator():
    n_bg = 16
    mesh_f, M = immersed_square_problem(n_fg=24, n_bg=n_bg)
    prob = PoissonProblem(mesh_f, k=1, sym=True, beta_value=10)
    blocks = prob.form.jacobian_blocks(jnp.zeros(prob.space.n_dofs))
    A = BackgroundOperator(prob.form, blocks, M)

    S = StencilOperator2D.probe(A.mv, (n_bg + 1, n_bg + 1), radius=2,
                                dtype=jnp.float64)
    err = S.verify(A.mv, n_checks=3)
    assert err < 1e-12, err
    # diag matches the exact device diagonal
    assert np.allclose(np.asarray(S.diag()), np.asarray(A.diag()), atol=1e-12)


def test_stencil_cg_solves():
    from iifea.solvers import krylov
    from iifea.solvers.precond import jacobi

    n_bg = 16
    mesh_f, M = immersed_square_problem(n_fg=24, n_bg=n_bg)
    prob = PoissonProblem(mesh_f, k=1)
    u0 = jnp.zeros(prob.space.n_dofs)
    blocks = prob.form.jacobian_blocks(u0)
    A = BackgroundOperator(prob.form, blocks, M)
    b = M.rmv(-prob.form.residual(u0))
    S = StencilOperator2D.probe(A.mv, (n_bg + 1, n_bg + 1), radius=2,
                                dtype=jnp.float64)
    d = S.diag()
    d = jnp.where(jnp.abs(d) > 0, d, 1.0)
    x, info = krylov.cg(S.mv, b, minv=jacobi(d), rtol=1e-11)
    x_ref, _ = krylov.cg(A.mv, b, minv=jacobi(A.diag()), rtol=1e-11)
    assert np.allclose(np.asarray(x), np.asarray(x_ref), atol=1e-8)


def test_stencil3d_matches_general_operator():
    from iifea.mesh.generators import immersed_cube_problem
    from iifea.ops.stencil import StencilOperator3D

    n_bg = 6
    mesh_f, M = immersed_cube_problem(n_fg=10, n_bg=n_bg)
    prob = PoissonProblem(mesh_f, k=1, sym=True, beta_value=10)
    blocks = prob.form.jacobian_blocks(jnp.zeros(prob.space.n_dofs))
    A = BackgroundOperator(prob.form, blocks, M)

    S = StencilOperator3D.probe_multi(
        A.mv_multi, (n_bg + 1,) * 3, radius=2, dtype=jnp.float64
    )
    err = S.verify(A.mv, n_checks=2)
    assert err < 1e-12, err
    assert np.allclose(np.asarray(S.diag()), np.asarray(A.diag()), atol=1e-12)


def test_block_stencil_matches_general_operator():
    """Coupled 2-field operator on a lattice background: block probing is
    exact (elasticity/NS fast-path machinery)."""
    from iifea.mesh.core import FunctionSpace
    from iifea.mesh.generators import immersed_square_problem
    from iifea.ops.assembly import Form, Term, build_cell_domain
    from iifea.ops.stencil import StencilOperatorBlock2D

    n_bg = 8
    mesh_f, M = immersed_square_problem(n_fg=14, n_bg=n_bg, n_fields=2)
    V = FunctionSpace(mesh_f, degree=1, n_fields=2)

    def coupled_kernel(u_loc, aux_loc, ctx, params):
        # vector Laplacian + symmetric field coupling (grad u0 . grad u1)
        g0 = jnp.einsum("qbd,b->qd", ctx.gphi, u_loc[:, 0])
        g1 = jnp.einsum("qbd,b->qd", ctx.gphi, u_loc[:, 1])
        r0 = jnp.einsum("q,qd,qbd->b", ctx.w, g0 + 0.3 * g1, ctx.gphi)
        r1 = jnp.einsum("q,qd,qbd->b", ctx.w, g1 + 0.3 * g0, ctx.gphi)
        u0 = jnp.einsum("qb,b->q", ctx.phi, u_loc[:, 0])
        u1 = jnp.einsum("qb,b->q", ctx.phi, u_loc[:, 1])
        r0 = r0 + jnp.einsum("q,q,qb->b", ctx.w, u0 + 0.5 * u1, ctx.phi)
        r1 = r1 + jnp.einsum("q,q,qb->b", ctx.w, u1 + 0.5 * u0, ctx.phi)
        return jnp.stack([r0, r1], axis=1)

    cells = np.where(mesh_f.material == 2)[0]
    dom = build_cell_domain(V, cells, 2)
    form = Form(V, [Term(dom, coupled_kernel)])
    blocks = form.jacobian_blocks(jnp.zeros(V.n_dofs))
    A = BackgroundOperator(form, blocks, M)

    S = StencilOperatorBlock2D.probe_multi(
        A.mv_multi, (n_bg + 1, n_bg + 1), n_fields=2, radius=2,
        dtype=jnp.float64,
    )
    err = S.verify(A.mv, n_checks=3)
    assert err < 1e-12, err
    assert np.allclose(np.asarray(S.diag()), np.asarray(A.diag()), atol=1e-12)


def test_probe_multi_chunked_matches_unchunked():
    """Chunked colored probing (bounded-memory lax.map over column chunks)
    matches the single-shot stacked probe to FP reduction-order noise —
    including a chunk size that does not divide the color count."""
    from iifea.mesh.generators import immersed_cube_problem
    from iifea.ops.stencil import StencilOperator3D

    n_bg = 6
    mesh_f, M = immersed_cube_problem(n_fg=10, n_bg=n_bg)
    prob = PoissonProblem(mesh_f, k=1, sym=True, beta_value=10)
    blocks = prob.form.jacobian_blocks(jnp.zeros(prob.space.n_dofs))
    A = BackgroundOperator(prob.form, blocks, M)

    S0 = StencilOperator3D.probe_multi(
        A.mv_multi, (n_bg + 1,) * 3, radius=2, dtype=jnp.float64
    )
    S7 = StencilOperator3D.probe_multi(
        A.mv_multi, (n_bg + 1,) * 3, radius=2, dtype=jnp.float64, chunk=7
    )
    # 7 does not divide 125: exercises the zero-padded tail chunk
    assert np.allclose(
        np.asarray(S0.coeffs), np.asarray(S7.coeffs), atol=1e-13, rtol=0
    )


def test_probe_chunk_sizing():
    from iifea.solvers.ksp import _probe_chunk

    from iifea.mesh.generators import immersed_cube_problem

    n_bg = 6
    mesh_f, M = immersed_cube_problem(n_fg=10, n_bg=n_bg)
    prob = PoissonProblem(mesh_f, k=1)
    blocks = prob.form.jacobian_blocks(jnp.zeros(prob.space.n_dofs))
    A = BackgroundOperator(prob.form, blocks, M)
    c = _probe_chunk(A, jnp.float64)
    assert c is not None and c >= 1
    # tiny problem: the budget admits far more columns than any probe uses
    assert c > 343


# -- shifted-FMA apply and smoother vs independent sparse references ----------

def _stencil_csr(C, shape, radius):
    """scipy CSR of y[p] = Σ_d C[d, p] x[p + d] over in-grid neighbours,
    built straight from the coefficient planes (offsets in row-major
    (oi, oj[, ok]) order, as ops/stencil.py stores them)."""
    import itertools

    import scipy.sparse as sp

    shape = tuple(shape)
    r = radius
    idx = np.arange(int(np.prod(shape))).reshape(shape)
    rows, cols, vals = [], [], []
    offs = itertools.product(range(-r, r + 1), repeat=len(shape))
    for k, off in enumerate(offs):
        src = tuple(slice(max(0, -o), s - max(0, o)) for o, s in zip(off, shape))
        dst = tuple(slice(max(0, o), s - max(0, -o)) for o, s in zip(off, shape))
        rows.append(idx[src].ravel())
        cols.append(idx[dst].ravel())
        vals.append(np.asarray(C[k])[src].ravel())
    n = idx.size
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )


def _random_stencil(shape, radius, seed):
    from iifea.ops.stencil import StencilOperator3D

    rng = np.random.default_rng(seed)
    m = (2 * radius + 1) ** len(shape)
    C = rng.standard_normal((m,) + tuple(shape))
    op = StencilOperator2D if len(shape) == 2 else StencilOperator3D
    x = rng.standard_normal(int(np.prod(shape)))
    return op(jnp.asarray(C), shape, radius), C, x


@pytest.mark.parametrize("shape", [(17, 17), (33, 129), (40, 200)])
@pytest.mark.parametrize("radius", [1, 2])
def test_mv_matches_sparse_matrix_2d(shape, radius):
    S, C, x = _random_stencil(shape, radius, seed=0)
    y = np.asarray(jax.jit(S.mv)(jnp.asarray(x)))
    y_ref = _stencil_csr(C, shape, radius) @ x
    assert np.allclose(y, y_ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", [(9, 9, 9), (13, 10, 17)])
@pytest.mark.parametrize("radius", [1, 2])
def test_mv_matches_sparse_matrix_3d(shape, radius):
    S, C, x = _random_stencil(shape, radius, seed=3)
    y = np.asarray(jax.jit(S.mv)(jnp.asarray(x)))
    y_ref = _stencil_csr(C, shape, radius) @ x
    assert np.allclose(y, y_ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape,radius", [
    ((21, 35), 2), ((11, 9, 14), 1), ((11, 9, 14), 2),
])
def test_jacobi_sweeps_match_numpy(shape, radius):
    """The multigrid smoother: x ← x + ω·invd·(b − A x), three sweeps."""
    from iifea.ops.multigrid import jacobi_sweeps

    S, C, x = _random_stencil(shape, radius, seed=1)
    rng = np.random.default_rng(2)
    b = rng.standard_normal(x.size)
    invd = rng.uniform(0.5, 2.0, x.size) / C.shape[0]
    om = 0.67
    got = jax.jit(jacobi_sweeps, static_argnums=5)(
        S, jnp.asarray(invd), jnp.asarray(b), jnp.asarray(x), om, 3)
    A = _stencil_csr(C, shape, radius)
    want = x
    for _ in range(3):
        want = want + om * invd * (b - A @ want)
    assert np.allclose(np.asarray(got), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", [(13, 37), (7, 13, 10)])
def test_pytree_roundtrip_keeps_logical_planes(shape):
    """Coefficient planes are stored unpadded, ((2r+1)^d, *shape), and
    survive flatten/unflatten, astype and a jit boundary unchanged."""
    S, C, _ = _random_stencil(shape, 1, seed=5)
    assert S.coeffs.shape == C.shape
    leaves, td = jax.tree_util.tree_flatten(S)
    assert [leaf.shape for leaf in leaves] == [C.shape]
    S2 = jax.tree_util.tree_unflatten(td, leaves)
    assert (S2.shape, S2.radius, S2.n) == (S.shape, S.radius, S.n)
    S3 = jax.jit(lambda s: s)(S2.astype(jnp.float32))
    assert S3.dtype == jnp.float32 and S3.coeffs.shape == C.shape
    assert np.array_equal(np.asarray(S3.coeffs), C.astype(np.float32))
