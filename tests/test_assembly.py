"""Assembly engine vs hand-computed element matrices and dense references."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from iifea.mesh.core import FunctionSpace, Mesh
from iifea.mesh.generators import rectangle_mesh
from iifea.ops.assembly import Form, Term, build_cell_domain, integrate


def laplace_kernel(u_loc, aux_loc, ctx, params):
    gu = jnp.einsum("qbd,b->qd", ctx.gphi, u_loc[:, 0])
    return jnp.einsum("q,qd,qbd->b", ctx.w, gu, ctx.gphi)[:, None]


def mass_kernel(u_loc, aux_loc, ctx, params):
    uq = jnp.einsum("qb,b->q", ctx.phi, u_loc[:, 0])
    return jnp.einsum("q,q,qb->b", ctx.w, uq, ctx.phi)[:, None]


def unit_triangle_mesh():
    coords = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    cells = np.array([[0, 1, 2]])
    return Mesh(coords, cells)


def test_p1_stiffness_unit_triangle():
    mesh = unit_triangle_mesh()
    V = FunctionSpace(mesh, 1)
    dom = build_cell_domain(V, np.array([0]), 2)
    form = Form(V, [Term(dom, laplace_kernel)])
    K = form.jacobian_blocks(jnp.zeros(3))[0][..., 0]
    # classic P1 stiffness on the unit right triangle
    expected = np.array([[1.0, -0.5, -0.5], [-0.5, 0.5, 0.0], [-0.5, 0.0, 0.5]])
    assert np.allclose(np.asarray(K), expected, atol=1e-14)


def test_p1_mass_unit_triangle():
    mesh = unit_triangle_mesh()
    V = FunctionSpace(mesh, 1)
    dom = build_cell_domain(V, np.array([0]), 2)
    form = Form(V, [Term(dom, mass_kernel)])
    K = form.jacobian_blocks(jnp.zeros(3))[0][..., 0]
    expected = (1 / 24) * np.array([[2, 1, 1], [1, 2, 1], [1, 1, 2]])
    assert np.allclose(np.asarray(K), expected, atol=1e-14)


@pytest.mark.parametrize("deg", [1, 2])
def test_mass_matrix_total_equals_area(deg):
    mesh = rectangle_mesh((0, 0), (2, 1), 4, 3)
    V = FunctionSpace(mesh, deg)
    dom = build_cell_domain(V, np.arange(mesh.n_cells), 2 * deg)
    form = Form(V, [Term(dom, mass_kernel)])
    ones = jnp.ones(V.n_dofs)
    # 1ᵀ M 1 = area
    r = form.residual(ones)
    assert abs(float(ones @ r) - 2.0) < 1e-12


@pytest.mark.parametrize("deg", [1, 2])
def test_stiffness_annihilates_linears(deg):
    mesh = rectangle_mesh((0, 0), (1, 1), 3, 3)
    V = FunctionSpace(mesh, deg)
    dom = build_cell_domain(V, np.arange(mesh.n_cells), 2 * deg)
    form = Form(V, [Term(dom, laplace_kernel)])
    # u = 2x + 3y - 1 is in the space; K u should vanish in the interior sense:
    # residual = ∫ grad u · grad v = boundary terms only; test exact gradient
    # reproduction instead: energy = uᵀKu/... check via integrate
    xy = np.asarray(V.node_coords)
    u = jnp.asarray(2 * xy[:, 0] + 3 * xy[:, 1] - 1.0)

    def grad_err(u_loc, aux_loc, ctx, params):
        gu = jnp.einsum("qbd,b->qd", ctx.gphi, u_loc[:, 0])
        target = jnp.array([2.0, 3.0])
        return jnp.einsum("q,qd->", ctx.w, (gu - target) ** 2)

    err = float(integrate(dom, grad_err, u))
    assert err < 1e-24


def test_jacobian_matches_residual_fd():
    mesh = rectangle_mesh((0, 0), (1, 1), 2, 2)
    V = FunctionSpace(mesh, 1)
    dom = build_cell_domain(V, np.arange(mesh.n_cells), 2)

    def nonlinear_kernel(u_loc, aux_loc, ctx, params):
        uq = jnp.einsum("qb,b->q", ctx.phi, u_loc[:, 0])
        gu = jnp.einsum("qbd,b->qd", ctx.gphi, u_loc[:, 0])
        # nonlinear diffusion (1 + u^2) grad u . grad v
        r = jnp.einsum("q,q,qd,qbd->b", ctx.w, 1 + uq**2, gu, ctx.gphi)
        return r[:, None]

    form = Form(V, [Term(dom, nonlinear_kernel)])
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(V.n_dofs) * 0.1)
    blocks = form.jacobian_blocks(u)
    x = jnp.asarray(rng.standard_normal(V.n_dofs))
    eps = 1e-7
    fd = (form.residual(u + eps * x) - form.residual(u - eps * x)) / (2 * eps)
    jv = form.matvec(blocks, x)
    assert np.allclose(np.asarray(jv), np.asarray(fd), atol=1e-6)


def test_matvec_transpose_consistency():
    mesh = rectangle_mesh((0, 0), (1, 1), 3, 2)
    V = FunctionSpace(mesh, 1)
    dom = build_cell_domain(V, np.arange(mesh.n_cells), 2)
    form = Form(V, [Term(dom, laplace_kernel)])
    blocks = form.jacobian_blocks(jnp.zeros(V.n_dofs))
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal(V.n_dofs))
    y = jnp.asarray(rng.standard_normal(V.n_dofs))
    assert np.isclose(
        float(y @ form.matvec(blocks, x)), float(x @ form.matvec_t(blocks, y))
    )


def test_jacobian_and_residual_fused_consistency():
    mesh = rectangle_mesh((0, 0), (1, 1), 4, 4)
    V = FunctionSpace(mesh, 1)
    dom = build_cell_domain(V, np.arange(mesh.n_cells), 2)

    def nonlinear_kernel(u_loc, aux_loc, ctx, params):
        uq = jnp.einsum("qb,b->q", ctx.phi, u_loc[:, 0])
        gu = jnp.einsum("qbd,b->qd", ctx.gphi, u_loc[:, 0])
        r = jnp.einsum("q,q,qd,qbd->b", ctx.w, 1 + uq**2, gu, ctx.gphi)
        return r[:, None]

    form = Form(V, [Term(dom, nonlinear_kernel)])
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.standard_normal(V.n_dofs) * 0.3)
    # chunk=0 forces one unchunked evaluation; None auto-chunks; 7 exercises
    # the lax.map path with padding (32 cells / 7 leaves a ragged tail)
    for chunk in (None, 7, 0):
        blocks, r = form.jacobian_and_residual(u, chunk=chunk)
        K_ref = form.jacobian_blocks(u, chunk=0)[0]
        r_ref = form.residual(u)
        assert np.allclose(np.asarray(blocks[0]), np.asarray(K_ref), atol=1e-13)
        assert np.allclose(np.asarray(r), np.asarray(r_ref), atol=1e-13)
        assert np.allclose(
            np.asarray(form.jacobian_blocks(u, chunk=chunk)[0]),
            np.asarray(K_ref), atol=1e-13,
        )


def test_auto_chunk_env(monkeypatch):
    from iifea.ops.assembly import _auto_chunk, _DEFAULT_JAC_CHUNK

    monkeypatch.delenv("IIFEA_ASSEMBLY_CHUNK", raising=False)
    assert _auto_chunk(None) == _DEFAULT_JAC_CHUNK
    assert _auto_chunk(0) is None          # explicit 0 disables chunking
    assert _auto_chunk(31) == 31
    monkeypatch.setenv("IIFEA_ASSEMBLY_CHUNK", "1024")
    assert _auto_chunk(None) == 1024
    monkeypatch.setenv("IIFEA_ASSEMBLY_CHUNK", "0")
    assert _auto_chunk(None) is None       # env 0 disables too


def test_residual_chunked_matches_unchunked():
    """Form.residual(chunk=...) (the biharmonic-workload HBM fix) is
    numerically identical to the one-shot evaluation."""
    from iifea.mesh.generators import immersed_square_problem
    from iifea.models.poisson import PoissonProblem

    mesh_f, M = immersed_square_problem(n_fg=16, n_bg=8)
    prob = PoissonProblem(mesh_f, k=1, sym=True, beta_value=10)
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.standard_normal(prob.space.n_dofs))
    r_ref = np.asarray(prob.form.residual(u, chunk=0))
    r_chk = np.asarray(prob.form.residual(u, chunk=37))
    assert np.allclose(r_chk, r_ref, atol=1e-12 * max(np.abs(r_ref).max(), 1))
