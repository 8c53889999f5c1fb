"""Krylov solvers against dense references on random SPD / nonsymmetric systems."""
import numpy as np
import jax.numpy as jnp
import pytest

from iifea.solvers import krylov
from iifea.solvers.direct import solve_direct
from iifea.solvers.precond import jacobi


def make_spd(n, seed=0):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n))
    A = B @ B.T + n * np.eye(n)
    return jnp.asarray(A), rng


@pytest.mark.parametrize("method", ["cg", "gmres", "gcr", "bicgstab"])
def test_spd_solve(method):
    A, rng = make_spd(40)
    b = jnp.asarray(rng.standard_normal(40))
    x_ref = np.linalg.solve(np.asarray(A), np.asarray(b))
    solver = getattr(krylov, method)
    x, info = solver(lambda v: A @ v, b, rtol=1e-12, atol=1e-14)
    assert bool(info.converged)
    assert np.allclose(np.asarray(x), x_ref, atol=1e-8)


@pytest.mark.parametrize("method", ["gmres", "gcr", "bicgstab"])
def test_nonsymmetric_solve(method):
    rng = np.random.default_rng(3)
    n = 35
    A = np.eye(n) * 5 + rng.standard_normal((n, n)) * 0.5
    b = rng.standard_normal(n)
    x_ref = np.linalg.solve(A, b)
    Aj = jnp.asarray(A)
    solver = getattr(krylov, method)
    x, info = solver(lambda v: Aj @ v, jnp.asarray(b), rtol=1e-12, atol=1e-14)
    assert np.allclose(np.asarray(x), x_ref, atol=1e-7)


def test_jacobi_preconditioning_reduces_iterations():
    rng = np.random.default_rng(5)
    n = 60
    d = 10.0 ** rng.uniform(-2, 2, n)
    A = np.diag(d) + 0.01 * np.eye(n)
    Aj = jnp.asarray(A)
    b = jnp.asarray(rng.standard_normal(n))
    _, info_plain = krylov.cg(lambda v: Aj @ v, b, rtol=1e-10, max_it=5000)
    minv = jacobi(jnp.asarray(np.diag(A)))
    x, info_pc = krylov.cg(lambda v: Aj @ v, b, minv=minv, rtol=1e-10)
    assert int(info_pc.iters) < int(info_plain.iters)
    assert np.allclose(np.asarray(x), np.linalg.solve(A, np.asarray(b)), atol=1e-7)


def test_gmres_restart_cycles():
    A, rng = make_spd(50, seed=7)
    b = jnp.asarray(rng.standard_normal(50))
    x, info = krylov.gmres(lambda v: A @ v, b, restart=10, rtol=1e-11)
    assert np.allclose(
        np.asarray(x), np.linalg.solve(np.asarray(A), np.asarray(b)), atol=1e-7
    )


def test_direct_null_pivot_handling():
    import scipy.sparse as sp

    # matrix with an empty (unsupported) row/col: direct solve must not fail
    A = np.array([[2.0, 1.0, 0.0], [1.0, 3.0, 0.0], [0.0, 0.0, 0.0]])
    b = np.array([1.0, 2.0, 5.0])
    x = solve_direct(sp.csr_matrix(A), b)
    assert np.allclose(A[:2, :2] @ x[:2], b[:2])
    assert x[2] == 0.0


def test_direct_near_null_pivot_escalation():
    """Rows with a tiny-but-nonzero diagonal (weakly supported background
    dofs, the 3D cube R3 failure mode) must be trimmed adaptively: the
    first factorization is catastrophically unstable, the escalation ladder
    retries with relative-diagonal BFR trims until backward-stable."""
    import scipy.sparse as sp

    rng = np.random.default_rng(3)
    n = 60
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = Q @ np.diag(np.linspace(1.0, 4.0, n)) @ Q.T
    # a near-null cluster: scale 4 rows+cols down to ~1e-12 of the rest
    weak = np.arange(4)
    s = np.ones(n)
    s[weak] = 1e-12
    A = (A * s[:, None]) * s[None, :]
    b = A @ np.ones(n)
    # corrupt the weak block at the f64 noise floor of the large entries,
    # emulating assembly round-off that dominates the tiny true values
    A[np.ix_(weak, weak)] += 1e-17 * rng.standard_normal((4, 4))
    x = solve_direct(sp.csr_matrix(A), b)
    assert np.all(np.isfinite(x))
    # the strongly supported block is solved accurately
    assert np.allclose(x[4:], 1.0, atol=1e-6)
    # no runaway near-null components
    assert np.abs(x).max() < 1e3


def test_direct_ill_conditioned_stable_not_gutted():
    """A STABLE factorization of an ill-conditioned system (shell-Jacobian
    class, cond ~1e11: refinement stagnates at eps*cond but never grows)
    must be accepted as-is — escalating the trim ladder here discards
    legitimate small-diagonal dofs and collapses the solution toward zero
    (the cut_shell tip-displacement (0,0,0) regression)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(11)
    n = 80
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    # smooth spectrum spanning 11 orders of magnitude
    A = Q @ np.diag(np.logspace(-11, 0, n)) @ Q.T
    x_true = rng.standard_normal(n)
    b = A @ x_true
    x = solve_direct(sp.csr_matrix(A), b)
    # the small-eigenvalue components are genuine solution content: a
    # gutted (over-trimmed) solve returns |x| << |x_true|
    assert np.linalg.norm(x - x_true) < 1e-3 * np.linalg.norm(x_true)


def test_direct_iterative_fallback_3d():
    """Synthetic immersed cube where every LU rung fails the backward-error
    check (non-axis-aligned near-null subspace, cond ~1e19): solve_direct
    must fall back to Jacobi-PCG and return a bounded, accurate solution
    (it returned |x| ~ 1e19, L2 error 0.63 before)."""
    from iifea.mesh.generators import immersed_cube_problem
    from iifea.models.poisson import PoissonProblem
    from iifea.ops.projection import assemble_background_system
    from iifea.solvers.ksp import solve_ksp

    mesh, M = immersed_cube_problem(n_fg=32, n_bg=27)
    prob = PoissonProblem(mesh, k=1, sym=True, beta_value=10)
    A, b = assemble_background_system(
        prob.form, jnp.zeros(prob.space.n_dofs), M
    )
    u, _ = solve_ksp(A, b, method="direct", monitor=False)
    assert float(jnp.abs(u).max()) < 100.0
    n = prob.error_norms(M.mv(u))
    assert n["L2"] < 0.03
    assert n["H10"] < 0.25


def test_nonzero_initial_guess():
    A, rng = make_spd(20, seed=9)
    b = jnp.asarray(rng.standard_normal(20))
    x_ref = np.linalg.solve(np.asarray(A), np.asarray(b))
    x0 = jnp.asarray(x_ref + 1e-3 * rng.standard_normal(20))
    x, info = krylov.cg(lambda v: A @ v, b, x0=x0, rtol=1e-12, check_every=4)
    assert int(info.iters) <= 16
    assert np.allclose(np.asarray(x), x_ref, atol=1e-8)


def test_solve_ksp_mg_pc():
    """pc='mg' (stencil probe + V-cycle) matches the jacobi-PC solution on a
    lattice background and converges in far fewer iterations."""
    from iifea.mesh.generators import immersed_square_problem
    from iifea.models.poisson import PoissonProblem
    from iifea.ops.projection import assemble_background_system
    from iifea.solvers.ksp import solve_ksp

    n_bg = 32
    mesh_f, M = immersed_square_problem(n_fg=48, n_bg=n_bg)
    prob = PoissonProblem(mesh_f, k=1, sym=True, beta_value=10)
    A, b = assemble_background_system(
        prob.form, jnp.zeros(prob.space.n_dofs), M
    )
    x_mg, info_mg = solve_ksp(
        A, b, method="cg", pc="mg", rtol=1e-10,
        lattice_shape=(n_bg + 1, n_bg + 1), monitor=False,
    )
    x_j, info_j = solve_ksp(A, b, method="cg", pc="jacobi", rtol=1e-10,
                            monitor=False)
    assert bool(info_mg.converged)
    assert int(info_mg.iters) < int(info_j.iters)
    d = np.asarray(A.diag())
    mask = np.abs(d) > 0
    scale = max(float(jnp.abs(x_j).max()), 1.0)
    assert np.allclose(np.asarray(x_mg)[mask], np.asarray(x_j)[mask],
                       atol=1e-6 * scale)


def test_solve_ksp_mg_pc_3d():
    """pc='mg' on a 3D lattice (stencil probe + stencil-Jacobi)."""
    from iifea.mesh.generators import immersed_cube_problem
    from iifea.models.poisson import PoissonProblem
    from iifea.ops.projection import assemble_background_system
    from iifea.solvers.ksp import solve_ksp

    n_bg = 6
    mesh_f, M = immersed_cube_problem(n_fg=10, n_bg=n_bg)
    prob = PoissonProblem(mesh_f, k=1, sym=True, beta_value=10)
    A, b = assemble_background_system(
        prob.form, jnp.zeros(prob.space.n_dofs), M
    )
    x_mg, info = solve_ksp(
        A, b, method="cg", pc="mg", rtol=1e-10,
        lattice_shape=(n_bg + 1,) * 3, monitor=False,
    )
    assert bool(info.converged)
    x_j, _ = solve_ksp(A, b, method="cg", pc="jacobi", rtol=1e-10,
                       monitor=False)
    d = np.asarray(A.diag())
    mask = np.abs(d) > 0
    scale = max(float(jnp.abs(x_j).max()), 1.0)
    assert np.allclose(np.asarray(x_mg)[mask], np.asarray(x_j)[mask],
                       atol=1e-6 * scale)


def test_solve_ksp_mg_pc_block():
    """pc='mg' with n_fields=2: block stencil probe + point-block-Jacobi."""
    from iifea.mesh.core import FunctionSpace
    from iifea.mesh.generators import immersed_square_problem
    from iifea.ops.assembly import Form, Term, build_cell_domain
    from iifea.ops.projection import BackgroundOperator
    from iifea.solvers.ksp import solve_ksp

    n_bg = 10
    mesh_f, M = immersed_square_problem(n_fg=16, n_bg=n_bg, n_fields=2)
    V = FunctionSpace(mesh_f, degree=1, n_fields=2)

    def coupled_kernel(u_loc, aux_loc, ctx, params):
        g0 = jnp.einsum("qbd,b->qd", ctx.gphi, u_loc[:, 0])
        g1 = jnp.einsum("qbd,b->qd", ctx.gphi, u_loc[:, 1])
        r0 = jnp.einsum("q,qd,qbd->b", ctx.w, g0 + 0.3 * g1, ctx.gphi)
        r1 = jnp.einsum("q,qd,qbd->b", ctx.w, g1 + 0.3 * g0, ctx.gphi)
        u0 = jnp.einsum("qb,b->q", ctx.phi, u_loc[:, 0])
        u1 = jnp.einsum("qb,b->q", ctx.phi, u_loc[:, 1])
        xq0 = ctx.x[:, 0]
        r0 = r0 + jnp.einsum("q,q,qb->b", ctx.w, u0 + 0.5 * u1 - xq0, ctx.phi)
        r1 = r1 + jnp.einsum("q,q,qb->b", ctx.w, u1 + 0.5 * u0, ctx.phi)
        return jnp.stack([r0, r1], axis=1)

    cells = np.where(mesh_f.material == 2)[0]
    dom = build_cell_domain(V, cells, 2)
    form = Form(V, [Term(dom, coupled_kernel)])
    u0v = jnp.zeros(V.n_dofs)
    blocks = form.jacobian_blocks(u0v)
    A = BackgroundOperator(form, blocks, M)
    b = M.rmv(-form.residual(u0v))

    x_blk, info = solve_ksp(
        A, b, method="cg", pc="mg", rtol=1e-10,
        lattice_shape=(n_bg + 1, n_bg + 1), n_fields=2, monitor=False,
    )
    assert bool(info.converged)
    x_ref, _ = solve_ksp(A, b, method="cg", pc="jacobi", rtol=1e-10,
                         monitor=False)
    # both routes hit residual ~1e-14; they may legitimately differ on
    # sliver-cut dofs (diagonal ~1e-2 of typical: numerically undetermined),
    # so compare residuals globally and values on well-supported dofs only
    res = float(jnp.linalg.norm(A.mv(x_blk) - b) / jnp.linalg.norm(b))
    assert res < 1e-9, res
    d = np.asarray(A.diag())
    mask = d > 0.05 * d.max()
    scale = max(float(jnp.abs(x_ref).max()), 1.0)
    assert np.allclose(np.asarray(x_blk)[mask], np.asarray(x_ref)[mask],
                       atol=1e-6 * scale)


def test_newton_with_mg_fast_path():
    """solve_nonlinear(linear_pc='mg'): nonlinear diffusion on a lattice
    background, each Newton step re-probed onto the stencil fast path."""
    from iifea.mesh.core import FunctionSpace
    from iifea.mesh.generators import immersed_square_problem
    from iifea.ops.assembly import Form, Term, build_cell_domain
    from iifea.solvers.newton import solve_nonlinear

    n_bg = 16
    mesh_f, M = immersed_square_problem(n_fg=24, n_bg=n_bg)
    V = FunctionSpace(mesh_f, degree=1, n_fields=1)

    def kern(u_loc, aux_loc, ctx, params):
        uq = jnp.einsum("qb,b->q", ctx.phi, u_loc[:, 0])
        gu = jnp.einsum("qbd,b->qd", ctx.gphi, u_loc[:, 0])
        r = jnp.einsum("q,q,qd,qbd->b", ctx.w, 1 + uq**2, gu, ctx.gphi)
        # reaction + source so the problem is well-posed without BCs
        r = r + jnp.einsum("q,q,qb->b", ctx.w, uq - 1.0, ctx.phi)
        return r[:, None]

    cells = np.where(mesh_f.material == 2)[0]
    dom = build_cell_domain(V, cells, 3)
    form = Form(V, [Term(dom, kern)])

    u_p0 = jnp.zeros(M.n_bg_dofs)
    u_p, u_f = solve_nonlinear(
        form, M.mv(u_p0), M, u_p0, max_iters=30,
        relative_tolerance=1e-8, monitor_newton=False,
        linear_method="cg", linear_pc="mg",
        lattice_shape=(n_bg + 1, n_bg + 1),
    )
    u_p2, _ = solve_nonlinear(
        form, M.mv(u_p0), M, u_p0, max_iters=30,
        relative_tolerance=1e-8, monitor_newton=False,
        linear_method="cg", linear_pc="jacobi",
    )
    scale = max(float(jnp.abs(u_p2).max()), 1.0)
    d = np.abs(np.asarray(
        __import__("iifea.ops.projection", fromlist=["BackgroundOperator"])
        .BackgroundOperator(form, form.jacobian_blocks(u_f), M).diag()
    )) > 0
    assert np.allclose(np.asarray(u_p)[d], np.asarray(u_p2)[d],
                       atol=1e-5 * scale)


def test_tg_step_with_block_mg():
    """One TG/NS Newton time step on a synthetic lattice background with
    linear_pc='mg' (StencilMultigridBlock end-to-end through the nonlinear
    driver — the VERDICT r1 item-4 demo-class solve)."""
    from iifea.api import l2_project
    from iifea.mesh.generators import immersed_square_problem
    from iifea.models.navier_stokes import TaylorGreenProblem, u_exact
    from iifea.solvers.newton import solve_nonlinear

    n, n_bg = 16, 8
    mesh_f, M = immersed_square_problem(n_fg=n, n_bg=n_bg, n_fields=3)
    Dt = 4 / np.sqrt(mesh_f.n_cells)
    prob = TaylorGreenProblem(
        mesh_f, k=1, Re=100.0, Dt=Dt, sym=False, n_bg_dofs=M.n_bg_dofs
    )

    def ic_expr(x):
        u = u_exact(x, prob.nu, 0.0)
        return jnp.array([u[0], u[1], 0.0])

    up_p, up_f = l2_project(ic_expr, prob.space, prob.cell_dom, M)
    # pin one supported pressure dof: enclosed flow carries an exact
    # constant-pressure null mode, and pinning removes it so BOTH
    # preconditioners converge in one Newton iteration to the same state.
    # Selection must be by OPERATOR diagonal — an M-referenced dof can
    # still be dead (zero diagonal) if its fg dofs sit outside the
    # integration domain, and pinning a dead dof is a silent no-op.
    from iifea.ops.projection import BackgroundOperator

    blocks0 = prob.form.jacobian_blocks(
        up_f, {"up_old": up_f}, {"t": jnp.asarray(0.5 * Dt)}
    )
    d0 = np.asarray(BackgroundOperator(prob.form, blocks0, M).diag())
    nn = M.n_bg_dofs // 3
    pin = np.array([2 * nn + int(np.argmax(d0[2 * nn:]))])
    up_p, up_f = solve_nonlinear(
        prob.form, up_f, M, up_p,
        aux={"up_old": up_f},
        params={"t": jnp.asarray(0.5 * Dt)},
        max_iters=10,
        linear_method="gmres", linear_pc="mg",
        lattice_shape=(n_bg + 1, n_bg + 1), n_fields=3,
        zero_ids=pin,
        monitor_newton=False,
        relative_tolerance=5e-4,
        absolute_tolerance=1e-4, absolute_tolerance_res=1e-5,
    )
    assert np.isfinite(float(jnp.linalg.norm(up_p)))
    norms = prob.error_norms(up_f, Dt)
    # measured 0.00398 (identical to the jacobi route to 8 digits)
    assert norms["L2u"] < 0.02, norms


def test_newtons_linear_warm_start_pins_zero():
    """solve_newtons_linear with zero_ids and a NONZERO warm-start u_p:
    pinned dofs must end at 0 (the defect-correction fixed point with
    target=u_p would park them at MINUS the initial guess), and unpinned
    dofs must match a cold-started solve."""
    from iifea.mesh.generators import immersed_square_problem
    from iifea.models.poisson import PoissonProblem
    from iifea.solvers.newton import solve_newtons_linear

    mesh, M = immersed_square_problem(n_fg=18, n_bg=12)
    prob = PoissonProblem(mesh, k=1, sym=True, beta_value=10)
    u_f = jnp.zeros(prob.space.n_dofs)
    pin = np.array([0, 1])
    cold, cold_f = solve_newtons_linear(
        prob.form, u_f, M, jnp.zeros(M.n_bg_dofs), zero_ids=pin,
        monitor_newton=False, linear_method="direct",
    )
    rng = np.random.default_rng(5)
    warm0 = jnp.asarray(rng.standard_normal(M.n_bg_dofs))
    warm, warm_f = solve_newtons_linear(
        prob.form, u_f, M, warm0, zero_ids=pin,
        monitor_newton=False, linear_method="direct",
    )
    assert np.allclose(np.asarray(cold_f), np.asarray(M.mv(cold)))
    assert np.allclose(np.asarray(warm)[pin], 0.0, atol=1e-12)
    assert np.allclose(np.asarray(cold)[pin], 0.0, atol=1e-12)
    # compare on SUPPORTED dofs only: zero-row (unsupported) dofs keep
    # whatever the initial guess put there — they never enter the residual
    # and carry no foreground meaning
    from iifea.ops.projection import (
        BackgroundOperator,
        assemble_background_system,
    )

    A, _ = assemble_background_system(prob.form, u_f, M)
    d = np.asarray(A.diag())
    sup = np.abs(d) > 0
    scale = max(float(jnp.abs(cold).max()), 1.0)
    assert np.allclose(np.asarray(warm)[sup], np.asarray(cold)[sup],
                       atol=1e-5 * scale)


def test_block_diag_exact_and_bjacobi_beats_jacobi():
    """BackgroundOperator.block_diag must reproduce the explicit matrix's
    per-node field-coupling blocks exactly (field-blocked layout,
    dof = node + field*m), and pc='bjacobi' must converge in no more — on
    the coupled vector system, strictly fewer — GMRES iterations than
    pointwise jacobi (PCBJACOBI role, common.py:568-616)."""
    from iifea.mesh.generators import immersed_square_problem
    from iifea.models.elasticity import ImmersedElasticityProblem
    from iifea.ops.projection import assemble_background_system
    from iifea.solvers.ksp import solve_ksp

    mesh_f, M = immersed_square_problem(n_fg=16, n_bg=8, degree=1,
                                        n_fields=2)
    prob = ImmersedElasticityProblem(mesh_f, k=1)
    A, b = assemble_background_system(
        prob.form, jnp.zeros(prob.space.n_dofs), M
    )
    nf = 2
    m = M.n_bg_dofs // nf
    A_sp = np.asarray(A.to_scipy().todense())
    bd = np.asarray(A.block_diag(nf))
    idx = np.arange(m)
    scale = np.abs(A_sp).max()
    for fa in range(nf):
        for fb in range(nf):
            ref = A_sp[idx + fa * m, idx + fb * m]
            assert np.allclose(bd[:, fa, fb], ref, atol=1e-12 * scale), (
                fa, fb, np.abs(bd[:, fa, fb] - ref).max())
    # the off-diagonal coupling must be nontrivial for this to test anything
    assert np.abs(bd[:, 0, 1]).max() > 1e-12 * scale

    u_j, info_j = solve_ksp(A, b, method="gmres", pc="jacobi",
                            rtol=1e-10, monitor=False)
    u_b, info_b = solve_ksp(A, b, method="gmres", pc="bjacobi", n_fields=nf,
                            rtol=1e-10, monitor=False)
    # same answer on supported dofs
    d = np.asarray(A.diag())
    sup = np.abs(d) > 0
    scale_u = max(float(jnp.abs(u_j).max()), 1.0)
    assert np.allclose(np.asarray(u_b)[sup], np.asarray(u_j)[sup],
                       atol=1e-6 * scale_u)
    assert int(info_b.iters) < int(info_j.iters), (
        int(info_b.iters), int(info_j.iters))


def test_bjacobi_single_field_degrades_to_jacobi():
    import warnings as _w

    from iifea.mesh.generators import immersed_square_problem
    from iifea.models.poisson import PoissonProblem
    from iifea.ops.projection import assemble_background_system
    from iifea.solvers.ksp import solve_ksp

    mesh_f, M = immersed_square_problem(n_fg=12, n_bg=6)
    prob = PoissonProblem(mesh_f, k=1, sym=True, beta_value=10)
    A, b = assemble_background_system(
        prob.form, jnp.zeros(prob.space.n_dofs), M
    )
    u_ref, _ = solve_ksp(A, b, method="cg", pc="jacobi", rtol=1e-11,
                         monitor=False)
    with _w.catch_warnings(record=True) as rec:
        _w.simplefilter("always")
        u, _ = solve_ksp(A, b, method="cg", pc="bjacobi", rtol=1e-11,
                         monitor=False)
    assert any("bjacobi" in str(r.message) for r in rec)
    assert np.allclose(np.asarray(u), np.asarray(u_ref), atol=1e-8)


def test_newton_line_search_globalizes():
    """Backtracking line search (VERDICT r4 item 6): an atan-reaction
    problem started far from the solution makes full Newton steps overshoot
    and oscillate — plain Newton (the reference's only rescue is a fixed
    relax_param, common.py:474) fails, the Armijo backtracking variant
    converges."""
    from iifea.mesh.core import FunctionSpace
    from iifea.mesh.generators import immersed_square_problem
    from iifea.ops.assembly import Form, Term, build_cell_domain
    from iifea.solvers.newton import (
        NonlinearSolveError,
        solve_nonlinear,
    )

    n_bg = 16
    mesh_f, M = immersed_square_problem(n_fg=24, n_bg=n_bg)
    V = FunctionSpace(mesh_f, degree=1, n_fields=1)

    def kern(u_loc, aux_loc, ctx, params):
        uq = jnp.einsum("qb,b->q", ctx.phi, u_loc[:, 0])
        gu = jnp.einsum("qbd,b->qd", ctx.gphi, u_loc[:, 0])
        r = jnp.einsum("q,qd,qbd->b", ctx.w, gu, ctx.gphi)
        # atan reaction: near-flat far field => full Newton steps overshoot
        r = r + jnp.einsum("q,q,qb->b", ctx.w, jnp.arctan(uq - 2.0), ctx.phi)
        return r[:, None]

    cells = np.where(mesh_f.material == 2)[0]
    dom = build_cell_domain(V, cells, 3)
    form = Form(V, [Term(dom, kern)])
    u_p0 = jnp.full(M.n_bg_dofs, 20.0)

    with pytest.raises(NonlinearSolveError):
        solve_nonlinear(
            form, M.mv(u_p0), M, u_p0, max_iters=15,
            relative_tolerance=1e-8, monitor_newton=False,
            linear_method="cg", linear_pc="jacobi",
        )

    u_p, u_f = solve_nonlinear(
        form, M.mv(u_p0), M, u_p0, max_iters=15,
        relative_tolerance=1e-8, monitor_newton=False,
        linear_method="cg", linear_pc="jacobi", line_search=True,
    )
    R = M.rmv(form.residual(u_f))
    assert float(jnp.linalg.norm(R)) < 1e-6


def test_asm_preconditioner_small():
    """pc='asm' (restricted additive Schwarz, PCASM role common.py:576-587)
    converges and beats jacobi in iterations on the immersed Poisson system.
    ASM consumes only the CSR graph of the projected operator — no lattice
    structure assumed (the strong-PC option where pc='mg' does not apply)."""
    from iifea.mesh.generators import immersed_square_problem
    from iifea.models.poisson import PoissonProblem
    from iifea.ops.projection import assemble_background_system
    from iifea.solvers.ksp import solve_ksp

    mesh_f, M = immersed_square_problem(n_fg=48, n_bg=24)
    prob = PoissonProblem(mesh_f, k=1, sym=True, beta_value=10)
    A, b = assemble_background_system(
        prob.form, jnp.zeros(prob.space.n_dofs), M
    )
    x_j, info_j = solve_ksp(A, b, method="gmres", pc="jacobi", rtol=1e-10,
                            monitor=False)
    x_a, info_a = solve_ksp(A, b, method="gmres", pc="asm", rtol=1e-10,
                            monitor=False)
    assert float(jnp.linalg.norm(b - A.mv(x_a))) <= \
        1.5e-10 * float(jnp.linalg.norm(b))
    assert int(info_a.iters) < int(info_j.iters)
    scale = max(float(jnp.abs(x_j).max()), 1.0)
    d = np.abs(np.asarray(A.diag())) > 0
    assert np.allclose(np.asarray(x_a)[d], np.asarray(x_j)[d],
                       atol=1e-7 * scale)


def test_asm_beats_jacobi_kirsch_k2():
    """VERDICT r4 item 7 'done' criterion: pc='asm' beating jacobi >= 3x in
    iterations on the Kirsch k=2 system (hole_in_plate Quadratic FG_R1/R2,
    quadratic extraction -> severely ill-conditioned projected operator).
    Measured: 24 vs 117 iterations (4.9x)."""
    import os

    from iifea.mesh.core import Mesh
    from iifea.mesh.io import read_mesh
    from iifea.models.elasticity import ElasticityProblem
    from iifea.ops.extraction import ExtractionOperator
    from iifea.ops.projection import assemble_background_system
    from iifea.solvers.ksp import solve_ksp

    path = "/root/reference/meshes/hole_in_plate/Quadratic/FG_R1/R2"
    if not os.path.isdir(path):
        pytest.skip("reference mesh artifacts not present")
    mesh_f = read_mesh(path)
    # hole/plate ids are flipped in the quadratic meshes
    # (linear_elasticity.py:148-157)
    flipped = np.where(
        mesh_f.material == 1, 2,
        np.where(mesh_f.material == 2, 1, mesh_f.material),
    )
    mesh_f = Mesh(mesh_f.coords, mesh_f.cells, flipped, mesh_f.cell_nodes)
    prob = ElasticityProblem(mesh_f, k=2)
    M = ExtractionOperator.from_exop_csv(
        path + "/ExOp_Cons.csv", prob.space.n_nodes, n_fields=2
    )
    A, b = assemble_background_system(
        prob.form, jnp.zeros(prob.space.n_dofs), M
    )
    _, info_j = solve_ksp(A, b, method="gmres", pc="jacobi", rtol=1e-8,
                          atol=1e-30, max_it=20000, monitor=False)
    x_a, info_a = solve_ksp(A, b, method="gmres", pc="asm", rtol=1e-8,
                            atol=1e-30, max_it=20000, monitor=False)
    assert float(jnp.linalg.norm(b - A.mv(x_a))) <= \
        1.5e-8 * float(jnp.linalg.norm(b))
    assert int(info_j.iters) >= 3 * int(info_a.iters), (
        int(info_j.iters), int(info_a.iters))
