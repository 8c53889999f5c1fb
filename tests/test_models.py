"""Model-family integration tests (fast CPU configurations).

Mirrors the reference's validation style: exact-solution error norms and
gold-value point probes (SURVEY.md §4).
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from iifea.mesh.core import Mesh
from iifea.mesh.io import read_mesh
from iifea.ops.extraction import ExtractionOperator
from iifea.ops.projection import assemble_background_system
from iifea.solvers import solve_ksp, solve_nonlinear

REF = "/root/reference/meshes"
needs_ref = pytest.mark.skipif(
    not os.path.exists(REF), reason="reference mesh artifacts not mounted"
)


@needs_ref
def test_poisson_quadratic_rates():
    from iifea.models.poisson import PoissonProblem

    errs = []
    for r in (2, 3):
        path = f"{REF}/square/Quadratic/R{r}"
        mesh = read_mesh(path)
        prob = PoissonProblem(mesh, k=2, sym=True, beta_value=10)
        M = ExtractionOperator.from_exop_csv(
            path + "/ExOp_Cons.csv", prob.space.n_nodes
        )
        A, b = assemble_background_system(
            prob.form, jnp.zeros(prob.space.n_dofs), M
        )
        u_p, _ = solve_ksp(A, b, method="direct", monitor=False)
        errs.append(prob.error_norms(M.mv(u_p)))
    # optimal k=2 rates: L2 ~ h^3, H10 ~ h^2
    assert errs[0]["L2"] / errs[1]["L2"] > 5.5
    assert errs[0]["H10"] / errs[1]["H10"] > 3.2


@needs_ref
def test_elasticity_kirsch_convergence():
    from iifea.models.elasticity import ElasticityProblem

    norms = []
    for r in (1, 2):
        path = f"{REF}/hole_in_plate/Linear/R{r}"
        mesh = read_mesh(path)
        prob = ElasticityProblem(mesh, k=1)
        M = ExtractionOperator.from_exop_csv(
            path + "/ExOp_Cons.csv", prob.space.n_nodes, n_fields=2
        )
        A, b = assemble_background_system(
            prob.form, jnp.zeros(prob.space.n_dofs), M
        )
        u_p, _ = solve_ksp(A, b, method="direct", monitor=False)
        norms.append(prob.stress_error_norm(M.mv(u_p)))
    assert norms[0] / norms[1] > 1.7  # stress error ~ h for P1
    assert norms[1] < 0.035


@needs_ref
def test_biharmonic_solves_and_converges():
    from iifea.models.biharmonic import BiharmonicProblem

    path = f"{REF}/square/Quadratic/R3"
    mesh = read_mesh(path)
    prob = BiharmonicProblem(mesh)
    M = ExtractionOperator.from_exop_csv(
        path + "/ExOp_Cons.csv", prob.space.n_nodes
    )
    A, b = assemble_background_system(prob.form, jnp.zeros(prob.space.n_dofs), M)
    u_p, _ = solve_ksp(A, b, method="direct", monitor=False)
    n = prob.error_norms(M.mv(u_p))
    assert n["L2_rel"] < 5e-5
    assert n["H2_rel"] < 1e-3


@needs_ref
def test_taylor_green_single_step():
    from iifea.api import l2_project
    from iifea.models.navier_stokes import TaylorGreenProblem, u_exact

    path = f"{REF}/square/Linear/R1"
    mesh = read_mesh(path)
    Dt = 0.25
    prob = TaylorGreenProblem(mesh, k=1, Re=100.0, Dt=Dt)
    M = ExtractionOperator.from_exop_csv(
        path + "/ExOp_Cons.csv", prob.space.n_nodes, n_fields=3
    )
    nu = prob.nu

    def ic(x):
        u = u_exact(x, nu, 0.0)
        return jnp.array([u[0], u[1], 0.0])

    up_p, up_old = l2_project(ic, prob.space, prob.cell_dom, M)
    up_p, up_f = solve_nonlinear(
        prob.form, up_old, M, up_p,
        aux={"up_old": up_old}, params={"t": jnp.asarray(Dt / 2)},
        max_iters=10, linear_method="gmres", monitor_newton=False,
        relative_tolerance=5e-4, absolute_tolerance=1e-4,
        absolute_tolerance_res=1e-5,
    )
    n = prob.error_norms(up_f, Dt)
    assert n["L2u"] < 0.05
    assert np.isfinite(n["L2p"])


@needs_ref
def test_pinned_shell_center_deflection():
    from iifea.models.kl_shell import KLShellProblem

    path = f"{REF}/square/Quadratic/R3"
    mesh = read_mesh(path)

    def flat(xi):
        return jnp.array([xi[0], xi[1], 0.0])

    prob = KLShellProblem(
        mesh, flat, E=4.8e5, nu=0.38, h_th=0.1, areal_force=90.0,
        pin_alpha=1e6, pin_mode="interface", pin_alpha_scale="h_facet",
        use_jvol=False,
    )
    M = ExtractionOperator.from_exop_csv(
        path + "/ExOp_Cons.csv", prob.space.n_nodes, n_fields=3
    )
    u_p, u_f = solve_nonlinear(
        prob.form, jnp.zeros(prob.space.n_dofs), M, jnp.zeros(M.n_bg_dofs),
        max_iters=10, linear_method="direct", monitor_newton=False,
        relative_tolerance=5e-4, absolute_tolerance=1e-4,
        absolute_tolerance_res=1e-5,
    )
    d = prob.evaluate(u_f, [[0.0, 0.0]])[0]
    # pure vertical deflection, Kirchhoff-plate magnitude
    assert abs(d[0]) < 1e-10 and abs(d[1]) < 1e-10
    assert 0.003 < d[2] < 0.01


@needs_ref
def test_shell_energy_hessian_symmetry():
    """The shell Jacobian is the energy Hessian: element blocks must be
    symmetric (internal energy part, zero load)."""
    from iifea.models.kl_shell import KLShellProblem

    path = f"{REF}/bent_tab/FG_R0/R0"
    mesh = read_mesh(path)

    def tab(xi):
        return jnp.array([xi[0], xi[1], 0.5 * (1 - xi[0] ** 2)])

    prob = KLShellProblem(mesh, tab, pressure=0.0)
    u = jnp.zeros(prob.space.n_dofs)
    blocks = prob.form.jacobian_blocks(u, params={"t": jnp.asarray(0.0)})
    K = np.asarray(blocks[0])
    assert np.allclose(K, np.swapaxes(K, 0, 1), atol=1e-8 * np.abs(K).max())


# -- synthetic on-device iterative product paths (round 3: SURVEY N5) ----------


def test_immersed_elasticity_mg_matches_direct():
    """Synthetic vector elasticity: block-MG CG on the lattice background
    must reproduce the host-LU answer (the on-device product path for the
    vector workload, linear_elasticity.py:299 analog)."""
    from iifea.mesh.generators import immersed_square_problem
    from iifea.models.elasticity import ImmersedElasticityProblem

    n, n_bg = 16, 8
    mesh_f, M = immersed_square_problem(n_fg=n, n_bg=n_bg, degree=1,
                                        n_fields=2)
    prob = ImmersedElasticityProblem(mesh_f, k=1)
    A, b = assemble_background_system(
        prob.form, jnp.zeros(prob.space.n_dofs), M
    )
    u_d, _ = solve_ksp(A, b, method="direct", monitor=False)
    u_m, info = solve_ksp(
        A, b, method="cg", pc="mg", rtol=1e-11,
        lattice_shape=(n_bg + 1, n_bg + 1), n_fields=2, monitor=False,
    )
    nd = prob.error_norms(M.mv(u_d))
    nm = prob.error_norms(M.mv(u_m))
    assert abs(nd["L2"] - nm["L2"]) < 1e-8 * nd["L2"]
    assert abs(nd["H10"] - nm["H10"]) < 1e-8 * nd["H10"]


def test_immersed_elasticity_convergence():
    """Manufactured-solution displacement error halves ~quadratically in L2
    under refinement (P1 fg, P1 lattice bg)."""
    from iifea.mesh.generators import immersed_square_problem
    from iifea.models.elasticity import ImmersedElasticityProblem

    errs = []
    for n in (16, 32):
        mesh_f, M = immersed_square_problem(n_fg=n, n_bg=n // 2, degree=1,
                                            n_fields=2)
        prob = ImmersedElasticityProblem(mesh_f, k=1)
        A, b = assemble_background_system(
            prob.form, jnp.zeros(prob.space.n_dofs), M
        )
        u, _ = solve_ksp(A, b, method="cg", pc="mg", rtol=1e-10,
                         lattice_shape=(n // 2 + 1, n // 2 + 1),
                         n_fields=2, monitor=False)
        errs.append(prob.error_norms(M.mv(u))["L2"])
    rate = np.log2(errs[0] / errs[1])
    assert rate > 1.5, (errs, rate)


def test_bspline_biharmonic_radius3_probe_and_mg():
    """Quadratic B-spline background: the projected 4th-order operator has
    stencil radius 3 (straddling fg cells couple control points 3 apart);
    the radius-3 probe must be exact and MG-GMRES must match host LU."""
    from iifea.mesh.generators import immersed_square_bspline_problem
    from iifea.models.biharmonic import BiharmonicProblem
    from iifea.ops.stencil import StencilOperator2D

    n_bg = 15  # ncp = 17
    mesh_f, M, ncp = immersed_square_bspline_problem(n_fg=32, n_bg=n_bg)
    prob = BiharmonicProblem(mesh_f)
    A, b = assemble_background_system(
        prob.form, jnp.zeros(prob.space.n_dofs), M
    )
    S = StencilOperator2D.probe_multi(A.mv_multi, ncp, radius=3,
                                      dtype=jnp.float64)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(M.n_bg_dofs))
    ax = A.mv(x)
    assert float(jnp.linalg.norm(S.mv(x) - ax)) < 1e-12 * float(
        jnp.linalg.norm(ax)
    )

    u_d, _ = solve_ksp(A, b, method="direct", monitor=False)
    u_m, _ = solve_ksp(A, b, method="gmres", pc="mg", rtol=1e-10,
                       lattice_shape=ncp, stencil_radius=3, monitor=False)
    nd = prob.error_norms(M.mv(u_d))
    nm = prob.error_norms(M.mv(u_m))
    # both land on the same discrete solution up to the h⁻⁴-conditioned
    # solve tolerance (≈0.5% of the 3e-5 discretization error here)
    assert abs(nd["L2_rel"] - nm["L2_rel"]) < 2e-2 * nd["L2_rel"]


def test_cube_bspline_partition_of_unity():
    """3D B-spline extraction rows sum to 1 for points inside the box
    (spline partition of unity == the interpolation-consistency property
    the reference CSVs satisfy)."""
    from iifea.mesh.generators import immersed_cube_bspline_problem

    mesh_f, M, ncp = immersed_cube_bspline_problem(n_fg=8, n_bg=3)
    ones = jnp.ones(M.n_bg_dofs)
    r = np.asarray(M.mv(ones))
    assert np.allclose(r, 1.0, atol=1e-12)
    assert ncp == (5, 5, 5)


def test_immersed_elasticity_3d_block_mg():
    """3D vector lattice solve through pc='mg' (the former ksp.py guard):
    block stencil probe + StencilMultigridBlock3D + field-constant
    deflation must reproduce host LU on a raw immersed operator."""
    from iifea.mesh.generators import immersed_cube_problem
    from iifea.models.elasticity import ImmersedElasticityProblem

    n, n_bg = 12, 6
    mesh_f, M = immersed_cube_problem(n_fg=n, n_bg=n_bg, degree=1,
                                      n_fields=3)
    prob = ImmersedElasticityProblem(mesh_f, k=1)
    A, b = assemble_background_system(
        prob.form, jnp.zeros(prob.space.n_dofs), M
    )
    u_d, _ = solve_ksp(A, b, method="direct", monitor=False)
    u_m, info = solve_ksp(
        A, b, method="cg", pc="mg", rtol=1e-10,
        lattice_shape=(n_bg + 1,) * 3, n_fields=3, monitor=False,
    )
    nd = prob.error_norms(M.mv(u_d))
    nm = prob.error_norms(M.mv(u_m))
    assert abs(nd["L2"] - nm["L2"]) < 1e-8 * nd["L2"]
    assert int(info.iters) < 60
