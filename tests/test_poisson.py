"""Integration tests: immersed Poisson end-to-end (SURVEY.md §4 strategy #1-3).

Convergence tests against the manufactured solution (the reference's primary
validation, demos/poisson.py:216-254) on synthetic immersed meshes, plus
file-format parity runs on the reference mesh artifacts when mounted.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest

from iifea.mesh.generators import immersed_square_problem
from iifea.models.poisson import PoissonProblem
from iifea.ops.extraction import ExtractionOperator
from iifea.ops.projection import assemble_background_system
from iifea.solvers.ksp import solve_ksp

REF = "/root/reference/meshes"


def solve_immersed(n, method="cg", sym=True):
    mesh_f, M = immersed_square_problem(n_fg=n, n_bg=max(n // 2, 4))
    prob = PoissonProblem(mesh_f, k=1, sym=sym, beta_value=10)
    u0 = jnp.zeros(prob.space.n_dofs)
    A, b = assemble_background_system(prob.form, u0, M)
    u_p, info = solve_ksp(A, b, method=method, pc="jacobi", monitor=False)
    return prob.error_norms(M.mv(u_p))


def test_convergence_rates_symmetric():
    e1 = solve_immersed(16)
    e2 = solve_immersed(32)
    e3 = solve_immersed(64)
    # optimal rates: L2 ~ h^2, H10 ~ h (poisson paper claim, SURVEY §6)
    assert e2["L2"] / e3["L2"] > 3.0
    assert e2["H10"] / e3["H10"] > 1.7
    assert e1["L2"] > e2["L2"] > e3["L2"]


def test_nonsymmetric_nitsche():
    e = solve_immersed(32, method="bicgstab", sym=False)
    assert e["L2"] < 0.08


def test_identity_extraction_matches_fitted():
    """--Ex False path (poisson.py:178-181): identity M == plain fitted FEM."""
    mesh_f, M = immersed_square_problem(n_fg=24, n_bg=12)
    prob = PoissonProblem(mesh_f, k=1, sym=True, beta_value=10)
    I = ExtractionOperator.identity(prob.space.n_nodes)
    u0 = jnp.zeros(prob.space.n_dofs)
    A, b = assemble_background_system(prob.form, u0, I)
    u_p, _ = solve_ksp(A, b, method="gmres", pc="jacobi", monitor=False,
                       bfr_tol=1e-9)
    e = prob.error_norms(I.mv(u_p))
    assert e["L2"] < 0.05


@pytest.mark.skipif(not os.path.exists(REF), reason="reference data not mounted")
@pytest.mark.parametrize("ref,expected_l2", [(2, 0.20), (3, 0.055), (4, 0.015)])
def test_reference_meshes_linear(ref, expected_l2):
    from iifea.mesh.io import read_mesh

    path = f"{REF}/square/Linear/R{ref}"
    mesh = read_mesh(path)
    prob = PoissonProblem(mesh, k=1, sym=True, beta_value=10)
    M = ExtractionOperator.from_exop_csv(
        path + "/ExOp_Cons.csv", prob.space.n_nodes
    )
    u0 = jnp.zeros(prob.space.n_dofs)
    A, b = assemble_background_system(prob.form, u0, M)
    u_p, _ = solve_ksp(A, b, method="gmres", pc="jacobi", monitor=False)
    e = prob.error_norms(M.mv(u_p))
    assert e["L2"] < expected_l2 * 1.1


@pytest.mark.skipif(not os.path.exists(REF), reason="reference data not mounted")
def test_direct_matches_iterative():
    from iifea.mesh.io import read_mesh

    path = f"{REF}/square/Linear/R2"
    mesh = read_mesh(path)
    prob = PoissonProblem(mesh, k=1, sym=True, beta_value=10)
    M = ExtractionOperator.from_exop_csv(
        path + "/ExOp_Cons.csv", prob.space.n_nodes
    )
    u0 = jnp.zeros(prob.space.n_dofs)
    A, b = assemble_background_system(prob.form, u0, M)
    u_it, _ = solve_ksp(A, b, method="gmres", pc="jacobi", monitor=False,
                        rtol=1e-13, atol=1e-15)
    u_dir, _ = solve_ksp(A, b, method="direct", monitor=False)
    assert np.allclose(np.asarray(u_it), np.asarray(u_dir), atol=1e-7)
