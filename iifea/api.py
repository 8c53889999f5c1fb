"""Reference-API parity surface.

One-stop functional equivalents of the reference's ``common``/``la_utils``
public functions (SURVEY.md §2.1), so a user of the reference can map each
call site directly:

  readExOp                    -> ExtractionOperator.from_exop_csv
  getIdentity                 -> ExtractionOperator.identity
  zeroDofBackground           -> zero_dof_background
  transferToForeground        -> transfer_to_foreground
  assembleLinearSystemBackground -> assemble_background_system
  AT_x / A_x_b / AT_R_A       -> M.rmv / operator.mv / BackgroundOperator
  solveKSP                    -> solve_ksp
  solveNonlinear              -> solve_nonlinear
  solveNewtonsLinear          -> solve_newtons_linear
  trimNodes / createNonzeroDiagonal / removeZeroDiagonal -> trim_* utilities
  estimateConditionNumber     -> estimate_condition_number
  L2Project                   -> l2_project
  L2Norm                      -> l2_norm
  generateUnfittedMesh        -> generate_unfitted_mesh
  mixedScalarSpace            -> mixed_scalar_space
  averageCellDiagonal         -> average_cell_diagonal
  cellMetric                  -> cell_metric
"""
from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp

from iifea.mesh.core import FunctionSpace, Mesh
from iifea.mesh.generators import generate_unfitted_mesh  # noqa: F401
from iifea.ops.assembly import Form, Term, integrate
from iifea.ops.extraction import ExtractionOperator
from iifea.ops.projection import (  # noqa: F401
    BackgroundOperator,
    assemble_background_system,
)
from iifea.solvers import (  # noqa: F401
    estimate_condition_number,
    solve_ksp,
    solve_newtons_linear,
    solve_nonlinear,
)


def zero_dof_background(M: ExtractionOperator, dtype=None):
    """zeroDofBackground parity (common.py:120-121)."""
    dtype = dtype or (
        jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    )
    return jnp.zeros(M.n_bg_dofs, dtype)


def transfer_to_foreground(u_p, M: ExtractionOperator):
    """transferToForeground parity (common.py:123-140): u_f = M u_b.

    Functional: returns the foreground vector (no ghost update needed — SPMD
    arrays have no ghosts)."""
    return M.mv(u_p)


def l2_project(
    expr_fn,
    space: FunctionSpace,
    cell_dom,
    M: ExtractionOperator,
    bfr_tol=None,
    method="cg",
    pc="jacobi",
    monitor=False,
):
    """L2Project parity (common.py:172-195): mass-matrix projection of an
    expression onto fg+bg spaces, returning (u_p, u_f) with u_f = M u_p.

    expr_fn(x) -> (n_fields,) target values at a point.
    """
    nF = space.n_fields

    def kern(u_loc, aux_loc, ctx, params):
        uq = jnp.einsum("qb,bf->qf", ctx.phi, u_loc)
        eq = jax.vmap(expr_fn)(ctx.x).reshape(uq.shape[0], nF)
        return jnp.einsum("q,qf,qb->bf", ctx.w, uq - eq, ctx.phi)

    form = Form(space, [Term(cell_dom, kern)])
    u0 = jnp.zeros(space.n_dofs)
    A, b = assemble_background_system(form, u0, M)
    u_p, _ = solve_ksp(A, b, method=method, pc=pc, bfr_tol=bfr_tol,
                       monitor=monitor)
    return u_p, M.mv(u_p)


def l2_norm(u, cell_dom, n_fields=1):
    """L2Norm parity (common.py:166-170) over a cell domain."""

    def kern(u_loc, aux_loc, ctx, params):
        uq = jnp.einsum("qb,bf->qf", ctx.phi, u_loc)
        return jnp.einsum("q,qf->", ctx.w, uq**2)

    return math.sqrt(float(integrate(cell_dom, kern, u, n_fields=n_fields)))


def mixed_scalar_space(mesh: Mesh, k: int = 1) -> FunctionSpace:
    """mixedScalarSpace parity (common.py:96-110): equal-order u-u-p space."""
    return FunctionSpace(mesh, degree=k, n_fields=3)


def average_cell_diagonal(mesh: Mesh) -> float:
    """averageCellDiagonal parity (common.py:112-118)."""
    total_area = float(mesh.cell_volumes.sum())
    average_cell_area = total_area / mesh.n_cells
    return math.sqrt(average_cell_area * 4)


def cell_metric(mesh: Mesh) -> np.ndarray:
    """cellMetric parity (common.py:197-205): G = (4/h_max²) I."""
    h = mesh.hmax()
    return (4.0 / h**2) * np.eye(mesh.dim)
