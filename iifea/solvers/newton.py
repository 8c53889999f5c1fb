"""Newton solvers on the background space.

solve_nonlinear mirrors the reference's solveNonlinear (common.py:404-480)
exactly: per iteration the residual and its autodiff Jacobian are re-assembled
and re-projected, the update system ``J du = R`` is solved, and convergence is
tested on both the relative ||du|| AND relative ||R|| (common.py:466-468), with
absolute escapes after iteration 1 (common.py:469-473). The converged
iteration's du is *not* applied, matching the reference's control flow.

solve_newtons_linear mirrors solveNewtonsLinear (common.py:335-402): the
defect-correction loop for ill-conditioned *linear* systems (3D biharmonic),
where A and L are assembled once and iterations solve ``A du = (A u + L)``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from iifea.ops.assembly import Form
from iifea.ops.extraction import ExtractionOperator
from iifea.ops.projection import BackgroundOperator
from iifea.solvers.ksp import solve_ksp
from iifea.solvers.trim import apply_trim_rhs, mask_from_ids, trim_mask_from_diag
from iifea.utils.logging import log_info


class NonlinearSolveError(RuntimeError):
    pass


@jax.jit
def _assemble(form, u_f, M, aux, params):
    blocks = form.jacobian_blocks(u_f, aux, params)
    R_b = M.rmv(form.residual(u_f, aux, params))
    return blocks, R_b


@jax.jit
def _residual_b(form, u_f, M, aux, params):
    """Projected residual only (no Jacobian) — the line-search merit term."""
    return M.rmv(form.residual(u_f, aux, params))


def solve_nonlinear(
    form: Form,
    u_f: jnp.ndarray,
    M: ExtractionOperator,
    u_p: jnp.ndarray,
    aux=None,
    params=None,
    max_iters: int = 20,
    relative_tolerance: float = 1e-4,
    monitor_newton: bool = True,
    monitor_linear: bool = False,
    linear_method: str | None = None,
    linear_pc: str | None = None,
    bfr_tol: float | None = None,
    relax_param: float = 1.0,
    absolute_tolerance: float = 1e-6,
    absolute_tolerance_res: float = 1e-9,
    du_0_mag: float | None = None,
    zero_ids=None,
    estimate_cond_num: bool = False,
    linear_rtol: float = 1e-8,
    linear_atol: float = 1e-9,
    lattice_shape: tuple | None = None,
    n_fields: int = 1,
    line_search: bool = False,
    max_halvings: int = 8,
    ptc_sigma0: float | None = None,
):
    """Newton's iteration; returns (u_p, u_f) with u_f = M u_p kept in sync.

    ``linear_pc='mg'`` + ``lattice_shape`` routes each linearized solve
    through the stencil fast path (re-probed per Newton iteration, since the
    Jacobian changes — see solvers/ksp._mg_solve).

    ``line_search=True`` adds a backtracking (Armijo-on-||R||) globalization
    the reference does NOT have — its only rescue for a diverging Newton is
    the fixed ``relax_param`` (common.py:404-480, :474). Default off for
    exact reference parity: step α·relax·du with α halved from 1 until
    ||R(u - α·relax·du)|| <= (1 - 1e-4 α)||R(u)||; if no α in
    ``max_halvings`` qualifies, the least-bad trial is taken (so a
    stagnating search still makes progress instead of stepping blind).

    ``ptc_sigma0`` enables pseudo-transient continuation: each linearized
    solve uses A + σ_k·|diag(A)| with σ_k = σ0·min(1, ||R_k||/||R_0||)
    (switched evolution relaxation). Regularizes the near-singular
    linearizations of badly cut / under-resolved problems where the raw
    Newton direction is garbage and NO step length helps (the TG synthetic
    ref-1 failure mode); σ decays with the residual, restoring Newton
    convergence near the solution. The reference has no counterpart."""
    aux = aux or {}
    initial_norm = initial_norm_res = None
    converged = False
    for i in range(max_iters):
        blocks, R_b = _assemble(form, u_f, M, aux, params)
        A = BackgroundOperator(form, blocks, M)
        if bfr_tol is not None:
            mask = trim_mask_from_diag(A.diag(), bfr_tol)
            A = A.with_trim(mask)
            R_b = apply_trim_rhs(R_b, mask, target=u_p)
        elif zero_ids is not None:
            mask = mask_from_ids(zero_ids, M.n_bg_dofs)
            A = A.with_trim(mask)
            R_b = apply_trim_rhs(R_b, mask, target=u_p)

        if estimate_cond_num:
            from iifea.solvers.condition import estimate_condition_number

            smax, smin = estimate_condition_number(A)
            log_info(f"sigma_max: {smax}, sigma_min: {smin}")

        current_norm_res = float(jnp.linalg.norm(R_b))
        if i == 0:
            initial_norm_res = current_norm_res
        relative_norm_res = current_norm_res / max(initial_norm_res, 1e-300)
        if ptc_sigma0 is not None:
            sig = ptc_sigma0 * min(1.0, relative_norm_res)
            A = A.with_shift(
                jnp.asarray(sig, R_b.dtype) * jnp.abs(A.diag())
            )
        du_p, _ = solve_ksp(
            A, R_b, method=linear_method or "gmres", pc=linear_pc or "jacobi",
            monitor=monitor_linear, rtol=linear_rtol, atol=linear_atol,
            lattice_shape=lattice_shape, n_fields=n_fields,
        )
        current_norm = float(jnp.linalg.norm(du_p))
        if i == 0:
            initial_norm = current_norm
        if du_0_mag is not None:
            initial_norm = du_0_mag
        relative_norm = current_norm / max(initial_norm, 1e-300)
        if monitor_newton:
            log_info(
                f"Newton solver iteration: {i}, Relative norm of du: "
                f"{relative_norm}, Relative norm of res: {relative_norm_res}"
            )
        if relative_norm < relative_tolerance and \
                relative_norm_res < relative_tolerance:
            converged = True
            break
        if i > 1 and (
            current_norm < absolute_tolerance
            or current_norm_res < absolute_tolerance_res
        ):
            converged = True
            break
        if line_search:
            mask = None
            if bfr_tol is not None:
                mask = trim_mask_from_diag(A.diag(), bfr_tol)
            elif zero_ids is not None:
                mask = mask_from_ids(zero_ids, M.n_bg_dofs)

            def merit(trial_p, trial_f):
                R = _residual_b(form, trial_f, M, aux, params)
                if mask is not None:
                    R = apply_trim_rhs(R, mask, target=trial_p)
                return float(jnp.linalg.norm(R))

            alpha, accepted = 1.0, False
            best_state, best_rn = None, float("inf")
            for _ in range(max_halvings):
                trial_p = u_p - (alpha * relax_param) * du_p
                trial_f = M.mv(trial_p)
                rn = merit(trial_p, trial_f)
                if rn <= (1.0 - 1e-4 * alpha) * current_norm_res:
                    u_p, u_f, accepted = trial_p, trial_f, True
                    break
                if rn < best_rn:
                    best_state, best_rn = (trial_p, trial_f, alpha), rn
                alpha *= 0.5
            if not accepted:
                u_p, u_f, alpha = best_state
            if monitor_newton:
                log_info(f"    line search: alpha = {alpha}"
                         + ("" if accepted else " (least-bad fallback)"))
        else:
            u_p = u_p - relax_param * du_p
            u_f = M.mv(u_p)

    if not converged:
        raise NonlinearSolveError("Nonlinear solver failed to converge.")
    return u_p, u_f


def solve_newtons_linear(
    form: Form,
    u_f: jnp.ndarray,
    M: ExtractionOperator,
    u_p: jnp.ndarray,
    aux=None,
    params=None,
    max_iters: int = 20,
    relative_tolerance: float = 1e-7,
    monitor_newton: bool = True,
    monitor_linear: bool = False,
    linear_method: str | None = None,
    linear_pc: str | None = None,
    relax_param: float = 1.0,
    zero_ids=None,
):
    """Defect-correction for ill-conditioned linear systems (common.py:335-402).

    Assembles A_b and L_b = Mᵀ R(u_f) once, then iterates
    res = A u + L ; solve A du = res ; u -= relax * du.

    Returns (u_p, u_f) like solve_nonlinear (u_f = M u_p, computed once at
    convergence — the system is linear, so intermediate foreground states
    are never consumed).
    """
    aux = aux or {}
    # reference builds (A, L) from the linear form pair; here the residual at
    # the current u_f plays the role of L_b = Mᵀ(-rhs): R(u) = A_f u - b_f.
    blocks, L_b = _assemble(form, jnp.zeros_like(u_f), M, aux, params)
    A = BackgroundOperator(form, blocks, M)
    # iterate from the caller's u_p — an extension over the reference, whose
    # solveNewtonsLinear resets it (u_p = zeroDofBackground, common.py:352);
    # matters for warm-started load steps.
    u_p = jnp.asarray(u_p, dtype=L_b.dtype)
    if zero_ids is not None:
        mask = mask_from_ids(zero_ids, M.n_bg_dofs)
        A = A.with_trim(mask)
        # pinned rows target ZERO: in the defect-correction fixed point
        # res = A u + L = 0 with identity trim rows, L[pin] = t gives
        # u[pin] = -t — so a warm-start u_p as target would pin the dofs at
        # MINUS the initial guess. zero_ids semantics are 'constrain to 0'
        # (trimNodes with target=u_p=0 in the reference, common.py:353-356).
        L_b = apply_trim_rhs(L_b, mask, target=None)
        u_p = jnp.where(mask, 0.0, u_p)

    initial_norm = initial_norm_res = None
    for i in range(max_iters):
        res_b = A.mv(u_p) + L_b
        current_norm_res = float(jnp.linalg.norm(res_b))
        du_p, _ = solve_ksp(
            A, res_b, method=linear_method or "gmres",
            pc=linear_pc or "jacobi", monitor=monitor_linear,
        )
        current_norm = float(jnp.linalg.norm(du_p))
        if i == 0:
            initial_norm = current_norm
            initial_norm_res = current_norm_res
        relative_norm = current_norm / max(initial_norm, 1e-300)
        relative_norm_res = current_norm_res / max(initial_norm_res, 1e-300)
        if monitor_newton:
            log_info(
                f"Newton solver iteration: {i}, Relative norm of du: "
                f"{relative_norm}, Relative norm of res: {relative_norm_res}"
            )
        if relative_norm < relative_tolerance or \
                relative_norm_res < relative_tolerance:
            log_info("converged")
            return u_p, M.mv(u_p)
        u_p = u_p - relax_param * du_p
    raise NonlinearSolveError("Nonlinear solver failed to converge.")
