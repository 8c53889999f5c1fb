"""Host sparse direct solve — the 'mumps' role.

Sparse LU is a sequential factorization with no on-device implementation here (SURVEY.md §2.3 N5); the reference's MUMPS path
(common.py:525-551) is covered by SuperLU (scipy.sparse.linalg.splu) on the
host CPU, including the null-pivot handling the reference enables via
``mat_mumps_icntl_24=1`` / ``cntl_3=1e-12``:

- structurally empty rows (background basis functions without foreground
  support, common.py:261-332) are converted to identity rows up front;
- each factorization's *stability* is judged by iterative refinement, not
  by its one-solve residual: a stable LU of an ill-conditioned system
  (shell Jacobians) stagnates at its conditioning floor and is accepted,
  while an unstable one (element growth on near-null subspaces) diverges
  under refinement and triggers an escalating relative-diagonal BFR trim
  (row+column zeroed, unit diagonal, zero rhs — the trimNodes semantics of
  common.py:261-332). This mirrors MUMPS, which fixes null pivots as they
  appear during elimination; SuperLU has no such hook.
- if every rung is unstable (non-axis-aligned near-null subspaces that no
  diagonal threshold can see), the solve falls back to Jacobi-PCG from
  zero, which never excites the near-null directions.

On well-conditioned systems the first factorization passes the residual
check and none of this machinery engages.
"""
from __future__ import annotations

import numpy as np

# escalation ladder of relative-diagonal trim thresholds (|d| <= tol*max|d|);
# chosen around MUMPS cntl_3=1e-12-with-dynamic-fixation behavior. 3D immersed
# Poisson (cube R3) needs 1e-10 to factor stably; 2D problems stop at `None`.
_TRIM_LADDER = (None, 1e-12, 1e-10, 1e-8, 1e-6)


def _trim_sym(A, b, keep_mask):
    """Zero rows+columns of ~keep_mask, unit diagonal, zero rhs (BFR)."""
    import scipy.sparse as sp

    Dm = sp.diags(keep_mask.astype(np.float64))
    At = (Dm @ A @ Dm + sp.diags(1.0 - keep_mask)).tocsc()
    return At, b * keep_mask


def solve_direct(
    A_csr,
    b: np.ndarray,
    null_pivot_tol: float = 1e-12,
    relres_ok: float = 1e-8,
    relres_accept: float = 1e-4,
):
    """Solve A x = b with sparse LU; returns numpy array."""
    import scipy.sparse.linalg as spla

    A = A_csr.tocsr()
    b = np.asarray(b, dtype=np.float64)
    n = A.shape[0]

    # structurally dead rows: max |entry| below the absolute tolerance
    row_max = np.zeros(n)
    if A.nnz:
        row_of = np.repeat(np.arange(n), np.diff(A.indptr))
        np.maximum.at(row_max, row_of, np.abs(A.data))
    alive = (row_max > null_pivot_tol).astype(np.float64)

    d = np.abs(A.diagonal())
    dmax = d.max() if n else 1.0

    best = None
    for tol in _TRIM_LADDER:
        keep = alive if tol is None else alive * (d > tol * dmax)
        At, bt = _trim_sym(A, b, keep)
        # relres must be relative to the system actually factorized: if a
        # trim rung zeroes rows carrying most of ||b||, normalizing by the
        # untrimmed rhs would deflate the residual and let an inaccurate
        # solve pass relres_ok
        bnorm = max(np.linalg.norm(bt), 1e-300)
        try:
            lu = spla.splu(At)
            x = lu.solve(bt)
        except RuntimeError:  # singular factor: escalate the trim
            continue
        relres = np.linalg.norm(At @ x - bt) / bnorm
        if not np.isfinite(relres):
            continue
        # Iterative refinement distinguishes the two failure modes that a
        # one-solve residual cannot:
        #  * a STABLE factorization of an ill-conditioned system (shell
        #    Jacobians: relres stalls near eps*cond ~ 1e-5) — refinement
        #    stagnates but never grows; the solution is the right Newton
        #    step and must be ACCEPTED, because deeper trim rungs would
        #    discard well-supported dofs with legitimately small h^3
        #    bending diagonals and collapse the solution toward zero;
        #  * an UNSTABLE factorization (element growth on near-null
        #    subspaces: cube R3) — refinement diverges explosively
        #    (1.9e-4 -> 5.7e10 in one pass); escalate the trim.
        diverged = False
        for _ in range(4):
            if relres <= relres_ok:
                break
            dx = lu.solve(bt - At @ x)
            x2 = x + dx
            r2 = np.linalg.norm(At @ x2 - bt) / bnorm
            if not np.isfinite(r2) or r2 > 10.0 * relres:
                diverged = True
                break
            if r2 < relres:
                x, relres = x2, r2
            else:                      # stagnated at the conditioning floor
                break
        if best is None or relres < best[0]:
            best = (relres, x)
        if relres <= relres_ok or (not diverged and relres <= relres_accept):
            return x

    # Diagonal trimming cannot reach near-null subspaces that are not
    # axis-aligned (pairs of basis functions with nearly coincident
    # support); MUMPS catches those as tiny pivots mid-elimination. When
    # every LU rung fails the backward-error check, fall back to Jacobi-PCG
    # from zero: Krylov iterations never excite the near-null directions
    # (b has no component there), so the solution stays bounded.
    At, bt = _trim_sym(A, b, alive)
    bnorm = max(np.linalg.norm(bt), 1e-300)
    dd = np.abs(At.diagonal())   # |diag|: CG needs a positive preconditioner
    Minv = _sp_diags(1.0 / np.where(dd > 0, dd, 1.0))
    x = np.zeros(n)
    for solver in (spla.cg, spla.bicgstab):
        try:
            x_it, _ = solver(At, bt, M=Minv, x0=x, maxiter=20000,
                             rtol=relres_ok * 1e-2, atol=0.0)
        except TypeError:  # older scipy spells rtol as tol
            x_it, _ = solver(At, bt, M=Minv, x0=x, maxiter=20000,
                             tol=relres_ok * 1e-2, atol=0.0)
        relres = np.linalg.norm(At @ x_it - bt) / bnorm
        if np.isfinite(relres) and (best is None or relres < best[0]):
            best = (relres, x_it)
        if relres <= relres_ok:
            return x_it
        x = x_it if np.all(np.isfinite(x_it)) else x

    if best is None:
        raise RuntimeError("solve_direct: all trimmed factorizations failed")
    return best[1]


def _sp_diags(v):
    import scipy.sparse as sp

    return sp.diags(v)
