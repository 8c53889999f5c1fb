"""solveKSP parity: one front-end for all background linear solves.

Maps the reference's solver menu (common.py:509-641) onto the device stack:

  method 'gmres' -> restarted (F)GMRES      (jit, on device)
         'cg'    -> preconditioned CG        (jit, on device)
         'gcr'   -> GCR(restart)             (jit, on device)
         'bicgstab'                          (jit, on device)
         'mumps'/'direct' -> host sparse LU  (SuperLU; SURVEY N5 substitution)
  pc     'jacobi' (exact diagonal of Mᵀ A_f M), 'none'
         'bjacobi' field-coupled point-block Jacobi (exact (nf, nf) node
                  blocks via BackgroundOperator.block_diag; needs n_fields>1)
         'mg'     geometric multigrid on a lattice background: the projected
                  operator is probed into stencil form (ops/stencil.py) and
                  preconditioned by a V-cycle (ops/multigrid.py) — the
                  on-device replacement for the MUMPS/ILU roles on
                  structured backgrounds; requires ``lattice_shape``.
         'asm'    restricted additive Schwarz (PCASM, common.py:576-587):
                  host-built overlapping patches from the explicit projected
                  CSR, batched dense patch inverses applied on device
                  (precond.AdditiveSchwarz) — the strong-PC option for
                  NON-lattice backgrounds where 'mg' does not apply.
         ('ICC'/'ILU'/'ILUT' are accepted and degrade to 'jacobi' with a
          warning: incomplete factorizations are inherently sequential and have
          no data-parallel analog; 'asm'/'mg' are the strong-PC substitutes.)
"""
from __future__ import annotations

import os
import warnings
import weakref
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from iifea.ops.projection import BackgroundOperator
from iifea.solvers import krylov, precond
from iifea.solvers.direct import solve_direct
from iifea.solvers.trim import apply_trim_rhs, trim_mask_from_diag

_SEQUENTIAL_PC = {"ICC", "ILU", "ILUT"}

# binned-projection tables are a host-side pass over every element plus
# device uploads; repeated solve_ksp(pc='mg') calls on the same (form, M)
# must not pay that setup each time. Weak keys: dropping the form/M frees
# the tables.
_BINNED_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_BINNED_FAIL = object()  # sentinel: binning raised LatticeBinError


def _binned_reducers_cached(form, M, shape, dtype):
    from iifea.ops import cell_window, lattice_bin

    per_form = _BINNED_CACHE.setdefault(form, weakref.WeakKeyDictionary())
    key_map = per_form.setdefault(M, {})
    key = (shape, np.dtype(dtype).name)
    if key not in key_map:
        build = (
            lattice_bin.build_binned_projection if len(shape) == 2
            else cell_window.build_window_projection
        )
        try:
            key_map[key] = build(form, M, shape, dtype=dtype)
        except lattice_bin.LatticeBinError:
            key_map[key] = _BINNED_FAIL
    out = key_map[key]
    return None if out is _BINNED_FAIL else out


def _probe_chunk(A, dtype) -> int | None:
    """Probe columns per chunk so the stacked mv_multi's live temporaries —
    the (k, ne, nE) element gather, the accumulator, and one (k, ne, nE)
    product per local dof b (Form.matvec_multi's unrolled FMA sum) — stay
    under IIFEA_PROBE_BUDGET_MB (default 2048). A radius-3 probe in 3D is
    343 columns; unchunked on a ~1.6M-element quadratic foreground that is a
    >200 GB allocation. Allocator fragmentation can roughly triple the
    planned peak — hence the honest (ne + 3) temp count and a default
    budget far under physical device memory."""
    import os

    try:
        terms = A.form.terms
    except AttributeError:
        return None
    per_col = 0
    n_temps = 4
    for (dom, _) in terms:
        ne, nE = dom.eldofsT.shape
        if ne * nE > per_col:
            per_col = ne * nE
            n_temps = ne + 3
    if per_col == 0:
        return None
    budget = float(os.environ.get("IIFEA_PROBE_BUDGET_MB", 2048)) * 2 ** 20
    return max(int(budget // (n_temps * per_col * np.dtype(dtype).itemsize)),
               1)


@partial(jax.jit, static_argnames=("method", "restart", "max_it"))
def _krylov_solve_asm(A, b, x0, idx, inv, own, passthrough, rtol, atol,
                      max_it, method, restart):
    """Krylov with the restricted-additive-Schwarz apply inlined (operands
    as arrays so repeat solves with fresh patch tables hit the jit cache)."""
    n = b.shape[0]

    def minv(r):
        rp = jnp.concatenate([r, jnp.zeros(1, r.dtype)])
        y = jnp.einsum("pij,pj->pi", inv, rp[idx],
                       precision=jax.lax.Precision.HIGHEST) * own
        z = jnp.zeros(n + 1, r.dtype).at[
            idx.reshape(-1)
        ].add(y.reshape(-1))[:n]
        return z + passthrough * r

    kw = dict(minv=minv, rtol=rtol, atol=atol, max_it=max_it)
    if method == "cg":
        return krylov.cg(A.mv, b, x0, **kw)
    if method == "bicgstab":
        return krylov.bicgstab(A.mv, b, x0, **kw)
    if method == "gcr":
        return krylov.gcr(A.mv, b, x0, restart=restart, **kw)
    return krylov.gmres(A.mv, b, x0, restart=restart, **kw)


@partial(jax.jit, static_argnames=("method", "pc", "restart", "max_it"))
def _krylov_solve(A, b, x0, diag, rtol, atol, max_it, method, pc, restart):
    if pc == "jacobi":
        minv = precond.jacobi(diag)
    elif pc == "bjacobi":
        minv = precond.block_jacobi(diag)
    else:
        minv = None
    kw = dict(minv=minv, rtol=rtol, atol=atol, max_it=max_it)
    if method == "cg":
        return krylov.cg(A.mv, b, x0, **kw)
    if method == "bicgstab":
        return krylov.bicgstab(A.mv, b, x0, **kw)
    if method == "gcr":
        return krylov.gcr(A.mv, b, x0, restart=restart, **kw)
    return krylov.gmres(A.mv, b, x0, restart=restart, **kw)


# Every jitted helper below lives at module scope: defining jit wrappers
# inside _mg_solve (a fresh lambda per call) made EVERY solve_ksp(pc='mg')
# re-trace and re-compile the probe and Krylov graphs — measured at ~100 s
# per repeat solve on the elasticity workload bench (round 4). Module-level
# functions hit jax's jit cache on repeat calls with the same form/M.


@partial(jax.jit,
         static_argnames=("shape", "n_fields", "radius", "dtn", "chunk"))
def _probe_block(A, shape, n_fields, radius, dtn, chunk):
    from iifea.ops.stencil import (
        StencilOperatorBlock2D,
        StencilOperatorBlock3D,
    )

    opB = (StencilOperatorBlock2D if len(shape) == 2
           else StencilOperatorBlock3D)
    return opB.probe_multi(
        A.mv_multi, shape, n_fields=n_fields, radius=radius,
        dtype=jnp.dtype(dtn), chunk=chunk,
    )


@partial(jax.jit, static_argnames=("shape", "radius", "dtn", "chunk"))
def _probe_general(A, shape, radius, dtn, chunk):
    from iifea.ops.stencil import StencilOperator2D, StencilOperator3D

    op = StencilOperator2D if len(shape) == 2 else StencilOperator3D
    return op.probe_multi(
        A.mv_multi, shape, radius=radius, dtype=jnp.dtype(dtn), chunk=chunk,
    )


@partial(jax.jit, static_argnames=("shape", "dtn"))
def _probe_binned_2d(reds, blocks, shape, dtn):
    from iifea.ops import lattice_bin
    from iifea.ops.stencil import StencilOperator2D

    dt = jnp.dtype(dtn)
    # direct window-congruence assembly (no probe vectors); the legacy
    # 25-color probe remains behind IIFEA_2D_COLOR_PROBE for A/B
    if os.environ.get("IIFEA_2D_COLOR_PROBE"):
        Y = lattice_bin.probe_y_binned(reds, [K.astype(dt) for K in blocks])
        return StencilOperator2D.from_probe_y(Y, shape, radius=2, dtype=dt)
    C = lattice_bin.stencil_planes_binned(
        reds, [K.astype(dt) for K in blocks]
    )
    return StencilOperator2D(C, shape, 2)


@partial(jax.jit, static_argnames=("shape", "dtn"))
def _probe_binned_3d(reds, blocks, shape, dtn):
    from iifea.ops import cell_window
    from iifea.ops.stencil import StencilOperator3D

    dt = jnp.dtype(dtn)
    # fused slab-scan probe: compact blocks in, no slot-bound K and no
    # materialized G (those two OOMed the 16 GB chip at 1M dofs, round 4)
    C = cell_window.stencil_planes_windows(reds, blocks, dtype=dt)
    return StencilOperator3D(C, shape, 2)


@partial(jax.jit, static_argnames=("method", "max_it", "restart"))
def _run_stencil_krylov(S, mgp, Q, b, x0, rtol, atol, method, max_it,
                        restart):
    """Krylov on a probed stencil operator, MG(+deflation) preconditioned."""
    if mgp is not None:
        if Q is None:
            minv = mgp.minv
        else:
            def deflate(v):
                hi = jax.lax.Precision.HIGHEST
                return v - jnp.matmul(Q.T, jnp.matmul(Q, v, precision=hi),
                                      precision=hi)

            def minv(r):
                return deflate(mgp.minv(deflate(r)))
    else:
        d = S.diag()
        invd = 1.0 / jnp.where(jnp.abs(d) > 0, d, 1.0)
        minv = lambda r: invd * r
    mv = S.mv
    kw = dict(minv=minv, rtol=rtol, atol=atol, max_it=max_it)
    if method == "cg":
        # check_every=4 (not the 25 default): with an MG V-cycle per
        # iteration, over-running the tolerance by up to check_every-1
        # iterations costs far more than the extra convergence-check dots
        return krylov.cg(mv, b, x0, check_every=4, **kw)
    return krylov.gmres(mv, b, x0, restart=restart, **kw)


@jax.jit
def _residual_rel(A, b, x):
    r = b - A.mv(x)
    return r, jnp.linalg.norm(r) / jnp.linalg.norm(b)


def _deflation_space(S, n_fields, dtype):
    """Field-constant null-mode deflation. Enclosed-flow NS (TG class:
    velocity Dirichlet everywhere, no pressure BC) carries an exact
    constant-pressure null mode; the reference's plain GMRES+jacobi
    tolerates it silently, but a V-cycle's coarse (pseudo-)inverse
    amplifies near-null content into O(1/sigma) garbage. Detect each
    field's supported-constant vector with one matvec and project it
    out of the preconditioner's input and output."""
    nn = S.nn
    dgf = jnp.stack(
        [S.point_block_diag()[f, f] for f in range(n_fields)]
    )                                                  # (nF, nn)
    sig = float(jnp.abs(S.coeffs).sum(axis=(1, 2)).max())
    qs = []
    for f in range(n_fields):
        v = jnp.zeros((n_fields, nn), dtype)
        v = v.at[f].set((jnp.abs(dgf[f]) > 0).astype(dtype))
        v = v.reshape(-1)
        vn = float(jnp.linalg.norm(v))
        if vn == 0.0:
            continue
        v = v / vn
        if float(jnp.linalg.norm(S.mv(v))) < 1e-8 * sig:
            qs.append(v)
    return jnp.stack(qs) if qs else None


def _mg_solve(A, b, x0, lattice_shape, method, rtol, atol, max_it,
              n_fields=1, stencil_radius=2, restart=300, mixed=False):
    """Stencil-probe the projected operator and MG-precondition the Krylov
    solve (the 'mg' pc): the bench.py fast path as a library feature.

    Scalar 2D and 3D lattices and block (multi-field) 2D/3D lattices get the
    geometric-multigrid V-cycle (StencilMultigrid / StencilMultigrid3D /
    StencilMultigridBlock) — always the dense shifted-FMA matvec instead of
    the gather-bound general path.

    ``mixed``: probe, MG, and Krylov run in f32; the f32 correction is
    iteratively refined against the true f64 operator (one general matvec
    per pass) until the f64 relative residual meets rtol — the same
    refinement the Poisson fast path uses (solvers/lattice_fast.py)."""
    from iifea.ops.multigrid import (
        StencilMultigrid,
        StencilMultigrid3D,
        StencilMultigridBlock,
        StencilMultigridBlock3D,
    )

    shape = tuple(lattice_shape)
    sdt = np.dtype(np.float32) if mixed else np.dtype(b.dtype)
    dtn = sdt.name

    # -- probe the projected operator into stencil form ----------------------
    if n_fields > 1:
        pchunk = _probe_chunk(A, sdt)
        S = _probe_block(A, shape, n_fields, stencil_radius, dtn, pchunk)
        mg = (StencilMultigridBlock if len(shape) == 2
              else StencilMultigridBlock3D)(S)
        Q = _deflation_space(S, n_fields, sdt)
    else:
        S = None
        if (A.trim_mask is None and getattr(A, "shift", None) is None
                and A.form.space is not None and stencil_radius == 2):
            # the binned/window reducers assume the degree-1 simplex lattice
            # (radius-2) geometry; other radii (e.g. 3 for quadratic B-spline
            # backgrounds) take the general colored probe
            reducers = _binned_reducers_cached(A.form, A.M, shape, sdt.type)
            if reducers is not None:
                probe = (_probe_binned_2d if len(shape) == 2
                         else _probe_binned_3d)
                S = probe(reducers, A.blocks, shape, dtn)
        if S is None:
            pchunk = _probe_chunk(A, sdt)
            S = _probe_general(A, shape, stencil_radius, dtn, pchunk)
        mg = (StencilMultigrid(S) if len(shape) == 2
              else StencilMultigrid3D(S))
        Q = None

    if not mixed:
        return _run_stencil_krylov(
            S, mg, Q, b, x0, jnp.asarray(rtol, b.dtype),
            jnp.asarray(atol, b.dtype), method, int(max_it), int(restart),
        )

    # -- mixed precision: f32 MG-Krylov passes + f64 refinement --------------
    b_norm = float(jnp.linalg.norm(b))
    rtol_eff = max(float(rtol), float(atol) / max(b_norm, 1e-300))
    x64 = x0.astype(jnp.float64)
    zero32 = jnp.zeros(b.shape, jnp.float32)
    iters, relf, hist = 0, 1.0, []
    for _ in range(12):
        r64, rel = _residual_rel(A, b, x64)
        relf = float(rel)
        hist.append(relf)
        if relf < rtol_eff or iters >= int(max_it):
            break
        # contract only as far as this pass needs (0.25x margin absorbs the
        # f32 apply error), clamped to the f32 floor
        rtol_pass = min(max(0.25 * rtol_eff / relf, 1e-6), 3e-2)
        dx, info = _run_stencil_krylov(
            S, mg, Q, r64.astype(jnp.float32), zero32,
            jnp.asarray(rtol_pass, jnp.float32), jnp.asarray(0.0, jnp.float32),
            method, int(max_it), int(restart),
        )
        it_pass = int(info.iters)
        iters += it_pass
        x64 = x64 + dx.astype(jnp.float64)
        if it_pass == 0:
            break  # no progress possible (e.g. zero rhs)
    return x64, krylov.SolveInfo(
        jnp.asarray(iters), jnp.asarray(relf * b_norm),
        jnp.asarray(relf < rtol_eff), jnp.asarray(hist),
    )


def solve_ksp(
    A: BackgroundOperator,
    b: jnp.ndarray,
    x0: jnp.ndarray | None = None,
    method: str = "gmres",
    pc: str = "jacobi",
    rtol: float = 1e-8,
    atol: float = 1e-9,
    max_it: int = 1000000,
    gmres_restart: int = 300,
    bfr_tol: float | None = None,
    bfr_b: bool = True,
    monitor: bool = True,
    lattice_shape: tuple | None = None,
    n_fields: int = 1,
    stencil_radius: int = 2,
    mixed: bool = False,
    asm_core: int = 64,
    asm_overlap: int = 1,
):
    """Solve A u = b on the background space. Returns (u, info|None).

    ``mixed`` applies to pc='mg' only (see _mg_solve): f32 MG-Krylov + f64
    refinement instead of MG-Krylov in the system's own dtype."""
    method = method or "gmres"
    pc = pc or "jacobi"
    if pc in _SEQUENTIAL_PC:
        warnings.warn(
            f"preconditioner '{pc}' has no data-parallel analog; using 'jacobi' "
            "(see solvers/precond.py)", stacklevel=2
        )
        pc = "jacobi"

    if bfr_tol is not None:
        # remove_zero_diagonal path of solveKSP (common.py:529-533, 565-566)
        diag0 = A.diag()
        mask = trim_mask_from_diag(diag0, bfr_tol)
        A = A.with_trim(mask)
        if bfr_b:
            b = apply_trim_rhs(b, mask)

    if method in ("mumps", "direct"):
        A_sp = A.to_scipy()
        u = solve_direct(A_sp, np.asarray(b))
        return jnp.asarray(u), None

    x0 = jnp.zeros_like(b) if x0 is None else x0
    if pc in ("asm", "ASM"):
        # restricted additive Schwarz (PCASM role, common.py:576-587):
        # host patch setup from the explicit CSR, device batched apply.
        # Measured on the Kirsch k=2 system (hole_in_plate Quadratic
        # FG_R1/R2): 24 gmres iterations vs 117 with jacobi.
        from iifea.solvers.precond import AdditiveSchwarz

        asm = AdditiveSchwarz(
            A.to_scipy().tocsr(), core_size=asm_core, overlap=asm_overlap
        )
        x, info = _krylov_solve_asm(
            A, b, x0, asm.idx, asm.inv, asm.own, asm.passthrough,
            jnp.asarray(rtol, b.dtype), jnp.asarray(atol, b.dtype),
            int(max_it), method, int(gmres_restart),
        )
        if monitor:
            _print_monitor(info)
        return x, info
    if pc == "mg":
        if lattice_shape is None:
            raise ValueError("pc='mg' requires lattice_shape=(nx+1, ny+1[, nz+1])")
        x, info = _mg_solve(A, b, x0, lattice_shape, method, rtol, atol,
                            max_it, n_fields=n_fields,
                            stencil_radius=stencil_radius,
                            restart=gmres_restart, mixed=mixed)
        if monitor:
            _print_monitor(info)
        return x, info
    if pc == "bjacobi" and n_fields <= 1:
        warnings.warn(
            "pc='bjacobi' with a single field is pointwise jacobi; "
            "pass n_fields>1 for field-coupled blocks", stacklevel=2
        )
        pc = "jacobi"
    if pc == "bjacobi":
        # field-coupled point-block diagonal (PCBJACOBI, common.py:568-616)
        diag = A.block_diag(n_fields)
    elif pc == "jacobi":
        diag = A.diag()
    else:
        diag = jnp.ones_like(b)
    x, info = _krylov_solve(
        A, b, x0, diag,
        jnp.asarray(rtol, b.dtype), jnp.asarray(atol, b.dtype),
        int(max_it), method, pc, int(gmres_restart),
    )
    if monitor:
        _print_monitor(info)
    return x, info


def _print_monitor(info):
    print(
        f"Converged in {int(info.iters)} iterations. "
        f"(residual norm {float(info.resnorm):.3e})"
    )
    if info.history is not None:
        h = np.asarray(info.history)
        print("Convergence history:", h[h >= 0].tolist())
