#!/usr/bin/env python3
"""Headline benchmark (BASELINE.md north star).

Immersed Poisson on a synthetic MORIS-style cut square (or cube, --dim 3):
assemble + Galerkin projection (Mᵀ A_f M) + solve at >= 1M background DOFs
on one device, to < 1e-10 relative (f64) residual, vs the
reference-equivalent CPU pipeline (scipy CSR assemble + PtAP + Jacobi-PCG —
the same algorithm FEniCS+PETSc runs, minus MPI), executed in a subprocess
on the host CPU.

Device pipeline (solvers/lattice_fast.py; see PERF.md for the phases):
  1. f64 element Jacobians + rhs on lattice-binned tables;
  2. gather-free f32 stencil extraction of the projected operator
     (ops/lattice_bin.py in 2D, ops/cell_window.py in 3D) + geometric
     multigrid hierarchy;
  3. f32 MG-PCG on the stencil planes, iteratively refined against the
     f64 operator until the relative f64 residual is < 1e-10.

Prints ONE JSON line:
  {"metric": ..., "value": <device seconds>, "unit": "s",
   "vs_baseline": <cpu/device>, "device": {...}}
Any failure raises, so the process exits non-zero.
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BASELINE_CACHE = os.path.join(HERE, "bench_baseline.json")


def fg_of(n_bg, dim=2):
    # 2D: the sqrt(2) fg/bg spacing ratio of the reference workloads.
    # 3D: 1.26 (~2^(1/3)). The round-4 1.19 choice (picked to keep the
    # max-slot-padded tables inside HBM) made fg and bg spacings nearly
    # equal, which breeds near-duplicate basis functions: measured 116
    # MG-PCG iters to 1e-6 at 17³ vs 32 at ratio 1.26 / 36 at 1.41. With
    # the l_cap-split tables the memory argument is gone, so the ratio is
    # chosen for conditioning (1.26 best of the sweep, r5).
    r = 1.4142 if dim == 2 else 1.26
    return int(n_bg * r) // 2 * 2


def build_problem(n_bg: int, dtype, dim: int = 2):
    from iifea.mesh.generators import (
        immersed_cube_problem,
        immersed_square_problem,
    )
    from iifea.models.poisson import PoissonProblem

    gen = immersed_square_problem if dim == 2 else immersed_cube_problem
    mesh_f, M = gen(n_fg=fg_of(n_bg, dim), n_bg=n_bg, degree=1, dtype=dtype)
    prob = PoissonProblem(mesh_f, k=1, sym=True, beta_value=10, dtype=dtype)
    return mesh_f, prob, M


def run_device(n_bg: int, rtol: float = 1e-10, verbose=False, dim: int = 2):
    import jax
    import jax.numpy as jnp
    from iifea.ops import lattice_bin
    from iifea.ops.multigrid import StencilMultigrid
    from iifea.ops.projection import BackgroundOperator
    from iifea.ops.stencil import StencilOperator2D
    from iifea.solvers import krylov
    from iifea.solvers.lattice_fast import BinnedLatticeSolver

    t0 = time.time()
    mesh_f, prob64, M64 = build_problem(n_bg, np.float64, dim)
    form64 = prob64.form
    shape = (n_bg + 1,) * dim
    # the whole fast pipeline is a LIBRARY feature (solvers/lattice_fast.py):
    # binned reducers + rhs tables + slot-bound geometry at setup, then
    # df assembly -> gather-free probe (2D: color probe, 3D: cell-window
    # congruence) -> MG -> f32 MG-PCG + df refinement
    try:
        solver = BinnedLatticeSolver(prob64, M64, shape)
    except lattice_bin.LatticeBinError:
        if dim != 2:
            raise  # the general fallback pipeline below is 2D-only
        solver = None
    t_setup = time.time() - t0

    # general fallback (gather-bound; used only when binning fails) --------
    from functools import partial as _partial

    @_partial(jax.jit, static_argnames=("kern_id",))
    def term_blocks64(dom, kern_id, u):
        from iifea.ops.assembly import Form as _F
        sub = _F.tree_unflatten(
            ((form64.terms[kern_id].kernel,), form64.n_dofs, form64.n_fields),
            (dom,),
        )
        blocks, r = sub.jacobian_and_residual(u, chunk=1 << 18)
        return blocks[0], r

    @jax.jit
    def project_rhs(M, r):
        return M.rmv(-r)

    def assemble64(form, M, u):
        blocks, rs = zip(*[
            term_blocks64(t.domain, i, u) for i, t in enumerate(form.terms)
        ])
        return list(blocks), project_rhs(M, sum(rs[1:], rs[0]))

    @jax.jit
    def probe32(form, M, blocks32):
        A = BackgroundOperator(form, blocks32, M)
        return StencilOperator2D.probe_multi(
            A.mv_multi, shape, radius=2, dtype=jnp.float32
        )

    @jax.jit
    def residual64(form, M, blocks64, b64, x64):
        A = BackgroundOperator(form, blocks64, M)
        r = b64 - A.mv(x64)
        return r, r.astype(jnp.float32), jnp.linalg.norm(r) / jnp.linalg.norm(b64)

    @jax.jit
    def cg32(S32, mg, r, rtol_pass):
        return krylov.cg(
            S32.mv, r, minv=mg.minv, rtol=rtol_pass, atol=1e-30,
            max_it=500, check_every=4,
        )

    u64 = jnp.zeros(prob64.space.n_dofs, jnp.float64)

    def full_solve():
        if solver is not None:
            x64, info = solver.solve(rtol=rtol)
            return x64, info["rel_residual"], info["cg_iters"]
        blocks64, b64 = assemble64(form64, M64, u64)
        S32 = probe32(form64, M64,
                      [b.astype(jnp.float32) for b in blocks64])
        mg = StencilMultigrid(S32)
        x64 = jnp.zeros(M64.n_bg_dofs, jnp.float64)
        relres, iters = 1.0, 0
        for i in range(10):
            if i == 0:
                r32 = b64.astype(jnp.float32)
            else:
                _, r32, rr = residual64(form64, M64, blocks64, b64, x64)
                relres = float(rr)
                if relres < rtol:
                    break
            rtol_pass = min(max(0.25 * rtol / relres, 1e-6), 3e-2)
            dx, info = cg32(S32, mg, r32, rtol_pass)
            iters += int(info.iters)
            x64 = x64 + dx.astype(jnp.float64)
        else:
            # exhausted the pass budget: re-measure for the returned x64
            _, _, rr = residual64(form64, M64, blocks64, b64, x64)
            relres = float(rr)
        return x64, relres, iters

    t0 = time.time()
    x64, relres, iters = full_solve()
    jax.block_until_ready(x64)
    t_first = time.time() - t0

    def _phase_traffic(S32, mg, bound, b64):
        """Modeled compulsory traffic per phase, bytes (each operand read
        once, each output written once — a lower bound on what each phase
        must move). The cg entry is per ITERATION:
        one fine matvec (coefficient planes + 3 vector streams) plus one
        V-cycle in which level l's planes are swept (nu_pre+nu_post+1) times
        (pre/post smoothing + the restriction residual), plus ~6 CG-body
        vector streams."""
        def nb(tree):
            return sum(
                leaf.size * leaf.dtype.itemsize
                for leaf in jax.tree_util.tree_leaves(tree)
                if hasattr(leaf, "size")
            )

        nvec32 = S32.n * 4
        lev = [nb(S.coeffs) for S in mg.levels]
        sweeps = mg.nu_pre + mg.nu_post + 1
        vcycle = sum(lb * sweeps for lb in lev) + 8 * nvec32
        return {
            "assemble_df+rhs_df": (nb(solver.rhs_tables)
                                   + nb(solver.JinvT_b) + nb(solver.wdetT_b)
                                   + nb(bound[0]) + b64.size * 8),
            "bind_facet": 2 * nb(bound[1]),
            "probe": nb(bound) + nb(solver.reducers) + lev[0],
            "mg_build": lev[0] + sum(lev[1:]),
            "cg_per_iter": lev[0] + 3 * nvec32 + vcycle + 6 * nvec32,
            # binned path: reducer apply_df over the bound tables; window
            # path: general f64 matvec over the compact blocks (+ M tables,
            # uncounted) — either way bound + vector streams dominate
            "residual_df": nb(bound) + 10 * nvec32,
        }

    if os.environ.get("IIFEA_BENCH_PHASES") and solver is not None:
        # per-phase wall clock: each phase runs twice on ready inputs,
        # best of the two is reported
        ph = {}

        def timed(name, fn, *inputs):
            best = None
            out = None
            for _ in range(2):
                jax.block_until_ready(inputs)
                t = time.time()
                out = jax.block_until_ready(fn())
                dt = time.time() - t
                best = dt if best is None else min(best, dt)
            ph[name] = best
            return out

        b64, K_cell_b, K_facet = timed(
            "assemble_df+rhs_df", lambda: solver.assemble(), u64)
        bound = timed("bind_facet",
                      lambda: solver.bind(K_cell_b, K_facet),
                      K_cell_b, K_facet)
        S32 = timed("probe", lambda: solver.probe(bound), bound)
        mg = timed("mg_build", lambda: solver.build_mg(S32), S32)
        r32 = b64.astype(jnp.float32)
        dx, info = timed(
            "cg_pass1", lambda: solver._cg_fn(S32, mg, r32, 1e-6), mg, r32)
        ph["cg1_iters"] = int(info.iters)
        x1 = jnp.zeros(M64.n_bg_dofs, jnp.float64) + dx.astype(jnp.float64)
        _, r32b, _ = timed(
            "residual_df",
            lambda: solver._residual_fn(solver.reducers, bound, b64, x1), x1)
        dx2, info2 = timed(
            "cg_pass2", lambda: solver._cg_fn(S32, mg, r32b, 1e-4), r32b)
        ph["cg2_iters"] = int(info2.iters)
        # achieved bandwidth per phase (modeled bytes / wall time)
        traffic = _phase_traffic(S32, mg, bound, b64)
        bw = {}
        for name, nbytes in traffic.items():
            if name == "cg_per_iter":
                continue
            t = ph.get(name)
            if t:
                bw[name] = round(nbytes / t / 1e9, 1)
        for p, it in (("cg_pass1", "cg1_iters"), ("cg_pass2", "cg2_iters")):
            if ph.get(p) and ph.get(it):
                bw[p] = round(
                    traffic["cg_per_iter"] * ph[it] / ph[p] / 1e9, 1
                )
        ph["gbps"] = bw
        print("phases:", json.dumps(
            {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in ph.items()}), file=sys.stderr)

    times = []
    for _ in range(3):
        t0 = time.time()
        x64, relres, iters = full_solve()
        jax.block_until_ready(x64)
        times.append(time.time() - t0)

    out = {
        "t_setup_host": round(t_setup, 3),
        "t_first_incl_compile": round(t_first, 3),
        "t_best": round(min(times), 4),
        "rel_residual_f64": relres,
        "cg_iters": iters,
        "n_bg_dofs": int(M64.n_bg_dofs),
        "n_cells": int(mesh_f.n_cells),
        "device": device_info(),
    }
    if verbose:
        print("device:", json.dumps(out), file=sys.stderr)
    return out


def device_info() -> dict:
    """Platform, kind and count of the devices JAX runs on."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def sharded_refine(solver, S32, mg, bound, b64, devices: int, rtol: float):
    """``solver.refine`` with its f32 MG-PCG on row-block-sharded planes.

    The fine-level matvec exchanges 2r halo rows over the 'dp' mesh axis
    (ppermute); CG dots psum across devices; the MG preconditioner is the
    SHARDED V-cycle (parallel/multigrid.py): fine levels row-block sharded
    with GSPMD halo exchange, coarse levels + the dense coarsest inverse
    replicated. Nothing in the CG loop un-shards. Returns (x64, relres,
    iters) like ``refine``.
    """
    import jax
    import jax.numpy as jnp
    from iifea.parallel.multigrid import ShardedMultigrid2D
    from iifea.parallel.sharding import make_device_mesh
    from iifea.parallel.stencil import ShardedStencil2D
    from iifea.solvers import krylov

    mesh = make_device_mesh(devices)
    Ssh = ShardedStencil2D(S32, mesh)
    smg = ShardedMultigrid2D(mg, mesh)

    @jax.jit
    def cg_pass(b2, rtol_pass):
        return krylov.cg(Ssh.mv2, b2, minv=smg.minv_padded, rtol=rtol_pass,
                         atol=1e-30, max_it=500, check_every=4)

    def cg_sharded(_S32, _mg, r32, rtol_pass):
        dx2, info = cg_pass(Ssh.shard_vec(r32), jnp.float32(rtol_pass))
        return Ssh.unshard_vec(dx2), info

    # same refinement driver as the single-device path, sharded CG injected
    return solver.refine(S32, mg, bound, b64, rtol, cg_fn=cg_sharded)


def run_sharded(n_bg: int, devices: int, rtol: float = 1e-10):
    """Multi-device bench path: the binned 2D pipeline with the f32 MG-PCG
    on row-block-sharded planes end-to-end (see sharded_refine); assembly,
    probe and MG build run on one device."""
    from iifea.solvers.lattice_fast import BinnedLatticeSolver

    t0 = time.time()
    mesh_f, prob64, M64 = build_problem(n_bg, np.float64, 2)
    shape = (n_bg + 1, n_bg + 1)
    solver = BinnedLatticeSolver(prob64, M64, shape)
    b64, K_cell_b, K_facet = solver.assemble()
    bound = solver.bind(K_cell_b, K_facet)
    S32 = solver.probe(bound)
    mg = solver.build_mg(S32)
    x64, relres, iters = sharded_refine(solver, S32, mg, bound, b64,
                                        devices, rtol)
    return x64, {
        "devices": devices,
        "rel_residual_f64": float(relres),
        "cg_iters": iters,
        "n_bg_dofs": int(M64.n_bg_dofs),
        "t_total": round(time.time() - t0, 3),
    }


def run_workload(workload: str, n_bg: int, rtol: float, verbose=False):
    """Non-Poisson on-device iterative product paths (SURVEY N5: 'the
    product path is iterative') vs the host sparse-LU direct solve — the
    reference's MUMPS role at these call sites
    (linear_elasticity.py:299, biharmonic.py:233-236).

    elasticity: 2-field block stencil probe + block geometric multigrid CG
    biharmonic: radius-3 scalar stencil probe (quadratic B-spline lattice)
                + geometric multigrid GMRES
    """
    import jax
    import jax.numpy as jnp
    from iifea.ops.projection import assemble_background_system
    from iifea.solvers import solve_ksp
    from iifea.solvers.direct import solve_direct

    if workload == "elasticity":
        from iifea.mesh.generators import immersed_square_problem
        from iifea.models.elasticity import ImmersedElasticityProblem

        mesh_f, M = immersed_square_problem(
            n_fg=2 * n_bg, n_bg=n_bg, degree=1, n_fields=2
        )
        prob = ImmersedElasticityProblem(mesh_f, k=1, sym=True)
        kw = dict(method="cg", pc="mg",
                  lattice_shape=(n_bg + 1, n_bg + 1), n_fields=2)
    elif workload == "biharmonic":
        from iifea.mesh.generators import immersed_square_bspline_problem
        from iifea.models.biharmonic import BiharmonicProblem

        # nested fg/bg grids: see demos/biharmonic.py — straddling grids
        # inject an interpolation crime along bg knot lines
        mesh_f, M, lattice_shape = immersed_square_bspline_problem(
            n_fg=2 * n_bg, n_bg=n_bg
        )
        prob = BiharmonicProblem(mesh_f, sym=False, beta_value=5.0,
                                 alpha_value=5.0, filter_tol=1e-5)
        kw = dict(method="gmres", pc="mg", lattice_shape=lattice_shape,
                  stencil_radius=3)
    else:
        raise SystemExit(f"unknown --workload {workload}")

    u0 = jnp.zeros(prob.space.n_dofs)
    A, b = assemble_background_system(prob.form, u0, M)

    def iter_solve():
        t0 = time.time()
        x, info = solve_ksp(A, b, rtol=rtol, monitor=False, **kw)
        jax.block_until_ready(x)
        return x, info, time.time() - t0

    x, info, t_first = iter_solve()
    times = [iter_solve()[2] for _ in range(2)]

    t0 = time.time()
    A_sp = A.to_scipy().tocsr()
    x_lu = solve_direct(A_sp, np.asarray(b))
    t_direct = time.time() - t0

    # agreement is measured in L2 over the PHYSICAL cell domain: bg dofs
    # with no support there (zero operator rows) and fg dofs in fictitious
    # cells are arbitrary and legitimately differ between the iterative and
    # trimmed-LU paths (verified: error norms agree to 9 digits while the
    # raw dof vectors differ by O(1))
    from iifea.api import l2_norm

    nF = getattr(prob.space, "n_fields", 1)
    u_d = M.mv(x) - M.mv(jnp.asarray(x_lu))
    agree = float(
        l2_norm(u_d, prob.cell_dom, n_fields=nF)
        / max(float(l2_norm(M.mv(jnp.asarray(x_lu)), prob.cell_dom,
                            n_fields=nF)), 1e-300)
    )
    out = {
        "metric": f"immersed_{workload}_mg_iter_{int(M.n_bg_dofs)}dofs",
        "value": round(min(times), 4),
        "unit": "s",
        "vs_baseline": round(t_direct / min(times), 2),
        "t_first_incl_compile": round(t_first, 3),
        "t_host_lu": round(t_direct, 3),
        "iters": int(info.iters) if info is not None else None,
        "vs_lu_rel_diff": agree,
        "device": device_info(),
    }
    return out


def run_cpu_baseline(n_bg: int, rtol: float = 1e-10, dim: int = 2):
    """Reference-equivalent CPU pipeline (runs under JAX_PLATFORMS=cpu)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import jax.numpy as jnp

    mesh_f, prob, M = build_problem(n_bg, np.float64, dim)
    u0 = jnp.zeros(prob.space.n_dofs)
    blocks = [np.asarray(b) for b in prob.form.jacobian_blocks(u0)]
    rhs_f = -np.asarray(prob.form.residual(u0))

    t0 = time.time()
    n_fg_dofs = prob.space.n_dofs
    mats = []
    for (dom, _), K in zip(prob.form.terms, blocks):
        fl = dom.flat_eldofs_np
        ne = fl.shape[1]
        rows = np.repeat(fl, ne, axis=1).ravel()
        cols = np.tile(fl, (1, ne)).ravel()
        Kel = np.moveaxis(K, -1, 0)          # (nE, ne, ne)
        mats.append(
            sp.coo_matrix((Kel.ravel(), (rows, cols)),
                          shape=(n_fg_dofs, n_fg_dofs))
        )
    A_f = sum(mats[1:], mats[0]).tocsr()
    Msp = M.to_scipy()
    A_b = (Msp.T @ A_f @ Msp).tocsr()
    b_b = Msp.T @ rhs_f
    t_assemble = time.time() - t0

    t0 = time.time()
    d = A_b.diagonal()
    d[np.abs(d) < 1e-300] = 1.0
    Pinv = sp.diags(1.0 / d)
    x, _ = spla.cg(A_b, b_b, rtol=rtol, atol=0.0, M=Pinv, maxiter=40000)
    t_solve = time.time() - t0
    relres = float(np.linalg.norm(b_b - A_b @ x) / np.linalg.norm(b_b))
    return {
        "t_assemble_project": round(t_assemble, 3),
        "t_solve": round(t_solve, 3),
        "t_total": round(t_assemble + t_solve, 3),
        "rel_residual": relres,
        "n_bg_dofs": int(A_b.shape[0]),
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n-bg", type=int, default=None,
                   help="background lattice cells per side (default: 1024 "
                        "poisson, 512 elasticity, 511 biharmonic)")
    p.add_argument("--dim", type=int, default=2, choices=(2, 3))
    p.add_argument("--rtol", type=float, default=1e-10)
    p.add_argument("--rebaseline", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--cpu-baseline-only", action="store_true",
                   help="internal: run the CPU baseline and print JSON")
    p.add_argument("--devices", type=int, default=1,
                   help="run the sharded (row-block dp mesh) pipeline on N "
                        "devices; provisions a virtual CPU mesh when fewer "
                        "real devices exist (correctness path, 2D only)")
    p.add_argument("--workload", choices=("poisson", "elasticity",
                                          "biharmonic"), default="poisson",
                   help="non-Poisson workloads time the on-device iterative "
                        "product path against the host sparse-LU (MUMPS "
                        "role) on the same system; --n-bg sets the lattice")
    args = p.parse_args()
    if args.n_bg is None:
        # power-of-two(+/-1) lattices coarsen all the way down in the MG
        # hierarchy: n+1 (P1) resp. n+2 (quadratic B-spline) must be 2^k+1
        args.n_bg = {"poisson": 1024, "elasticity": 512,
                     "biharmonic": 511}[args.workload]
        if args.dim == 3 and args.workload == "poisson":
            # 105^3 = 1.157M >= 1M dofs AND coarsens 105-53-27-14 to a
            # dense coarse inverse. The first 3D attempt used n_bg=100,
            # whose 101-51-26 ladder bottoms out at 26^3 = 17.6k dofs with
            # only Jacobi sweeps as the "coarse solve": CG then ran 3132
            # iterations (6 passes at the cap).
            args.n_bg = 104

    if args.devices > 1:
        import jax

        if len(jax.devices()) < args.devices:
            raise SystemExit(
                f"--devices {args.devices}: only {len(jax.devices())} "
                "devices visible. Provision a virtual mesh first, e.g.\n"
                "  XLA_FLAGS=--xla_force_host_platform_device_count="
                f"{args.devices} JAX_PLATFORMS=cpu python bench.py ..."
            )
        x64, info = run_sharded(args.n_bg, args.devices, args.rtol)
        print(json.dumps({
            "metric": f"immersed_poisson_sharded_{info['n_bg_dofs']}dofs",
            "value": info["rel_residual_f64"],
            "unit": "rel_residual",
            "vs_baseline": 0.0,
            **{k: info[k] for k in ("devices", "cg_iters", "t_total")},
        }))
        return

    if args.cpu_baseline_only:
        print(json.dumps(run_cpu_baseline(args.n_bg, args.rtol, args.dim)))
        return

    if args.workload != "poisson":
        print(json.dumps(run_workload(args.workload, args.n_bg,
                                      args.rtol, args.verbose)))
        return

    dev = run_device(args.n_bg, args.rtol, args.verbose, args.dim)
    if not dev["rel_residual_f64"] < args.rtol:
        raise SystemExit(
            f"not converged: relative f64 residual "
            f"{dev['rel_residual_f64']:.3e} >= rtol {args.rtol:.1e}"
        )

    key = f"n{args.n_bg}" if args.dim == 2 else f"n{args.n_bg}_d3"
    cache = {}
    if os.path.exists(BASELINE_CACHE):
        cache = json.load(open(BASELINE_CACHE))
    if args.rebaseline or key not in cache:
        # the baseline child must stay off the device this process holds
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             "--cpu-baseline-only", "--n-bg", str(args.n_bg),
             "--dim", str(args.dim), "--rtol", str(args.rtol)],
            capture_output=True, text=True, env=env, timeout=3600,
            check=True,
        )
        cache[key] = json.loads(res.stdout.strip().splitlines()[-1])
        cache[key]["recorded_on"] = os.uname().nodename
        json.dump(cache, open(BASELINE_CACHE, "w"), indent=1)
    base = cache[key]
    if args.verbose:
        print("cpu:", json.dumps(base), file=sys.stderr)

    value = dev["t_best"]
    vs = base["t_total"] / value if value > 0 else 0.0
    tag = "" if args.dim == 2 else "3d_"
    print(json.dumps({
        "metric":
            f"immersed_poisson_{tag}assemble_project_cg_"
            f"{dev['n_bg_dofs']}dofs",
        "value": round(value, 4),
        "unit": "s",
        "vs_baseline": round(vs, 2),
        "rel_residual_f64": dev["rel_residual_f64"],
        "device": dev["device"],
    }))


if __name__ == "__main__":
    main()
