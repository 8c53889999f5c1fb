#!/usr/bin/env python3
"""Smoke test of the immersed-FEA main path on one CUDA device.

Drives the solver library (``BinnedLatticeSolver``, ``solve_ksp``) and
bench.py's entry points at the bench sizes, and checks every result against
an independent host reference. Any failed check raises, so the process
exits non-zero at the first failure; only a run in which every phase passed
prints the final JSON line.

    python chip_smoke.py              # phases 1-6 on one card
    python chip_smoke.py --devices 4  # phase 7 alone: the sharded refine

Phases:
  1. device gate: JAX's first device is a GPU (there is no CPU fallback);
  2. double-float arithmetic keeps its 48 bits on the card;
  3. an f32 V-cycle on the card matches the same hierarchy in f64 to f32
     rounding (no reduced-precision contractions);
  4. 2D immersed Poisson, n_bg=1024 (1,050,625 background dofs);
  5. 3D immersed Poisson, n_bg=104 (1,157,625 background dofs);
  6. Poisson, elasticity and biharmonic solutions vs host sparse LU;
  7. (--devices N only) bench's sharded refine on N cards vs one card.

The last line of stdout is
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""
import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

RTOL = 1e-10
# a df pair keeps 24 + 24 bits: the split rounds to 2^-48 relative (a
# dropped rounding or a reassociated f32 transform shows as ~2^-24), and
# sums and products of two f32 values are exact in the pair. df_add/df_mul
# may see each input as its pair or, where the compiler keeps the excess
# precision, as the f64 it came from: up to 2^-48 per input plus the
# output's split, so 2^-47 against the pair values.
SPLIT_TOL = 2.0 ** -48
DF_TOL = 2.0 ** -47
# f32 V-cycle vs the same hierarchy in f64: f32 rounding through a few
# levels of smoothing; TF32 contractions would show as ~1e-3
VCYCLE_TOL = 1e-5
REF_RESIDUAL_TOL = 1e-9       # card solution on the independent operator
AGREE_TOL = {"poisson": 1e-8, "elasticity": 1e-6, "biharmonic": 1e-6}
SHARDED_TOL = 1e-8


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAIL {what}")
    log(f"ok   {what}")


def device_gate(count: int = 1):
    """Phase 1: the first device must be a GPU, and ``count`` of them."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a CUDA device; JAX's first device is "
            f"{devs[0].platform!r}"
        )
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found {len(devs)}")
    return devs


def card_name_and_power() -> str:
    """nvidia-smi's name and power limit, read by a child that never
    imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def peak_gib() -> float:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 2 ** 30


# -- phase 2 -------------------------------------------------------------------

def check_df(n: int = 1 << 20, seed: int = 0) -> None:
    """The f64 -> pair split and df add/mul, computed on the default device
    and checked in numpy f64 on the host (a check compiled with them could
    be rewritten the same way)."""
    import jax
    import jax.numpy as jnp
    from iifea.ops import df

    rng = np.random.default_rng(seed)
    # magnitudes over 2^±20: exercises exponent alignment in the transforms
    a64, b64 = (rng.standard_normal(n) * np.exp2(rng.integers(-20, 20, n))
                for _ in range(2))

    @jax.jit
    def pairs(a64, b64):
        a, b = df.df_from_f64(a64), df.df_from_f64(b64)
        a32, b32 = (a[0], jnp.zeros_like(a[0])), (b[0], jnp.zeros_like(b[0]))
        return (a, b, df.df_add(a32, b32), df.df_mul(a32, b32),
                df.df_add(a, b), df.df_mul(a, b))

    a, b, s2, p2, add, mul = [
        tuple(np.asarray(v, np.float64) for v in pair)
        for pair in pairs(jnp.asarray(a64), jnp.asarray(b64))
    ]
    A, B = a[0] + a[1], b[0] + b[1]

    def rel(got, want, scale):
        return float(np.max(np.abs(got[0] + got[1] - want) / scale))

    err = {
        "split": rel(a, a64, np.abs(a64)),
        # of two f32 values: the product is exact in the pair, the sum too
        # while their exponents are within 24 (else to f64 rounding)
        "f32_sum": rel(s2, a[0] + b[0], np.abs(a[0] + b[0])),
        "f32_product": rel(p2, a[0] * b[0], np.abs(a[0] * b[0])),
        "df_add": rel(add, A + B, np.abs(A) + np.abs(B)),
        "df_mul": rel(mul, A * B, np.abs(A * B)),
    }
    log(f"     df max relative errors over {n} samples: {err}")
    check(err["split"] <= SPLIT_TOL, "phase 2: f64 -> df split within 2^-48")
    check(max(err["f32_sum"], err["f32_product"]) <= 2.0 ** -52,
          "phase 2: sums and products of f32 values exact in df")
    check(err["df_add"] <= DF_TOL and err["df_mul"] <= DF_TOL,
          "phase 2: df_add/df_mul within 2^-47")


# -- phase 3 -------------------------------------------------------------------

def check_vcycle_precision(S32, seed: int = 0) -> float:
    """Apply one V-cycle of a hierarchy built from the probed f32 operator
    in f32, and the same hierarchy cast to f64; return their relative
    difference."""
    import jax
    import jax.numpy as jnp
    from iifea.ops.multigrid import StencilMultigrid

    mg32 = StencilMultigrid(S32)
    mg64 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), mg32)
    d = np.asarray(S32.diag())
    r = np.random.default_rng(seed).standard_normal(S32.n) * (d != 0)
    z32 = jax.jit(lambda mg, r: mg.minv(r))(mg32, jnp.asarray(r, jnp.float32))
    z64 = jax.jit(lambda mg, r: mg.minv(r))(mg64, jnp.asarray(r))
    z32, z64 = np.asarray(z32, np.float64), np.asarray(z64)
    return float(np.linalg.norm(z32 - z64) / np.linalg.norm(z64))


# -- phases 4/5: main path -----------------------------------------------------

def reference_system(prob, M):
    """Independent f64 reference: element blocks on the CPU backend, CSR
    assembly and MᵀA_fM in scipy (bench.run_cpu_baseline's algorithm)."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    cpu = jax.devices("cpu")[0]
    form = jax.device_put(prob.form, cpu)
    u0 = jax.device_put(jnp.zeros(prob.space.n_dofs, jnp.float64), cpu)
    blocks = jax.jit(lambda f, u: f.jacobian_blocks(u))(form, u0)
    rhs_f = -np.asarray(jax.jit(lambda f, u: f.residual(u))(form, u0))
    n = prob.space.n_dofs
    mats = []
    for (dom, _), K in zip(prob.form.terms, blocks):
        fl = dom.flat_eldofs_np
        ne = fl.shape[1]
        rows = np.repeat(fl, ne, axis=1).ravel()
        cols = np.tile(fl, (1, ne)).ravel()
        Kel = np.moveaxis(np.asarray(K), -1, 0)
        mats.append(sp.coo_matrix((Kel.ravel(), (rows, cols)), shape=(n, n)))
        del K, Kel, rows, cols
    A_f = sum(mats[1:], mats[0]).tocsr()
    Msp = M.to_scipy().tocsr()
    return (Msp.T @ A_f @ Msp).tocsr(), Msp.T @ rhs_f


def setup_problem(n_bg: int, dim: int):
    """bench's problem at ``n_bg`` and its BinnedLatticeSolver (host setup:
    mesh generation, extraction operator, lattice binning)."""
    import bench
    from iifea.solvers.lattice_fast import BinnedLatticeSolver

    t0 = time.time()
    mesh_f, prob, M = bench.build_problem(n_bg, np.float64, dim)
    solver = BinnedLatticeSolver(prob, M, (n_bg + 1,) * dim)
    return solver, {"n_bg_dofs": int(M.n_bg_dofs),
                    "n_cells": int(mesh_f.n_cells),
                    "t_setup_host": time.time() - t0}


def main_path(solver, out: dict, reference=None,
              precision_check: bool = False) -> dict:
    """One BinnedLatticeSolver solve, timed like bench.run_device, checked
    against the pipeline's own f64 residual and, when ``reference`` (a
    future of :func:`reference_system`) is given, the independent scipy
    operator."""
    import jax

    if precision_check:
        S32 = solver.probe(solver.bind(*solver.assemble()[1:]))
        out["vcycle_f32_vs_f64"] = check_vcycle_precision(S32)
        del S32

    # the first call runs solve()'s stages one by one, so that the compile
    # time each stage adds is visible
    stages, t_first = {}, time.time()

    def stage(name, fn, *args):
        t0 = time.time()
        res = jax.block_until_ready(fn(*args))
        stages[name] = time.time() - t0
        return res

    b64, K_cell, K_facet = stage("assemble", solver.assemble)
    bound = stage("bind", solver.bind, K_cell, K_facet)
    S32 = stage("probe", solver.probe, bound)
    mg = stage("mg_build", solver.build_mg, S32)
    stage("refine", solver.refine, S32, mg, bound, b64, RTOL)
    out["t_first_incl_compile"] = time.time() - t_first
    out["t_first_stages"] = stages
    del b64, K_cell, K_facet, bound, S32, mg
    times = []
    for _ in range(3):
        t0 = time.time()
        x, info = solver.solve(rtol=RTOL)
        x = jax.block_until_ready(x)
        times.append(time.time() - t0)
    out.update(t_best=min(times), cg_iters=info["cg_iters"],
               rel_residual_f64=info["rel_residual"], peak_gib=peak_gib())
    x = np.asarray(x)
    out["finite"] = bool(np.isfinite(x).all())
    if reference is not None:
        t0 = time.time()
        A, b = reference.result()
        out["t_wait_reference"] = time.time() - t0
        out["rel_residual_reference"] = float(
            np.linalg.norm(b - A @ x) / np.linalg.norm(b))
    return out


def check_main_path(phase: int, solver, out: dict, pool) -> dict:
    """Phases 4/5 (and 3 inside phase 4); the host reference assembles in
    ``pool`` while the card solves."""
    ref = pool.submit(reference_system, solver.prob, solver.M)
    out = main_path(solver, out, ref, precision_check=(phase == 4))
    if "vcycle_f32_vs_f64" in out:
        log(f"     f32 V-cycle vs f64 on the same hierarchy: "
            f"{out['vcycle_f32_vs_f64']:.3e}")
        check(out["vcycle_f32_vs_f64"] <= VCYCLE_TOL,
              f"phase 3: f32 V-cycle within {VCYCLE_TOL:g} of f64")
    log(f"     {len(solver.shape)}D {solver.shape}: {json.dumps(out)}")
    check(out["finite"], f"phase {phase}: finite solution")
    check(out["rel_residual_f64"] < RTOL,
          f"phase {phase}: pipeline f64 residual "
          f"{out['rel_residual_f64']:.3e} < {RTOL:g}")
    check(out["rel_residual_reference"] <= REF_RESIDUAL_TOL,
          f"phase {phase}: residual on the independent scipy operator "
          f"{out['rel_residual_reference']:.3e} <= {REF_RESIDUAL_TOL:g}")
    return out


# -- phase 6: agreement with the host direct solve -----------------------------

def host_lu(prob, M) -> np.ndarray:
    """Host SuperLU solution on the independent reference operator."""
    from iifea.solvers.direct import solve_direct

    A, b = reference_system(prob, M)
    return solve_direct(A, b)


def poisson_vs_lu(n_bg: int, pool) -> float:
    """L2 difference over the physical domain between the 2D lattice
    pipeline and host SuperLU on the reference operator (the measure
    bench.run_workload uses); the LU runs in ``pool`` meanwhile."""
    import jax.numpy as jnp
    from iifea.api import l2_norm

    solver, _ = setup_problem(n_bg, 2)
    lu = pool.submit(host_lu, solver.prob, solver.M)
    x, _ = solver.solve(rtol=RTOL)
    u_lu = solver.M.mv(jnp.asarray(lu.result()))
    dom = solver.prob.cell_dom
    return float(l2_norm(solver.M.mv(x) - u_lu, dom) / l2_norm(u_lu, dom))


def check_agreement(pool, sizes=None) -> dict:
    import bench

    sizes = sizes or {"poisson": 256, "elasticity": 256, "biharmonic": 127}
    got = {"poisson": poisson_vs_lu(sizes["poisson"], pool)}
    for wl in ("elasticity", "biharmonic"):
        rec = bench.run_workload(wl, sizes[wl], RTOL)
        log(f"     {wl} n_bg={sizes[wl]}: {json.dumps(rec)}")
        got[wl] = rec["vs_lu_rel_diff"]
    for wl, diff in got.items():
        check(diff <= AGREE_TOL[wl],
              f"phase 6: {wl} n_bg={sizes[wl]} vs host LU, L2 rel diff "
              f"{diff:.3e} <= {AGREE_TOL[wl]:g}")
    return got


# -- phase 7: sharded refine ---------------------------------------------------

def sharded_vs_single(n_bg: int, devices: int) -> dict:
    """bench's sharded refine on ``devices`` devices vs the one-device fused
    refine, on the same assembled and probed system."""
    import jax
    import bench

    solver, _ = setup_problem(n_bg, 2)
    b64, K_cell, K_facet = solver.assemble()
    bound = solver.bind(K_cell, K_facet)
    S32 = solver.probe(bound)
    mg = solver.build_mg(S32)
    x1, rel1, _ = solver.refine(S32, mg, bound, b64, RTOL)
    t0 = time.time()
    xs, rels, its = bench.sharded_refine(solver, S32, mg, bound, b64,
                                         devices, RTOL)
    xs = jax.block_until_ready(xs)
    t_sharded = time.time() - t0
    d = np.asarray(S32.diag())
    x1, xs = np.asarray(x1), np.asarray(xs)

    def rel_diff(mask):
        return float(np.linalg.norm((xs - x1)[mask])
                     / np.linalg.norm(x1[mask]))

    return {"rel_residual_single": rel1, "rel_residual_sharded": rels,
            "cg_iters_sharded": its, "t_sharded_incl_compile": t_sharded,
            # compared on well-supported dofs (diagonal above 5 % of the
            # largest): dofs with a sliver of support sit in the operator's
            # near-null space, where two solves that both meet the residual
            # target legitimately differ (reported, not checked)
            "rel_diff": rel_diff(d > 0.05 * d.max()),
            "rel_diff_all_supported": rel_diff(d != 0)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", type=int, default=1,
                   help="run phase 7 alone: bench's sharded refine on this "
                        "many cards vs one card")
    args = p.parse_args(argv)
    t_start = time.time()

    devs = device_gate(args.devices)
    import jax
    import iifea  # noqa: F401  (x64, compile cache)

    log(f"devices: {devs}")
    log(f"device_kind: {devs[0].device_kind}  jax {jax.__version__}  "
        f"compile cache: {jax.config.jax_compilation_cache_dir}")
    card = card_name_and_power()
    log(f"nvidia-smi: {card}")
    check(True, "phase 1: device gate (gpu)")

    if args.devices > 1:
        out = sharded_vs_single(1024, args.devices)
        log(f"     sharded n_bg=1024 on {args.devices} cards: "
            f"{json.dumps(out)}")
        check(out["rel_residual_sharded"] < RTOL,
              f"phase 7: sharded f64 residual < {RTOL:g}")
        check(out["rel_diff"] <= SHARDED_TOL,
              f"phase 7: sharded vs one-card solution on well-supported "
              f"dofs {out['rel_diff']:.3e} <= {SHARDED_TOL:g}")
    else:
        check_df()
        # host-only work (the 3D setup, the scipy references, host LU)
        # runs on worker threads while the card solves
        with ThreadPoolExecutor(max_workers=2) as pool:
            setup3 = pool.submit(setup_problem, 104, 3)
            check_main_path(4, *setup_problem(1024, 2), pool)
            check_main_path(5, *setup3.result(), pool)
            check_agreement(pool)

    import bench

    log(f"card: {card}  smoke wall time {time.time() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": bench.device_info()}),
          flush=True)


if __name__ == "__main__":
    main()
