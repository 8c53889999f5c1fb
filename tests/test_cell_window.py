"""Cell-window projection (ops/cell_window.py) vs the general probe.

The dimension-generic gather-free PtAP: validates the window-G congruence
assembly + static stencil placement against StencilOperator{2,3}D.probe_multi
over the general BackgroundOperator, and the df apply/rhs paths against the
f64 general path — in 2D (cross-check vs lattice_bin) and 3D (the new path).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from iifea.mesh.generators import (
    immersed_cube_problem,
    immersed_square_problem,
)
from iifea.models.poisson import PoissonProblem
from iifea.ops import cell_window as cw
from iifea.ops.lattice_bin import LatticeBinError
from iifea.ops.projection import BackgroundOperator
from iifea.ops.stencil import StencilOperator2D, StencilOperator3D


def _setup2d(n_bg=12, n_fg=17, dtype=np.float64):
    mesh_f, M = immersed_square_problem(
        n_fg=n_fg, n_bg=n_bg, degree=1, dtype=dtype
    )
    prob = PoissonProblem(mesh_f, k=1, sym=True, beta_value=10, dtype=dtype)
    return prob, M, (n_bg + 1, n_bg + 1)


def _setup3d(n_bg=6, n_fg=10, dtype=np.float64):
    mesh_f, M = immersed_cube_problem(
        n_fg=n_fg, n_bg=n_bg, degree=1, dtype=dtype
    )
    prob = PoissonProblem(mesh_f, k=1, sym=True, beta_value=10, dtype=dtype)
    return prob, M, (n_bg + 1,) * 3


def test_window_stencil_matches_general_2d():
    prob, M, shape = _setup2d()
    u0 = jnp.zeros(prob.space.n_dofs)
    blocks = prob.form.jacobian_blocks(u0)
    A = BackgroundOperator(prob.form, blocks, M)
    S_ref = StencilOperator2D.probe_multi(
        A.mv_multi, shape, radius=2, dtype=jnp.float64
    )
    reducers = cw.build_window_projection(
        prob.form, M, shape, dtype=np.float64
    )
    bound = [r.bind_blocks(K) for r, K in zip(reducers, blocks)]
    C = jax.jit(cw.stencil_coeffs_windows)(reducers, bound)
    C_ref = np.asarray(S_ref.coeffs)
    scale = np.abs(C_ref).max()
    assert np.allclose(np.asarray(C), C_ref, atol=1e-12 * scale)


def test_window_stencil_matches_general_3d():
    prob, M, shape = _setup3d()
    u0 = jnp.zeros(prob.space.n_dofs)
    blocks = prob.form.jacobian_blocks(u0)
    A = BackgroundOperator(prob.form, blocks, M)
    S_ref = StencilOperator3D.probe_multi(
        A.mv_multi, shape, radius=2, dtype=jnp.float64
    )
    reducers = cw.build_window_projection(
        prob.form, M, shape, dtype=np.float64
    )
    bound = [r.bind_blocks(K) for r, K in zip(reducers, blocks)]
    C = jax.jit(cw.stencil_coeffs_windows)(reducers, bound)
    S_win = StencilOperator3D(C, shape, 2)
    C_ref = np.asarray(S_ref.coeffs)
    scale = np.abs(C_ref).max()
    assert np.allclose(np.asarray(C), C_ref, atol=1e-12 * scale)
    assert S_win.verify(A.mv) < 1e-12


def test_window_df_apply_and_rhs_3d():
    """df operator application + rhs projection at ~1e-13 relative in 3D."""
    from iifea.ops import df as dfm
    from iifea.ops.projection import assemble_background_system

    prob, M, shape = _setup3d(n_bg=5, n_fg=9)
    u0 = jnp.zeros(prob.space.n_dofs)
    blocks64 = prob.form.jacobian_blocks(u0)
    A64 = BackgroundOperator(prob.form, blocks64, M)

    reducers = cw.build_window_projection(prob.form, M, shape, df=True)
    bound = [
        r.bind_blocks_df(*dfm.df_from_f64(K))
        for r, K in zip(reducers, blocks64)
    ]

    rng = np.random.default_rng(7)
    x64 = jnp.asarray(rng.standard_normal(M.n_bg_dofs))
    y_ref = np.asarray(A64.mv(x64))
    y_df = jax.jit(cw.apply_df_windows)(reducers, bound, dfm.df_from_f64(x64))
    y = np.asarray(dfm.df_to_f64(y_df))
    scale = np.abs(y_ref).max()
    assert np.abs(y - y_ref).max() < 1e-12 * scale

    # gather-free df rhs matches the general f64 rhs
    _, b_ref = assemble_background_system(prob.form, u0, M)
    tables = prob.rhs_df_tables(reducers)
    r_el = jax.jit(prob.rhs_el_df)(tables)
    b_df = jax.jit(cw.project_rhs_df_windows)(reducers, r_el)
    rel = float(
        jnp.linalg.norm(dfm.df_to_f64(b_df) - b_ref) / jnp.linalg.norm(b_ref)
    )
    assert rel < 1e-13, rel


def test_window_planes_fused_matches_general_3d():
    """The fused slab-scan probe (window_planes, compact K in, no bound K /
    G materialization) reproduces the general probe to f64 roundoff — in
    both df mode (val_b + val_lo reconstruction) and plain f32-table mode."""
    prob, M, shape = _setup3d()
    u0 = jnp.zeros(prob.space.n_dofs)
    blocks = prob.form.jacobian_blocks(u0)
    A = BackgroundOperator(prob.form, blocks, M)
    S_ref = StencilOperator3D.probe_multi(
        A.mv_multi, shape, radius=2, dtype=jnp.float64
    )
    C_ref = np.asarray(S_ref.coeffs)
    scale = np.abs(C_ref).max()

    red_df = cw.build_window_projection(prob.form, M, shape, df=True)
    # small slab budget to force the scan + tail path
    C64 = jax.jit(
        lambda reds, Ks: cw.stencil_planes_windows(
            reds, Ks, dtype=jnp.float64, slab_bytes=2e5
        )
    )(red_df, blocks)
    assert np.abs(np.asarray(C64) - C_ref).max() < 1e-12 * scale

    red_f32 = cw.build_window_projection(
        prob.form, M, shape, dtype=np.float32
    )
    C32 = jax.jit(
        lambda reds, Ks: cw.stencil_planes_windows(
            reds, Ks, dtype=jnp.float32
        )
    )(red_f32, [K.astype(jnp.float32) for K in blocks])
    assert np.abs(np.asarray(C32) - C_ref).max() < 1e-5 * scale


def test_window_planes_lcap_split_matches_uncapped():
    """l_cap splitting (dense table capped at p99 occupancy + compact
    scatter-placed overflow) reproduces the uncapped fused probe exactly:
    the split only re-homes slots, every (element, weight) contribution is
    assembled once."""
    prob, M, shape = _setup3d()
    u0 = jnp.zeros(prob.space.n_dofs)
    blocks = prob.form.jacobian_blocks(u0)
    red = cw.build_window_projection(prob.form, M, shape, dtype=np.float32)
    C_ref = jax.jit(
        lambda reds, Ks: cw.stencil_planes_windows(reds, Ks,
                                                   dtype=jnp.float32)
    )(red, [K.astype(jnp.float32) for K in blocks])

    # a tiny cap forces a real split on every term
    red_cap = cw.build_window_projection(
        prob.form, M, shape, dtype=np.float32, l_cap=2
    )
    assert any(r.spill is not None for r in red_cap)
    assert all(r.meta[2] <= 2 for r in red_cap)
    C_cap = jax.jit(
        lambda reds, Ks: cw.stencil_planes_windows(reds, Ks,
                                                   dtype=jnp.float32)
    )(red_cap, [K.astype(jnp.float32) for K in blocks])
    scale = float(np.abs(np.asarray(C_ref)).max())
    assert np.abs(np.asarray(C_cap) - np.asarray(C_ref)).max() < 1e-6 * scale

    # 'auto' (the solver default) also matches
    red_auto = cw.build_window_projection(
        prob.form, M, shape, dtype=np.float32, l_cap="auto"
    )
    C_auto = jax.jit(
        lambda reds, Ks: cw.stencil_planes_windows(reds, Ks,
                                                   dtype=jnp.float32)
    )(red_auto, [K.astype(jnp.float32) for K in blocks])
    assert np.abs(np.asarray(C_auto) - np.asarray(C_ref)).max() < 1e-6 * scale

    # guarded: bound-table paths must refuse a split table
    with pytest.raises(LatticeBinError):
        next(r for r in red_cap if r.spill is not None).window_g(None)


def test_window_spill_raises():
    # n_fg=2 on n_bg=9: fg elements span ~4.5 bg cells with non-aligned
    # nodes, so an element's extraction targets exceed the {0..2}^3 window.
    # (An exact 2:1 aligned coarsening — e.g. n_fg=4, n_bg=8 — does NOT
    # spill: fg nodes coincide with alternate bg nodes and the element
    # legitimately fits the radius-2 stencil.)
    mesh_f, M = immersed_cube_problem(n_fg=2, n_bg=9, degree=1)
    prob = PoissonProblem(mesh_f, k=1, sym=True, beta_value=10)
    with pytest.raises(LatticeBinError):
        cw.build_window_projection(prob.form, M, (10, 10, 10))


def test_binned_lattice_solver_3d_end_to_end():
    """BinnedLatticeSolver on a 3D lattice: full df pipeline vs direct."""
    from iifea.ops.projection import assemble_background_system
    from iifea.solvers import BinnedLatticeSolver, solve_ksp

    prob, M, shape = _setup3d(n_bg=8, n_fg=14)
    solver = BinnedLatticeSolver(prob, M, shape)
    u, info = solver.solve(rtol=1e-10)
    assert info["rel_residual"] < 1e-10
    A, b = assemble_background_system(
        prob.form, jnp.zeros(prob.space.n_dofs), M
    )
    u_d, _ = solve_ksp(A, b, method="direct")
    # Sliver-cut dofs (diagonal ~1e-3 of typical) are numerically
    # undetermined: both solvers hit residual ~1e-14 yet may differ wildly
    # there. The well-posed comparison is the foreground solution's error
    # norms, which both routes must reproduce to solver precision.
    r_dir = float(jnp.linalg.norm(A.mv(u_d) - b) / jnp.linalg.norm(b))
    assert r_dir < 1e-10
    n_bin = prob.error_norms(M.mv(u))
    n_dir = prob.error_norms(M.mv(u_d))
    for key in ("L2", "H10"):
        assert abs(n_bin[key] - n_dir[key]) < 1e-8 * abs(n_dir[key]) + 1e-12, (
            key, n_bin[key], n_dir[key]
        )


@pytest.mark.slow
def test_window_reducers_match_binned_2d(monkeypatch):
    """IIFEA_2D_WINDOW=1 (cell-window congruence reducers in 2D) must
    reproduce the color-probe binned pipeline's solution."""
    import numpy as np
    from iifea.mesh.generators import immersed_square_problem
    from iifea.models.poisson import PoissonProblem
    from iifea.solvers.lattice_fast import BinnedLatticeSolver

    n_bg = 48
    mesh, M = immersed_square_problem(
        n_fg=int(n_bg * 1.4142), n_bg=n_bg, dtype=np.float64
    )
    prob = PoissonProblem(mesh, k=1, sym=True, beta_value=10,
                          dtype=np.float64)
    s1 = BinnedLatticeSolver(prob, M, (n_bg + 1, n_bg + 1))
    x1, i1 = s1.solve(rtol=1e-10)
    monkeypatch.setenv("IIFEA_2D_WINDOW", "1")
    s2 = BinnedLatticeSolver(prob, M, (n_bg + 1, n_bg + 1))
    x2, i2 = s2.solve(rtol=1e-10)
    assert i1["rel_residual"] < 1e-10 and i2["rel_residual"] < 1e-10
    scale = max(float(jnp.abs(x1).max()), 1.0)
    assert float(jnp.linalg.norm(x1 - x2)) < 1e-4 * scale
