"""Lattice-binned gather-free probe vs the general probe (ops/lattice_bin.py)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from iifea.mesh.generators import immersed_square_problem
from iifea.models.poisson import PoissonProblem
from iifea.ops.lattice_bin import (
    LatticeBinError,
    LatticeBinnedTerm2D,
    build_binned_projection,
    probe_y_binned,
)
from iifea.ops.projection import BackgroundOperator
from iifea.ops.stencil import StencilOperator2D


def _setup(n_bg=12, n_fg=17, dtype=np.float64):
    mesh_f, M = immersed_square_problem(
        n_fg=n_fg, n_bg=n_bg, degree=1, dtype=dtype
    )
    prob = PoissonProblem(mesh_f, k=1, sym=True, beta_value=10, dtype=dtype)
    return mesh_f, prob, M


@pytest.mark.parametrize("n_bg,n_fg", [(12, 17), (16, 23), (9, 12)])
def test_binned_probe_matches_general(n_bg, n_fg):
    _, prob, M = _setup(n_bg, n_fg)
    shape = (n_bg + 1, n_bg + 1)
    u0 = jnp.zeros(prob.space.n_dofs)
    blocks = prob.form.jacobian_blocks(u0)
    A = BackgroundOperator(prob.form, blocks, M)

    S_ref = StencilOperator2D.probe_multi(
        A.mv_multi, shape, radius=2, dtype=jnp.float64
    )
    reducers = build_binned_projection(
        prob.form, M, shape, radius=2, dtype=np.float64
    )
    Y = probe_y_binned(reducers, blocks)
    S_bin = StencilOperator2D.from_probe_y(Y, shape, radius=2,
                                           dtype=jnp.float64)

    C_ref = np.asarray(S_ref.coeffs)
    C_bin = np.asarray(S_bin.coeffs)
    scale = np.abs(C_ref).max()
    assert np.allclose(C_bin, C_ref, atol=1e-12 * scale)

    # and the binned stencil reproduces the true operator exactly
    assert S_bin.verify(A.mv) < 1e-12


def test_compact_term_binning():
    """Facet (sparse-touch) terms auto-select compact cell binning."""
    _, prob, M = _setup(16, 23)
    shape = (17, 17)
    reducers = build_binned_projection(prob.form, M, shape, dtype=np.float64)
    # the interface facet term touches few cells -> compact
    assert any(r.cells is not None for r in reducers)
    # the bulk cell term is dense
    assert any(r.cells is None for r in reducers)


def test_spill_raises():
    """Foreground elements wider than the background spacing can't bin."""
    mesh_f, M = immersed_square_problem(n_fg=5, n_bg=12, degree=1)
    prob = PoissonProblem(mesh_f, k=1, sym=True, beta_value=10)
    with pytest.raises(LatticeBinError):
        build_binned_projection(prob.form, M, (13, 13), dtype=np.float64)


def test_binned_probe_f32_close():
    """The bench configuration: f32 tables, f32 blocks."""
    _, prob, M = _setup(16, 23)
    shape = (17, 17)
    u0 = jnp.zeros(prob.space.n_dofs)
    blocks = [b.astype(jnp.float32) for b in prob.form.jacobian_blocks(u0)]
    A64 = BackgroundOperator(
        prob.form, prob.form.jacobian_blocks(u0), M
    )
    S_ref = StencilOperator2D.probe_multi(
        A64.mv_multi, shape, radius=2, dtype=jnp.float64
    )
    reducers = build_binned_projection(prob.form, M, shape, dtype=np.float32)
    Y = jax.jit(probe_y_binned)(reducers, blocks)
    S_bin = StencilOperator2D.from_probe_y(Y, shape, radius=2)
    C_ref = np.asarray(S_ref.coeffs)
    C_bin = np.asarray(S_bin.coeffs)
    scale = np.abs(C_ref).max()
    assert np.allclose(C_bin, C_ref, atol=1e-5 * scale)


def test_df_apply_matches_f64_general():
    """Binned double-float application reproduces the true f64 operator to
    ~1e-13 relative — the refinement-residual accuracy requirement."""
    from iifea.ops import df as dfm
    from iifea.ops.lattice_bin import (
        apply_df_binned,
        bind_blocks_df_binned,
        probe_y_binned_bound,
        split_blocks_df,
    )

    _, prob, M = _setup(16, 23)
    shape = (17, 17)
    u0 = jnp.zeros(prob.space.n_dofs)
    blocks64 = prob.form.jacobian_blocks(u0)
    A64 = BackgroundOperator(prob.form, blocks64, M)

    reducers = build_binned_projection(prob.form, M, shape, df=True)
    bound = bind_blocks_df_binned(reducers, split_blocks_df(blocks64))

    rng = np.random.default_rng(7)
    x64 = jnp.asarray(rng.standard_normal(M.n_bg_dofs))
    y_ref = np.asarray(A64.mv(x64))

    x_df = dfm.df_from_f64(x64)
    y_df = jax.jit(apply_df_binned, static_argnums=())(reducers, bound, x_df)
    y = np.asarray(dfm.df_to_f64(y_df))
    scale = np.abs(y_ref).max()
    assert np.abs(y - y_ref).max() < 1e-12 * scale

    # and the f32 probe off the same bound blocks matches the general probe
    Y = probe_y_binned_bound(reducers, bound)
    S_bin = StencilOperator2D.from_probe_y(Y, shape, radius=2)
    S_ref = StencilOperator2D.probe_multi(
        A64.mv_multi, shape, radius=2, dtype=jnp.float64
    )
    C_ref = np.asarray(S_ref.coeffs)
    assert np.allclose(
        np.asarray(S_bin.coeffs), C_ref, atol=1e-5 * np.abs(C_ref).max()
    )


def test_cell_stiffness_df():
    """df fast-path P1 stiffness matches the f64 autodiff element blocks."""
    from iifea.ops import df as dfm

    _, prob, M = _setup(16, 23)
    u0 = jnp.zeros(prob.space.n_dofs)
    K64 = prob.form.jacobian_blocks(u0)[0]          # cell term
    Kh, Kl = jax.jit(prob.cell_stiffness_df)()
    K = np.asarray(Kh.astype(jnp.float64) + Kl.astype(jnp.float64))
    ref = np.asarray(K64)
    assert np.abs(K - ref).max() < 1e-13 * np.abs(ref).max()


def test_rhs_df_fast_path():
    """Gather-free df rhs (pointwise setup tables + binned Mᵀ projection)
    matches the general f64 assemble_background_system rhs to ~1e-14."""
    import jax
    from iifea.ops import lattice_bin
    from iifea.ops.df import df_to_f64
    from iifea.ops.projection import assemble_background_system

    for sym in (True, False):
        n_bg = 24
        mesh, M = immersed_square_problem(n_fg=48, n_bg=n_bg)
        prob = PoissonProblem(mesh, k=1, sym=sym, beta_value=10)
        _, b_ref = assemble_background_system(
            prob.form, jnp.zeros(prob.space.n_dofs), M
        )
        reducers = lattice_bin.build_binned_projection(
            prob.form, M, (n_bg + 1, n_bg + 1), dtype=np.float32, df=True
        )
        tables = prob.rhs_df_tables(reducers)
        r_el = jax.jit(prob.rhs_el_df)(tables)
        b_df = jax.jit(lattice_bin.project_rhs_df_binned)(reducers, r_el)
        rel = float(
            jnp.linalg.norm(df_to_f64(b_df) - b_ref) / jnp.linalg.norm(b_ref)
        )
        assert rel < 1e-13, (sym, rel)


def test_binned_lattice_solver_end_to_end():
    """BinnedLatticeSolver (the full gather-free df pipeline as a library
    API) matches the direct solver on supported dofs and hits the f64
    residual target."""
    from iifea.ops.projection import assemble_background_system
    from iifea.solvers import BinnedLatticeSolver, solve_ksp

    n_bg = 24
    mesh, M = immersed_square_problem(n_fg=48, n_bg=n_bg)
    prob = PoissonProblem(mesh, k=1, sym=True, beta_value=10)
    solver = BinnedLatticeSolver(prob, M, (n_bg + 1, n_bg + 1))
    u, info = solver.solve(rtol=1e-10)
    assert info["rel_residual"] < 1e-10
    A, b = assemble_background_system(
        prob.form, jnp.zeros(prob.space.n_dofs), M
    )
    u_d, _ = solve_ksp(A, b, method="direct")
    d = np.asarray(A.diag())
    mask = np.abs(d) > 0
    scale = max(float(jnp.abs(u_d).max()), 1.0)
    assert np.allclose(np.asarray(u)[mask], np.asarray(u_d)[mask],
                       atol=1e-7 * scale)


@pytest.mark.parametrize("n_bg,n_fg", [(12, 17), (16, 23), (9, 12)])
def test_direct_stencil_matches_probe(n_bg, n_fg):
    """Direct window-congruence assembly == the 25-color probe (f64 exact)."""
    from iifea.ops.lattice_bin import stencil_planes_binned

    _, prob, M = _setup(n_bg, n_fg)
    shape = (n_bg + 1, n_bg + 1)
    u0 = jnp.zeros(prob.space.n_dofs)
    blocks = prob.form.jacobian_blocks(u0)
    reducers = build_binned_projection(
        prob.form, M, shape, radius=2, dtype=np.float64
    )
    Y = probe_y_binned(reducers, blocks)
    C_probe = np.asarray(
        StencilOperator2D.from_probe_y(Y, shape, radius=2,
                                       dtype=jnp.float64).coeffs
    )
    C_dir = np.asarray(jax.jit(stencil_planes_binned)(reducers, blocks))
    scale = np.abs(C_probe).max()
    assert np.allclose(C_dir, C_probe, atol=1e-12 * scale)
    if n_bg >= 16:
        # both compact (facet) and dense (cell) placements were exercised
        # (smaller lattices auto-bin every term dense)
        assert any(r.cells is not None for r in reducers)
    assert any(r.cells is None for r in reducers)


def test_direct_stencil_slab_chunking():
    """Tiny slab budget forces the lax.scan slab path; result unchanged."""
    from iifea.ops.lattice_bin import stencil_planes_binned

    _, prob, M = _setup(16, 23)
    shape = (17, 17)
    u0 = jnp.zeros(prob.space.n_dofs)
    blocks = prob.form.jacobian_blocks(u0)
    reducers = build_binned_projection(
        prob.form, M, shape, radius=2, dtype=np.float64
    )
    C_full = np.asarray(stencil_planes_binned(reducers, blocks))
    dense = [r for r in reducers if r.cells is None][0]
    Kb = dense.bind_blocks(blocks[0])
    C_slab = np.asarray(dense.stencil_planes_bound(Kb, slab_bytes=1))
    C_ref = np.asarray(dense.stencil_planes_bound(Kb))
    scale = max(np.abs(C_ref).max(), 1e-30)
    assert np.allclose(C_slab, C_ref, atol=1e-12 * scale)
    assert np.isfinite(C_full).all()
