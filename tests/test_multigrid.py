"""Geometric multigrid preconditioner on probed stencil operators."""
import numpy as np
import jax.numpy as jnp

from iifea.mesh.generators import immersed_square_problem
from iifea.models.poisson import PoissonProblem
from iifea.ops.multigrid import StencilMultigrid
from iifea.ops.projection import BackgroundOperator
from iifea.ops.stencil import StencilOperator2D
from iifea.solvers import krylov


def _stencil(n_bg=32):
    mesh_f, M = immersed_square_problem(n_fg=48, n_bg=n_bg)
    prob = PoissonProblem(mesh_f, k=1, sym=True, beta_value=10)
    blocks = prob.form.jacobian_blocks(jnp.zeros(prob.space.n_dofs))
    A = BackgroundOperator(prob.form, blocks, M)
    S = StencilOperator2D.probe_multi(
        A.mv_multi, (n_bg + 1, n_bg + 1), radius=2, dtype=jnp.float64
    )
    b = M.rmv(-prob.form.residual(jnp.zeros(prob.space.n_dofs)))
    return S, b


def test_mg_accelerates_cg():
    S, b = _stencil()
    # min_size below the fixture's 33² so the hierarchy is exercised
    mg = StencilMultigrid(S, min_size=9)
    assert len(mg.levels) >= 2
    x_mg, info_mg = krylov.cg(S.mv, b, minv=mg.minv, rtol=1e-10, check_every=2)
    d = S.diag()
    x_j, info_j = krylov.cg(
        S.mv, b, minv=lambda r: r / jnp.where(jnp.abs(d) > 0, d, 1.0),
        rtol=1e-10, check_every=2,
    )
    assert bool(info_mg.converged)
    # MG must beat Jacobi by a wide margin in iteration count
    assert int(info_mg.iters) < int(info_j.iters) / 2
    # the projected system is singular on unsupported bg dofs (zero
    # rows/cols): solutions are unique only on the supported block
    mask = np.asarray(jnp.abs(d) > 0)
    scale = max(float(jnp.abs(x_j).max()), 1.0)
    assert np.allclose(
        np.asarray(x_mg)[mask], np.asarray(x_j)[mask], atol=1e-6 * scale
    )


def test_mg_vcycle_is_linear():
    """Fixed sweep counts => the V-cycle is a linear operator (required for
    use inside plain CG)."""
    # min_size=9: the 17^2 fixture must build a genuine multi-level V-cycle
    # (the default min_size=33 would make minv a single dense coarse inverse)
    S, _ = _stencil(16)
    mg = StencilMultigrid(S, min_size=9)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(S.n))
    v = jnp.asarray(rng.standard_normal(S.n))
    lhs = np.asarray(mg.minv(2.0 * u + 3.0 * v))
    rhs = 2.0 * np.asarray(mg.minv(u)) + 3.0 * np.asarray(mg.minv(v))
    assert np.allclose(lhs, rhs, atol=1e-9 * max(np.abs(rhs).max(), 1))


def _stencil3(n_bg=12, n_fg=18):
    from iifea.mesh.generators import immersed_cube_problem
    from iifea.ops.stencil import StencilOperator3D

    mesh_f, M = immersed_cube_problem(n_fg=n_fg, n_bg=n_bg)
    prob = PoissonProblem(mesh_f, k=1, sym=True, beta_value=10)
    blocks = prob.form.jacobian_blocks(jnp.zeros(prob.space.n_dofs))
    A = BackgroundOperator(prob.form, blocks, M)
    S = StencilOperator3D.probe_multi(
        A.mv_multi, (n_bg + 1,) * 3, radius=2, dtype=jnp.float64
    )
    b = M.rmv(-prob.form.residual(jnp.zeros(prob.space.n_dofs)))
    return S, b


def test_mg3d_accelerates_cg():
    """3D V-cycle with a real hierarchy (13³ -> 7³) beats Jacobi-PCG."""
    from iifea.ops.multigrid import StencilMultigrid3D

    S, b = _stencil3()
    mg = StencilMultigrid3D(S, min_size=5)
    assert len(mg.levels) >= 2
    x_mg, info_mg = krylov.cg(S.mv, b, minv=mg.minv, rtol=1e-10, check_every=2)
    d = S.diag()
    x_j, info_j = krylov.cg(
        S.mv, b, minv=lambda r: r / jnp.where(jnp.abs(d) > 0, d, 1.0),
        rtol=1e-10, check_every=2,
    )
    assert bool(info_mg.converged)
    assert int(info_mg.iters) < int(info_j.iters)
    mask = np.asarray(jnp.abs(d) > 0)
    scale = max(float(jnp.abs(x_j).max()), 1.0)
    assert np.allclose(
        np.asarray(x_mg)[mask], np.asarray(x_j)[mask], atol=1e-6 * scale
    )


def test_mg3d_vcycle_is_linear():
    from iifea.ops.multigrid import StencilMultigrid3D

    S, _ = _stencil3(n_bg=8, n_fg=12)
    mg = StencilMultigrid3D(S, min_size=3)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(S.n))
    v = jnp.asarray(rng.standard_normal(S.n))
    lhs = np.asarray(mg.minv(2.0 * u + 3.0 * v))
    rhs = 2.0 * np.asarray(mg.minv(u)) + 3.0 * np.asarray(mg.minv(v))
    assert np.allclose(lhs, rhs, atol=1e-9 * max(np.abs(rhs).max(), 1))


# -- direct (conv) Galerkin coarsening vs the probe oracle ---------------------


def test_coarsen_direct_matches_probe_2d():
    """_coarsen (one strided conv over coefficient planes) must reproduce
    the probed R A P exactly, on a real immersed operator AND on a random
    stencil (incl. garbage in off-grid-column slots, which the matvec never
    reads but the direct contraction must mask)."""
    from iifea.ops.multigrid import _coarsen, _coarsen_probe

    S, _ = _stencil(16)
    Sc_d, Sc_p = _coarsen(S), _coarsen_probe(S)
    err = np.abs(np.asarray(Sc_d.coeffs - Sc_p.coeffs)).max()
    assert err < 1e-12 * float(jnp.abs(S.coeffs).max())

    rng = np.random.default_rng(7)
    C = jnp.asarray(rng.standard_normal((25, 17, 13)))
    Sr = StencilOperator2D(C, (17, 13), 2)
    Sc_d, Sc_p = _coarsen(Sr), _coarsen_probe(Sr)
    assert np.allclose(
        np.asarray(Sc_d.coeffs), np.asarray(Sc_p.coeffs), atol=1e-12
    )


def test_coarsen_direct_matches_probe_3d():
    from iifea.ops.multigrid import _coarsen3, _coarsen3_probe
    from iifea.ops.stencil import StencilOperator3D

    rng = np.random.default_rng(8)
    C = jnp.asarray(rng.standard_normal((125, 9, 11, 9)))
    S = StencilOperator3D(C, (9, 11, 9), 2)
    Sc_d, Sc_p = _coarsen3(S), _coarsen3_probe(S)
    assert np.allclose(
        np.asarray(Sc_d.coeffs), np.asarray(Sc_p.coeffs), atol=1e-12
    )


def test_coarsen_direct_matches_probe_block():
    from iifea.ops.multigrid import (
        _coarsen_block,
        _coarsen_block_probe,
    )
    from iifea.ops.stencil import StencilOperatorBlock2D

    rng = np.random.default_rng(9)
    C = jnp.asarray(rng.standard_normal((3, 3, 25, 13, 9)))
    S = StencilOperatorBlock2D(C, (13, 9), 2)
    Sc_d, Sc_p = _coarsen_block(S), _coarsen_block_probe(S)
    assert np.allclose(
        np.asarray(Sc_d.coeffs), np.asarray(Sc_p.coeffs), atol=1e-12
    )


def test_chebyshev_smoother_option():
    """smoother='chebyshev' must converge inside CG like the default (it
    carries per-level lambda-max estimates through the pytree)."""
    S, b = _stencil(16)
    mg = StencilMultigrid(S, min_size=9, smoother="chebyshev")
    x_c, info = krylov.cg(S.mv, b, minv=mg.minv, rtol=1e-10, check_every=2)
    assert bool(info.converged)
    mg_j = StencilMultigrid(S, min_size=9)
    x_j, _ = krylov.cg(S.mv, b, minv=mg_j.minv, rtol=1e-10, check_every=2)
    d = S.diag()
    mask = np.asarray(jnp.abs(d) > 0)
    scale = max(float(jnp.abs(x_j).max()), 1.0)
    assert np.allclose(
        np.asarray(x_c)[mask], np.asarray(x_j)[mask], atol=1e-6 * scale
    )


def test_coarsen_direct_matches_probe_block3d():
    from iifea.ops.multigrid import (
        _coarsen_block3,
        _coarsen_block3_probe,
    )
    from iifea.ops.stencil import StencilOperatorBlock3D

    rng = np.random.default_rng(12)
    C = jnp.asarray(rng.standard_normal((2, 2, 125, 9, 9, 9)))
    S = StencilOperatorBlock3D(C, (9, 9, 9), 2)
    Sc_d, Sc_p = _coarsen_block3(S), _coarsen_block3_probe(S)
    assert np.allclose(
        np.asarray(Sc_d.coeffs), np.asarray(Sc_p.coeffs), atol=1e-12
    )


def test_block3d_probe_and_mg():
    """3D block stencil: probe_multi recovers a field-coupled operator
    exactly, and the block V-cycle preconditions CG far better than plain
    CG on a well-posed SPD operator (B x 7-point-Laplacian). Raw immersed
    operators additionally need BFR trimming / null-mode deflation before
    the coarse pseudo-inverse, as the 2D block ksp branch does."""
    import itertools
    from iifea.ops.multigrid import StencilMultigridBlock3D
    from iifea.ops.stencil import StencilOperatorBlock3D

    shape = (13, 13, 13)
    C = np.zeros((125,) + shape)
    for i, (oi, oj, ok) in enumerate(
        itertools.product(range(-2, 3), repeat=3)
    ):
        taxi = abs(oi) + abs(oj) + abs(ok)
        if taxi == 0:
            C[i] = 6.0
        elif taxi == 1:
            C[i] = -1.0
    B = np.array([[2.0, 0.7], [0.7, 1.5]])       # SPD field coupling
    Cb = jnp.asarray(np.einsum("ab,kxyz->abkxyz", B, C))
    S = StencilOperatorBlock3D(Cb, shape, 2)

    # probing the block operator's own matvec must reproduce it exactly on
    # in-grid slots (off-grid-column slots are never read by the matvec:
    # the probe correctly returns 0 there while the synthetic C holds -1)
    from iifea.ops.multigrid import _offgrid_mask3

    S2 = StencilOperatorBlock3D.probe_multi(
        S.mv_multi, shape, n_fields=2, radius=2, dtype=jnp.float64
    )
    msk = _offgrid_mask3(shape, 2)
    assert np.allclose(
        np.asarray(S2.coeffs) * msk, np.asarray(Cb) * msk, atol=1e-12
    )

    mg = StencilMultigridBlock3D(S, min_size=7)
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal(S.n))
    x_mg, info = krylov.cg(S.mv, b, minv=mg.minv, rtol=1e-10, check_every=2)
    x_cg, info_cg = krylov.cg(S.mv, b, rtol=1e-10, check_every=2,
                              max_it=20000)
    assert bool(info.converged)
    assert int(info.iters) < int(info_cg.iters) / 3
    assert np.allclose(np.asarray(x_mg), np.asarray(x_cg),
                       atol=1e-7 * float(jnp.abs(x_cg).max()))


def test_coarsen3_chunked_matches_monolithic():
    """The chunked in-channel scan of _coarsen3 (the 3D bench HBM fix) is
    numerically the same RAP as the monolithic conv."""
    import iifea.ops.multigrid as mgm
    from iifea.ops.stencil import StencilOperator3D

    rng = np.random.default_rng(9)
    C = jnp.asarray(rng.standard_normal((125, 13, 9, 11)), jnp.float32)
    S = StencilOperator3D(C, (13, 9, 11), 2)
    ref = np.asarray(mgm._coarsen3(S).coeffs)
    old = mgm._COARSEN3_MONO_BYTES
    # jit caches on input shape: drop the cached monolithic executable so
    # the lowered threshold actually traces the chunked path
    mgm._coarsen3.clear_cache()
    mgm._COARSEN3_MONO_BYTES = 0
    try:
        got = np.asarray(mgm._coarsen3(S).coeffs)
    finally:
        mgm._COARSEN3_MONO_BYTES = old
        mgm._coarsen3.clear_cache()
    assert np.allclose(got, ref, atol=1e-5 * np.abs(ref).max())
