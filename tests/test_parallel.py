"""Sharded execution on the virtual 8-device CPU mesh: parity with the
single-device path (the reference's "mpirun -np N gives identical norms"
check, SURVEY.md §4 item 4)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from iifea.mesh.generators import immersed_square_problem
from iifea.models.poisson import PoissonProblem
from iifea.ops.projection import BackgroundOperator, assemble_background_system
from iifea.parallel.sharding import ShardedProjectedSystem, make_device_mesh

needs_devices = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def setup():
    mesh_f, M = immersed_square_problem(n_fg=24, n_bg=12)
    prob = PoissonProblem(mesh_f, k=1, sym=True, beta_value=10)
    return prob, M


@needs_devices
def test_sharded_matvec_matches_single(setup):
    prob, M = setup
    u0 = jnp.zeros(prob.space.n_dofs)
    blocks = prob.form.jacobian_blocks(u0)
    A = BackgroundOperator(prob.form, blocks, M)

    mesh = make_device_mesh(8)
    S = ShardedProjectedSystem(prob.form, M, mesh)
    sblocks = S.assemble_blocks(jnp.zeros(M.n_bg_dofs))

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(M.n_bg_dofs))
    y_ref = np.asarray(A.mv(x))
    y_sh = np.asarray(S.matvec(sblocks, x))
    assert np.allclose(y_sh, y_ref, atol=1e-10 * max(np.abs(y_ref).max(), 1))


@needs_devices
def test_sharded_diag_matches_single(setup):
    prob, M = setup
    u0 = jnp.zeros(prob.space.n_dofs)
    blocks = prob.form.jacobian_blocks(u0)
    d_ref = np.asarray(BackgroundOperator(prob.form, blocks, M).diag())

    mesh = make_device_mesh(8)
    S = ShardedProjectedSystem(prob.form, M, mesh)
    sblocks = S.assemble_blocks(jnp.zeros(M.n_bg_dofs))
    d_sh = np.asarray(S.diag(sblocks))
    assert np.allclose(d_sh, d_ref, atol=1e-10 * max(np.abs(d_ref).max(), 1))


@needs_devices
def test_sharded_residual_matches_single(setup):
    prob, M = setup
    mesh = make_device_mesh(8)
    S = ShardedProjectedSystem(prob.form, M, mesh)
    rng = np.random.default_rng(1)
    u_p = jnp.asarray(rng.standard_normal(M.n_bg_dofs) * 0.1)
    r_ref = np.asarray(M.rmv(prob.form.residual(M.mv(u_p))))
    r_sh = np.asarray(S.residual_b(u_p))
    assert np.allclose(r_sh, r_ref, atol=1e-9 * max(np.abs(r_ref).max(), 1))


@needs_devices
def test_sharded_step_solves(setup):
    prob, M = setup
    mesh = make_device_mesh(8)
    S = ShardedProjectedSystem(prob.form, M, mesh)
    step = jax.jit(S.make_step(rtol=1e-10, max_it=300))
    u_p, resnorm = step(jnp.zeros(M.n_bg_dofs))
    # compare against the unsharded solve
    u0 = jnp.zeros(prob.space.n_dofs)
    A, b = assemble_background_system(prob.form, u0, M)
    from iifea.solvers import solve_ksp

    u_ref, _ = solve_ksp(A, b, method="cg", pc="jacobi", monitor=False,
                         rtol=1e-10)
    assert np.allclose(np.asarray(u_p), np.asarray(u_ref), atol=1e-6)


@needs_devices
@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_device_count_invariance(setup, n_dev):
    """Same norms regardless of partitioning — the mpirun invariance check."""
    prob, M = setup
    mesh = make_device_mesh(n_dev)
    S = ShardedProjectedSystem(prob.form, M, mesh)
    step = jax.jit(S.make_step(rtol=1e-10, max_it=300))
    u_p, _ = step(jnp.zeros(M.n_bg_dofs))
    e = prob.error_norms(M.mv(u_p))
    assert abs(e["L2"] - 0.0329) < 0.02  # stable across partitionings


@needs_devices
def test_sharded_stencil_mv_matches_single(setup):
    from iifea.ops.stencil import StencilOperator2D
    from iifea.parallel.stencil import ShardedStencil2D

    prob, M = setup
    n_bg = 12
    blocks = prob.form.jacobian_blocks(jnp.zeros(prob.space.n_dofs))
    A = BackgroundOperator(prob.form, blocks, M)
    S = StencilOperator2D.probe(A.mv, (n_bg + 1, n_bg + 1), radius=2,
                                dtype=jnp.float64)
    mesh = make_device_mesh(8)
    Ssh = ShardedStencil2D(S, mesh)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(S.n))
    y_ref = np.asarray(S.mv(x))
    y_sh = np.asarray(Ssh.mv(x))
    assert np.allclose(y_sh, y_ref, atol=1e-12 * max(np.abs(y_ref).max(), 1))


@needs_devices
def test_sharded_stencil_cg(setup):
    from iifea.ops.stencil import StencilOperator2D
    from iifea.parallel.stencil import ShardedStencil2D
    from iifea.solvers import krylov

    prob, M = setup
    n_bg = 12
    u0 = jnp.zeros(prob.space.n_dofs)
    blocks = prob.form.jacobian_blocks(u0)
    A = BackgroundOperator(prob.form, blocks, M)
    b = M.rmv(-prob.form.residual(u0))
    S = StencilOperator2D.probe(A.mv, (n_bg + 1, n_bg + 1), radius=2,
                                dtype=jnp.float64)
    mesh = make_device_mesh(8)
    Ssh = ShardedStencil2D(S, mesh)
    d2 = Ssh.diag2()
    invd2 = 1.0 / jnp.where(jnp.abs(d2) > 0, d2, 1.0)
    b2 = Ssh.shard_vec(b)

    @jax.jit
    def solve(b2):
        return krylov.cg(Ssh.mv2, b2, minv=lambda r: invd2 * r,
                         rtol=1e-11, max_it=2000)

    x2, info = solve(b2)
    assert bool(info.converged)
    x_ref, _ = krylov.cg(S.mv, b, minv=lambda r: r * (1.0 / jnp.where(
        jnp.abs(S.diag()) > 0, S.diag(), 1.0)), rtol=1e-11, max_it=2000)
    d = np.asarray(S.diag())
    mask = np.abs(d) > 0
    got = np.asarray(Ssh.unshard_vec(x2))[mask]
    ref = np.asarray(x_ref)[mask]
    assert np.allclose(got, ref, atol=1e-7 * max(np.abs(ref).max(), 1))


@needs_devices
def test_sharded_bench_refine_matches_single():
    """bench.py --devices N path: the sharded f32 MG-PCG + df refinement
    reaches the same f64 residual as the single-device BinnedLatticeSolver
    and agrees on well-supported dofs (VERDICT r1 item 10)."""
    import bench
    from iifea.solvers.lattice_fast import BinnedLatticeSolver
    from iifea.mesh.generators import immersed_square_problem

    n_bg = 24
    x_sh, info = bench.run_sharded(n_bg, 8, rtol=1e-10)
    assert info["rel_residual_f64"] < 1e-10

    mesh_f, M = immersed_square_problem(
        n_fg=bench.fg_of(n_bg), n_bg=n_bg, degree=1, dtype=np.float64
    )
    prob = PoissonProblem(mesh_f, k=1, sym=True, beta_value=10,
                          dtype=np.float64)
    solver = BinnedLatticeSolver(prob, M, (n_bg + 1, n_bg + 1))
    x_1, info_1 = solver.solve(rtol=1e-10)
    assert info_1["rel_residual"] < 1e-10
    d = np.asarray(solver.probe(
        solver.bind(*solver.assemble()[1:])).diag())
    mask = d > 0.05 * d.max()
    scale = max(float(jnp.abs(x_1).max()), 1.0)
    assert np.allclose(np.asarray(x_sh)[mask], np.asarray(x_1)[mask],
                       atol=1e-7 * scale)


@needs_devices
def test_sharded_stencil3d_mv_matches_single():
    """3D slab-sharded stencil apply == single-device mv (raw immersed
    operator from the synthetic cube)."""
    from iifea.mesh.generators import immersed_cube_problem
    from iifea.ops.stencil import StencilOperator3D
    from iifea.parallel.stencil import ShardedStencil3D

    n_bg = 8
    mesh_f, M = immersed_cube_problem(n_fg=16, n_bg=n_bg)
    prob = PoissonProblem(mesh_f, k=1, sym=True, beta_value=10)
    blocks = prob.form.jacobian_blocks(jnp.zeros(prob.space.n_dofs))
    A = BackgroundOperator(prob.form, blocks, M)
    S = StencilOperator3D.probe_multi(
        A.mv_multi, (n_bg + 1,) * 3, radius=2, dtype=jnp.float64
    )
    Ssh = ShardedStencil3D(S, make_device_mesh(8))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(S.shape[0] * S.shape[1] * S.shape[2]))
    y_ref = np.asarray(S.mv(x))
    y_sh = np.asarray(Ssh.mv(x))
    assert np.allclose(y_sh, y_ref, atol=1e-12 * max(np.abs(y_ref).max(), 1))


@needs_devices
def test_sharded_stencil_block2d_mv_matches_single():
    """Block (vector) row-sharded stencil apply == single-device mv
    (synthetic immersed elasticity operator, n_fields=2)."""
    from iifea.mesh.generators import immersed_square_problem
    from iifea.models.elasticity import ImmersedElasticityProblem
    from iifea.ops.stencil import StencilOperatorBlock2D
    from iifea.parallel.stencil import ShardedStencilBlock2D

    n_bg = 12
    mesh_f, M = immersed_square_problem(n_fg=24, n_bg=n_bg, n_fields=2)
    prob = ImmersedElasticityProblem(mesh_f, k=1)
    blocks = prob.form.jacobian_blocks(jnp.zeros(prob.space.n_dofs))
    A = BackgroundOperator(prob.form, blocks, M)
    S = StencilOperatorBlock2D.probe_multi(
        A.mv_multi, (n_bg + 1, n_bg + 1), n_fields=2, radius=2,
        dtype=jnp.float64,
    )
    Ssh = ShardedStencilBlock2D(S, make_device_mesh(8))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(S.n))
    y_ref = np.asarray(S.mv(x))
    y_sh = np.asarray(Ssh.mv(x))
    assert np.allclose(y_sh, y_ref, atol=1e-12 * max(np.abs(y_ref).max(), 1))
