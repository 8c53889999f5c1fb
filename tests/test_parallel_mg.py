"""Sharded multigrid V-cycle parity (VERDICT r4 item 2).

The reference's preconditioners run rank-parallel under mpirun
(InterpolationBasedImmersedFEA/common.py:509-641); these tests pin that the
row-block-sharded V-cycle (parallel/multigrid.py) is numerically the same
cycle as the single-device hierarchy, on the virtual 8-device CPU mesh."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from iifea.parallel.sharding import make_device_mesh

needs_devices = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@needs_devices
def test_sharded_mg2d_minv_matches_single():
    """V-cycle output parity on the real immersed cut-cell operator (f32
    planes from the binned pipeline), fine level row-sharded over 8
    devices, coarse level replicated."""
    from iifea.mesh.generators import immersed_square_problem
    from iifea.models.poisson import PoissonProblem
    from iifea.parallel.multigrid import ShardedMultigrid2D
    from iifea.solvers.lattice_fast import BinnedLatticeSolver

    n_bg = 64
    mesh_f, M = immersed_square_problem(
        n_fg=90, n_bg=n_bg, degree=1, dtype=np.float64
    )
    prob = PoissonProblem(mesh_f, k=1, sym=True, beta_value=10,
                          dtype=np.float64)
    solver = BinnedLatticeSolver(prob, M, (n_bg + 1, n_bg + 1))
    S32 = solver.probe(solver.bind(*solver.assemble()[1:]))
    mg = solver.build_mg(S32)
    mesh = make_device_mesh(8)
    # threshold chosen so the 65-row fine level shards and the 33-row
    # coarse level replicates — exercises the mixed fine/coarse case
    smg = ShardedMultigrid2D(mg, mesh, min_shard_rows=40)
    assert smg._specs[0][0] == "dp"
    assert smg._specs[-1][0] is None

    rng = np.random.default_rng(0)
    r = jnp.asarray(rng.standard_normal(S32.n), jnp.float32)
    z_ref = np.asarray(mg.minv(r))
    z_sh = np.asarray(jax.jit(smg.minv)(r))
    scale = max(np.abs(z_ref).max(), 1e-30)
    assert np.allclose(z_sh, z_ref, atol=3e-6 * scale)


@needs_devices
def test_sharded_mg2d_padded_plane_interface():
    """minv_padded consumes/produces the row-padded sharded planes of
    parallel/stencil.ShardedStencil2D (the bench --devices layout)."""
    from iifea.mesh.generators import immersed_square_problem
    from iifea.models.poisson import PoissonProblem
    from iifea.parallel.multigrid import ShardedMultigrid2D
    from iifea.parallel.stencil import ShardedStencil2D
    from iifea.solvers.lattice_fast import BinnedLatticeSolver

    n_bg = 64
    mesh_f, M = immersed_square_problem(
        n_fg=90, n_bg=n_bg, degree=1, dtype=np.float64
    )
    prob = PoissonProblem(mesh_f, k=1, sym=True, beta_value=10,
                          dtype=np.float64)
    solver = BinnedLatticeSolver(prob, M, (n_bg + 1, n_bg + 1))
    S32 = solver.probe(solver.bind(*solver.assemble()[1:]))
    mg = solver.build_mg(S32)
    mesh = make_device_mesh(8)
    Ssh = ShardedStencil2D(S32, mesh)
    smg = ShardedMultigrid2D(mg, mesh)

    rng = np.random.default_rng(1)
    r = jnp.asarray(rng.standard_normal(S32.n), jnp.float32)
    z_ref = np.asarray(mg.minv(r))
    z2 = jax.jit(smg.minv_padded)(Ssh.shard_vec(r))
    assert z2.shape == (Ssh.nxs, S32.shape[1])
    z_sh = np.asarray(Ssh.unshard_vec(z2))
    scale = max(np.abs(z_ref).max(), 1e-30)
    assert np.allclose(z_sh, z_ref, atol=3e-6 * scale)
    # padded rows stay zero
    assert not np.asarray(z2)[S32.shape[0]:].any()


@needs_devices
def test_sharded_mg3d_minv_matches_single():
    """3D x-slab-sharded V-cycle parity (f64 analytic Dirichlet Laplacian,
    3-level hierarchy)."""
    from iifea.ops.multigrid import StencilMultigrid3D
    from iifea.ops.stencil import dirichlet_laplace_3d
    from iifea.parallel.multigrid import ShardedMultigrid3D

    S = dirichlet_laplace_3d((33, 33, 33))
    mg = StencilMultigrid3D(S)
    mesh = make_device_mesh(8)
    smg = ShardedMultigrid3D(mg, mesh, min_shard_rows=32)
    assert smg._specs[0][0] == "dp"

    rng = np.random.default_rng(2)
    r = jnp.asarray(rng.standard_normal(S.n))
    z_ref = np.asarray(mg.minv(r))
    z_sh = np.asarray(jax.jit(smg.minv)(r))
    scale = max(np.abs(z_ref).max(), 1e-30)
    assert np.allclose(z_sh, z_ref, atol=1e-11 * scale)


@needs_devices
def test_sharded_mg_pcg_solves():
    """End-to-end: sharded CG preconditioned by the SHARDED V-cycle (no
    un-shard anywhere in the loop) converges and matches the single-device
    MG-PCG solution on supported dofs."""
    from iifea.mesh.generators import immersed_square_problem
    from iifea.models.poisson import PoissonProblem
    from iifea.parallel.multigrid import ShardedMultigrid2D
    from iifea.parallel.stencil import ShardedStencil2D
    from iifea.solvers import krylov
    from iifea.solvers.lattice_fast import BinnedLatticeSolver

    n_bg = 64
    mesh_f, M = immersed_square_problem(
        n_fg=90, n_bg=n_bg, degree=1, dtype=np.float64
    )
    prob = PoissonProblem(mesh_f, k=1, sym=True, beta_value=10,
                          dtype=np.float64)
    solver = BinnedLatticeSolver(prob, M, (n_bg + 1, n_bg + 1))
    b64, K_cell_b, K_facet = solver.assemble()
    bound = solver.bind(K_cell_b, K_facet)
    S32 = solver.probe(bound)
    mg = solver.build_mg(S32)
    mesh = make_device_mesh(8)
    Ssh = ShardedStencil2D(S32, mesh)
    smg = ShardedMultigrid2D(mg, mesh)

    r32 = b64.astype(jnp.float32)

    @jax.jit
    def cg_sh(b2):
        return krylov.cg(Ssh.mv2, b2, minv=smg.minv_padded, rtol=1e-6,
                         atol=1e-30, max_it=300, check_every=4)

    x2, info = cg_sh(Ssh.shard_vec(r32))
    assert bool(info.converged)
    x_sh = np.asarray(Ssh.unshard_vec(x2))

    dx_ref, info_ref = solver._cg_fn(S32, mg, r32, 1e-6)
    d = np.asarray(S32.diag())
    mask = d > 0.05 * d.max()
    ref = np.asarray(dx_ref)
    scale = max(np.abs(ref).max(), 1.0)
    assert np.allclose(x_sh[mask], ref[mask], atol=2e-4 * scale)
    # similar iteration counts: same preconditioner quality
    assert abs(int(info.iters) - int(info_ref.iters)) <= 4


@needs_devices
def test_sharded_mg_block2d_minv_matches_single():
    """Block (vector-field) sharded V-cycle parity on a synthetic immersed
    elasticity operator (nF=2), plus end-to-end sharded block MG-CG."""
    from iifea.mesh.generators import immersed_square_problem
    from iifea.models.elasticity import ImmersedElasticityProblem
    from iifea.ops.multigrid import StencilMultigridBlock
    from iifea.ops.projection import BackgroundOperator
    from iifea.ops.stencil import StencilOperatorBlock2D
    from iifea.parallel.multigrid import ShardedMultigridBlock2D
    from iifea.parallel.stencil import ShardedStencilBlock2D
    from iifea.solvers import krylov

    n_bg = 24
    mesh_f, M = immersed_square_problem(n_fg=48, n_bg=n_bg, n_fields=2)
    prob = ImmersedElasticityProblem(mesh_f, k=1)
    blocks = prob.form.jacobian_blocks(jnp.zeros(prob.space.n_dofs))
    A = BackgroundOperator(prob.form, blocks, M)
    S = StencilOperatorBlock2D.probe_multi(
        A.mv_multi, (n_bg + 1, n_bg + 1), n_fields=2, radius=2,
        dtype=jnp.float64,
    )
    mg = StencilMultigridBlock(S)
    mesh = make_device_mesh(8)
    smg = ShardedMultigridBlock2D(mg, mesh, min_shard_rows=16)
    assert smg._specs[0][1] == "dp"
    assert smg._specs[-1][1] is None

    rng = np.random.default_rng(4)
    r = jnp.asarray(rng.standard_normal(S.n))
    z_ref = np.asarray(mg.minv(r))
    z_sh = np.asarray(jax.jit(smg.minv)(r))
    scale = max(np.abs(z_ref).max(), 1e-30)
    assert np.allclose(z_sh, z_ref, atol=1e-10 * scale)

    # end-to-end: sharded block CG with the sharded block V-cycle
    Ssh = ShardedStencilBlock2D(S, mesh)
    # rhs manufactured in the operator's range: a raw random vector has
    # components on dead (unsupported) dofs, which no solver can reach
    x_true = jnp.asarray(rng.standard_normal(S.n))
    b = S.mv(x_true)

    @jax.jit
    def cg_sh(b3):
        return krylov.cg(Ssh.mvb, b3, minv=smg.minv_padded, rtol=1e-8,
                         atol=1e-30, max_it=400, check_every=4)

    x3, info = cg_sh(Ssh.shard_vec(b))
    assert bool(info.converged)
    x_sh = Ssh.unshard_vec(x3)
    rel = float(jnp.linalg.norm(S.mv(x_sh) - b) / jnp.linalg.norm(b))
    assert rel < 1e-6, rel
