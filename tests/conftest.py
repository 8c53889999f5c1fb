"""Test configuration: run on a virtual 8-device CPU mesh.

Sharding correctness is validated on host-platform virtual devices (SURVEY.md
§7 step 8). Both settings must be made before jax initializes a backend.
Tests marked ``gpu`` need a CUDA device and skip elsewhere; run them on the
card with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
"""
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# no persistent compile cache in tests (or in the demos they start): CPU
# executables are specialised to the compiling host's CPU features
os.environ.setdefault("JAX_ENABLE_COMPILATION_CACHE", "false")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import iifea  # noqa: E402,F401  (enables x64)

REF_MESHES = "/root/reference/meshes"


def ref_mesh_path(*parts: str) -> str:
    return os.path.join(REF_MESHES, *parts)


# -- test tiers ---------------------------------------------------------------
# The full suite takes ~20-35 min on a 1-core host (jit compiles dominate).
# Default selection excludes @pytest.mark.slow and finishes in ~8 min
# (measured 7.5 min green, r2); `pytest tests/ --runslow` runs everything
# (the CI/judge full tier).
import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow",
    )


# Central slow list (measured on the 1-core dev box, 2026-08; each entry
# >25 s). Every feature keeps at least one fast representative.
_SLOW_NODES = {
    # multigrid (fast rep: test_mg_vcycle_is_linear)
    "test_mg3d_vcycle_is_linear", "test_mg3d_accelerates_cg",
    "test_mg_accelerates_cg",
    # ksp mg paths (fast rep: test_solve_ksp_mg_pc_block)
    "test_solve_ksp_mg_pc_3d", "test_solve_ksp_mg_pc",
    "test_newton_with_mg_fast_path", "test_tg_step_with_block_mg",
    # direct solver (fast rep: test_direct_near_null_pivot_escalation)
    "test_direct_iterative_fallback_3d",
    # newton globalization (compile-heavy: two full Newton loops)
    "test_newton_line_search_globalizes",
    # lattice_bin (fast reps: [9-12] probe, f32_close, cell_stiffness_df)
    "test_binned_lattice_solver_end_to_end",
    "test_df_apply_matches_f64_general", "test_rhs_df_fast_path",
    "test_binned_probe_matches_general[16-23]",
    "test_binned_probe_matches_general[12-17]",
    # poisson (fast reps: reference_meshes_linear[2]/[4], nonsym, direct)
    "test_convergence_rates_symmetric", "test_reference_meshes_linear[3-0.055]",
    "test_identity_extraction_matches_fitted",
    # parallel (fast reps: device_count_invariance, step_solves, stencil_cg)
    "test_sharded_matvec_matches_single", "test_sharded_diag_matches_single",
    "test_sharded_residual_matches_single",
    "test_sharded_stencil_mv_matches_single",
    "test_sharded_bench_refine_matches_single",
    # models (fast reps: taylor_green_single_step, biharmonic)
    "test_elasticity_kirsch_convergence", "test_shell_energy_hessian_symmetry",
    "test_poisson_quadratic_rates", "test_pinned_shell_center_deflection",
    # stencil (fast reps: block_stencil, stencil_cg_solves)
    "test_stencil3d_matches_general_operator",
    "test_stencil_matches_general_operator",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.name in _SLOW_NODES:
            item.add_marker(pytest.mark.slow)
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="slow tier: pass --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)
