"""chip_smoke.py on the host: the device gate refuses the CPU, and the
phases' checks and references are exercised at tiny sizes."""
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_device_gate_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        chip_smoke.device_gate()


@pytest.mark.parametrize("alone", [False, True])
def test_script_fails_without_gpu_and_prints_no_result(alone, tmp_path):
    """On the CPU, and as a lone copy without the package, the script exits
    non-zero and never prints its JSON result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        cwd = str(tmp_path)
        script = shutil.copy(script, tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_df_phase_passes_on_host():
    chip_smoke.check_df(n=1 << 14)


def test_vcycle_precision_phase_on_laplacian():
    """f32 vs f64 V-cycle of one hierarchy (phase 3's measure) on a 65²
    Dirichlet Laplacian in radius-2 stencil storage."""
    from iifea.ops.stencil import StencilOperator2D

    s = 65
    C = np.zeros((25, s, s), np.float32)
    inner = np.zeros((s, s), bool)
    inner[1:-1, 1:-1] = True
    C[12] = np.where(inner, 4.0, 1.0)
    for k in (7, 17, 11, 13):          # (±1, 0), (0, ±1) in 5x5 ordering
        C[k] = np.where(inner, -1.0, 0.0)
    S32 = StencilOperator2D(jnp.asarray(C), (s, s), 2)
    assert chip_smoke.check_vcycle_precision(S32) <= chip_smoke.VCYCLE_TOL


@pytest.mark.parametrize("dim,n_bg", [(2, 8), (3, 4)])
def test_reference_system_matches_projected_operator(dim, n_bg):
    """The independent scipy operator of phases 4-6 equals MᵀA_fM applied
    matrix-free, and its rhs the projected residual."""
    import bench
    from iifea.ops.projection import assemble_background_system

    _, prob, M = bench.build_problem(n_bg, np.float64, dim)
    A_ref, b_ref = chip_smoke.reference_system(prob, M)
    A, b = assemble_background_system(
        prob.form, jnp.zeros(prob.space.n_dofs), M)
    x = np.random.default_rng(0).standard_normal(M.n_bg_dofs)
    assert np.allclose(A_ref @ x, np.asarray(A.mv(jnp.asarray(x))),
                       rtol=1e-12, atol=1e-12 * np.abs(A_ref).max())
    assert np.allclose(b_ref, np.asarray(b), rtol=1e-12, atol=1e-14)



@pytest.mark.gpu
def test_df_phase_on_card():
    """Phase 2 at full size on the card (run there with -m gpu)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA device")
    chip_smoke.check_df()
