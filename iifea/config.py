"""Global configuration for iifea.

The reference's knob surface (DOLFIN ``parameters[...]``, PETSc options DB,
per-demo argparse — see SURVEY.md §5 "Config / flag system") is consolidated
here into one module-level config plus per-problem dataclasses in the demos.
"""
from __future__ import annotations

import dataclasses
import os

import jax

_CONFIGURED = False

# persistent compile cache when JAX_COMPILATION_CACHE_DIR is not set: a fixed
# directory in the checkout, so reruns on any machine find what they cached
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def setup(enable_x64: bool = True) -> None:
    """Initialise JAX for immersed-FEA workloads.

    Double precision is the default because the reference's numerics
    (Nitsche penalties up to h^-3, basis-function-removal tolerances of 1e-9,
    KSP rtol 1e-8 — common.py:509-641) are meaningless in f32.
    Performance-critical paths (bench.py) opt into mixed precision
    explicitly via ``dtype=...`` arguments instead of flipping this switch.
    """
    global _CONFIGURED
    if _CONFIGURED:
        return
    jax.config.update("jax_enable_x64", bool(enable_x64))
    # JAX reads JAX_COMPILATION_CACHE_DIR itself; only the default is ours
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    _CONFIGURED = True


@dataclasses.dataclass
class SolverConfig:
    """Mirrors the reference's linear-solve knobs (common.py:509-641).

    method: 'cg' | 'gmres' (FGMRES) | 'gcr' | 'bicgstab' | 'direct'
        ('direct' provides the 'mumps' role: sparse LU, executed on host;
        see SURVEY.md §2.3 N5.)
    pc: 'jacobi' | 'none' | 'bjacobi'
    """

    method: str = "gmres"
    pc: str = "jacobi"
    rtol: float = 1e-8
    atol: float = 1e-9
    max_it: int = 100000
    gmres_restart: int = 300
    bfr_tol: float | None = None  # basis-function removal (trimNodes) tolerance
    monitor: bool = True


def default_device_count() -> int:
    return int(os.environ.get("IIFEA_DEVICES", len(jax.devices())))
