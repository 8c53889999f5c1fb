from iifea.solvers.krylov import cg, bicgstab, gmres, gcr  # noqa: F401
from iifea.solvers.direct import solve_direct  # noqa: F401
from iifea.solvers.ksp import solve_ksp  # noqa: F401
from iifea.solvers.newton import solve_nonlinear, solve_newtons_linear  # noqa: F401
from iifea.solvers.trim import trim_mask_from_diag, apply_trim_rhs  # noqa: F401
from iifea.solvers.condition import estimate_condition_number  # noqa: F401
from iifea.solvers.lattice_fast import BinnedLatticeSolver  # noqa: F401
