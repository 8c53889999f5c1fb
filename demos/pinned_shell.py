"""Kirchhoff-Love shell, flat square pinned at the immersed (diamond) boundary,
uniform vertical load — parity with reference demos/pinned_shell.py.

    python3 demos/pinned_shell.py --ref 5
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp

from iifea.mesh.io import read_mesh
from iifea.models.kl_shell import KLShellProblem
from iifea.ops.extraction import ExtractionOperator
from iifea.solvers import solve_nonlinear
from iifea.utils.logging import log_info

parser = argparse.ArgumentParser()
parser.add_argument('--ref', dest='ref', default='5',
                    help='Refinement level, integers in (4,6)')
parser.add_argument('--line-search', dest='line_search', default=False,
                    action='store_true',
                    help='Backtracking line search on ||R|| inside Newton (globalization beyond the reference, common.py:474).')
parser.add_argument('--ptc', dest='ptc', type=float, default=None,
                    help='Pseudo-transient continuation sigma0 (A + sigma_k|diag A|, sigma decaying with the residual).')
parser.add_argument('--mesh-root', dest='mesh_root',
                    default=os.environ.get("IIFEA_MESH_ROOT",
                                           "/root/reference/meshes"))
args = parser.parse_args()
ref = args.ref

path = os.path.join(args.mesh_root, f"square/Quadratic/R{ref}")
mesh_f = read_mesh(path)


def flat_surface(xi):
    # X = [ξ0, ξ1, 0] (pinned_shell.py:109)
    return jnp.array([xi[0], xi[1], 0.0])


prob = KLShellProblem(
    mesh_f, flat_surface,
    E=4.8e5, nu=0.38, h_th=0.1,                    # pinned_shell.py:49-52
    areal_force=90.0,
    pin_alpha=1e6, pin_mode="interface",           # :203, :212-214
    pin_alpha_scale="h_facet", use_jvol=False,
)

M = ExtractionOperator.from_exop_csv(
    os.path.join(path, "ExOp_Cons.csv"), prob.space.n_nodes, n_fields=3
)

u_soln = jnp.zeros(M.n_bg_dofs)
u_f = jnp.zeros(prob.space.n_dofs)
u_soln, u_f = solve_nonlinear(
    prob.form, u_f, M, u_soln, max_iters=10,
    linear_method='direct',
    monitor_newton=False, monitor_linear=False,
    relative_tolerance=5e-4, relax_param=1.0,
    absolute_tolerance=1e-4, absolute_tolerance_res=1e-5,
    line_search=args.line_search, ptc_sigma0=args.ptc,
)                                                  # pinned_shell.py:245-250

middle = [0.0, 0.0]
u_x, u_y, u_z = prob.evaluate(u_f, [middle])[0]
log_info(f"Center displacement: ( {u_x} , {u_y} , {u_z} )")
