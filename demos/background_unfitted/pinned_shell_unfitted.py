"""Pinned Kirchhoff-Love shell with an explicit B-spline background —
capability parity with reference demos/background_unfitted/pinned_shell_unfitted.py
(tIGAr ExplicitBSplineControlMesh + mshr foreground).

Substitutions (neither tIGAr nor mshr exists in this environment, and both
are external to the reference repo): the foreground is a structured simplex
mesh immersing the 45°-rotated square (the mshr geometry of
pinned_shell_unfitted.py:33-47) via material classification; the background
is this framework's native quadratic B-spline space, with extraction built
by basis evaluation at foreground nodes (mesh/bspline.py — the
splineGenerator.writeExtraction role).

    python3 demos/background_unfitted/pinned_shell_unfitted.py --ref 4
"""
import argparse
import math
import os
import sys

sys.path.insert(
    0,
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
)

import numpy as np
import jax.numpy as jnp

from iifea.mesh.bspline import BSplineSpace2D
from iifea.mesh.core import Mesh
from iifea.mesh.generators import rectangle_mesh
from iifea.models.kl_shell import KLShellProblem
from iifea.solvers import solve_nonlinear
from iifea.utils.logging import log_info

parser = argparse.ArgumentParser()
parser.add_argument('--ref', dest='ref', default='4',
                    help='Refinement level (foreground 2^ref cells per edge)')
parser.add_argument('--p', dest='p', default=2, help='B-spline degree')
args = parser.parse_args()
ref = int(args.ref)
p = int(args.p)

# foreground: structured mesh over [-1,1]^2; block = 45-degree rotated square
# (diamond) of half-diagonal 1/sqrt(2) (pinned_shell_unfitted.py:33-47)
n = 8 * 2**ref
mesh_f = rectangle_mesh((-1.0, -1.0), (1.0, 1.0), n, n)
cent = mesh_f.cell_coords.mean(1)
half = 1.0 / math.sqrt(2.0)
inside = (np.abs(cent[:, 0]) + np.abs(cent[:, 1])) <= half * math.sqrt(2.0)
material = np.where(inside, 2, 1).astype(np.int32)
mesh_f = Mesh(mesh_f.coords, mesh_f.cells, material)


def flat_surface(xi):
    return jnp.array([xi[0], xi[1], 0.0])


prob = KLShellProblem(
    mesh_f, flat_surface,
    E=4.8e5, nu=0.38, h_th=0.1, areal_force=90.0,
    pin_alpha=1e6, pin_mode="interface", pin_alpha_scale="h_facet",
    use_jvol=False,
)

# background: native quadratic B-spline space over the bounding square
spline = BSplineSpace2D(p, (max(n // 2, 4),) * 2, (-1.0, -1.0), (1.0, 1.0))
M = spline.transfer_matrix(
    np.asarray(prob.space.node_coords), n_fields=3
)
log_info(f"B-spline background: {spline.ncp} control net, "
         f"{M.n_bg_dofs} dofs; fg {prob.space.n_dofs} dofs")

u_p, u_f = solve_nonlinear(
    prob.form, jnp.zeros(prob.space.n_dofs), M, jnp.zeros(M.n_bg_dofs),
    max_iters=20, linear_method='direct', monitor_newton=True,
    relative_tolerance=5e-4, absolute_tolerance=1e-4,
    absolute_tolerance_res=1e-5,
)

u_x, u_y, u_z = prob.evaluate(u_f, [[0.0, 0.0]])[0]
log_info(f"Center displacement: ( {u_x} , {u_y} , {u_z} )")
