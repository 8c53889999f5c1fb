"""Cut Kirchhoff-Love shell with an explicit B-spline background —
capability parity with reference demos/background_unfitted/cut_shell_unfitted.py.

The reference builds the trimmed 'bent tab' foreground with mshr CSG
(square - circle - rectangle + rectangle + small circle,
cut_shell_unfitted.py:27-46) and the B-spline background with tIGAr. Here the
same trimmed geometry defines the immersed material classification on a
structured foreground mesh, and the background is the native B-spline space
(mesh/bspline.py).

    python3 demos/background_unfitted/cut_shell_unfitted.py --ref 4 --steps 10
"""
import argparse
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
parser.add_argument('--ref', dest='ref', default='4', help='Refinement level')
parser.add_argument('--p', dest='p', default=2, help='B-spline degree')
parser.add_argument('--steps', dest='steps', default=10,
                    help='Load steps (reference: 100)')
args = parser.parse_args()
ref = int(args.ref)
p = int(args.p)
N_STEPS = int(args.steps)


def tab_material(x, y):
    """The trimmed geometry of cut_shell.py:138-153 / the mshr CSG of
    cut_shell_unfitted.py:27-46: unit square minus big circle minus lower
    rectangle, plus small circle and upper neck."""
    r2 = x**2 + y**2
    mat = np.ones_like(x, dtype=np.int32)
    cut = (r2 < 0.25) | ((y < 0) & (np.abs(x) < 0.2) & (r2 >= 0.25))
    keep = (r2 < 0.0625) | ((r2 >= 0.0625) & (r2 < 0.25) & (y > 0)
                            & (np.abs(x) < 0.1))
    mat[cut] = 0
    mat[cut & keep] = 1
    return np.where(mat > 0, 2, 1).astype(np.int32)


n = 8 * 2**ref
mesh_f = rectangle_mesh((-1.0, -1.0), (1.0, 1.0), n, n)
cent = mesh_f.cell_coords.mean(1)
material = tab_material(cent[:, 0], cent[:, 1])
mesh_f = Mesh(mesh_f.coords, mesh_f.cells, material)


def bent_tab_surface(xi):
    return jnp.array([xi[0], xi[1], 0.5 * (1.0 - xi[0] ** 2)])


prob = KLShellProblem(
    mesh_f, bent_tab_surface,
    E=3e4, nu=0.3, h_th=0.03, pressure=2.0,
    pin_alpha=1e5, pin_mode="boundary", pin_alpha_scale="hmin",
    use_jvol=True,
)

spline = BSplineSpace2D(p, (max(n // 2, 4),) * 2, (-1.0, -1.0), (1.0, 1.0))
M = spline.transfer_matrix(np.asarray(prob.space.node_coords), n_fields=3)
log_info(f"B-spline background: {spline.ncp} control net; "
         f"fg {prob.space.n_dofs} dofs")

T_MAX = 1.0
DELTA_T = T_MAX / float(N_STEPS)
t = 0.0
u_p = jnp.zeros(M.n_bg_dofs)
u_f = jnp.zeros(prob.space.n_dofs)
for i in range(N_STEPS):
    log_info(f"------- Step: {i+1} , t = {t} -------")
    u_p, u_f = solve_nonlinear(
        prob.form, u_f, M, u_p, params={"t": jnp.asarray(t)},
        max_iters=100, linear_method='direct', monitor_newton=False,
    )
    t += DELTA_T

tip = prob.evaluate(u_f, [[0.0, -0.25]])[0]
log_info(f"Displacement at tip of tab: ( {tip[0]} , {tip[1]} , {tip[2]} )")
