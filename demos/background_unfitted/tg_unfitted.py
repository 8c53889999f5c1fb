"""Taylor-Green vortex on an unfitted background — parity with reference
demos/background_unfitted/tg_unfitted.py.

Note on the reference's behavior (SURVEY.md §2.2 D8): tg_unfitted.py builds a
transfer matrix at :208 but *overrides it with an identity* at :221, so the
demo degenerates to a fitted solve exercising the same VMS pipeline. This
port reproduces that behavior by default (--identity True) and also offers
the real runtime-transfer path the reference constructs but never uses.

    python3 demos/background_unfitted/tg_unfitted.py --ref 1
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

from iifea.api import l2_project
from iifea.mesh.core import Mesh
from iifea.mesh.generators import rectangle_mesh, transfer_matrix_simplex
from iifea.models.navier_stokes import TaylorGreenProblem, u_exact
from iifea.ops.extraction import ExtractionOperator
from iifea.solvers import solve_nonlinear
from iifea.utils.logging import log_info


def str2bool(v):
    return str(v) not in ("False", "false", "0")


parser = argparse.ArgumentParser()
parser.add_argument('--ref', dest='ref', default='1', help='Refinement level')
parser.add_argument('--Re', dest='Re', default=100.0, help='Reynolds number.')
parser.add_argument('--T', dest='T', default=1.0, help='Time interval.')
parser.add_argument('--identity', dest='identity', default=True,
                    help='True: identity M (reference behavior, :221); '
                         'False: real runtime transfer matrix')
args = parser.parse_args()
ref = int(args.ref)
Re = float(args.Re)
T = float(args.T)

n = 8 * 2**ref
L = 2.0
mesh_f = rectangle_mesh((-L / 2, -L / 2), (L / 2, L / 2), n, n)
mesh_f = Mesh(mesh_f.coords, mesh_f.cells,
              np.full(mesh_f.n_cells, 2, np.int32))

N = math.sqrt(mesh_f.n_cells)
Dt_approx = 4 / N
N_STEPS = int(np.ceil(T / Dt_approx))
Dt = T / N_STEPS

bdry = np.where(mesh_f.facet_data.facet_cells[:, 1] < 0)[0]
prob = TaylorGreenProblem(mesh_f, k=1, Re=Re, Dt=Dt, boundary_facets=bdry)
if str2bool(args.identity):
    M = ExtractionOperator.identity(prob.space.n_nodes, n_fields=3)
else:
    mesh_b = rectangle_mesh((-2.0, -2.0), (2.0, 2.0), n, n)
    M = transfer_matrix_simplex(
        mesh_b, np.asarray(prob.space.node_coords), n_fields=3
    )
prob = TaylorGreenProblem(mesh_f, k=1, Re=Re, Dt=Dt, n_bg_dofs=M.n_bg_dofs,
                          boundary_facets=bdry)

nu = prob.nu


def ic(x):
    u = u_exact(x, nu, 0.0)
    return jnp.array([u[0], u[1], 0.0])


up_p, up_old_f = l2_project(ic, prob.space, prob.cell_dom, M)
up_f = up_old_f
t = 0.0
for step in range(N_STEPS):
    log_info(f"======= Time step {step+1}/{N_STEPS} =======")
    t += 0.5 * Dt
    up_p, up_f = solve_nonlinear(
        prob.form, up_f, M, up_p,
        aux={"up_old": up_old_f}, params={"t": jnp.asarray(t)},
        max_iters=10, linear_method='gmres', monitor_newton=False,
        relative_tolerance=5e-4, absolute_tolerance=1e-4,
        absolute_tolerance_res=1e-5,
    )
    up_old_f = up_f
    t += 0.5 * Dt

norms = prob.error_norms(up_f, t)
log_info('-' * 40)
log_info(f"L2 velocity error: {norms['L2u']}")
log_info(f"H1 velocity error: {norms['H1u']}")
log_info(f"L2 pressure error: {norms['L2p']}")
log_info(f"L2 pressure error (mean-removed): {norms['L2p0']}")
log_info(f"H1 pressure error: {norms['H1p']}")
log_info('-' * 40)
