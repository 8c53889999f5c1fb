"""2D Taylor-Green vortex, VMS-stabilized unsteady Navier-Stokes — parity with
reference demos/tg_vortex.py (same flags, printed report, CSV schema).

    python3 demos/tg_vortex.py --k 1 --ref 1
"""
import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

from iifea.api import l2_project
from iifea.mesh.io import read_mesh
from iifea.models.navier_stokes import TaylorGreenProblem, u_exact
from iifea.ops.extraction import ExtractionOperator
from iifea.solvers import solve_nonlinear
from iifea.utils.logging import log_info


def str2bool(v):
    return str(v) not in ("False", "false", "0")


parser = argparse.ArgumentParser()
parser.add_argument('--k', dest='k', default=1,
                    help='Polynomial degree (1 or 2).')
parser.add_argument('--ref', dest='ref', default='0',
                    help='Refinement level, integers in (0,6) for 2D')
parser.add_argument('--Re', dest='Re', default=100.0, help='Reynolds number.')
parser.add_argument('--T', dest='T', default=1.0,
                    help='Length of time interval to consider.')
parser.add_argument('--sym', dest='symmetric', default=False,
                    help='True for symmetric Nitsche; False for nonsymmetric')
parser.add_argument('--wf', dest='wf', default=False,
                    help='write output to file')
parser.add_argument('--of', dest='of', default='error_data_tg.csv',
                    help='output file to write error data to')
parser.add_argument('--solv', dest='solv', default='gmres',
                    help='Linear solver for the Newton updates')
parser.add_argument('--pc', dest='pc', default='jacobi',
                    help="Preconditioner; 'mg' = block geometric multigrid "
                         "on the background lattice (synthetic meshes only)")
parser.add_argument('--ckpt', dest='ckpt', default=None,
                    help='Checkpoint directory: resume from latest, save '
                         'every --ckpt-every steps (reference has no '
                         'checkpointing; SURVEY.md §5)')
parser.add_argument('--ckpt-every', dest='ckpt_every', default=10,
                    help='Checkpoint interval in time steps')
parser.add_argument('--line-search', dest='line_search', default=False,
                    action='store_true',
                    help='Backtracking line search on ||R|| inside Newton '
                         '(globalization beyond the reference\'s fixed '
                         'relax_param, common.py:474). Default off.')
parser.add_argument('--ptc', dest='ptc', type=float, default=None,
                    help='Pseudo-transient continuation sigma0: each Newton '
                         'solve uses A + sigma_k|diag A| with sigma_k '
                         'decaying with the residual. Rescues near-singular '
                         'linearizations on badly cut coarse meshes.')
parser.add_argument('--bfr', dest='bfr', type=float, default=None,
                    help='basis-function-removal diagonal tolerance '
                         '(common.py:261-332 trimNodes). The reference TG '
                         'passes bfr_tol=None and leans on MUMPS null-pivot '
                         'detection (common.py:535-539); the iterative path '
                         'has no such crutch, so coarse synthetic cuts with '
                         'unsupported bg dofs need an explicit trim '
                         '(observed: ref 1 synthetic Newton divergence)')
parser.add_argument('--pin-pressure', dest='pin_pressure', default=False,
                    help="Pin one supported pressure dof (removes the "
                         "enclosed-flow constant-pressure null mode; "
                         "recommended with --pc mg)")
parser.add_argument('--mesh-root', dest='mesh_root',
                    default=os.environ.get("IIFEA_MESH_ROOT",
                                           "/root/reference/meshes"),
                    help="Reference mesh artifacts root, or 'synthetic' for "
                         "a generated immersed square on a lattice "
                         "background (enables --pc mg)")
parser.add_argument('--wv', dest='wv', default=False,
                    help='write a ParaView velocity/pressure series '
                         '(tg_results/fields.pvd), one snapshot per '
                         '--wv-every steps')
parser.add_argument('--wv-every', dest='wv_every', default=1,
                    help='snapshot interval in time steps for --wv')
args = parser.parse_args()

k = int(args.k)
ref = args.ref
Re_num = float(args.Re)
T = float(args.T)
symmetric = str2bool(args.symmetric)
write_file = str2bool(args.wf)

lattice_shape = None
if args.mesh_root == "synthetic":
    from iifea.mesh.generators import immersed_square_problem

    n = 8 * 2 ** int(ref)
    n_bg = max(n // 2, 4)
    mesh_f, M_synth = immersed_square_problem(
        n_fg=n, n_bg=n_bg, degree=k, n_fields=3
    )
    lattice_shape = (n_bg + 1, n_bg + 1)
else:
    deg = 'Linear' if k == 1 else 'Quadratic'
    path = os.path.join(args.mesh_root, f"square/{deg}/R{ref}")
    mesh_f = read_mesh(path)
    M_synth = None

# Midpoint stepping, space-time quasi-uniformity (tg_vortex.py:267-273)
N = math.sqrt(mesh_f.n_cells)
Dt_approx = 4 / N
N_STEPS = int(np.ceil(T / Dt_approx))
Dt = T / N_STEPS

if M_synth is not None:
    fileName = "synthetic"
    M = M_synth
else:
    fileName = os.path.join(path, "ExOp_Cons.csv")
    prob = TaylorGreenProblem(mesh_f, k=k, Re=Re_num, Dt=Dt, sym=symmetric)
    M = ExtractionOperator.from_exop_csv(
        fileName, prob.space.n_nodes, n_fields=3
    )
prob = TaylorGreenProblem(
    mesh_f, k=k, Re=Re_num, Dt=Dt, sym=symmetric, n_bg_dofs=M.n_bg_dofs
)

# Project the initial condition (tg_vortex.py:293-297)
nu = prob.nu


def ic_expr(x):
    u = u_exact(x, nu, 0.0)
    return jnp.array([u[0], u[1], 0.0])


up_p, up_old_f = l2_project(ic_expr, prob.space, prob.cell_dom, M)
up_f = up_old_f

zero_ids = None
if str2bool(args.pin_pressure):
    # pin the pressure dof with the largest OPERATOR diagonal (field-blocked
    # bg layout: pressure = field 2, common.py:703). Extraction weight alone
    # is not enough — an M-referenced dof can still have a zero diagonal
    # when the fg dofs it feeds lie outside the integration domain, and
    # pinning a dead dof leaves the constant-pressure null mode in place.
    from iifea.ops.projection import BackgroundOperator

    blocks0 = prob.form.jacobian_blocks(
        up_f, {"up_old": up_old_f}, {"t": jnp.asarray(0.0)}
    )
    d0 = np.asarray(BackgroundOperator(prob.form, blocks0, M).diag())
    nn = M.n_bg_dofs // 3
    zero_ids = np.array([2 * nn + int(np.argmax(d0[2 * nn:]))])

t = 0.0
start_step = 0
if args.ckpt:
    from iifea.utils.checkpoint import load_checkpoint, save_checkpoint

    resumed = load_checkpoint(args.ckpt)
    if resumed is not None:
        start_step, state, meta = resumed
        up_p = state["up_p"]
        up_f = up_old_f = state["up_old_f"]
        t = float(meta["t"])
        log_info(f">>> Resumed from {args.ckpt} at step {start_step}, "
                 f"t = {t}")

series = None
if str2bool(args.wv):
    from iifea.utils.fieldio import PVDSeries

    series = PVDSeries("tg_results/fields.pvd")

    def _write_fields(time, u_field):
        # fg dofs are node-interleaved (u, v, p) triples
        f = np.asarray(u_field).reshape(-1, 3)
        series.write(time, prob.space,
                     point_data={"velocity": f[:, :2], "pressure": f[:, 2]},
                     cell_data={"material": mesh_f.material})

    _write_fields(t, up_f)

for step in range(start_step, N_STEPS):
    log_info(f"======= Time step {step+1}/{N_STEPS} =======")
    t += 0.5 * Dt
    up_p, up_f = solve_nonlinear(
        prob.form, up_f, M, up_p,
        aux={"up_old": up_old_f},
        params={"t": jnp.asarray(t)},
        max_iters=10,
        linear_method=args.solv,
        linear_pc=args.pc,
        lattice_shape=lattice_shape if args.pc == 'mg' else None,
        n_fields=3,
        bfr_tol=args.bfr,
        zero_ids=zero_ids,
        monitor_newton=True,
        monitor_linear=False,
        relative_tolerance=5e-4,
        relax_param=1.0,
        absolute_tolerance=1e-4,
        absolute_tolerance_res=1e-5,
        line_search=args.line_search,
        ptc_sigma0=args.ptc,
    )                                          # tg_vortex.py:332-338
    up_old_f = up_f
    t += 0.5 * Dt
    if series is not None and (step + 1) % int(args.wv_every) == 0:
        _write_fields(t, up_f)
    if args.ckpt and (step + 1) % int(args.ckpt_every) == 0:
        save_checkpoint(args.ckpt, step + 1,
                        {"up_p": up_p, "up_old_f": up_old_f},
                        meta={"t": t})

norms = prob.error_norms(up_f, t)

if write_file:
    with open(args.of, 'a') as f:  # schema: tg_vortex.py:362-365
        f.write("\n")
        f.write(f"{ref},{norms['L2u']},{norms['H1u']},{norms['L2p']},"
                f"{norms['H1p']},{k},{fileName},{Re_num},{N_STEPS}")

log_info('-' * 40)
log_info(f"L2 velocity error: {norms['L2u']}")
log_info(f"H1 velocity error: {norms['H1u']}")
log_info(f"L2 pressure error: {norms['L2p']}")
log_info(f"L2 pressure error (mean-removed): {norms['L2p0']}")
log_info(f"H1 pressure error: {norms['H1p']}")
log_info('-' * 40)
