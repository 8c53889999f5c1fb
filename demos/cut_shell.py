"""Kirchhoff-Love shell: cut 'bent tab' geometry under a uniform follower
pressure, 100 load steps — parity with reference demos/cut_shell.py
(same flags plus --steps for shortened runs; same tracker-point CSVs).

    python3 demos/cut_shell.py --ref 5
"""
import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

from iifea.mesh.io import read_mesh
from iifea.models.kl_shell import KLShellProblem
from iifea.ops.extraction import ExtractionOperator
from iifea.solvers import solve_nonlinear
from iifea.utils.logging import log_info


def str2bool(v):
    return str(v) not in ("False", "false", "0")


parser = argparse.ArgumentParser()
parser.add_argument('--ref', dest='ref', default='3',
                    help='Refinement level, integers in (3,6)')
parser.add_argument('--lref', dest='lref', default='0',
                    help='Local refinement level, integers in (0,2)')
parser.add_argument('--of', dest='of', default='False',
                    help='Output result files')
parser.add_argument('--steps', dest='steps', default=100,
                    help='Number of load steps (reference: 100)')
parser.add_argument('--ckpt', dest='ckpt', default=None,
                    help='Checkpoint directory: resume from latest, save '
                         'every --ckpt-every load steps')
parser.add_argument('--ckpt-every', dest='ckpt_every', default=10,
                    help='Checkpoint interval in load steps')
parser.add_argument('--wv', dest='wv', default=False,
                    help='write a ParaView displacement series '
                         '(bent_shell_results/disp.pvd) on the mapped '
                         'midsurface, one snapshot per load step '
                         '(File("...pvd") role, cut_shell.py:342-349)')
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
lref = args.lref
generate_files = str2bool(args.of)
N_STEPS = int(args.steps)

path = os.path.join(args.mesh_root, f"bent_tab/FG_R{lref}/R{ref}")
mesh_f = read_mesh(path)


def bent_tab_surface(xi):
    # parabolic initial geometry F = [ξ0, ξ1, ½(1−ξ0²)] (cut_shell.py:178)
    return jnp.array([xi[0], xi[1], 0.5 * (1.0 - xi[0] ** 2)])


prob = KLShellProblem(
    mesh_f, bent_tab_surface,
    E=3e4, nu=0.3, h_th=0.03,                     # cut_shell.py:263-267
    pressure=2.0,                                  # :293
    pin_alpha=1e5, pin_mode="boundary",            # :290, :312
    pin_alpha_scale="hmin", use_jvol=True,
)

M = ExtractionOperator.from_exop_csv(
    os.path.join(path, "ExOp_Cons.csv"), prob.space.n_nodes, n_fields=3
)

# tracker points (cut_shell.py:124-127)
circle_tip = [0.0, -0.25]
corner_top_y = -math.sqrt(0.5**2 - 0.2**2)
wing_top_corner = [-0.2, corner_top_y]
wing_bottom_corner = [-0.2, -1.0]

T_MAX = 1.0
DELTA_T = T_MAX / float(N_STEPS)
t = 0.0

u_p = jnp.zeros(M.n_bg_dofs)
u_f = jnp.zeros(prob.space.n_dofs)
tip_hist = np.zeros((N_STEPS, 3))
top_hist = np.zeros((N_STEPS, 3))
bot_hist = np.zeros((N_STEPS, 3))

start_step = 0
if args.ckpt:
    from iifea.utils.checkpoint import load_checkpoint, save_checkpoint

    resumed = load_checkpoint(args.ckpt)
    if resumed is not None:
        start_step, state, meta = resumed
        u_p, u_f = state["u_p"], state["u_f"]
        ns = min(start_step, N_STEPS)
        tip_hist[:ns] = np.asarray(state["tip_hist"])[:ns]
        top_hist[:ns] = np.asarray(state["top_hist"])[:ns]
        bot_hist[:ns] = np.asarray(state["bot_hist"])[:ns]
        t = float(meta["t"])
        log_info(f">>> Resumed from {args.ckpt} at load step {start_step}, "
                 f"t = {t}")

series = None
if str2bool(args.wv):
    import jax

    from iifea.utils.fieldio import PVDSeries

    series = PVDSeries("bent_shell_results/disp.pvd")
    # mapped 3D midsurface as the viz geometry (the parametric mesh is 2D)
    surf_pts = np.asarray(jax.vmap(bent_tab_surface)(
        jnp.asarray(prob.space.node_coords)
    ))

log_info(">>> Solving load steps...")
for i in range(start_step, N_STEPS):
    log_info(f"------- Step: {i+1} , t = {t} -------")
    u_p, u_f = solve_nonlinear(
        prob.form, u_f, M, u_p,
        params={"t": jnp.asarray(t)},
        max_iters=100, linear_method='direct',
        monitor_newton=False,
        line_search=args.line_search, ptc_sigma0=args.ptc,
    )                                              # cut_shell.py:372-374
    t += DELTA_T
    tip_hist[i] = prob.evaluate(u_f, [circle_tip])[0]
    top_hist[i] = prob.evaluate(u_f, [wing_top_corner])[0]
    bot_hist[i] = prob.evaluate(u_f, [wing_bottom_corner])[0]
    if series is not None:
        series.write(t, prob.space, point_data={"disp": np.asarray(u_f)},
                     cell_data={"material": mesh_f.material},
                     points=surf_pts)
    if args.ckpt and (i + 1) % int(args.ckpt_every) == 0:
        save_checkpoint(args.ckpt, i + 1,
                        {"u_p": u_p, "u_f": u_f, "tip_hist": tip_hist,
                         "top_hist": top_hist, "bot_hist": bot_hist},
                        meta={"t": t})

if generate_files:
    os.makedirs("bent_shell_results", exist_ok=True)
    for name, hist in (("circle_tip", tip_hist),
                       ("wing_top_corner", top_hist),
                       ("wing_bottom_corner", bot_hist)):
        np.savetxt(
            f"bent_shell_results/{name}.csv", hist, delimiter=",",
            header="d0,d1,d2", comments="",
        )  # cut_shell.py:403-405

u_x, u_y, u_z = tip_hist[-1]
log_info(f"Displacement at tip of tab: ( {u_x} , {u_y} , {u_z} )")
