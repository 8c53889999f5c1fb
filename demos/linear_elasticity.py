"""2D linear elasticity of a plate with a hole (Kirsch problem) — parity with
reference demos/linear_elasticity.py (same flags, same printed report,
same CSV schema ref,norm,t_solve,t_extract).

    python3 demos/linear_elasticity.py --k 2 --ref 3 --lref 1
"""
import argparse
import os
import sys
from timeit import default_timer

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

from iifea.mesh.core import Mesh
from iifea.mesh.io import read_mesh
from iifea.models.elasticity import ElasticityProblem
from iifea.ops.extraction import ExtractionOperator
from iifea.ops.projection import assemble_background_system
from iifea.solvers import solve_ksp
from iifea.utils.logging import log_info


def str2bool(v):
    return str(v) not in ("False", "false", "0")


parser = argparse.ArgumentParser()
parser.add_argument('--k', dest='k', default=1, help='Polynomial degree.')
parser.add_argument('--ref', dest='ref', default='0',
                    help='Refinement level, integers in (0,6)')
parser.add_argument('--lref', dest='lref', default='0',
                    help='Local refinement level, (0,2), only for k=2')
parser.add_argument('--sym', dest='symmetric', default=True,
                    help='True for symmetric Nitsche; False for nonsymmetric')
parser.add_argument('--solv', dest='solv', default='mumps',
                    help='Linear solver')
parser.add_argument('--pc', dest='pc', default=None,
                    help='Preconditioner for linear solver')
parser.add_argument('--wf', dest='wf', default=False,
                    help='write output data to file')
parser.add_argument('--E', dest='E', default=200e9, help='Youngs Modulus')
parser.add_argument('--nu', dest='nu', default=0.3, help='Poissons ratio')
parser.add_argument('--of', dest='of', default='error_data.csv',
                    help='Destination for output data')
parser.add_argument('--mesh-root', dest='mesh_root',
                    default=os.environ.get("IIFEA_MESH_ROOT",
                                           "/root/reference/meshes"),
                    help="Reference mesh artifacts root, or 'synthetic' for "
                         "a generated immersed square on a lattice "
                         "background — there the solve runs ON DEVICE via "
                         "block geometric multigrid (cg+mg) by default. "
                         "Reference-CSV artifacts keep host LU: their "
                         "ExOp bg ids are a trimmed subset of an unknown "
                         "lattice, so the stencil probe has no grid to "
                         "probe on.")
args = parser.parse_args()

k = int(args.k)
ref = args.ref
lref = args.lref
symmetric = str2bool(args.symmetric)
write_file = str2bool(args.wf)
E = float(args.E)
nu = float(args.nu)

if args.mesh_root == "synthetic":
    # synthetic immersed square with a KNOWN lattice background: the
    # product path here is the on-device iterative solve (SURVEY N5 —
    # "the product path is iterative"): block stencil probe + geometric
    # multigrid V-cycle preconditioned CG, all on device.
    from iifea.mesh.generators import immersed_square_problem
    from iifea.models.elasticity import ImmersedElasticityProblem

    n = 8 * 2 ** int(ref)
    n_bg = max(n // 2, 4)
    mesh_f, M_synth = immersed_square_problem(
        n_fg=n, n_bg=n_bg, degree=k, n_fields=2
    )
    prob = ImmersedElasticityProblem(mesh_f, k=k, sym=symmetric)
    solv = 'cg' if args.solv == 'mumps' else args.solv
    pc = 'mg' if args.pc is None else args.pc

    u0 = jnp.zeros(prob.space.n_dofs)
    dR_b, R_b = assemble_background_system(prob.form, u0, M_synth)
    start = default_timer()
    u_p, _ = solve_ksp(dR_b, R_b, method=solv, pc=pc, rtol=1e-10,
                       lattice_shape=(n_bg + 1, n_bg + 1), n_fields=2,
                       monitor=True)
    t_solve = default_timer() - start
    norms = prob.error_norms(M_synth.mv(u_p))

    if write_file:
        with open(args.of, 'a') as f:
            f.write("\n")
            f.write(f"{ref},{norms['L2']},{norms['H10']},{t_solve},synthetic")
    log_info('-' * 40)
    log_info(f"Synthetic immersed elasticity (n_fg={n}, n_bg={n_bg}, "
             f"solv={solv}, pc={pc})")
    log_info(f"Time for solve_linear: {t_solve}")
    log_info(f"relative L2 norm: {norms['L2']}")
    log_info(f"relative H10 norm: {norms['H10']}")
    log_info('-' * 40)
    sys.exit(0)

root = os.path.join(args.mesh_root, "hole_in_plate")
if k == 1:
    path = os.path.join(root, f"Linear/R{ref}")
elif k == 2:
    path = os.path.join(root, f"Quadratic/FG_R{lref}/R{ref}")
else:
    log_info('Only linear and quadratic basis functions are currently supported')
    sys.exit(1)

mesh_f = read_mesh(path)
if k == 2:
    # hole/plate ids are flipped in the quadratic meshes
    # (linear_elasticity.py:148-157)
    flipped = np.where(
        mesh_f.material == 1, 2, np.where(mesh_f.material == 2, 1,
                                          mesh_f.material)
    )
    mesh_f = Mesh(mesh_f.coords, mesh_f.cells, flipped, mesh_f.cell_nodes)

prob = ElasticityProblem(mesh_f, k=k, E=E, nu=nu, sym=symmetric)

start = default_timer()
M = ExtractionOperator.from_exop_csv(
    os.path.join(path, "ExOp_Cons.csv"), prob.space.n_nodes, n_fields=2
)
t_extract = default_timer() - start

u0 = jnp.zeros(prob.space.n_dofs)
dR_b, R_b = assemble_background_system(prob.form, u0, M)

start = default_timer()
u_p, _ = solve_ksp(dR_b, R_b, method=args.solv, pc=args.pc, monitor=True)
t_solve = default_timer() - start

u_f = M.mv(u_p)
norm = prob.stress_error_norm(u_f)

Nitsche_type = 'Symmetric Nitsche Method' if symmetric \
    else 'Nonsymmetric Nitsche Method'

if write_file:
    with open(args.of, 'a') as f:  # schema: linear_elasticity.py:354-357
        f.write("\n")
        f.write(f"{ref},{norm},{t_solve},{t_extract}")

log_info('-' * 40)
log_info('-' * 5 + f" {Nitsche_type} " + '-' * 5)
log_info('-' * 40)
log_info(f"Time for creating M: {t_extract}")
log_info(f"Time for solve_linear: {t_solve}")
log_info(f"Extraction error norm: {norm}")
log_info('-' * 40)
