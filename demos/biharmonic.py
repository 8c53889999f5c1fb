"""2D/3D biharmonic with Nitsche BCs — parity with reference demos/biharmonic.py
(same flags, same printed report, same CSV schema).

    python3 demos/biharmonic.py --ref 3 --dim 2
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp

from iifea.mesh.io import read_mesh
from iifea.models.biharmonic import BiharmonicProblem
from iifea.ops.extraction import ExtractionOperator
from iifea.ops.projection import assemble_background_system
from iifea.solvers import solve_ksp, solve_newtons_linear
from iifea.utils.logging import log_info


def str2bool(v):
    return str(v) not in ("False", "false", "0")


parser = argparse.ArgumentParser()
parser.add_argument('--dim', dest='dimension', default=2,
                    help='Problem dimension (2 or 3).')
parser.add_argument('--ref', dest='ref', default='3',
                    help='Refinement level, (0,6) 2D, (0,4) 3D')
parser.add_argument('--sym', dest='symmetric', default=False,
                    help='True for symmetric Nitsche; False for nonsymmetric')
parser.add_argument('--solv', dest='solv', default='gmres',
                    help='Linear solver')
parser.add_argument('--pc', dest='pc', default='jacobi',
                    help='Preconditioner for linear solver')
parser.add_argument('--wf', dest='wf', default=False,
                    help='write output data to file')
parser.add_argument('--of', dest='of', default='biharmonic_error.csv',
                    help='output data file')
parser.add_argument('--b', dest='beta_val', default=5, help='Beta penalty')
parser.add_argument('--a', dest='alpha_val', default=5, help='alpha penalty')
parser.add_argument('--ft', dest='ft', default=1e-5,
                    help='cell volume filtering tolerance')
parser.add_argument('--snap', dest='snap', default=False,
                    help="synthetic 2D only: snap the staircase cut onto "
                         "the exact rotated square (restores the L2 "
                         "duality rate the staircase corners destroy)")
parser.add_argument('--mms', dest='mms', default='reference',
                    choices=('reference', 'steep'),
                    help="manufactured solution: 'reference' is the "
                         "reference's own cos(0.05 pi x + 0.1)... "
                         "(biharmonic.py:39 — nearly flat: relative errors "
                         "start ~1e-5, at the level of secondary floors, so "
                         "convergence rates cannot show); 'steep' uses the "
                         "reference's 3D-style wavelength-2 cosines in any "
                         "dimension, exercising the actual asymptotic rate")
parser.add_argument('--mesh-root', dest='mesh_root',
                    default=os.environ.get("IIFEA_MESH_ROOT",
                                           "/root/reference/meshes"),
                    help="Reference mesh artifacts root, or 'synthetic' for "
                         "a generated immersed square on a quadratic "
                         "B-spline lattice background — there the 4th-order "
                         "solve runs ON DEVICE via the radius-3 stencil "
                         "probe + geometric multigrid (gmres+mg) by "
                         "default. Reference-CSV artifacts keep host LU: "
                         "their bg ids are a trimmed subset of an unknown "
                         "lattice.")
args = parser.parse_args()

dim = int(args.dimension)
ref = args.ref
symmetric = str2bool(args.symmetric)
write_file = str2bool(args.wf)
ft = float(args.ft)

u_exact = None
if args.mms == 'steep':
    import jax.numpy as _jnp

    def u_exact(x):
        out = _jnp.cos(_jnp.pi * x[0] + 0.5)
        for d in range(1, dim):
            out = out * _jnp.cos(_jnp.pi * x[d] + 0.5)
        return out

lattice_shape = None
if args.mesh_root == "synthetic":
    # synthetic immersed square on a quadratic B-spline lattice: the
    # product path is the on-device iterative solve (SURVEY N5) — radius-3
    # stencil probe (quadratic splines couple control points 3 apart
    # across straddling fg cells) + MG-preconditioned GMRES.
    if dim == 3:
        from iifea.mesh.generators import immersed_cube_bspline_problem

        # NESTED grids (n_fg = 2*n_bg) for the same reason as the 2D branch
        # below — straddling fg cells break P2 extraction across the
        # spline's C1 knot planes (O(h) H2 crime, rates cap at ~1).
        n_bg = 2 ** (int(ref) + 3) - 1
        mesh_f, M, lattice_shape = immersed_cube_bspline_problem(
            n_fg=2 * n_bg, n_bg=n_bg
        )
    else:
        from iifea.mesh.generators import immersed_square_bspline_problem

        # NESTED grids (n_fg = 2*n_bg, fg lines contain every bg knot): each
        # fg cell sees ONE polynomial piece of the quadratic spline, so the
        # P2 interpolation-based extraction reproduces the background space
        # exactly. Straddling grids (2*(n_bg+1)) inject an O(h) H2 /
        # O(h^2) L2 interpolation crime along knot lines that caps the
        # observed rates at ~1 (diagnosed round 3; the reference's MORIS
        # artifacts are nested by construction).
        n_bg = 2 ** (int(ref) + 4) - 1
        mesh_f, M, lattice_shape = immersed_square_bspline_problem(
            n_fg=2 * n_bg, n_bg=n_bg, snap_boundary=str2bool(args.snap)
        )
    prob = BiharmonicProblem(
        mesh_f, sym=symmetric, beta_value=float(args.beta_val),
        alpha_value=float(args.alpha_val), filter_tol=ft,
        u_exact=u_exact,
    )
else:
    sub = 'square' if dim == 2 else 'cube'
    path = os.path.join(args.mesh_root, sub, f"Quadratic/R{ref}")
    mesh_f = read_mesh(path)
    dim = mesh_f.dim

    prob = BiharmonicProblem(
        mesh_f, sym=symmetric, beta_value=float(args.beta_val),
        alpha_value=float(args.alpha_val), filter_tol=ft,
        u_exact=u_exact,
    )

    M = ExtractionOperator.from_exop_csv(
        os.path.join(path, "ExOp_Cons.csv"), prob.space.n_nodes
    )

u0 = jnp.zeros(prob.space.n_dofs)
dR_b, R_b = assemble_background_system(prob.form, u0, M)

if lattice_shape is not None:
    solv = 'gmres' if args.solv in ('gmres', 'direct', 'mumps') else args.solv
    u_p, _ = solve_ksp(dR_b, R_b, method=solv, pc='mg', rtol=1e-10,
                       lattice_shape=lattice_shape, stencil_radius=3,
                       monitor=True)
    u_f = M.mv(u_p)
elif dim == 3:
    # defect-correction Newton against finite-precision blowup
    # (biharmonic.py:230-231)
    u_p, u_f = solve_newtons_linear(
        prob.form, u0, M, jnp.zeros(M.n_bg_dofs), max_iters=20,
        relative_tolerance=1e-12, linear_method='direct',
    )
else:
    u_p, _ = solve_ksp(dR_b, R_b, method='direct', monitor=True)  # :233-236
    u_f = M.mv(u_p)
norms = prob.error_norms(u_f)

if write_file:
    with open(args.of, 'a') as f:  # schema: biharmonic.py:288-292
        f.write("\n")
        f.write(f"{ref},{norms['L2_rel']},{norms['H1_rel']},"
                f"{norms['H2_rel']},{args.alpha_val},{args.beta_val}")

log_info('-' * 40)
log_info(f"L2 norm: {norms['L2']}")
log_info(f"H1 norm: {norms['H1']}")
log_info(f"H2 norm: {norms['H2']}")
log_info(f"relative L2 norm: {norms['L2_rel']}")
log_info(f"relative H1 norm: {norms['H1_rel']}")
log_info(f"relative H2 norm: {norms['H2_rel']}")
log_info('-' * 40)
