"""2D/3D Poisson on an unfitted mesh with Nitsche BCs — demo parity with
reference demos/poisson.py (same flags, same printed report, same CSV schema).

    python3 demos/poisson.py --k 1 --ref 3 --dim 2

Multi-device execution replaces mpirun: pass --devices N (or run under a JAX
multi-host setup); sharding is handled by iifea.parallel, not MPI ranks.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp

from iifea.mesh.io import read_mesh
from iifea.mesh.generators import immersed_square_problem
from iifea.models.poisson import PoissonProblem
from iifea.ops.extraction import ExtractionOperator
from iifea.ops.projection import assemble_background_system
from iifea.solvers import solve_ksp
from iifea.utils.logging import log_info


def str2bool(v):
    return str(v) not in ("False", "false", "0")


parser = argparse.ArgumentParser()
parser.add_argument('--k', dest='k', default=1,
                    help='Polynomial degree (1 or 2).')
parser.add_argument('--dim', dest='dimension', default=2,
                    help='Problem dimension (2 or 3).')
parser.add_argument('--ref', dest='ref', default='0',
                    help='Refinement level, integers in (0,6) for 2D, (0,4) for 3D')
parser.add_argument('--sym', dest='symmetric', default=True,
                    help='True for symmetric Nitsche; False for nonsymmetric')
parser.add_argument('--solv', dest='solv', default='gmres',
                    help='Linear solver')
parser.add_argument('--pc', dest='pc', default='jacobi',
                    help='Preconditioner for linear solver')
parser.add_argument('--wf', dest='wf', default=False,
                    help='write output data to file')
parser.add_argument('--of', dest='of', default='poisson_data.csv',
                    help='Destination for output data')
parser.add_argument('--wv', dest='wv', default=False,
                    help='write solution/exact fields to a VTU file for '
                         'ParaView (XDMFFile role, poisson.py:256-261)')
parser.add_argument('--ov', dest='ov', default='poisson_fields.vtu',
                    help='VTU output path for --wv')
parser.add_argument('--beta', dest='beta', default='10.0',
                    help='Nitsche penalty (reference poisson.py:194 uses 10), '
                         'or "auto": smallest coercive beta (doubling from '
                         '10, positive-definiteness checked on the projected '
                         'operator) — removes the 3D R2 marginal-coercivity '
                         'H10 dip instead of footnoting it (RESULTS.md)')
parser.add_argument('--Ex', dest='Ex', default=True,
                    help='Option to solve on the FG mesh (False: identity M)')
parser.add_argument('--devices', dest='devices', default=1, type=int,
                    help='Solve SPMD over N devices (the mpirun analog): '
                         'fused-extraction sharded assembly + CG '
                         '(iifea.parallel.sharding). For a virtual mesh: '
                         'XLA_FLAGS=--xla_force_host_platform_device_count=N '
                         'JAX_PLATFORMS=cpu')
parser.add_argument('--mesh-root', dest='mesh_root',
                    default=os.environ.get("IIFEA_MESH_ROOT",
                                           "/root/reference/meshes"),
                    help='Root directory with the reference mesh artifacts; '
                         'use "synthetic" for generated immersed meshes')
args = parser.parse_args()

k = int(args.k)
dim = int(args.dimension)
Ex = str2bool(args.Ex)
symmetric = str2bool(args.symmetric)
ref = args.ref
write_file = str2bool(args.wf)
output_file = args.of
LINEAR_SOLVER = args.solv
PRECONDITIONER = args.pc

if args.mesh_root == "synthetic":
    # native immersed-pair generator: covers refinement levels whose
    # MORIS artifacts are stripped from the reference checkout (e.g. the
    # finer 3D cubes), and any scale beyond them
    if dim == 3:
        from iifea.mesh.generators import immersed_cube_problem
        n = 6 * 2 ** int(ref)
        mesh_f, M_synth = immersed_cube_problem(
            n_fg=int(n * 1.19), n_bg=n
        )
        if k != 1:
            raise SystemExit("synthetic 3D meshes are linear (k=1)")
    else:
        n = 8 * 2 ** int(ref)
        mesh_f, M_synth = immersed_square_problem(n_fg=n, n_bg=max(n // 2, 4),
                                                  degree=k)
else:
    sub = 'square' if dim == 2 else 'cube'
    deg = 'Linear' if k == 1 else 'Quadratic'
    path = os.path.join(args.mesh_root, sub, deg, f"R{ref}")
    mesh_f = read_mesh(path)
    M_synth = None

beta_auto = str(args.beta).lower() == 'auto'
beta_val = 10.0 if beta_auto else float(args.beta)
prob = PoissonProblem(mesh_f, k=k, sym=symmetric, beta_value=beta_val)

if not Ex:
    M = ExtractionOperator.identity(prob.space.n_nodes)   # poisson.py:178-181
elif M_synth is not None:
    M = M_synth
else:
    M = ExtractionOperator.from_exop_csv(
        os.path.join(path, "ExOp_Cons.csv"), prob.space.n_nodes
    )

if beta_auto:
    if not symmetric:
        log_info('[poisson] --beta auto: nonsymmetric Nitsche is '
                 'penalty-free; keeping beta unused')
    else:
        from iifea.models.poisson import select_coercive_beta

        beta_sel, prob = select_coercive_beta(mesh_f, M, k=k, beta0=10.0)
        log_info(f'[poisson] auto-selected Nitsche beta = {beta_sel} '
                 '(smallest coercive in 10*2^j)')

if args.devices > 1:
    # SPMD path (the mpirun analog): extraction fused into the element
    # gather, one psum per apply, replicated background vector — see
    # iifea/parallel/sharding.py. Symmetric Nitsche is SPD => CG.
    import jax
    from iifea.parallel.sharding import (
        ShardedProjectedSystem, make_device_mesh,
    )

    if len(jax.devices()) < args.devices:
        raise SystemExit(
            f"--devices {args.devices}: only {len(jax.devices())} devices "
            "visible. Provision a virtual mesh, e.g.\n"
            "  XLA_FLAGS=--xla_force_host_platform_device_count="
            f"{args.devices} JAX_PLATFORMS=cpu python demos/poisson.py ..."
        )
    sys_sh = ShardedProjectedSystem(prob.form, M, make_device_mesh(args.devices))
    step = jax.jit(sys_sh.make_step(rtol=1e-8, atol=1e-9, max_it=100000))
    log_info(f"[poisson] SPMD solve over {args.devices} devices")
    u_p, _resnorm = step(jnp.zeros(M.n_bg_dofs))
else:
    u_f0 = jnp.zeros(prob.space.n_dofs)
    dR_b, R_b = assemble_background_system(prob.form, u_f0, M)  # J du = -res

    if dim == 3:
        # reference uses a direct solver for 3D conditioning
        # (poisson.py:207-210)
        LINEAR_SOLVER = 'direct'
    u_p, _ = solve_ksp(dR_b, R_b, method=LINEAR_SOLVER, pc=PRECONDITIONER,
                       bfr_tol=1e-9 if not Ex else None)

u_f = M.mv(u_p)
norms = prob.error_norms(u_f)

Nitsche_type = 'Symmetric Nitsche Method' if symmetric \
    else 'Nonsymmetric Nitsche Method'

if write_file:
    with open(output_file, 'a') as f:  # schema parity: poisson.py:241-247
        f.write("\n")
        f.write(f"{ref},{norms['H10']},{norms['L2']},{k}")

if str2bool(args.wv):
    import numpy as np

    from iifea.utils.fieldio import write_vtu

    import jax

    u_ex = np.asarray(jax.vmap(prob.u_ex)(
        jnp.asarray(prob.space.node_coords)
    ))
    write_vtu(
        args.ov, prob.space,
        point_data={"u": np.asarray(u_f), "u_exact": u_ex,
                    "error": np.asarray(u_f) - u_ex},
        cell_data={"material": mesh_f.material},
    )
    log_info(f"wrote fields to {args.ov}")

log_info('-' * 40)
log_info('-' * 5 + f" {Nitsche_type} " + '-' * 5)
log_info('-' * 40)
log_info(f"L2 norm: {norms['L2']}")
log_info(f"H10 norm: {norms['H10']}")
log_info(f"H1 norm: {norms['H1']}")
log_info('-' * 40)
