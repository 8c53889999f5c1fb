"""2D Poisson with a background-unfitted mesh: M is built at runtime by
Lagrange interpolation (the PETScDMCollection.create_transfer_matrix role) —
parity with reference demos/background_unfitted/poisson_unfitted.py.

    python3 demos/background_unfitted/poisson_unfitted.py --k 1 --ref 3
"""
import argparse
import os
import sys

sys.path.insert(
    0,
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
)

import numpy as np
import jax
import jax.numpy as jnp

from iifea.api import average_cell_diagonal
from iifea.mesh.core import FunctionSpace, Mesh
from iifea.mesh.generators import generate_unfitted_mesh, transfer_matrix_simplex
from iifea.models.poisson import source_fn, u_exact_fn
from iifea.ops.assembly import Form, Term, build_cell_domain, build_facet_domain, integrate
from iifea.ops.projection import assemble_background_system
from iifea.solvers import solve_ksp
from iifea.utils.logging import log_info


def str2bool(v):
    return str(v) not in ("False", "false", "0")


parser = argparse.ArgumentParser()
parser.add_argument('--n', dest='n', default=16,
                    help='Number of elements in each direction.')
parser.add_argument('--ref', dest='ref', default=-1, help='Refinement level.')
parser.add_argument('--k', dest='k', default=1, help='Polynomial degree.')
parser.add_argument('--sym', dest='symmetric', default=True,
                    help='True for symmetric Nitsche; False for nonsymmetric')
parser.add_argument('--of', dest='of', default='error_data_NC_Poisson.csv',
                    help='output file to write error data to')
args = parser.parse_args()

ref = float(args.ref)
Nel = int(4 * 2**ref) if ref > -1 else int(args.n)
k = int(args.k)

L_f, L_b = 2.0, 4.0
mesh_f, mesh_b = generate_unfitted_mesh(L_f, L_b, Nel, Nel, dim=2,
                                        rotate_f=True)
# whole foreground is the domain; its true boundary carries the Nitsche terms
mesh_f = Mesh(mesh_f.coords, mesh_f.cells,
              np.full(mesh_f.n_cells, 2, np.int32))

V_f = FunctionSpace(mesh_f, degree=k)
u_ex = u_exact_fn(2)
f_fn = source_fn(u_ex)
beta = 8.0                        # poisson_unfitted.py:135-137
symmetric = False
sgn = 1.0 if symmetric else -1.0

qd = 2 * k                        # dx(metadata 2k), poisson_unfitted.py:132
cell_dom = build_cell_domain(V_f, np.arange(mesh_f.n_cells), qd)
fd = mesh_f.facet_data
bdry = np.where(fd.facet_cells[:, 1] < 0)[0]
bdry_dom = build_facet_domain(V_f, bdry, qd)


def cell_kern(u_loc, aux_loc, ctx, params):
    gu = jnp.einsum("qbd,b->qd", ctx.gphi, u_loc[:, 0])
    fx = jax.vmap(f_fn)(ctx.x)
    r = jnp.einsum("q,qd,qbd->b", ctx.w, gu, ctx.gphi)
    return (r - jnp.einsum("q,q,qb->b", ctx.w, fx, ctx.phi))[:, None]


def bdry_kern(u_loc, aux_loc, ctx, params):
    # interior_A/boundary_A/L over the true 'ds' (poisson_unfitted.py:37-84)
    U = u_loc[:, 0]
    uq = jnp.einsum("qb,b->q", ctx.phi, U)
    gun = jnp.einsum("qbd,b,d->q", ctx.gphi, U, ctx.n)
    gq = jax.vmap(u_ex)(ctx.x)
    gphin = jnp.einsum("qbd,d->qb", ctx.gphi, ctx.n)
    r = -jnp.einsum("q,q,qb->b", ctx.w, gun, ctx.phi)
    r = r + sgn * jnp.einsum("q,q,qb->b", ctx.w, gq - uq, gphin)
    if symmetric:
        r = r + (beta / ctx.h) * jnp.einsum("q,q,qb->b", ctx.w, uq - gq, ctx.phi)
    return r[:, None]


form = Form(V_f, [Term(cell_dom, cell_kern), Term(bdry_dom, bdry_kern)])

# runtime transfer matrix V_b -> V_f (poisson_unfitted.py:134)
M = transfer_matrix_simplex(mesh_b, np.asarray(V_f.node_coords), degree=k)

u0 = jnp.zeros(V_f.n_dofs)
dR_b, R_b = assemble_background_system(form, u0, M)
u_p, _ = solve_ksp(dR_b, R_b, method='direct', monitor=True)  # :158
u_f = M.mv(u_p)


def err_sq(u_loc, aux_loc, ctx, params):
    e = jnp.einsum("qb,b->q", ctx.phi, u_loc[:, 0]) - jax.vmap(u_ex)(ctx.x)
    return jnp.einsum("q,q->", ctx.w, e**2)


def gerr_sq(u_loc, aux_loc, ctx, params):
    ge = jnp.einsum("qbd,b->qd", ctx.gphi, u_loc[:, 0]) - jax.vmap(
        jax.grad(u_ex))(ctx.x)
    return jnp.einsum("q,qd->", ctx.w, ge**2)


def edge_sq(u_loc, aux_loc, ctx, params):
    e = jnp.einsum("qb,b->q", ctx.phi, u_loc[:, 0]) - jax.vmap(u_ex)(ctx.x)
    return jnp.einsum("q,q->", ctx.w, e**2) / ctx.h


norm_L2 = float(integrate(cell_dom, err_sq, u_f))
norm_H10 = float(integrate(cell_dom, gerr_sq, u_f))
norm_edge = float(integrate(bdry_dom, edge_sq, u_f))
norm_H1 = (norm_L2 + norm_H10 + norm_edge) ** 0.5
norm_L2 = norm_L2**0.5

Nitsche_type = ('Symmetric' if symmetric else 'Nonymmetric') + ' Nitsche Method'
log_info('-' * 40)
log_info('-' * 5 + f" {Nitsche_type} " + '-' * 5)
log_info('-' * 40)
log_info("Average mesh size of the foreground mesh = "
         + str(average_cell_diagonal(mesh_f)))
log_info(f"L2 norm: {norm_L2}")
log_info(f"H1 norm: {norm_H1}")
log_info(f"Nel: {Nel}")
log_info('-' * 40)
