#!/usr/bin/env python3
"""Host-side audit of the 3D BinnedLatticeSolver's persistent device arrays:
prints every table's shape/dtype/GB so device OOMs can be attributed without
a device compile. Run with JAX_PLATFORMS=cpu."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

n_bg = int(sys.argv[1]) if len(sys.argv) > 1 else 100

import jax
from bench import build_problem
from iifea.solvers.lattice_fast import BinnedLatticeSolver

mesh_f, prob64, M64 = build_problem(n_bg, np.float64, 3)
print(f"cells={mesh_f.n_cells} fg_dofs={prob64.space.n_dofs} "
      f"bg_dofs={M64.n_bg_dofs}", flush=True)
solver = BinnedLatticeSolver(prob64, M64, (n_bg + 1,) * 3)

tot = 0.0


def rep(name, tree):
    global tot
    leaves = jax.tree_util.tree_leaves(tree)
    nb = sum(getattr(l, "nbytes", 0) for l in leaves)
    tot += nb
    shapes = [
        f"{getattr(l, 'shape', '?')}:{getattr(l, 'dtype', '?')}"
        for l in leaves if hasattr(l, "shape")
    ]
    print(f"{name:>18}: {nb / 1e9:7.3f} GB  {shapes[:6]}", flush=True)


for i, red in enumerate(solver.reducers):
    print(f"reducer[{i}] meta={red.meta} bbox={red.bbox}")
    perm = np.asarray(red.perm)          # (L, nc), 0 = padding
    occ = (perm != 0).sum(axis=0)
    used = occ[occ > 0]
    print(f"  occupancy: cells_used={used.size}/{occ.size} "
          f"({used.size / occ.size:.1%}) mean={used.mean():.2f} "
          f"p50={np.percentile(used, 50):.0f} "
          f"p99={np.percentile(used, 99):.0f} max={used.max()}")
    rep(f"red{i}.val_b", red.val_b)
    rep(f"red{i}.kappa", red.kappa)
    rep(f"red{i}.perm", red.perm)
    rep(f"red{i}.val_lo", red.val_lo)
    if red.spill is not None:
        print(f"  spill meta={red.spill.meta}")
        rep(f"red{i}.spill", red.spill)
rep("rhs_tables", solver.rhs_tables)
rep("JinvT_b", solver.JinvT_b)
rep("wdetT_b", solver.wdetT_b)
rep("facet_dom", solver.prob.facet_dom)
rep("cell_dom", solver.prob.cell_dom)
print(f"persistent total: {tot / 1e9:.3f} GB")

live = sorted(jax.live_arrays(), key=lambda a: -a.nbytes)
ltot = sum(a.nbytes for a in live)
print(f"\nALL live device arrays: {ltot / 1e9:.3f} GB in {len(live)}")
for a in live[:20]:
    print(f"  {a.nbytes / 1e9:7.3f} GB  {a.shape}:{a.dtype}")

# derived per-stage live estimates
red = solver.reducers[0]
ne, km, L, nc = red.meta
w = red.w
print(f"\nstage estimates (ne={ne} km={km} L={L} nc={nc} w={w}):")
kb = ne * ne * L * nc * 4 / 1e9
print(f"  bound K hi+lo: {2 * kb:.3f} GB")
print(f"  G (nc,w,w) f32: {nc * w * w * 4 / 1e9:.3f} GB")
print(f"  stencil planes (125,shape): "
      f"{125 * np.prod([n_bg + 1] * 3) * 4 / 1e9:.3f} GB")
print(f"  apply_df xe/ye 2*2*(ne,L,nc): "
      f"{2 * 2 * ne * L * nc * 4 / 1e9:.3f} GB")
