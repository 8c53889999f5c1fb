"""iifea — interpolation-based immersed finite element analysis on accelerators.

A from-scratch JAX/XLA framework with the capabilities of
``jefromm/interpolation-based-immersed-fea`` (FEniCS + PETSc + MUMPS), redesigned
for data-parallel accelerators:

* PDEs are discretized with FEM on a body-fitted *foreground* simplex mesh,
  Galerkin-projected through a sparse *extraction operator* ``M`` onto the basis
  of a structured *background* mesh (reference: common.py:142-163), solved there,
  and interpolated back (``u_f = M u_b``, reference: common.py:123-140).
* Assembly is batched: vmapped per-cell/per-facet residual kernels with JAX
  autodiff Jacobians (replacing UFL ``derivative``), scatter via pre-sorted
  segment-sums (replacing DOLFIN's C++ assembler).
* The projected operator is applied matrix-free, ``A_b x = Mᵀ(A_f(M x))``,
  inside jit-compiled Krylov solvers (replacing PETSc KSP); direct-solve parity
  ('mumps') is provided by a host sparse LU on the explicitly projected matrix.
* Multi-device scaling uses ``jax.sharding`` / ``shard_map`` over a device Mesh
  with XLA collectives (replacing MPI domain decomposition).
"""

from iifea import config as config  # noqa: F401

# Eagerly enable x64: immersed FEA conditioning (Nitsche h^-3 penalties, BFR)
# requires double precision by default, mirroring PETSc's f64 baseline.
config.setup()

from iifea.mesh.core import Mesh, FunctionSpace  # noqa: E402,F401
from iifea.ops.extraction import ExtractionOperator  # noqa: E402,F401

__version__ = "0.1.0"
