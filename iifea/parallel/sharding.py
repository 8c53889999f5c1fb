"""SPMD multi-device execution — the MPI domain-decomposition replacement.

The reference scales by MPI rank-partitioning the mesh (DOLFIN ghost facets,
PETSc row-distributed matrices, VecScatter halos — SURVEY.md §2.4/N7). The
data-parallel restatement implemented here:

* **cells/facets are sharded** across the device mesh axis 'dp' (element
  batches are embarrassingly parallel; chunks are padded with zero-weight
  elements, which contribute exactly nothing). Arrays are struct-of-planes
  (element axis minormost — see ops/assembly.py), so the shard axis is the
  LAST axis of every per-element array;
* **the background DOF vector is replicated** (it is the coarse space —
  much smaller than the foreground);
* the extraction operator is **fused into the element gather**: each device
  evaluates the solution at its own cells directly from the background
  vector, u_loc[a,e] = Σ_k val[k,a,e]·x[idx[k,a,e]], so no foreground halo
  exchange exists at all (the reference needs ghost_mode="shared_facet" +
  VecScatter for the same purpose);
* every assembly/operator application ends in ONE ``psum`` of a
  background-sized array across devices — the analog of matrix-stash exchange +
  MPI_Allreduce, as a single dense collective.

Krylov iterations run *outside* shard_map on replicated vectors, so dot
products need no additional collectives.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh as DeviceMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from jax import shard_map

from iifea.ops.assembly import CellCtx, CellDomain, FacetCtx, Form
from iifea.ops.extraction import ExtractionOperator


def make_device_mesh(n_devices: int | None = None) -> DeviceMesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return DeviceMesh(np.array(devs[:n]), ("dp",))


def _pad_last(arr: np.ndarray, n: int, fill=0.0):
    arr = np.asarray(arr)
    pad = n - arr.shape[-1]
    if pad == 0:
        # always writable: inputs may be read-only views of device buffers
        return np.array(arr)
    widths = [(0, 0)] * (arr.ndim - 1) + [(0, pad)]
    return np.pad(arr, widths, constant_values=fill)


def _register(cls):
    fields = [f.name for f in dataclasses.fields(cls)]

    def flatten(o):
        return tuple(getattr(o, f) for f in fields), None

    jax.tree_util.register_pytree_node(cls, flatten, lambda _, l: cls(*l))
    return cls


def _last_axis_spec(a) -> P:
    return P(*([None] * (np.ndim(a) - 1)), "dp")


@_register
@dataclasses.dataclass
class FusedTerm:
    """One integral term with extraction fused in, sharded over 'dp'.

    trailing-axis-sharded arrays: geometry + Fidx/Fval; replicated: tables.
    """

    Fidx: jnp.ndarray   # (km, ne, nE) background dof ids per local dof
    Fval: jnp.ndarray   # (km, ne, nE) extraction weights
    geom: tuple         # domain-kind-specific sharded geometry arrays
    tables: tuple       # replicated static tables


def _fuse_term(dom, M: ExtractionOperator, n_dev: int):
    Midx = M.idx_np
    Mval = M.val_np
    fl = getattr(dom, "flat_eldofs_np", None)
    if fl is None:
        fl = np.asarray(dom.eldofsT).T
    nE = fl.shape[0]
    nE_pad = -(-nE // n_dev) * n_dev
    flT = np.ascontiguousarray(fl.T)                     # (ne, nE)
    Fidx = _pad_last(np.moveaxis(Midx[flT], -1, 0), nE_pad)   # (km, ne, nE)
    Fval = _pad_last(np.moveaxis(Mval[flT], -1, 0), nE_pad)
    if isinstance(dom, CellDomain):
        geom = (
            _pad_last(np.asarray(dom.JinvT), nE_pad),
            _pad_last(np.asarray(dom.wdetT), nE_pad),
            _pad_last(np.asarray(dom.xqT), nE_pad),
            # pad h with 1 to avoid div-by-zero in h^-1 penalties of padded
            # cells (their quadrature weights are 0, so they contribute 0)
            _pad_last(np.asarray(dom.h), nE_pad, fill=1.0),
        )
        tables = (np.asarray(dom.phi), np.asarray(dom.gphi_ref),
                  np.asarray(dom.hess_ref))
        kind = "cell"
    else:
        geom = (
            _pad_last(np.asarray(dom.phiT), nE_pad),
            _pad_last(np.asarray(dom.gphiT), nE_pad),
            _pad_last(np.asarray(dom.hessT), nE_pad)
            if dom.hessT.size else np.asarray(dom.hessT),
            _pad_last(np.asarray(dom.wT), nE_pad),
            _pad_last(np.asarray(dom.xqT), nE_pad),
            _pad_last(np.asarray(dom.h), nE_pad, fill=1.0),
            _pad_last(np.asarray(dom.normalT), nE_pad),
        )
        tables = ()
        kind = "facet"
    return kind, Fidx, Fval, geom, tables


def _local_ctx(kind, geom, tables):
    if kind == "cell":
        JinvT, wdetT, xqT, h = geom
        phi, gphi_ref, hess_ref = tables
        gphi = jnp.einsum("qbd,deE->qbeE", gphi_ref, JinvT)
        hess = (
            jnp.einsum("dcE,qbde,efE->qbcfE", JinvT, hess_ref, JinvT)
            if hess_ref.size else None
        )
        nE = wdetT.shape[-1]
        phi_b = jnp.broadcast_to(phi[..., None], phi.shape + (nE,))
        return CellCtx(phi_b, gphi, wdetT, xqT, h, hess)
    phiT, gphiT, hessT, wT, xqT, h, normalT = geom
    return FacetCtx(phiT, gphiT, wT, xqT, h, normalT,
                    hessT if hessT.size else None)


class ShardedProjectedSystem:
    """The full background system under SPMD sharding.

    Provides jit-compatible assemble/residual/matvec/diag, each one
    shard_map region ending in a single psum.
    """

    def __init__(self, form: Form, M: ExtractionOperator, mesh: DeviceMesh):
        self.form = form
        self.M = M
        self.mesh = mesh
        self.n = M.n_bg_dofs
        self.n_fields = form.n_fields
        n_dev = mesh.devices.size

        self.kinds, self.kernels, self.terms, self._specs = [], [], [], []
        for dom, kern in form.terms:
            kind, Fidx, Fval, geom, tables = _fuse_term(dom, M, n_dev)
            self.kinds.append(kind)
            self.kernels.append(kern)
            spec = FusedTerm(
                Fidx=_last_axis_spec(Fidx),
                Fval=_last_axis_spec(Fval),
                geom=tuple(
                    _last_axis_spec(g) if g.size else P() for g in geom
                ),
                tables=tuple(P() for _ in tables),
            )
            self._specs.append(spec)

            def put(a, s):
                return jax.device_put(
                    a, NamedSharding(mesh, s if a.size else P())
                )

            self.terms.append(
                FusedTerm(
                    Fidx=put(Fidx, spec.Fidx),
                    Fval=put(Fval, spec.Fval),
                    geom=tuple(put(g, s) for g, s in zip(geom, spec.geom)),
                    tables=tuple(
                        jax.device_put(t, NamedSharding(mesh, P()))
                        for t in tables
                    ),
                )
            )

    # -- local helpers --------------------------------------------------------

    def _gather_local(self, Fidx, Fval, x):
        """u_loc (nb, nF, nE) from the replicated background vector."""
        vals = (Fval * x[Fidx]).sum(0)                # (ne, nE)
        ne, nE = vals.shape
        return vals.reshape(ne // self.n_fields, self.n_fields, nE)

    def _scatter_local(self, Fidx, Fval, r_loc, n):
        ne, nE = Fval.shape[1:]
        data = (r_loc.reshape(1, ne, nE) * Fval).reshape(-1)
        return jax.ops.segment_sum(data, Fidx.reshape(-1), num_segments=n)

    # -- public ops (jit-compatible) ------------------------------------------

    def residual_b(self, u_p, params=None):
        """r_b = Mᵀ R(M u_p): fused, sharded, one psum per term."""
        out = jnp.zeros(self.n, u_p.dtype)
        for i, term in enumerate(self.terms):
            kern, kind = self.kernels[i], self.kinds[i]

            @partial(shard_map, mesh=self.mesh,
                     in_specs=(self._specs[i], P()), out_specs=P())
            def term_res(t, x, kern=kern, kind=kind):
                u_loc = self._gather_local(t.Fidx, t.Fval, x)
                ctx = _local_ctx(kind, t.geom, t.tables)
                r_loc = jax.vmap(
                    kern, in_axes=(-1, -1, -1, None), out_axes=-1
                )(u_loc, {}, ctx, params)
                contrib = self._scatter_local(t.Fidx, t.Fval, r_loc, self.n)
                return jax.lax.psum(contrib, "dp")

            out = out + term_res(term, u_p)
        return out

    def assemble_blocks(self, u_p, params=None):
        """Sharded element Jacobians K (ne, ne, nE) (kept sharded)."""
        blocks = []
        for i, term in enumerate(self.terms):
            kern, kind = self.kernels[i], self.kinds[i]

            @partial(shard_map, mesh=self.mesh,
                     in_specs=(self._specs[i], P()),
                     out_specs=P(None, None, "dp"))
            def term_blocks(t, x, kern=kern, kind=kind):
                u_loc = self._gather_local(t.Fidx, t.Fval, x)
                ctx = _local_ctx(kind, t.geom, t.tables)

                def local_jac(ul, c):
                    nb, nF = ul.shape

                    def flat_res(uf):
                        return kern(uf.reshape(nb, nF), {}, c, params).reshape(-1)

                    return jax.jacfwd(flat_res)(ul.reshape(-1))

                return jax.vmap(local_jac, in_axes=(-1, -1), out_axes=-1)(
                    u_loc, ctx
                )

            blocks.append(term_blocks(term, u_p))
        return blocks

    def matvec(self, blocks, x):
        y = jnp.zeros(self.n, x.dtype)
        for i, term in enumerate(self.terms):

            @partial(shard_map, mesh=self.mesh,
                     in_specs=(P(None, None, "dp"), self._specs[i].Fidx,
                               self._specs[i].Fval, P()),
                     out_specs=P())
            def term_mv(K, Fidx, Fval, xx):
                xe = (Fval * xx[Fidx]).sum(0)              # (ne, nE)
                ne = xe.shape[0]
                # unrolled tiny contraction (see ops/assembly.Form.matvec)
                ye = sum(K[:, b, :] * xe[b][None, :] for b in range(ne))
                contrib = self._scatter_local(Fidx, Fval, ye, self.n)
                return jax.lax.psum(contrib, "dp")

            y = y + term_mv(blocks[i], term.Fidx, term.Fval, x)
        return y

    def diag(self, blocks):
        d = jnp.zeros(self.n, blocks[0].dtype)
        for i, term in enumerate(self.terms):

            @partial(shard_map, mesh=self.mesh,
                     in_specs=(P(None, None, "dp"), self._specs[i].Fidx,
                               self._specs[i].Fval),
                     out_specs=P())
            def term_diag(K, Fidx, Fval):
                eq = Fidx[:, :, None, None, :] == Fidx[None, None, :, :, :]
                T = jnp.einsum(
                    "abE,KaLbE,LbE->KaE", K, eq.astype(K.dtype), Fval
                ) * Fval
                dd = jax.ops.segment_sum(
                    T.reshape(-1), Fidx.reshape(-1), num_segments=self.n
                )
                return jax.lax.psum(dd, "dp")

            d = d + term_diag(blocks[i], term.Fidx, term.Fval)
        return d

    def make_step(self, rtol=1e-8, atol=1e-12, max_it=500):
        """The jittable full step: assemble -> project -> PCG -> update."""
        from iifea.solvers import krylov
        from iifea.solvers.precond import jacobi

        def step(u_p, params=None):
            blocks = self.assemble_blocks(u_p, params)
            b = -self.residual_b(u_p, params)
            d = self.diag(blocks)
            du, info = krylov.cg(
                lambda v: self.matvec(blocks, v), b,
                minv=jacobi(d), rtol=rtol, atol=atol, max_it=max_it,
            )
            return u_p + du, info.resnorm

        return step
