"""Row-block-sharded geometric multigrid V-cycle (SPMD, GSPMD-partitioned).

The reference's entire solver stack is rank-parallel under `mpirun -np N` —
KSP, PC, and the MUMPS coarse factorization all operate on row-distributed
PETSc objects (InterpolationBasedImmersedFEA/common.py:509-641; ASM
subdomain solves common.py:576-587). Here the analogous multi-chip V-cycle
runs as ONE SPMD program over a 1D 'dp' device mesh:

  * fine levels: coefficient planes and vectors are row-block sharded
    (`PartitionSpec(None, 'dp', None)` / `('dp', None)`); the smoother's
    shifted-FMA matvec and the full-weighting restrict are plain XLA
    pad/slice/conv ops, so GSPMD inserts the 2r-row halo collective-permutes
    by itself — the hand-written ppermute of
    parallel/stencil.py and this module's compiler-partitioned V-cycle
    compute the same exchanges;
  * coarse levels below a row threshold: replicated (the standard
    coarse-grid replication trade at modest device counts — one small
    all-gather at the restrict boundary, zero collectives inside);
  * coarsest level: the dense truncated pseudo-inverse applied replicated
    (the MUMPS-coarse role, ops/multigrid._dense_inverse).

Built FROM an existing single-device StencilMultigrid / StencilMultigrid3D
hierarchy: construction is `device_put` placements only — no re-probing, no
numerical changes, so sharded and single-device cycles agree to roundoff
(pinned by tests/test_parallel_mg.py and dryrun_multichip phase 4).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as DeviceMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from iifea.ops.multigrid import (
    _prolong,
    _prolong3,
    _restrict,
    _restrict3,
)


def _put(x, mesh, spec):
    return jax.device_put(x, NamedSharding(mesh, spec))


class _ShardedMGBase:
    """Common V-cycle driver over plane-form levels (dim-agnostic)."""

    dim: int

    def __init__(self, mg, mesh: DeviceMesh, min_shard_rows: int | None = None):
        self.smoother = getattr(mg, "smoother", "jacobi")
        self.cheb_alpha = getattr(mg, "cheb_alpha", 8.0)
        if self.smoother not in ("jacobi", "chebyshev"):
            raise NotImplementedError(
                f"sharded V-cycle: unsupported smoother {self.smoother!r}"
            )
        self.mesh = mesh
        self.nu_pre, self.nu_post = mg.nu_pre, mg.nu_post
        self.omega = mg.omega
        self.coarse_sweeps = mg.coarse_sweeps
        ndev = mesh.devices.size
        if min_shard_rows is None:
            # each device should own at least a few row-tiles; below that the
            # halo (2r rows/slabs per exchange) rivals the local work
            min_shard_rows = max(4 * ndev, 16)
        self.shapes = [tuple(S.shape) for S in mg.levels]
        self.radii = [S.radius for S in mg.levels]
        tail = (None,) * (self.dim - 1)
        self.C, self.invd, self._specs = [], [], []
        for S, invd in zip(mg.levels, mg.inv_diags):
            sh = tuple(S.shape)
            sharded = sh[0] >= min_shard_rows
            spec_x = P("dp", *tail) if sharded else P(None, *tail)
            spec_c = P(None, *spec_x)
            self._specs.append(spec_x)
            # device_put demands row counts divisible by the mesh size —
            # store zero-padded leaves and slice back to the logical shape
            # inside the traced cycle (uneven shardings are fine in-graph)
            pad_rows = (-(-sh[0] // ndev) * ndev - sh[0]) if sharded else 0
            padw = ((0, pad_rows),) + ((0, 0),) * (self.dim - 1)
            self.C.append(_put(
                jnp.pad(S.coeffs, ((0, 0),) + padw), mesh, spec_c
            ))
            self.invd.append(_put(
                jnp.pad(invd.reshape(sh), padw), mesh, spec_x
            ))
        self.coarse_inv = (
            None if mg.coarse_inv is None else _put(mg.coarse_inv, mesh, P())
        )
        self._x_sharding = NamedSharding(mesh, P("dp", *tail))

    # -- pytree ----------------------------------------------------------------

    def tree_flatten(self):
        return (self.C, self.invd, self.coarse_inv), (
            self.mesh, self.nu_pre, self.nu_post, self.omega,
            self.coarse_sweeps, tuple(self.shapes), tuple(self.radii),
            tuple(self._specs), self.smoother, self.cheb_alpha,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.C, obj.invd, obj.coarse_inv = children
        (obj.mesh, obj.nu_pre, obj.nu_post, obj.omega, obj.coarse_sweeps,
         shapes, radii, specs, obj.smoother, obj.cheb_alpha) = aux
        obj.shapes = list(shapes)
        obj.radii = list(radii)
        obj._specs = list(specs)
        tail = (None,) * (obj.dim - 1)
        obj._x_sharding = NamedSharding(obj.mesh, P("dp", *tail))
        return obj

    # -- per-level building blocks ----------------------------------------------

    def _c(self, lvl: int, x):
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(self.mesh, self._specs[lvl])
        )

    def _Clvl(self, lvl: int):
        sh = self.shapes[lvl]
        C = self.C[lvl]
        if C.shape[1] != sh[0]:
            C = jax.lax.slice_in_dim(C, 0, sh[0], axis=1)
        return C

    def _invdlvl(self, lvl: int):
        sh = self.shapes[lvl]
        invd = self.invd[lvl]
        if invd.shape[0] != sh[0]:
            invd = jax.lax.slice_in_dim(invd, 0, sh[0], axis=0)
        return invd

    def _mv(self, lvl: int, x):
        """Shifted-FMA stencil apply on the level's plane. Static pads and
        slices along the sharded row axis — GSPMD turns the r-row overlap
        into neighbor collective-permutes."""
        C = self._Clvl(lvl)
        sh = self.shapes[lvl]
        r = self.radii[lvl]
        m = 2 * r + 1
        xs = jnp.pad(x, ((r, r),) * self.dim)
        y = jnp.zeros_like(x)
        for k in range(m ** self.dim):
            off = []
            kk = k
            for _ in range(self.dim):
                kk, o = divmod(kk, m)
                off.append(o)
            off = tuple(reversed(off))
            y = y + C[k] * jax.lax.slice(
                xs, off, tuple(o + s for o, s in zip(off, sh))
            )
        return y

    def _smooth(self, lvl: int, x, b, sweeps: int):
        invd = self._invdlvl(lvl)
        if self.smoother == "chebyshev":
            # fixed-interval Chebyshev on the scaled operator — mirrors
            # StencilMultigrid3D._smooth so the sharded cycle matches
            # single-device iteration-for-iteration
            if sweeps <= 0:
                return x
            hi = 1.05
            lo = hi / self.cheb_alpha
            theta = 0.5 * (hi + lo)
            delta = 0.5 * (hi - lo)
            sigma = theta / delta
            rho = 1.0 / sigma
            r = invd * (b - self._mv(lvl, x))
            d = r / theta
            x = self._c(lvl, x + d)
            for _ in range(sweeps - 1):
                rho_new = 1.0 / (2.0 * sigma - rho)
                r = invd * (b - self._mv(lvl, x))
                d = rho_new * (2.0 * r / delta + rho * d)
                x = self._c(lvl, x + d)
                rho = rho_new
            return x
        om = self.omega

        def body(_, x):
            return self._c(lvl, x + om * invd * (b - self._mv(lvl, x)))

        return jax.lax.fori_loop(0, sweeps, body, x)

    def _restrict(self, x):
        return _restrict(x) if self.dim == 2 else _restrict3(x)

    def _prolong(self, xc):
        return _prolong(xc) if self.dim == 2 else _prolong3(xc)

    def _vcycle(self, lvl: int, b):
        if lvl == len(self.shapes) - 1:
            if self.coarse_inv is not None:
                z = jnp.matmul(self.coarse_inv, b.reshape(-1),
                               precision=jax.lax.Precision.HIGHEST)
                z = z.reshape(b.shape)
                return self._c(lvl, z)
            return self._smooth(lvl, jnp.zeros_like(b), b, self.coarse_sweeps)
        x = self._smooth(lvl, jnp.zeros_like(b), b, self.nu_pre)
        r = b - self._mv(lvl, x)
        rc = self._c(lvl + 1, self._restrict(r))
        xc = self._vcycle(lvl + 1, rc)
        x = self._c(lvl, x + self._prolong(xc))
        return self._smooth(lvl, x, b, self.nu_post)

    # -- public interfaces -------------------------------------------------------

    def minv_plane(self, r):
        """V-cycle on the level-0 plane (nx1, [ny1[, nz1]])."""
        return self._vcycle(0, self._c(0, r))

    def minv(self, r):
        """Flat-vector interface (matches StencilMultigrid.minv)."""
        sh = self.shapes[0]
        return self.minv_plane(r.reshape(sh)).reshape(-1)

    def minv_padded(self, r2):
        """Row-padded sharded-plane interface compatible with
        parallel/stencil.py's shard_vec layout: (nxs, ...) in/out, padded
        rows zero. This is the preconditioner the sharded MG-PCG pipeline
        (bench.py --devices N) plugs straight into krylov.cg."""
        sh = self.shapes[0]
        nxs = r2.shape[0]
        z = self.minv_plane(r2[: sh[0]])
        pad = ((0, nxs - sh[0]),) + ((0, 0),) * (self.dim - 1)
        return jax.lax.with_sharding_constraint(
            jnp.pad(z, pad), self._x_sharding
        )


@jax.tree_util.register_pytree_node_class
class ShardedMultigrid2D(_ShardedMGBase):
    """Sharded V-cycle over a StencilMultigrid (2D) hierarchy."""

    dim = 2


@jax.tree_util.register_pytree_node_class
class ShardedMultigrid3D(_ShardedMGBase):
    """Sharded V-cycle over a StencilMultigrid3D hierarchy (x-slab blocks)."""

    dim = 3


@jax.tree_util.register_pytree_node_class
class ShardedMultigridBlock2D:
    """Row-block-sharded V-cycle over a StencilMultigridBlock hierarchy —
    the vector-field (elasticity / NS / shell) analog of ShardedMultigrid2D.
    Fields stay replicated in layout; lattice rows shard over 'dp'; the
    point-block-Jacobi inverse blocks ride as (nF, nF, nx, ny) planes."""

    def __init__(self, mg, mesh: DeviceMesh, min_shard_rows: int | None = None):
        self.mesh = mesh
        self.nu_pre, self.nu_post = mg.nu_pre, mg.nu_post
        self.omega = mg.omega
        self.coarse_sweeps = mg.coarse_sweeps
        ndev = mesh.devices.size
        if min_shard_rows is None:
            min_shard_rows = max(4 * ndev, 16)
        self.shapes = [tuple(S.shape) for S in mg.levels]
        self.radii = [S.radius for S in mg.levels]
        self.n_fields = mg.levels[0].n_fields
        self.C, self.binv, self._specs = [], [], []
        for S, binv in zip(mg.levels, mg.binvs):
            sh = tuple(S.shape)
            nF = S.n_fields
            sharded = sh[0] >= min_shard_rows
            spec_x = P(None, "dp", None) if sharded else P(None, None, None)
            self._specs.append(spec_x)
            pad_rows = (-(-sh[0] // ndev) * ndev - sh[0]) if sharded else 0
            # C: (nF, nF, m², nx, ny) — rows are axis 3
            Cp = jnp.pad(
                S.coeffs,
                ((0, 0),) * 3 + ((0, pad_rows), (0, 0)),
            )
            self.C.append(_put(Cp, mesh, P(None, None, None, *spec_x[1:])))
            # binv: (nF, nF, nn) -> (nF, nF, nx, ny) planes
            b4 = jnp.pad(
                binv.reshape(nF, nF, *sh),
                ((0, 0), (0, 0), (0, pad_rows), (0, 0)),
            )
            self.binv.append(_put(b4, mesh, P(None, None, *spec_x[1:])))
        self.coarse_inv = (
            None if mg.coarse_inv is None else _put(mg.coarse_inv, mesh, P())
        )
        self._x_sharding = NamedSharding(mesh, P(None, "dp", None))

    def tree_flatten(self):
        return (self.C, self.binv, self.coarse_inv), (
            self.mesh, self.nu_pre, self.nu_post, self.omega,
            self.coarse_sweeps, tuple(self.shapes), tuple(self.radii),
            self.n_fields, tuple(self._specs),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.C, obj.binv, obj.coarse_inv = children
        (obj.mesh, obj.nu_pre, obj.nu_post, obj.omega, obj.coarse_sweeps,
         shapes, radii, obj.n_fields, specs) = aux
        obj.shapes = list(shapes)
        obj.radii = list(radii)
        obj._specs = list(specs)
        obj._x_sharding = NamedSharding(obj.mesh, P(None, "dp", None))
        return obj

    def _c(self, lvl: int, x):
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(self.mesh, self._specs[lvl])
        )

    def _mv(self, lvl: int, x3):
        """Block stencil apply on (nF, nx, ny) planes."""
        sh = self.shapes[lvl]
        r = self.radii[lvl]
        m = 2 * r + 1
        nF = self.n_fields
        C = self.C[lvl]
        if C.shape[3] != sh[0]:
            C = jax.lax.slice_in_dim(C, 0, sh[0], axis=3)
        xs = jnp.pad(x3, ((0, 0), (r, r), (r, r)))
        outs = []
        for f1 in range(nF):
            acc = jnp.zeros(sh, x3.dtype)
            for f2 in range(nF):
                for k in range(m * m):
                    oi, oj = divmod(k, m)
                    acc = acc + C[f1, f2, k] * jax.lax.slice(
                        xs[f2], (oi, oj), (oi + sh[0], oj + sh[1])
                    )
            outs.append(acc)
        return jnp.stack(outs)

    def _binvlvl(self, lvl: int):
        sh = self.shapes[lvl]
        b = self.binv[lvl]
        if b.shape[2] != sh[0]:
            b = jax.lax.slice_in_dim(b, 0, sh[0], axis=2)
        return b

    def _smooth(self, lvl: int, x, b, sweeps: int):
        om = self.omega
        Binv = self._binvlvl(lvl)

        def body(_, x):
            r3 = b - self._mv(lvl, x)
            z = jnp.einsum("abxy,bxy->axy", Binv, r3,
                           precision=jax.lax.Precision.HIGHEST)
            return self._c(lvl, x + om * z)

        return jax.lax.fori_loop(0, sweeps, body, x)

    def _vcycle(self, lvl: int, b):
        if lvl == len(self.shapes) - 1:
            if self.coarse_inv is not None:
                z = jnp.matmul(self.coarse_inv, b.reshape(-1),
                               precision=jax.lax.Precision.HIGHEST)
                z = z.reshape(b.shape)
                return self._c(lvl, z)
            return self._smooth(lvl, jnp.zeros_like(b), b, self.coarse_sweeps)
        x = self._smooth(lvl, jnp.zeros_like(b), b, self.nu_pre)
        r3 = b - self._mv(lvl, x)
        rc = self._c(lvl + 1, jax.vmap(_restrict)(r3))
        xc = self._vcycle(lvl + 1, rc)
        x = self._c(lvl, x + jax.vmap(_prolong)(xc))
        return self._smooth(lvl, x, b, self.nu_post)

    def minv_plane(self, r3):
        return self._vcycle(0, self._c(0, r3))

    def minv(self, r):
        nF = self.n_fields
        sh = self.shapes[0]
        return self.minv_plane(r.reshape(nF, *sh)).reshape(-1)

    def minv_padded(self, r3):
        """(nF, nxs, ny) padded sharded planes, the
        parallel/stencil.ShardedStencilBlock2D layout."""
        sh = self.shapes[0]
        nxs = r3.shape[1]
        z = self.minv_plane(r3[:, : sh[0]])
        z3 = jnp.pad(z, ((0, 0), (0, nxs - sh[0]), (0, 0)))
        return jax.lax.with_sharding_constraint(z3, self._x_sharding)
