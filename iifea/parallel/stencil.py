"""Multi-device stencil operators: the hot path under SPMD sharding.

The stencil-form background operator (ops/stencil.py) is the product compute
pattern; at multi-chip scale the lattice is split into contiguous ROW BLOCKS
across the 'dp' mesh axis (the domain-decomposition analog of the reference's
MPI row-distributed PETSc matrices). Each device owns

    x_local (rows_loc, ny1)      its slab of the solution plane
    C_local (m², rows_loc, ny1)  its slab of every coefficient plane

and one application is: exchange 2r halo rows with the two neighbors
(``jax.lax.ppermute`` — non-cyclic, boundary devices receive zeros,
which matches the zero Dirichlet halo of the single-device kernel), then
(2r+1)² shifted FMAs on the local slab. Krylov loops run on the sharded
vectors directly: dot products and norms lower to one ``psum`` each under
jit — no rank-conditional code, SPMD by construction (SURVEY.md §2.4/N7).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as DeviceMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from jax import shard_map

from iifea.ops.stencil import StencilOperator2D


class ShardedStencil2D:
    """Row-block sharded StencilOperator2D over a 1D 'dp' device mesh.

    Rows are padded to a multiple of the device count; padded rows carry
    zero coefficients so they contribute nothing (same convention as the
    single-device tile padding).
    """

    def __init__(self, S: StencilOperator2D, mesh: DeviceMesh):
        self.mesh = mesh
        self.shape = S.shape
        self.radius = S.radius
        self.n = S.n
        nx1, ny1 = S.shape
        ndev = mesh.devices.size
        self.nxs = -(-nx1 // ndev) * ndev          # sharded row count

        C = S.coeffs                               # (m², nx1, ny1) logical
        Cp = jnp.pad(C, ((0, 0), (0, self.nxs - nx1), (0, 0)))
        self.C = jax.device_put(
            Cp, NamedSharding(mesh, P(None, "dp", None))
        )
        self._x_sharding = NamedSharding(mesh, P("dp", None))

        r = self.radius
        m = 2 * r + 1
        axis = mesh.axis_names[0]
        fwd = [(i, i + 1) for i in range(ndev - 1)]
        bwd = [(i + 1, i) for i in range(ndev - 1)]

        @partial(
            shard_map, mesh=mesh,
            in_specs=(P("dp", None), P(None, "dp", None)),
            out_specs=P("dp", None),
        )
        def _mv2(x2, C):
            # halo exchange: my bottom rows -> next device's top halo, my
            # top rows -> previous device's bottom halo (zeros at the ends)
            top_halo = jax.lax.ppermute(x2[-r:], axis, fwd)
            bot_halo = jax.lax.ppermute(x2[:r], axis, bwd)
            xs = jnp.concatenate([top_halo, x2, bot_halo], axis=0)
            xs = jnp.pad(xs, ((0, 0), (r, r)))
            rows = x2.shape[0]
            y = jnp.zeros_like(x2)
            for k in range(m * m):
                oi, oj = divmod(k, m)
                y = y + C[k] * jax.lax.dynamic_slice(
                    xs, (oi, oj), (rows, x2.shape[1])
                )
            return y

        self._mv2 = _mv2

    def shard_vec(self, x: jnp.ndarray) -> jnp.ndarray:
        """Flat (n,) -> row-sharded (nxs, ny1) plane."""
        nx1, ny1 = self.shape
        x2 = jnp.pad(x.reshape(nx1, ny1), ((0, self.nxs - nx1), (0, 0)))
        return jax.device_put(x2, self._x_sharding)

    def unshard_vec(self, x2: jnp.ndarray) -> jnp.ndarray:
        return x2[: self.shape[0], :].reshape(-1)

    def mv2(self, x2: jnp.ndarray) -> jnp.ndarray:
        """Sharded-plane matvec: (nxs, ny1) -> (nxs, ny1)."""
        return self._mv2(x2, self.C)

    def mv(self, x: jnp.ndarray) -> jnp.ndarray:
        """Flat-vector interface (shards, applies, gathers)."""
        return self.unshard_vec(self.mv2(self.shard_vec(x)))

    def diag2(self) -> jnp.ndarray:
        r = self.radius
        m = 2 * r + 1
        return self.C[r * m + r]


class ShardedStencil3D:
    """Row-block (x-slab) sharded StencilOperator3D over a 1D 'dp' mesh —
    the 3D analog of ShardedStencil2D: exchange 2r halo SLABS (r, ny1, nz1)
    with the two neighbors, then (2r+1)³ shifted FMAs locally."""

    def __init__(self, S, mesh: DeviceMesh):
        self.mesh = mesh
        self.shape = S.shape
        self.radius = S.radius
        self.n = S.shape[0] * S.shape[1] * S.shape[2]
        nx1, ny1, nz1 = S.shape
        ndev = mesh.devices.size
        self.nxs = -(-nx1 // ndev) * ndev

        C = S.coeffs                          # (m³, nx1, ny1, nz1)
        Cp = jnp.pad(C, ((0, 0), (0, self.nxs - nx1), (0, 0), (0, 0)))
        self.C = jax.device_put(
            Cp, NamedSharding(mesh, P(None, "dp", None, None))
        )
        self._x_sharding = NamedSharding(mesh, P("dp", None, None))

        r = self.radius
        m = 2 * r + 1
        axis = mesh.axis_names[0]
        fwd = [(i, i + 1) for i in range(ndev - 1)]
        bwd = [(i + 1, i) for i in range(ndev - 1)]

        @partial(
            shard_map, mesh=mesh,
            in_specs=(P("dp", None, None), P(None, "dp", None, None)),
            out_specs=P("dp", None, None),
        )
        def _mv3(x3, C):
            top_halo = jax.lax.ppermute(x3[-r:], axis, fwd)
            bot_halo = jax.lax.ppermute(x3[:r], axis, bwd)
            xs = jnp.concatenate([top_halo, x3, bot_halo], axis=0)
            xs = jnp.pad(xs, ((0, 0), (r, r), (r, r)))
            rows = x3.shape[0]
            y = jnp.zeros_like(x3)
            for k in range(m ** 3):
                oi, rem = divmod(k, m * m)
                oj, ok = divmod(rem, m)
                y = y + C[k] * jax.lax.dynamic_slice(
                    xs, (oi, oj, ok), (rows, x3.shape[1], x3.shape[2])
                )
            return y

        self._mv3 = _mv3

    def shard_vec(self, x: jnp.ndarray) -> jnp.ndarray:
        nx1, ny1, nz1 = self.shape
        x3 = jnp.pad(
            x.reshape(nx1, ny1, nz1), ((0, self.nxs - nx1), (0, 0), (0, 0))
        )
        return jax.device_put(x3, self._x_sharding)

    def unshard_vec(self, x3: jnp.ndarray) -> jnp.ndarray:
        return x3[: self.shape[0]].reshape(-1)

    def mv3(self, x3: jnp.ndarray) -> jnp.ndarray:
        return self._mv3(x3, self.C)

    def mv(self, x: jnp.ndarray) -> jnp.ndarray:
        return self.unshard_vec(self.mv3(self.shard_vec(x)))


class ShardedStencilBlock2D:
    """Row-block sharded StencilOperatorBlock2D (vector lattices) over a 1D
    'dp' mesh. Fields stay replicated in layout (axis 0); rows shard. One
    halo exchange covers ALL fields (the (nF, r, ny1) slab), then nF²·(2r+1)²
    shifted FMAs locally — same collective count per apply as the scalar
    operator."""

    def __init__(self, S, mesh: DeviceMesh):
        self.mesh = mesh
        self.shape = S.shape
        self.radius = S.radius
        self.n_fields = S.n_fields
        self.n = S.n
        nx1, ny1 = S.shape
        ndev = mesh.devices.size
        self.nxs = -(-nx1 // ndev) * ndev

        C = S.coeffs                          # (nF, nF, m², nx1, ny1)
        Cp = jnp.pad(
            C, ((0, 0), (0, 0), (0, 0), (0, self.nxs - nx1), (0, 0))
        )
        self.C = jax.device_put(
            Cp, NamedSharding(mesh, P(None, None, None, "dp", None))
        )
        self._x_sharding = NamedSharding(mesh, P(None, "dp", None))

        r = self.radius
        m = 2 * r + 1
        nF = self.n_fields
        axis = mesh.axis_names[0]
        fwd = [(i, i + 1) for i in range(ndev - 1)]
        bwd = [(i + 1, i) for i in range(ndev - 1)]

        @partial(
            shard_map, mesh=mesh,
            in_specs=(P(None, "dp", None), P(None, None, None, "dp", None)),
            out_specs=P(None, "dp", None),
        )
        def _mvb(x3, C):
            top_halo = jax.lax.ppermute(x3[:, -r:], axis, fwd)
            bot_halo = jax.lax.ppermute(x3[:, :r], axis, bwd)
            xs = jnp.concatenate([top_halo, x3, bot_halo], axis=1)
            xs = jnp.pad(xs, ((0, 0), (0, 0), (r, r)))
            rows = x3.shape[1]
            y = jnp.zeros_like(x3)
            for f1 in range(nF):
                acc = jnp.zeros((rows, x3.shape[2]), x3.dtype)
                for f2 in range(nF):
                    for k in range(m * m):
                        oi, oj = divmod(k, m)
                        acc = acc + C[f1, f2, k] * jax.lax.dynamic_slice(
                            xs[f2], (oi, oj), (rows, x3.shape[2])
                        )
                y = y.at[f1].set(acc)
            return y

        self._mvb = _mvb

    def shard_vec(self, x: jnp.ndarray) -> jnp.ndarray:
        nF = self.n_fields
        nx1, ny1 = self.shape
        x3 = jnp.pad(
            x.reshape(nF, nx1, ny1), ((0, 0), (0, self.nxs - nx1), (0, 0))
        )
        return jax.device_put(x3, self._x_sharding)

    def unshard_vec(self, x3: jnp.ndarray) -> jnp.ndarray:
        return x3[:, : self.shape[0], :].reshape(-1)

    def mvb(self, x3: jnp.ndarray) -> jnp.ndarray:
        return self._mvb(x3, self.C)

    def mv(self, x: jnp.ndarray) -> jnp.ndarray:
        return self.unshard_vec(self.mvb(self.shard_vec(x)))
