"""The extraction operator M (background -> foreground interpolation).

on-device replacement for the reference's distributed PETSc AIJ matrix
(readExOp, common.py:645-712). M is stored in padded **slot-major ELL** form:

    idxT (kmax, n_fg_dofs) int32   background dof ids (padded with 0)
    valT (kmax, n_fg_dofs) float   weights (padding weight 0)

Slot-major ("struct of planes") puts the long dof axis minormost: with
(kmax, n) every plane is a dense contiguous vector, and no table with a
tiny minor dim is ever padded out.

The two hot operations are embarrassingly vectorizable:

* ``u_f = M u_b``  — a gather + weighted plane-sum (bandwidth-bound),
  replacing PETSc MatMult (transferToForeground, common.py:123-140);
* ``r_b = Mᵀ r_f`` — a pre-sorted transpose-gather, replacing
  MatMultTranspose (AT_x, la_utils.py:143-163). The permutation is computed
  once on host, so the device op is a gather + plane-sum (no atomic scatters).

Multi-RHS variants take/return **stacked** vectors of shape (k, n) — the RHS
axis leads so the dof axis stays minormost.

Multi-field block offsets follow the reference exactly: foreground dofs
interleave fields (node*n_fields + field) while background dofs are
field-blocked (bg_id = node + field*m, common.py:703).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
class ExtractionOperator:
    """Sparse M of shape (n_fg_dofs, n_bg_dofs) in slot-major ELL planes."""

    def __init__(self, idx, val, n_bg_dofs, _device_cache=None):
        """idx/val are (n_fg, kmax) numpy arrays (row-major construction is
        natural on host; device copies are stored transposed)."""
        self.idx_np = np.asarray(idx)
        self.val_np = np.asarray(val)
        self.n_bg_dofs = int(n_bg_dofs)
        self.n_fg_dofs = int(self.idx_np.shape[0])
        if _device_cache is None:
            _device_cache = self._build_device_cache()
        (self._t_gidx, self._d_idx, self._d_val) = _device_cache

    # -- construction --------------------------------------------------------

    def _build_device_cache(self):
        # transpose-gather table (see ops/assembly._scatter_cache): Mᵀ as a
        # pure gather + plane-sum instead of a conflicting scatter. Positions
        # index the slot-major flattening (slot*n_fg + row), shifted by +1
        # (0 = zero sentinel). ELL padding entries (val == 0) are excluded —
        # otherwise background dof 0 accumulates every padded slot and the
        # gather plane count explodes.
        idxT = np.ascontiguousarray(self.idx_np.T)   # (kmax, n_fg)
        valT = np.ascontiguousarray(self.val_np.T)
        live = np.flatnonzero(valT.ravel() != 0.0)
        ids = idxT.ravel()[live]
        order = np.argsort(ids, kind="stable")
        sorted_ids = ids[order]
        counts = np.bincount(ids, minlength=self.n_bg_dofs)
        kmax = max(int(counts.max()) if counts.size else 1, 1)
        starts = np.zeros(self.n_bg_dofs, dtype=np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        pos = np.arange(ids.size, dtype=np.int64) - starts[sorted_ids]
        gidx = np.zeros((kmax, self.n_bg_dofs), dtype=np.int32)
        gidx[pos, sorted_ids] = (live[order] + 1).astype(np.int32)
        return (
            jnp.asarray(gidx),
            jnp.asarray(idxT),
            jnp.asarray(valT),
        )

    @classmethod
    def from_triples(
        cls,
        fg_nodes: np.ndarray,
        bg_nodes: np.ndarray,
        weights: np.ndarray,
        n_fg_nodes: int,
        n_bg_nodes: int | None = None,
        n_fields: int = 1,
        dtype=np.float64,
    ) -> "ExtractionOperator":
        """Build M from 0-based (fg_node, bg_node, weight) triples.

        Scalar triples are replicated across fields with the reference's
        block layout (common.py:679-708).
        """
        fg_nodes = np.asarray(fg_nodes, dtype=np.int64)
        bg_nodes = np.asarray(bg_nodes, dtype=np.int64)
        weights = np.asarray(weights, dtype=np.float64)
        m = int(bg_nodes.max()) + 1 if n_bg_nodes is None else int(n_bg_nodes)
        n_fg = n_fg_nodes * n_fields
        n_bg = m * n_fields

        # accumulate duplicate (fg, bg) entries like PETSc ADD_VALUES would not
        # occur here (readExOp uses INSERT semantics: last value wins); we
        # deduplicate keeping the last occurrence for exact parity.
        key = fg_nodes * (m + 1) + bg_nodes
        _, last_index = np.unique(key[::-1], return_index=True)
        keep = len(key) - 1 - last_index
        fg_nodes, bg_nodes, weights = fg_nodes[keep], bg_nodes[keep], weights[keep]

        counts = np.bincount(fg_nodes, minlength=n_fg_nodes)
        kmax = max(int(counts.max()) if len(counts) else 1, 1)
        idx = np.zeros((n_fg, kmax), dtype=np.int32)
        val = np.zeros((n_fg, kmax), dtype=dtype)
        order = np.argsort(fg_nodes, kind="stable")
        fg_s, bg_s, w_s = fg_nodes[order], bg_nodes[order], weights[order]
        # position of each entry within its row
        row_start = np.zeros(len(fg_s), dtype=np.int64)
        if len(fg_s):
            new_row = np.ones(len(fg_s), dtype=bool)
            new_row[1:] = fg_s[1:] != fg_s[:-1]
            pos = np.arange(len(fg_s)) - np.maximum.accumulate(
                np.where(new_row, np.arange(len(fg_s)), 0)
            )
            row_start = pos
        for f in range(n_fields):
            rows = fg_s * n_fields + f
            cols = bg_s + f * m
            idx[rows, row_start] = cols
            val[rows, row_start] = w_s
        return cls(idx, val, n_bg)

    @classmethod
    def from_exop_csv(
        cls, paths, n_fg_nodes: int, n_fields: int = 1, dtype=np.float64
    ) -> "ExtractionOperator":
        """Load ExOp_Cons.csv triples (readExOp parity, common.py:645-712).

        Ids in the files are 1-based Exodus ids (common.py:699-703); since this
        framework adopts Exodus node ids as dof ids, the map is id-1.
        """
        from iifea.mesh.io import read_exop_triples

        tri = read_exop_triples(paths)
        fg = tri[:, 0].astype(np.int64) - 1
        bg = tri[:, 1].astype(np.int64) - 1
        w = tri[:, 2]
        ok = fg >= 0
        return cls.from_triples(
            fg[ok], bg[ok], w[ok], n_fg_nodes, n_fields=n_fields, dtype=dtype
        )

    @classmethod
    def identity(cls, n_nodes: int, n_fields: int = 1, dtype=None) -> "ExtractionOperator":
        """Identity extraction: the fitted-FEM sanity path (--Ex False,
        poisson.py:178-181; getIdentity, common.py:254-258)."""
        import jax

        n = n_nodes * n_fields
        idx = np.arange(n, dtype=np.int32)[:, None]
        fdt = dtype or (np.float64 if jax.config.jax_enable_x64 else np.float32)
        val = np.ones((n, 1), dtype=fdt)
        return cls(idx, val, n)

    # -- pytree protocol ------------------------------------------------------

    def tree_flatten(self):
        leaves = (self._d_idx, self._d_val, self._t_gidx)
        aux = (self.n_bg_dofs, self.n_fg_dofs)
        return leaves, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        d_idx, d_val, t_gidx = leaves
        obj = object.__new__(cls)
        obj.n_bg_dofs, obj.n_fg_dofs = aux
        obj._t_gidx = t_gidx
        obj._d_idx, obj._d_val = d_idx, d_val
        return obj

    # -- operators ------------------------------------------------------------

    def mv(self, u_b: jnp.ndarray) -> jnp.ndarray:
        """u_f = M u_b (transferToForeground, common.py:123-140)."""
        return (self._d_val * u_b[self._d_idx]).sum(axis=0)

    def rmv(self, r_f: jnp.ndarray) -> jnp.ndarray:
        """r_b = Mᵀ r_f (AT_x, la_utils.py:143-163): transpose-gather."""
        data = (self._d_val * r_f[None, :]).reshape(-1)
        padded = jnp.concatenate([jnp.zeros(1, data.dtype), data])
        return padded[self._t_gidx].sum(axis=0)

    # -- multi-RHS variants ---------------------------------------------------
    # Stacked (k, n) layouts keep the dof axis minormost (lane-aligned) while
    # amortizing the per-index gather latency over k simultaneous vectors:
    # used for stencil probing and blocked solves.

    def mv_multi(self, U: jnp.ndarray) -> jnp.ndarray:
        """(k, n_bg) -> (k, n_fg)."""
        return (self._d_val[None] * U[:, self._d_idx]).sum(axis=1)

    def rmv_multi(self, R: jnp.ndarray) -> jnp.ndarray:
        """(k, n_fg) -> (k, n_bg)."""
        k = R.shape[0]
        data = (self._d_val[None] * R[:, None, :]).reshape(k, -1)
        padded = jnp.concatenate([jnp.zeros((k, 1), data.dtype), data], axis=1)
        return jnp.take(padded, self._t_gidx, axis=1).sum(axis=1)

    def row_blocks(self, eldofsT: jnp.ndarray):
        """Gather ELL planes for fg dof ids (ne, nE): (idx, val) each
        (kmax, ne, nE)."""
        return self._d_idx[:, eldofsT], self._d_val[:, eldofsT]

    # -- host-side export -------------------------------------------------------

    def to_scipy(self):
        """CSR copy for the host direct-solve path (MUMPS-role, SURVEY N5)."""
        import scipy.sparse as sp

        idx = self.idx_np
        val = self.val_np
        rows = np.repeat(np.arange(self.n_fg_dofs), idx.shape[1])
        mat = sp.coo_matrix(
            (val.ravel(), (rows, idx.ravel())),
            shape=(self.n_fg_dofs, self.n_bg_dofs),
        )
        return mat.tocsr()
