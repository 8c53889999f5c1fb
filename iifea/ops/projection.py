"""Galerkin projection onto the background basis: A_b = Mᵀ A_f M.

The reference materializes the projected matrix with two PETSc MatMatMults
(AT_R_A, la_utils.py:165-182). On the device the product path is
matrix-free:
``A_b x = Mᵀ(A_f(M x))`` composed from the extraction ELL ops and the batched
element-block matvec — three bandwidth-bound, shape-static device passes.

What still needs explicit structure:
* the diagonal of A_b (Jacobi preconditioning, BFR trimming — common.py:207-332):
  computed exactly on device, per element block, chunked to bound memory;
* the full A_b in CSR on host for the sparse direct path (the 'mumps' role,
  common.py:525-551): exported once via scipy's sparse triple product.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from iifea.ops.assembly import Form
from iifea.ops.extraction import ExtractionOperator


class BackgroundOperator:
    """The linearized background operator dR_b (optionally BFR-trimmed).

    With a trim mask t (basis-function removal, trimNodes common.py:261-332),
    application reproduces PETSc ``zeroRows``: trimmed rows become identity
    rows, other rows keep their (untrimmed) column entries.

    ``shift`` (a (n_bg,) vector) applies the operator A + diag(shift) —
    the pseudo-transient-continuation regularization of solve_nonlinear
    (a capability the reference lacks; its only Newton rescue is
    relax_param, common.py:474). Trim overrides shift on trimmed rows.
    """

    def __init__(
        self,
        form: Form,
        blocks: list[jnp.ndarray],
        M: ExtractionOperator,
        trim_mask: jnp.ndarray | None = None,
        shift: jnp.ndarray | None = None,
    ):
        self.form = form
        self.blocks = blocks
        self.M = M
        self.n = M.n_bg_dofs
        self.trim_mask = trim_mask
        self.shift = shift

    def mv(self, x: jnp.ndarray) -> jnp.ndarray:
        y = self.M.rmv(self.form.matvec(self.blocks, self.M.mv(x)))
        if self.shift is not None:
            y = y + self.shift * x
        if self.trim_mask is not None:
            y = jnp.where(self.trim_mask, x, y)
        return y

    def mv_t(self, x: jnp.ndarray) -> jnp.ndarray:
        """Transpose application (Golub-Kahan condition estimation).

        With trimming, the transpose of row-substitution zeroes the trimmed
        *columns* of Aᵀ and keeps unit diagonals.
        """
        xi = x if self.trim_mask is None else jnp.where(self.trim_mask, 0.0, x)
        y = self.M.rmv(self.form.matvec_t(self.blocks, self.M.mv(xi)))
        if self.shift is not None:
            y = y + self.shift * xi
        if self.trim_mask is not None:
            y = y + jnp.where(self.trim_mask, x, 0.0)
        return y

    def _stacked_copy_bytes(self, k: int) -> int:
        """Worst-case padded transpose copy the stacked multi-apply can
        force. XLA may lower the batched axis-1 gathers of
        rmv_multi/scatter_into_multi by materializing the operand
        TRANSPOSED, (flat_len, k), with the minor k axis tile-padded to 128
        — a x(128/k) blowup, bounded here conservatively."""
        itemsize = self.blocks[0].dtype.itemsize if self.blocks else 4
        flat = int(np.prod(self.M._d_idx.shape))     # kmax * n_fg
        for (dom, _) in self.form.terms:
            ne, nE = dom.eldofsT.shape
            flat = max(flat, ne * nE)
        return flat * max(k, 128) * itemsize

    def mv_multi(self, X: jnp.ndarray) -> jnp.ndarray:
        """Multi-RHS application, stacked (k, n_bg): amortizes gather latency
        while keeping the dof axis minormost.

        Above IIFEA_MULTI_TEMP_MB (default 2048) of worst-case padded copy
        (see _stacked_copy_bytes) the columns run through a sequential
        lax.map of single applies instead — 1-D gathers, no batched
        transpose copies."""
        import os

        k = X.shape[0]
        budget = float(os.environ.get("IIFEA_MULTI_TEMP_MB", 2048)) * 2 ** 20
        if k > 1 and self._stacked_copy_bytes(k) > budget:
            return jax.lax.map(self.mv, X)
        Y = self.M.rmv_multi(
            self.form.matvec_multi(self.blocks, self.M.mv_multi(X))
        )
        if self.shift is not None:
            Y = Y + self.shift[None, :] * X
        if self.trim_mask is not None:
            Y = jnp.where(self.trim_mask[None, :], X, Y)
        return Y

    def with_trim(self, mask) -> "BackgroundOperator":
        return BackgroundOperator(self.form, self.blocks, self.M, mask,
                                  self.shift)

    def with_shift(self, shift) -> "BackgroundOperator":
        """A + diag(shift) (PTC regularization; see class docstring)."""
        return BackgroundOperator(self.form, self.blocks, self.M,
                                  self.trim_mask, shift)

    def tree_flatten(self):
        return (self.form, self.blocks, self.M, self.trim_mask,
                self.shift), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        form, blocks, M, trim_mask, shift = children
        obj = object.__new__(cls)
        obj.form, obj.blocks, obj.M, obj.trim_mask = form, blocks, M, trim_mask
        obj.shift = shift
        obj.n = M.n_bg_dofs
        return obj

    # -- exact diagonal -------------------------------------------------------

    def diag(self, chunk: int = 65536) -> jnp.ndarray:
        """diag(Mᵀ A_f M), exact, computed block-wise on device.

        For an element block K (ne, ne) with extraction rows (idx, val) of its
        dofs ((ne, km) each), the contribution to diag[j] is
        sum_{a,ka,b,kb} val[a,ka] K[a,b] val[b,kb] [idx[a,ka]=j][idx[b,kb]=j].
        """
        d = jnp.zeros(self.n, dtype=self.blocks[0].dtype)
        for (dom, _), K in zip(self.form.terms, self.blocks):
            if dom.n_elem == 0:
                continue
            midx, mval = self.M.row_blocks(dom.eldofsT)   # (km, ne, nE)
            nE = K.shape[-1]
            csize = max(min(chunk, nE), 1)
            # zero-pad (not edge-replicate): padded elements must contribute 0
            pad = (-nE) % csize

            def prep(a):
                if pad:
                    z = jnp.zeros(a.shape[:-1] + (pad,), a.dtype)
                    a = jnp.concatenate([a, z], axis=-1)
                a = a.reshape(a.shape[:-1] + ((nE + pad) // csize, csize))
                return jnp.moveaxis(a, -2, 0)

            Kc_all, ic_all, vc_all = prep(K), prep(midx), prep(mval)

            def body(acc, args):
                Kc, ic, vc = args
                eq = ic[:, :, None, None, :] == ic[None, None, :, :, :]
                # T[K,a,E] = val[K,a] * Σ_{L,b} K[a,b] val[L,b] [idx equal]
                T = jnp.einsum(
                    "abE,KaLbE,LbE->KaE", Kc, eq.astype(Kc.dtype), vc
                ) * vc
                acc = acc + jax.ops.segment_sum(
                    T.reshape(-1), ic.reshape(-1), num_segments=self.n
                )
                return acc, None

            partial, _ = jax.lax.scan(
                body, jnp.zeros(self.n, K.dtype), (Kc_all, ic_all, vc_all)
            )
            d = d + partial
        if self.shift is not None:
            d = d + self.shift
        if self.trim_mask is not None:
            d = jnp.where(self.trim_mask, 1.0, d)
        return d

    def block_diag(self, n_fields: int, chunk: int = 65536) -> jnp.ndarray:
        """Per-node (nf, nf) diagonal blocks of Mᵀ A_f M, exact.

        Background dofs are field-blocked (dof = node + field*m, the
        reference's layout — common.py:703), so the block at node j collects
        the entries A_b[j + fa*m, j + fb*m]. Same element-block reduction as
        ``diag`` with the dof-equality test split into node equality plus a
        field mask pair — nf² passes over the diag() einsum, paid once at
        preconditioner setup (PCBJACOBI role, common.py:568-616).

        Returns (m, nf, nf) with m = n_bg_dofs // n_fields. Trimmed dofs get
        identity rows in their node's block (zeroRows parity).
        """
        nf = int(n_fields)
        assert self.n % nf == 0, (self.n, nf)
        m = self.n // nf
        dtype = self.blocks[0].dtype
        out = jnp.zeros((nf, nf, m), dtype=dtype)
        for (dom, _), K in zip(self.form.terms, self.blocks):
            if dom.n_elem == 0:
                continue
            midx, mval = self.M.row_blocks(dom.eldofsT)   # (km, ne, nE)
            nE = K.shape[-1]
            csize = max(min(chunk, nE), 1)
            pad = (-nE) % csize

            def prep(a):
                if pad:
                    z = jnp.zeros(a.shape[:-1] + (pad,), a.dtype)
                    a = jnp.concatenate([a, z], axis=-1)
                a = a.reshape(a.shape[:-1] + ((nE + pad) // csize, csize))
                return jnp.moveaxis(a, -2, 0)

            Kc_all, ic_all, vc_all = prep(K), prep(midx), prep(mval)

            def body(acc, args):
                Kc, ic, vc = args
                node = ic % m
                fld = ic // m
                eqn = node[:, :, None, None, :] == node[None, None, :, :, :]
                for fa in range(nf):
                    va = jnp.where(fld == fa, vc, 0.0)
                    for fb in range(nf):
                        vb = jnp.where(fld == fb, vc, 0.0)
                        T = jnp.einsum(
                            "abE,KaLbE,LbE->KaE",
                            Kc, eqn.astype(Kc.dtype), vb,
                        ) * va
                        acc = acc.at[fa, fb].add(jax.ops.segment_sum(
                            T.reshape(-1), node.reshape(-1), num_segments=m
                        ))
                return acc, None

            partial, _ = jax.lax.scan(
                body, jnp.zeros((nf, nf, m), K.dtype), (Kc_all, ic_all, vc_all)
            )
            out = out + partial
        blocks = jnp.moveaxis(out, -1, 0)                  # (m, nf, nf)
        if self.shift is not None:
            sh = self.shift.reshape(nf, m).T               # (m, nf)
            blocks = blocks + sh[:, :, None] * jnp.eye(nf, dtype=dtype)
        if self.trim_mask is not None:
            tm = self.trim_mask.reshape(nf, m)             # [field, node]
            eye = jnp.eye(nf, dtype=dtype)
            # trimmed (node, field) rows become identity rows of the block
            blocks = jnp.where(
                tm.T[:, :, None], eye[None, :, :], blocks
            )
        return blocks

    # -- explicit export (direct-solver path) ---------------------------------

    def to_scipy(self):
        """Explicit A_b as scipy CSR via Mᵀ A_f M (host; the PtAP of
        la_utils.py:165-182). Used by the sparse-LU 'direct' solver."""
        import scipy.sparse as sp

        n_fg = self.form.n_dofs
        mats = []
        for (dom, _), K in zip(self.form.terms, self.blocks):
            if dom.n_elem == 0:
                continue
            fl = getattr(dom, "flat_eldofs_np", None)
            if fl is None:
                fl = np.asarray(dom.eldofsT).T
            ne = fl.shape[1]
            rows = np.repeat(fl, ne, axis=1).ravel()
            cols = np.tile(fl, (1, ne)).ravel()
            Kel = np.moveaxis(np.asarray(K), -1, 0)      # (nE, ne, ne)
            mats.append(
                sp.coo_matrix(
                    (Kel.ravel(), (rows, cols)), shape=(n_fg, n_fg)
                )
            )
        A_f = sum(mats[1:], mats[0]).tocsr()
        Msp = self.M.to_scipy()
        A_b = (Msp.T @ A_f @ Msp).tocsr()
        if self.shift is not None:
            A_b = (A_b + sp.diags(np.asarray(self.shift))).tocsr()
        if self.trim_mask is not None:
            mask = np.asarray(self.trim_mask)
            A_b = _zero_rows_scipy(A_b, np.where(mask)[0])
        return A_b


jax.tree_util.register_pytree_node_class(BackgroundOperator)


def _zero_rows_scipy(A, rows):
    """PETSc MatZeroRows semantics: zero the rows, put 1 on the diagonal."""
    import scipy.sparse as sp

    A = A.tolil()
    for r in rows:
        A.rows[r] = [int(r)]
        A.data[r] = [1.0]
    return A.tocsr()


def assemble_background_system(
    form: Form,
    u_f: jnp.ndarray,
    M: ExtractionOperator,
    aux=None,
    params=None,
    rhs_sign: float = -1.0,
):
    """assembleLinearSystemBackground parity (common.py:142-163).

    Returns (A_b operator, b_b) for the linearization around ``u_f``:
    A_b = Mᵀ (dR/du) M, b_b = Mᵀ (rhs_sign * R(u_f)). Demos use rhs_sign=-1
    (solve J du = -R) or +1 inside Newton (J du = R, update u -= du), matching
    the reference call sites (poisson.py:203, common.py:435).
    """
    blocks = form.jacobian_blocks(u_f, aux, params)
    res = form.residual(u_f, aux, params)
    A = BackgroundOperator(form, blocks, M)
    b = M.rmv(rhs_sign * res)
    return A, b
