"""Gather-free lattice-binned Galerkin probe (the projection fast path).

The general stencil probe (StencilOperator2D.probe_multi over
BackgroundOperator.mv_multi) is XLA-gather-bound: every probe application
pays M-gathers, element-dof gathers, the assembly transpose-gather, and the
Mᵀ transpose-gather at ~34M indices/s — ~2.7 s of the 1M-dof bench.

This module removes every runtime gather from the probe for structured
lattice backgrounds (the reference's MORIS/XTK grids and our generators,
SURVEY.md §2.3 N8). At setup each foreground element is *binned* by a base
background cell — chosen as the min lattice corner over its extraction
targets. Because element diameters are below the background spacing (the
radius-2 stencil premise), every target of an element then sits at a static
offset δ ∈ {0..2}² from its base. All index structure becomes static
per-(slot, cell) tables:

  val_b  (ne, km, L, nc) f32/f64  extraction weight of contribution slot
  kappa  (ne, km, L, nc) int8     offset class 3·δi + δj  (0..8)
  phase  (ne, km, L, nc) int8     probe color (i mod 5)·5 + (j mod 5)
  perm   (L, nc)         int32    element id + 1 (0 = padding)

and the device-side probe is pure elementwise masked multiply-adds over
dense per-cell planes plus static shift-accumulation onto the lattice —
streaming at memory bandwidth. The only runtime indexed access is the single
(ne,ne,1)-slice gather binning the element Jacobian blocks.

The same tables serve dense (full-lattice) and compact (occupied-cell-list)
layouts; sparse-touch terms (interface facet integrals) use compact binning
with 9 unique-index scatters at the end.

Replaces the probe's use of the general path; the projected operator it
feeds (ops/stencil.py) and its consumers (multigrid, Krylov) are unchanged.
Reference role: the PtAP of la_utils.py:165-182 on lattice backgrounds.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


class LatticeBinError(ValueError):
    """Raised when a term cannot be lattice-binned (spilled elements)."""


@jax.tree_util.register_pytree_node_class
class LatticeBinnedTerm2D:
    """One form term's binned probe tables on an (nx1, ny1) lattice.

    Built on host from the term's flattened element dofs and the extraction
    operator; ``probe_y(K)`` then computes this term's contribution to
    Y[c] = (Mᵀ A_term M) x_c for all (2r+1)² probe combs x_c without gathers.
    """

    def __init__(self, val_b, kappa, phase, perm, shape, meta=None,
                 cells=None, val_lo=None, rows9=None, bbox=None):
        self.val_b = val_b          # (ne, km, L, nc)
        self.kappa = kappa          # (ne, km, L, nc) int8
        self.phase = phase          # (ne, km, L, nc) int8
        self.perm = perm            # (L, nc) int32, elem id + 1
        self.cells = cells          # None (dense) or (nc,) int32 cell ids
        self.val_lo = val_lo        # df mode: low f32 parts of the weights
        self.rows9 = rows9          # compact mode: (9, nc) int32 lattice rows
        self.shape = tuple(shape)
        self.meta = meta
        # dense mode: (bi0, bj0, bcx, bcy) bounding box of occupied cells
        # (static); slot grid is bbox-local, placement offsets by (bi0, bj0)
        if bbox is None and cells is None:
            bbox = (0, 0, shape[0] - 2, shape[1] - 2)
        self.bbox = bbox

    def tree_flatten(self):
        leaves = (self.val_b, self.kappa, self.phase, self.perm, self.cells,
                  self.val_lo, self.rows9)
        return leaves, (self.shape, self.meta, self.bbox)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        val_b, kappa, phase, perm, cells, val_lo, rows9 = leaves
        shape, meta, bbox = aux
        return cls(val_b, kappa, phase, perm, shape, meta, cells,
                   val_lo, rows9, bbox)

    # -- host construction ----------------------------------------------------

    @staticmethod
    def build(flat_eldofs: np.ndarray, M, shape, radius: int = 2,
              dtype=np.float32, compact: bool | None = None,
              df: bool = False) -> "LatticeBinnedTerm2D":
        """flat_eldofs: (nE, ne) foreground dof ids of the term's elements;
        M: ExtractionOperator (scalar field); shape: (nx1, ny1) lattice.

        compact: bin only occupied cells (auto when < 1/4 of cells touched).
        df: store weights as double-float (hi, lo) f32 pairs, enabling
        ~1e-14-accurate probing and operator application (ops/df.py).
        Raises LatticeBinError if any element's targets exceed the {0..2}²
        offset window (callers fall back to the general probe).
        """
        if radius != 2:
            raise LatticeBinError("lattice binning implemented for radius 2")
        nx1, ny1 = shape
        if M.n_bg_dofs != nx1 * ny1:
            raise LatticeBinError("extraction is not scalar on this lattice")
        eldofs = np.asarray(flat_eldofs, dtype=np.int64)   # (nE, ne)
        nE, ne = eldofs.shape
        idx = M.idx_np
        val = M.val_np
        km = idx.shape[1]
        tidx = idx[eldofs]                                 # (nE, ne, km)
        if df:
            dtype = np.float32
            tval64 = val[eldofs].astype(np.float64)
            tval = tval64.astype(np.float32)
            tval_lo = (tval64 - tval.astype(np.float64)).astype(np.float32)
        else:
            tval = val[eldofs].astype(dtype)
            tval_lo = None
        valid = tval != 0.0
        ti = tidx // ny1
        tj = tidx - ti * ny1
        big = np.int64(1) << 40
        bi = np.where(valid, ti, big).min(axis=(1, 2))
        bj = np.where(valid, tj, big).min(axis=(1, 2))
        has = valid.any(axis=(1, 2))
        bi = np.clip(bi, 0, max(nx1 - 3, 0))
        bj = np.clip(bj, 0, max(ny1 - 3, 0))
        di = ti - bi[:, None, None]
        dj = tj - bj[:, None, None]
        in_win = ((di >= 0) & (di <= 2) & (dj >= 0) & (dj <= 2)) | ~valid
        spilled = has & ~in_win.all(axis=(1, 2))
        if spilled.any():
            raise LatticeBinError(
                f"{int(spilled.sum())} elements exceed the lattice stencil "
                "window (foreground elements wider than the background "
                "spacing); use the general probe"
            )
        use = np.flatnonzero(has)
        ncx, ncy = nx1 - 2, ny1 - 2
        cell = (bi[use] * ncy + bj[use]).astype(np.int64)

        if compact is None:
            # compact (scattered cell list) only for genuinely sparse-touch
            # terms (facet integrals): its 9-scatter placement costs ~3x the
            # dense slice placement per color. Bulk terms use the
            # bbox-cropped dense layout below instead.
            compact = np.unique(cell).size < (ncx * ncy) // 4
        if compact:
            cells_occ, cell_c = np.unique(cell, return_inverse=True)
            nc = cells_occ.size
            cell = cell_c
            cells_arr = cells_occ.astype(np.int32)
            bbox = None
        else:
            # bbox-cropped dense layout: slot grid spans only the bounding
            # box of occupied cells — same gather/scatter-free slice
            # placement as full-dense, ~2x less memory and probe compute on
            # immersed subdomains (a rotated block touches ~1/3 of cells,
            # ~1/2 of the bbox)
            bi_u, bj_u = bi[use], bj[use]
            bi0 = int(bi_u.min()) if use.size else 0
            bj0 = int(bj_u.min()) if use.size else 0
            bcx = (int(bi_u.max()) - bi0 + 1) if use.size else 1
            bcy = (int(bj_u.max()) - bj0 + 1) if use.size else 1
            nc = bcx * bcy
            cell = ((bi_u - bi0) * bcy + (bj_u - bj0)).astype(np.int64)
            cells_arr = None
            bbox = (bi0, bj0, bcx, bcy)
        nc = max(nc, 1)

        counts = np.bincount(cell, minlength=nc)
        L = max(int(counts.max()) if counts.size else 0, 1)
        order = np.argsort(cell, kind="stable")
        cell_s = cell[order]
        starts = np.zeros(nc, dtype=np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        slot = np.arange(cell.size, dtype=np.int64) - starts[cell_s]

        perm = np.zeros((L, nc), dtype=np.int32)
        perm[slot, cell_s] = (use[order] + 1).astype(np.int32)

        val_t = np.zeros((ne, km, L, nc), dtype=dtype)
        kap_t = np.zeros((ne, km, L, nc), dtype=np.int8)
        pha_t = np.zeros((ne, km, L, nc), dtype=np.int8)
        src = use[order]
        # masked-out (invalid) entries keep val 0 -> contribute nothing
        val_t[:, :, slot, cell_s] = np.moveaxis(
            np.where(valid[src], tval[src], 0.0), 0, -1
        )
        kap_t[:, :, slot, cell_s] = np.moveaxis(
            (di[src] * 3 + dj[src]).astype(np.int8), 0, -1
        )
        pha_t[:, :, slot, cell_s] = np.moveaxis(
            ((ti[src] % 5) * 5 + tj[src] % 5).astype(np.int8), 0, -1
        )
        val_lo_t = None
        if df:
            val_lo_t = np.zeros((ne, km, L, nc), dtype=np.float32)
            val_lo_t[:, :, slot, cell_s] = np.moveaxis(
                np.where(valid[src], tval_lo[src], 0.0), 0, -1
            )
        rows9 = None
        if cells_arr is not None:
            base_i = cells_arr.astype(np.int64) // ncy
            base_j = cells_arr.astype(np.int64) - base_i * ncy
            rows9 = np.stack([
                (base_i + d // 3) * ny1 + base_j + d % 3 for d in range(9)
            ]).astype(np.int32)
        return LatticeBinnedTerm2D(
            jnp.asarray(val_t), jnp.asarray(kap_t), jnp.asarray(pha_t),
            jnp.asarray(perm), shape,
            meta=(ne, km, L, nc),
            cells=jnp.asarray(cells_arr) if cells_arr is not None else None,
            val_lo=jnp.asarray(val_lo_t) if val_lo_t is not None else None,
            rows9=jnp.asarray(rows9) if rows9 is not None else None,
            bbox=bbox,
        )

    # -- device probe ---------------------------------------------------------

    def bind_blocks(self, K: jnp.ndarray) -> jnp.ndarray:
        """Gather the element Jacobian blocks into binned (ne, ne, L, nc)
        layout — the single runtime gather of the fast path.

        The gather fetches CONTIGUOUS ne² rows (element axis major) and
        transposes afterwards: contiguous row gathers read whole rows, where
        strided (ne, ne, 1) slice gathers read scattered elements, and a
        transpose of the same volume is bandwidth-cheap."""
        ne = self.meta[0]
        L, nc = self.meta[2], self.meta[3]
        dt = self.val_b.dtype
        rows = K.astype(dt).reshape(ne * ne, -1).T       # (nE, ne²)
        rows = jnp.concatenate(
            [jnp.zeros((1, ne * ne), dt), rows], axis=0
        )
        out = rows[self.perm.reshape(-1)]                # (L·nc, ne²)
        return out.T.reshape(ne, ne, L, nc)

    def bind_blocks_df(self, K_hi: jnp.ndarray, K_lo: jnp.ndarray):
        """df variant: one packed contiguous-row gather for the (hi, lo)
        block pair (see bind_blocks for the layout rationale)."""
        ne = self.meta[0]
        L, nc = self.meta[2], self.meta[3]
        w = 2 * ne * ne
        rows = jnp.stack([K_hi, K_lo]).reshape(w, -1).T  # (nE, 2·ne²)
        rows = jnp.concatenate(
            [jnp.zeros((1, w), jnp.float32), rows], axis=0
        )
        out = rows[self.perm.reshape(-1)]                # (L·nc, 2·ne²)
        Kb = out.T.reshape(2, ne, ne, L, nc)
        return Kb[0], Kb[1]

    def probe_y(self, K: jnp.ndarray) -> jnp.ndarray:
        """This term's Y (25, nx1*ny1): projected operator applied to all 25
        phase-comb probe vectors. K: (ne, ne, nE) element Jacobian blocks.
        """
        return self.probe_y_bound(self.bind_blocks(K))

    def probe_y_bound(self, Kb: jnp.ndarray) -> jnp.ndarray:
        ne, km, L, nc = self.meta
        nx1, ny1 = self.shape
        ncx, ncy = nx1 - 2, ny1 - 2
        dt = self.val_b.dtype
        val_b, kappa, phase = self.val_b, self.kappa, self.phase

        def one_color(c):
            # xe[b] = (M x_c) at local dof b — phase-indicator contraction
            xe = [
                sum(
                    val_b[b, kb] * (phase[b, kb] == c).astype(dt)
                    for kb in range(km)
                )
                for b in range(ne)
            ]                                       # ne x (L, nc)
            # ye[a] = Σ_b K[a,b] xe[b]  (unrolled FMAs, no big intermediates)
            ye = [
                sum(Kb[a, b] * xe[b] for b in range(ne)) for a in range(ne)
            ]
            # acc[d] = Σ_{a,ka,l} val·ye·[κ==d]
            acc = [jnp.zeros((nc,), dt) for _ in range(9)]
            for a in range(ne):
                for ka in range(km):
                    V = val_b[a, ka] * ye[a]        # (L, nc)
                    kap = kappa[a, ka]
                    for d in range(9):
                        acc[d] = acc[d] + (
                            V * (kap == d).astype(dt)
                        ).sum(axis=0)
            return self._accumulate(acc, dt)

        return jax.lax.map(one_color, jnp.arange(25, dtype=jnp.int8))

    def _accumulate(self, acc, dt):
        """Place the 9 per-cell offset-class planes onto the lattice."""
        nx1, ny1 = self.shape
        if self.cells is None:
            bi0, bj0, bcx, bcy = self.bbox
            Y = jnp.zeros((nx1, ny1), dt)
            for d in range(9):
                di, dj = bi0 + d // 3, bj0 + d % 3
                Y = jax.lax.dynamic_update_slice(
                    Y,
                    jax.lax.dynamic_slice(Y, (di, dj), (bcx, bcy))
                    + acc[d].reshape(bcx, bcy),
                    (di, dj),
                )
            return Y.reshape(-1)
        Y = jnp.zeros(nx1 * ny1, dt)
        for d in range(9):
            Y = Y.at[self.rows9[d]].add(acc[d])  # unique within one class
        return Y

    # -- direct stencil assembly (no probe vectors) -----------------------------

    def stencil_planes_bound(self, Kb: jnp.ndarray, radius: int = 2,
                             slab_bytes: float = 1.0e9) -> jnp.ndarray:
        """Stencil coefficient planes (25, nx1, ny1) of Mᵀ A_term M, assembled
        DIRECTLY from the bound blocks — no probe vectors at all.

        The 25-color probe re-reads every slot table once per color and pays
        ne·km·(1+9) masked compare-FMAs per slot per color (~0.29 s of the 1M-
        dof bench, launch/compute bound at 3.7 GB/s effective). But the color
        machinery is redundant in the binned layout: ``kappa`` already says
        which lattice offset every weight targets, so the matrix entry
        A[base+δ(d1), base+δ(d2)] is just the window congruence
        G[n, d1, d2] = Σ_{l,a,b} E[a,d1]·Kb[a,b]·E[b,d2] with
        E[b,d] = Σ_kb val_b[b,kb]·[kappa==d] — one pass over the tables, two
        batched small dot_generals, and 81 static slice/scatter placements at
        offset δ(d2)−δ(d1). Same math as cell_window.window_planes, on the
        binned df tables that fit HBM at the 2D headline size.

        Dense (bbox) terms stream bbox x-row slabs through a lax.scan so the
        (ne, 9, L, nc) E tensor is never materialized; compact (facet) terms
        assemble in one shot and place via the 9 unique-row scatter classes.
        Kb: (ne, ne, L, nc) bound element blocks (hi part in df mode).
        """
        if radius != 2:
            raise LatticeBinError("stencil assembly implemented for radius 2")
        ne, km, L, nc = self.meta
        nx1, ny1 = self.shape
        m = 2 * radius + 1
        dt = Kb.dtype

        def congruence(lo, n_sl):
            # Returns a list g[d1*9+d2] of (n_sl,) planes. All intermediates
            # keep the slot axis minormost and the tiny (ne, 9) contractions
            # unrolled into plane FMAs: a dot_general over (L, n_sl, ne, 9)
            # operands would put the tiny (ne, 9) axes minormost, whose
            # tiled layouts padded the 1M-dof headline out of device memory.
            val = jax.lax.dynamic_slice_in_dim(self.val_b, lo, n_sl, 3)
            kap = jax.lax.dynamic_slice_in_dim(self.kappa, lo, n_sl, 3)
            Kc = jax.lax.dynamic_slice_in_dim(Kb, lo, n_sl, 3)
            E = [[None] * 9 for _ in range(ne)]          # E[b][d]: (L, n_sl)
            for b in range(ne):
                for d in range(9):
                    acc = jnp.zeros((L, n_sl), dt)
                    for kb in range(km):
                        acc = acc + val[b, kb] * (kap[b, kb] == d).astype(dt)
                    E[b][d] = acc
            out = [None] * 81
            for d2 in range(9):
                T = []                                   # T[a] = Σ_b K[a,b]·E[b][d2]
                for a in range(ne):
                    t = Kc[a, 0] * E[0][d2]
                    for b in range(1, ne):
                        t = t + Kc[a, b] * E[b][d2]
                    T.append(t)
                for d1 in range(9):
                    g = E[0][d1] * T[0]
                    for a in range(1, ne):
                        g = g + E[a][d1] * T[a]
                    out[d1 * 9 + d2] = jnp.sum(g, axis=0)
            return out

        if self.cells is not None:
            # compact: one congruence pass, scatter placement per row class
            G = congruence(0, nc)
            planes = jnp.zeros((m * m, nx1 * ny1), dt)
            for d1 in range(9):
                rows = self.rows9[d1]                    # unique within class
                for d2 in range(9):
                    oi = d2 // 3 - d1 // 3
                    oj = d2 % 3 - d1 % 3
                    k = (oi + radius) * m + (oj + radius)
                    planes = planes.at[k, rows].add(G[d1 * 9 + d2])
            return planes.reshape(m * m, nx1, ny1)

        bi0, bj0, bcx, bcy = self.bbox
        # slab budget: E planes (ne·9, dt-sized, (L, slot)) + val (ne·km)
        # + kap (int8) + Kb slice (ne²) + G output (81 slot-planes, no L
        # axis). Element size from the working dtype (ADVICE r4: the
        # hardcoded 4 made per_x ~2x optimistic for f64 tables).
        esz = dt.itemsize
        per_x = bcy * (
            L * (esz * (ne * 9 + ne + ne * km + ne * ne) + ne * km)
            + esz * 81
        )
        slab = max(1, min(int(slab_bytes // max(per_x, 1)), bcx))

        def slab_contrib(planes, r0, n_x):
            G = congruence(r0 * bcy, n_x * bcy)
            for d1 in range(9):
                for d2 in range(9):
                    oi = d2 // 3 - d1 // 3
                    oj = d2 % 3 - d1 % 3
                    k = (oi + radius) * m + (oj + radius)
                    at = (k, bi0 + d1 // 3 + r0, bj0 + d1 % 3)
                    cur = jax.lax.dynamic_slice(planes, at, (1, n_x, bcy))
                    planes = jax.lax.dynamic_update_slice(
                        planes,
                        cur + G[d1 * 9 + d2].reshape(1, n_x, bcy),
                        at,
                    )
            return planes

        planes = jnp.zeros((m * m, nx1, ny1), dt)
        n_full = bcx // slab
        if n_full:
            def body(p, i):
                return slab_contrib(p, i * slab, slab), None

            planes, _ = jax.lax.scan(
                body, planes, jnp.arange(n_full), unroll=1
            )
        tail = bcx - n_full * slab
        if tail:
            planes = slab_contrib(planes, n_full * slab, tail)
        return planes

    # -- static data binding + rhs projection ----------------------------------

    def bind_static(self, arr: np.ndarray) -> np.ndarray:
        """Host-side: bind static per-element data (..., nE) into the padded
        (..., L, nc) slot layout (padding slots = 0).

        For quadrature-point data known at setup (w·f(x_q), w·g(x_q),
        geometry contractions), so the runtime rhs path has no gathers at
        all — the static analog of bind_blocks."""
        a = np.asarray(arr)
        pad = np.zeros(a.shape[:-1] + (1,), a.dtype)
        perm = np.asarray(self.perm)
        return np.concatenate([pad, a], axis=-1)[..., perm]

    def project_rhs_df(self, r_el_df):
        """y = Mᵀ_term r: accumulate bound df element residual vectors
        (ne, L, nc) onto the lattice, gather-free. Returns a df pair.

        The la_utils.py:143-163 AT_x role for the rhs, fused with the
        fg-dof scatter: contributions go straight from element slots to
        background lattice nodes through the val_b/kappa tables (the last
        accumulation stage of apply_df with ye ← r_el)."""
        from iifea.ops import df as dfm

        ne, km, L, nc = self.meta
        nx1, ny1 = self.shape
        ncx, ncy = nx1 - 2, ny1 - 2
        r_hi, r_lo = r_el_df
        val_hi, val_lo = self.val_b, self.val_lo
        kappa = self.kappa
        f32 = jnp.float32

        out = [(jnp.zeros((nc,), f32), jnp.zeros((nc,), f32))
               for _ in range(9)]
        for a in range(ne):
            for ka in range(km):
                V = dfm.df_mul(
                    (val_hi[a, ka], val_lo[a, ka]), (r_hi[a], r_lo[a])
                )
                kap = kappa[a, ka]
                for d in range(9):
                    m = (kap == d).astype(f32)
                    out[d] = dfm.df_add(
                        out[d], dfm.df_sum((V[0] * m, V[1] * m), 0)
                    )
        if self.cells is None:
            bi0, bj0, bcx, bcy = self.bbox
            Yh = jnp.zeros((nx1, ny1), f32)
            Yl = jnp.zeros((nx1, ny1), f32)
            for d in range(9):
                di, dj = bi0 + d // 3, bj0 + d % 3
                cur = (
                    jax.lax.dynamic_slice(Yh, (di, dj), (bcx, bcy)),
                    jax.lax.dynamic_slice(Yl, (di, dj), (bcx, bcy)),
                )
                new = dfm.df_add(cur, (out[d][0].reshape(bcx, bcy),
                                       out[d][1].reshape(bcx, bcy)))
                Yh = jax.lax.dynamic_update_slice(Yh, new[0], (di, dj))
                Yl = jax.lax.dynamic_update_slice(Yl, new[1], (di, dj))
            return Yh.reshape(-1), Yl.reshape(-1)
        Yh = jnp.zeros(nx1 * ny1, f32)
        Yl = jnp.zeros(nx1 * ny1, f32)
        for d in range(9):
            rows = self.rows9[d]
            cur = (Yh[rows], Yl[rows])
            new = dfm.df_add(cur, out[d])
            Yh = Yh.at[rows].set(new[0])
            Yl = Yl.at[rows].set(new[1])
        return Yh, Yl

    # -- double-float operator application ------------------------------------

    def apply_df(self, Kb_df, x_df):
        """y += (Mᵀ A_term M) x in double-float, gather-free (dense mode) or
        with one small row gather (compact mode).

        Kb_df: bound (hi, lo) blocks from bind_blocks_df; x_df: (hi, lo)
        lattice vectors of length nx1*ny1. Returns a df pair. Used for
        ~1e-14-accurate iterative-refinement residuals from f32 tables
        (SURVEY.md §7 f64 risk item).
        """
        from iifea.ops import df as dfm

        ne, km, L, nc = self.meta
        nx1, ny1 = self.shape
        ncx, ncy = nx1 - 2, ny1 - 2
        K_hi, K_lo = Kb_df
        val_hi, val_lo = self.val_b, self.val_lo
        kappa = self.kappa
        x2h = x_df[0].reshape(nx1, ny1)
        x2l = x_df[1].reshape(nx1, ny1)

        # per-class source planes xs[δ] (nc,)
        xs = []
        for d in range(9):
            if self.cells is None:
                bi0, bj0, bcx, bcy = self.bbox
                di, dj = bi0 + d // 3, bj0 + d % 3
                xs.append((
                    jax.lax.dynamic_slice(x2h, (di, dj), (bcx, bcy)).reshape(-1),
                    jax.lax.dynamic_slice(x2l, (di, dj), (bcx, bcy)).reshape(-1),
                ))
            else:
                rows = self.rows9[d]
                xs.append((x_df[0][rows], x_df[1][rows]))

        f32 = jnp.float32

        def sel(kap):
            """Σ_δ [κ==δ]·xs[δ] — the (data-dependent) source value, df."""
            sh = jnp.zeros((L, nc), f32)
            sl = jnp.zeros((L, nc), f32)
            for d in range(9):
                m = (kap == d).astype(f32)
                sh = sh + m * xs[d][0][None, :]
                sl = sl + m * xs[d][1][None, :]
            return sh, sl

        # xe[b] = Σ_kb val[b,kb]·x[target]  (df)
        xe = []
        for b in range(ne):
            acc = (jnp.zeros((L, nc), f32), jnp.zeros((L, nc), f32))
            for kb in range(km):
                v = (val_hi[b, kb], val_lo[b, kb])
                acc = dfm.df_add(acc, dfm.df_mul(v, sel(kappa[b, kb])))
            xe.append(acc)
        # ye[a] = Σ_b K[a,b]·xe[b]  (df)
        ye = []
        for a in range(ne):
            acc = (jnp.zeros((L, nc), f32), jnp.zeros((L, nc), f32))
            for b in range(ne):
                acc = dfm.df_add(
                    acc, dfm.df_mul((K_hi[a, b], K_lo[a, b]), xe[b])
                )
            ye.append(acc)
        # acc[δ] = Σ_{a,ka} Σ_L val[a,ka]·ye[a]·[κ==δ]  (df)
        out = [(jnp.zeros((nc,), f32), jnp.zeros((nc,), f32))
               for _ in range(9)]
        for a in range(ne):
            for ka in range(km):
                V = dfm.df_mul((val_hi[a, ka], val_lo[a, ka]), ye[a])
                kap = kappa[a, ka]
                for d in range(9):
                    m = (kap == d).astype(f32)
                    out[d] = dfm.df_add(
                        out[d], dfm.df_sum((V[0] * m, V[1] * m), 0)
                    )
        # place on the lattice
        from iifea.ops.df import df_add as _dfadd
        if self.cells is None:
            bi0, bj0, bcx, bcy = self.bbox
            Yh = jnp.zeros((nx1, ny1), f32)
            Yl = jnp.zeros((nx1, ny1), f32)
            for d in range(9):
                di, dj = bi0 + d // 3, bj0 + d % 3
                cur = (
                    jax.lax.dynamic_slice(Yh, (di, dj), (bcx, bcy)),
                    jax.lax.dynamic_slice(Yl, (di, dj), (bcx, bcy)),
                )
                new = _dfadd(cur, (out[d][0].reshape(bcx, bcy),
                                   out[d][1].reshape(bcx, bcy)))
                Yh = jax.lax.dynamic_update_slice(Yh, new[0], (di, dj))
                Yl = jax.lax.dynamic_update_slice(Yl, new[1], (di, dj))
            return Yh.reshape(-1), Yl.reshape(-1)
        Yh = jnp.zeros(nx1 * ny1, f32)
        Yl = jnp.zeros(nx1 * ny1, f32)
        for d in range(9):
            rows = self.rows9[d]             # unique within one class
            cur = (Yh[rows], Yl[rows])
            new = _dfadd(cur, out[d])
            Yh = Yh.at[rows].set(new[0])
            Yl = Yl.at[rows].set(new[1])
        return Yh, Yl


def build_binned_projection(form, M, shape, radius: int = 2,
                            dtype=np.float32,
                            df: bool = False) -> list[LatticeBinnedTerm2D]:
    """Binned probe tables for every term of a form (host, setup-time).

    Terms touching few cells (facet integrals) get compact binning. Raises
    LatticeBinError if any term cannot be binned — callers fall back to the
    general StencilOperator2D.probe_multi path.
    """
    if form.n_fields != 1:
        raise LatticeBinError("lattice binning covers scalar fields")
    reducers = []
    for dom, _ in form.terms:
        fl = getattr(dom, "flat_eldofs_np", None)
        if fl is None:
            fl = np.asarray(dom.eldofsT).T
        reducers.append(
            LatticeBinnedTerm2D.build(fl, M, shape, radius, dtype=dtype,
                                      df=df)
        )
    return reducers


def probe_y_binned(reducers, blocks) -> jnp.ndarray:
    """Y (25, n) = A_b applied to the 25 probe combs, summed over terms."""
    Y = reducers[0].probe_y(blocks[0])
    for red, K in zip(reducers[1:], blocks[1:]):
        Y = Y + red.probe_y(K)
    return Y


# -- double-float pipeline (bind once, probe + apply many) --------------------


def split_blocks_df(blocks64):
    """Per-term f64 element blocks -> (hi, lo) f32 pairs."""
    from iifea.ops import df as dfm

    return [dfm.df_from_f64(K) for K in blocks64]


def bind_blocks_df_binned(reducers, blocks_df):
    """One packed binning gather per term; reused by probe and applies."""
    return [
        red.bind_blocks_df(hi, lo)
        for red, (hi, lo) in zip(reducers, blocks_df)
    ]


def probe_y_binned_bound(reducers, bound) -> jnp.ndarray:
    """f32 probe from the hi parts of bound df blocks."""
    Y = reducers[0].probe_y_bound(bound[0][0])
    for red, Kb in zip(reducers[1:], bound[1:]):
        Y = Y + red.probe_y_bound(Kb[0])
    return Y


def stencil_planes_binned_bound(reducers, bound) -> jnp.ndarray:
    """Direct stencil planes (25, nx1, ny1) from bound df blocks (hi parts),
    summed over terms — the probe-free replacement for
    from_probe_y(probe_y_binned_bound(...))."""
    C = reducers[0].stencil_planes_bound(bound[0][0])
    for red, Kb in zip(reducers[1:], bound[1:]):
        C = C + red.stencil_planes_bound(Kb[0])
    return C


def stencil_planes_binned(reducers, blocks) -> jnp.ndarray:
    """Direct stencil planes from compact per-term element blocks (binds,
    then assembles) — the probe-free replacement for
    from_probe_y(probe_y_binned(...))."""
    C = reducers[0].stencil_planes_bound(
        reducers[0].bind_blocks(blocks[0])
    )
    for red, K in zip(reducers[1:], blocks[1:]):
        C = C + red.stencil_planes_bound(red.bind_blocks(K))
    return C


def project_rhs_df_binned(reducers, r_el_dfs):
    """b = Σ_terms Mᵀ_term(r_el) in double-float, gather-free."""
    from iifea.ops import df as dfm

    y = reducers[0].project_rhs_df(r_el_dfs[0])
    for red, r in zip(reducers[1:], r_el_dfs[1:]):
        y = dfm.df_add(y, red.project_rhs_df(r))
    return y


def apply_df_binned(reducers, bound, x_df):
    """y = A_b x in double-float (~1e-14 relative), summed over terms."""
    from iifea.ops import df as dfm

    y = reducers[0].apply_df(bound[0], x_df)
    for red, Kb in zip(reducers[1:], bound[1:]):
        y = dfm.df_add(y, red.apply_df(Kb, x_df))
    return y
