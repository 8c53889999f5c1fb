"""Cell-window Galerkin projection: the dimension-generic gather-free probe.

The 2D fast path (ops/lattice_bin.py) recovers the projected stencil by
masked color probing: 25 probe colors x 9 offset-class masks. That approach
does not survive 3D — 125 colors x 27 classes is ~15x the arithmetic and
~40x the memory traffic per slot — so this module replaces color probing
with direct *per-cell window assembly*:

Every foreground element binned to background cell c touches only the
3^dim lattice nodes of the {0..2}^dim window anchored at c (the radius-2
premise, as in lattice_bin). Collect the element's extraction rows into a
static local matrix E_l in R^{ne x w} (w = 3^dim) and the projected
operator's restriction to the window is

    G_c = Σ_{l in cell c}  E_lᵀ K_l E_l          (w x w per cell)

— a batched congruence transform that runs as matrix products (two batched
dot_generals contracting ne and L·ne), with zero gathers and zero masked
color passes. The stencil coefficients fall out by static placement:
row class d1, column class d2 contribute C[δ(d2) − δ(d1)] at lattice rows
(bbox + δ(d1)), i.e. w² shifted slice-accumulations of cell-plane arrays.

Cost at equal slot count: the masked 2D probe reads every table plane
(classes x colors)/(table width) ~ 25x; the window form reads E and the
bound blocks O(1) times and pushes the w² work through batched matrix
products — in 3D over 30x fewer bytes read per probe.

The double-float residual/rhs paths reuse the lattice_bin design (per-class
shifted slices + elementwise df arithmetic), generalized to w classes.

Reference role: the PtAP of la_utils.py:165-182 (explicit background
assembly) on lattice backgrounds, and the AT_x rhs projection of
la_utils.py:143-163 — for any spatial dimension.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from iifea.ops.lattice_bin import LatticeBinError


def _class_offsets(dim: int) -> np.ndarray:
    """(w, dim) int offsets of window class k (mixed-radix base 3)."""
    w = 3**dim
    ks = np.arange(w)
    out = np.zeros((w, dim), dtype=np.int64)
    for d in range(dim - 1, -1, -1):
        out[:, d] = ks % 3
        ks = ks // 3
    return out


@jax.tree_util.register_pytree_node_class
class CellWindowTerm:
    """One form term's binned window tables on an n-D lattice.

    Tables (same layout family as lattice_bin.LatticeBinnedTerm2D, minus the
    probe-color table, which window assembly does not need):

      val_b  (ne, km, L, nc) f32   extraction weight of contribution slot
      kappa  (ne, km, L, nc) int8  window class Σ δ_d·3^(dim-1-d), δ ∈ {0..2}
      perm   (L, nc)         int32 element id + 1 (0 = padding)
      val_lo (ne, km, L, nc) f32   df mode: low parts of the f64 weights

    Cells use the bbox-cropped dense layout: nc = Π bbox_sizes, cell index
    row-major within the bbox; placement is by static shifted slices.
    """

    def __init__(self, val_b, kappa, perm, shape, meta=None, val_lo=None,
                 bbox=None, spill=None):
        self.val_b = val_b
        self.kappa = kappa
        self.perm = perm
        self.val_lo = val_lo
        self.shape = tuple(shape)
        self.meta = meta                 # (ne, km, L, nc)
        self.bbox = bbox                 # (starts tuple, sizes tuple)
        self.spill = spill               # CompactWindowTerm | None (l_cap)

    @property
    def dim(self) -> int:
        return len(self.shape)

    @property
    def w(self) -> int:
        return 3 ** self.dim

    def tree_flatten(self):
        return (self.val_b, self.kappa, self.perm, self.val_lo,
                self.spill), (self.shape, self.meta, self.bbox)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        val_b, kappa, perm, val_lo, spill = leaves
        shape, meta, bbox = aux
        return cls(val_b, kappa, perm, shape, meta, val_lo, bbox, spill)

    # -- host construction ----------------------------------------------------

    @staticmethod
    def build(flat_eldofs: np.ndarray, M, shape, radius: int = 2,
              dtype=np.float32, df: bool = False,
              l_cap=None) -> "CellWindowTerm":
        """flat_eldofs: (nE, ne) foreground dof ids of the term's elements;
        M: scalar ExtractionOperator; shape: lattice (n1+1, ..., nd+1).

        Raises LatticeBinError if any element's extraction targets exceed
        the {0..2}^dim window (elements wider than the background spacing).

        ``l_cap``: cap the dense slot depth; overflow slots spill into a
        CompactWindowTerm (probe-only). The min-corner anchoring is heavily
        skewed — measured p50=6 / p99=24 / max=48 occupancy at the 3D
        1M-dof bench — so the dense (ne, km, L, nc) tables at L=max pay
        ~2x the HBM of L=p99 for <1% of the slots. 'auto' picks the 99th
        occupancy percentile. None (default) keeps one exact dense table
        (required by the df apply/project paths, which do not see spills).
        """
        if radius != 2:
            raise LatticeBinError("cell-window binning implemented for radius 2")
        shape = tuple(int(s) for s in shape)
        dim = len(shape)
        if M.n_bg_dofs != int(np.prod(shape)):
            raise LatticeBinError("extraction is not scalar on this lattice")
        eldofs = np.asarray(flat_eldofs, dtype=np.int64)     # (nE, ne)
        nE, ne = eldofs.shape
        idx = M.idx_np
        val = M.val_np
        km = idx.shape[1]
        tidx = idx[eldofs]                                   # (nE, ne, km)
        if df:
            dtype = np.float32
            tval64 = val[eldofs].astype(np.float64)
            tval = tval64.astype(np.float32)
            tval_lo = (tval64 - tval.astype(np.float64)).astype(np.float32)
        else:
            tval = val[eldofs].astype(dtype)
            tval_lo = None
        valid = tval != 0.0

        # decompose flat node ids into lattice coordinates (row-major)
        coords = []
        rem = tidx
        for d in range(dim - 1, 0, -1):
            coords.append(rem % shape[d])
            rem = rem // shape[d]
        coords.append(rem)
        coords = coords[::-1]                                # dim x (nE, ne, km)

        big = np.int64(1) << 40
        base = []
        for d in range(dim):
            bd = np.where(valid, coords[d], big).min(axis=(1, 2))
            bd = np.clip(bd, 0, max(shape[d] - 3, 0))
            base.append(bd)
        has = valid.any(axis=(1, 2))
        deltas = [coords[d] - base[d][:, None, None] for d in range(dim)]
        in_win = np.ones_like(valid)
        for d in range(dim):
            in_win &= ((deltas[d] >= 0) & (deltas[d] <= 2)) | ~valid
        spilled = has & ~in_win.all(axis=(1, 2))
        if spilled.any():
            raise LatticeBinError(
                f"{int(spilled.sum())} elements exceed the lattice stencil "
                "window (foreground elements wider than the background "
                "spacing); use the general probe"
            )
        use = np.flatnonzero(has)

        # bbox-cropped dense cell layout
        starts = []
        sizes = []
        for d in range(dim):
            bu = base[d][use]
            s0 = int(bu.min()) if use.size else 0
            sz = (int(bu.max()) - s0 + 1) if use.size else 1
            starts.append(s0)
            sizes.append(sz)
        nc = max(int(np.prod(sizes)), 1)
        cell = np.zeros(use.size, dtype=np.int64)
        for d in range(dim):
            cell = cell * sizes[d] + (base[d][use] - starts[d])

        counts = np.bincount(cell, minlength=nc)
        L = max(int(counts.max()) if counts.size else 0, 1)
        order = np.argsort(cell, kind="stable")
        cell_s = cell[order]
        cstarts = np.zeros(nc, dtype=np.int64)
        np.cumsum(counts[:-1], out=cstarts[1:])
        slot = np.arange(cell.size, dtype=np.int64) - cstarts[cell_s]

        src = use[order]
        kap = np.zeros((nE, ne, km), dtype=np.int8)
        for d in range(dim):
            kap = kap * 3 + np.clip(deltas[d], 0, 2).astype(np.int8)

        if l_cap == "auto":
            # byte-optimal cap from the occupancy histogram: dense pays
            # cap·nc slots, the spill pays (L-cap)·ncc(cap) with
            # ncc(cap) = #cells of occupancy > cap. (A p99 cap is useless
            # when the distribution is top-heavy — at the ratio-1.26 3D
            # bench p99 == max == 48 and the table stayed 2.7 GB.)
            if counts.size and L > 1:
                caps = np.arange(1, L + 1)
                hist = np.bincount(
                    np.minimum(counts[counts > 0], L), minlength=L + 1
                )
                ncc_gt = hist[::-1].cumsum()[::-1]        # ncc_gt[c] = #cells occ >= c
                ncc = np.concatenate([ncc_gt[2:], [0]])   # occ > cap
                # spill slots are ~6x a dense slot at runtime (their
                # placement is scatter-add, the dense path shifted slices),
                # so the objective weights them — a pure-bytes optimum put
                # 16% of the used cells in the spill and the probe paid
                # seconds of scatter time for a few hundred MB saved
                total = caps * nc + 6 * (L - caps) * ncc
                l_cap = max(int(caps[np.argmin(total)]), 2)
            else:
                l_cap = None
        spill = None
        if l_cap is not None and L > int(l_cap) and not df:
            l_cap = int(l_cap)
            over = slot >= l_cap
            spill = CompactWindowTerm._build(
                shape, starts, sizes, cell_s[over], slot[over] - l_cap,
                src[over], tval, valid, kap, dtype,
            )
            cell_s, slot, src = cell_s[~over], slot[~over], src[~over]
            L = l_cap

        perm = np.zeros((L, nc), dtype=np.int32)
        perm[slot, cell_s] = (src + 1).astype(np.int32)

        val_t = np.zeros((ne, km, L, nc), dtype=dtype)
        kap_t = np.zeros((ne, km, L, nc), dtype=np.int8)
        val_t[:, :, slot, cell_s] = np.moveaxis(
            np.where(valid[src], tval[src], 0.0), 0, -1
        )
        kap_t[:, :, slot, cell_s] = np.moveaxis(kap[src], 0, -1)
        val_lo_t = None
        if df:
            val_lo_t = np.zeros((ne, km, L, nc), dtype=np.float32)
            val_lo_t[:, :, slot, cell_s] = np.moveaxis(
                np.where(valid[src], tval_lo[src], 0.0), 0, -1
            )
        return CellWindowTerm(
            jnp.asarray(val_t), jnp.asarray(kap_t), jnp.asarray(perm),
            shape, meta=(ne, km, L, nc),
            val_lo=jnp.asarray(val_lo_t) if val_lo_t is not None else None,
            bbox=(tuple(starts), tuple(sizes)), spill=spill,
        )

    # -- runtime binding (same contiguous-row gather as lattice_bin) -----------

    def bind_blocks(self, K: jnp.ndarray) -> jnp.ndarray:
        """(ne, ne, nE) element blocks -> binned (ne, ne, L, nc)."""
        ne = self.meta[0]
        L, nc = self.meta[2], self.meta[3]
        dt = self.val_b.dtype
        rows = K.astype(dt).reshape(ne * ne, -1).T
        rows = jnp.concatenate([jnp.zeros((1, ne * ne), dt), rows], axis=0)
        out = rows[self.perm.reshape(-1)]
        return out.T.reshape(ne, ne, L, nc)

    def bind_blocks_df(self, K_hi: jnp.ndarray, K_lo: jnp.ndarray):
        ne = self.meta[0]
        L, nc = self.meta[2], self.meta[3]
        wd = 2 * ne * ne
        rows = jnp.stack([K_hi, K_lo]).reshape(wd, -1).T
        rows = jnp.concatenate([jnp.zeros((1, wd), jnp.float32), rows], axis=0)
        out = rows[self.perm.reshape(-1)]
        Kb = out.T.reshape(2, ne, ne, L, nc)
        return Kb[0], Kb[1]

    def bind_static(self, arr: np.ndarray) -> np.ndarray:
        """Host-side: bind static per-element data (..., nE) into (..., L, nc)."""
        a = np.asarray(arr)
        pad = np.zeros(a.shape[:-1] + (1,), a.dtype)
        perm = np.asarray(self.perm)
        return np.concatenate([pad, a], axis=-1)[..., perm]

    # -- window assembly (the probe replacement) --------------------------------

    def _no_spill(self, what: str):
        if self.spill is not None:
            raise LatticeBinError(
                f"{what} is not available on an l_cap-split table (the "
                "overflow slots live in .spill); build with l_cap=None"
            )

    def window_g(self, Kb: jnp.ndarray, chunk: int | None = None) -> jnp.ndarray:
        """G (nc, w, w) = Σ_l E_lᵀ K_l E_l — batched congruence products.

        Kb: bound element blocks (ne, ne, L, nc). ``chunk``: cells per
        batch; columns are processed in static slices so the E workspace
        stays bounded (default targets ~256 MB of E per chunk).
        """
        self._no_spill("window_g")
        ne, km, L, nc = self.meta
        w = self.w
        dt = Kb.dtype
        if chunk is None:
            chunk = max(int(256e6 // (max(L, 1) * ne * w * 4)), 1)
        chunk = min(chunk, nc)

        hi = jax.lax.Precision.HIGHEST

        def g_of(sl_lo, sl_n):
            val = jax.lax.dynamic_slice_in_dim(self.val_b, sl_lo, sl_n, 3)
            kap = jax.lax.dynamic_slice_in_dim(self.kappa, sl_lo, sl_n, 3)
            Kc = jax.lax.dynamic_slice_in_dim(Kb, sl_lo, sl_n, 3)
            cols = []
            for d in range(w):
                acc = jnp.zeros((ne, L, sl_n), dt)
                for ka in range(km):
                    acc = acc + val[:, ka] * (kap[:, ka] == d).astype(dt)
                cols.append(acc)
            E = jnp.stack(cols, axis=1)                  # (ne, w, L, ncc)
            E_b = jnp.transpose(E, (2, 3, 0, 1))         # (L, ncc, ne, w)
            K_b = jnp.transpose(Kc, (2, 3, 0, 1))        # (L, ncc, ne, ne)
            # T[l,c] = K_l E_l : batch (L, ncc), contract ne
            T = jax.lax.dot_general(
                K_b, E_b, (((3,), (2,)), ((0, 1), (0, 1))), precision=hi,
            )                                            # (L, ncc, ne, w)
            # G[c] = Σ_{l,a} E[l,c,a,:]ᵀ T[l,c,a,:] : batch ncc, contract (L, ne)
            G = jax.lax.dot_general(
                E_b, T, (((0, 2), (0, 2)), ((1,), (1,))), precision=hi,
            )                                            # (ncc, w, w)
            return G

        if chunk >= nc:
            return g_of(0, nc)
        outs = []
        for lo in range(0, nc, chunk):
            outs.append(g_of(lo, min(chunk, nc - lo)))
        return jnp.concatenate(outs, axis=0)

    def stencil_coeffs(self, G: jnp.ndarray, radius: int = 2) -> jnp.ndarray:
        """Window operators -> stencil coefficient planes ((2r+1)^dim, *shape).

        Row class d1, column class d2 contribute at offset δ(d2) − δ(d1)
        (∈ [−2, 2]^dim) on lattice rows bbox_start + δ(d1): w² static
        shifted slice-accumulations, no scatters. Accumulates into per-k
        planes (not one big C via .at[k]) to keep the jit graph free of
        full-tensor copies.
        """
        dim = self.dim
        w = self.w
        m = 2 * radius + 1
        starts, sizes = self.bbox
        offs = _class_offsets(dim)
        planes = [jnp.zeros(self.shape, G.dtype) for _ in range(m ** dim)]
        Gc = G.reshape((-1, w, w))
        for d1 in range(w):
            place = tuple(starts[d] + int(offs[d1, d]) for d in range(dim))
            for d2 in range(w):
                o = offs[d2] - offs[d1]                  # in [-2, 2]^dim
                k = 0
                for d in range(dim):
                    k = k * m + int(o[d]) + radius
                cur = jax.lax.dynamic_slice(planes[k], place, sizes)
                planes[k] = jax.lax.dynamic_update_slice(
                    planes[k], cur + Gc[:, d1, d2].reshape(sizes), place
                )
        return jnp.stack(planes)

    # -- fused bind+congruence+placement (the memory-bounded probe) --------------

    def window_planes(self, K_el: jnp.ndarray, dtype=jnp.float64,
                      radius: int = 2,
                      slab_bytes: float = 1.5e9) -> jnp.ndarray:
        """Stencil planes ((2r+1)^dim, *shape) of Mᵀ A_term M, fused.

        Streams bbox x-slabs through bind -> E build -> congruence ->
        placement inside one lax.scan, so neither the slot-bound element
        blocks (ne, ne, L, nc) nor the window operators G (nc, w, w) are
        ever materialized. At the 3D 1M-dof bench those two tensors are
        4.7 GB + 4.5 GB in f64 — the round-4 OOM — while this path's peak
        extra footprint is one slab's workspace (≤ ``slab_bytes``) plus the
        plane accumulator itself.

        ``K_el``: compact per-element blocks (ne, ne, nE) — NOT slot-bound;
        binding happens per-slab via a perm gather. ``dtype=float64`` gives
        a genuinely double-precision probe: in df mode the
        extraction weights are reconstructed exactly as val_b + val_lo, so
        the planes match the true projected operator to f64 roundoff and
        the iterative-refinement residual can run on the stencil itself
        instead of the reducer apply_df (la_utils.py:165-182 role, exact).
        """
        ne, km, L, nc = self.meta
        w = self.w
        dim = self.dim
        m = 2 * radius + 1
        starts, sizes = self.bbox
        sx = sizes[0]
        rest = int(np.prod(sizes[1:])) if dim > 1 else 1
        dtype = jnp.dtype(dtype)
        offs = _class_offsets(dim)
        hi = jax.lax.Precision.HIGHEST

        rows = K_el.astype(dtype).reshape(ne * ne, -1).T       # (nE, ne²)
        rows = jnp.concatenate(
            [jnp.zeros((1, ne * ne), dtype), rows], axis=0
        )

        # Every intermediate keeps the slot axis minormost and the tiny
        # (ne, w) contractions either unrolled into plane FMAs or merged
        # into one large (ne·L) axis: a dot_general over (L, n_sl, ne, w)
        # operands would put the tiny (ne, w) axes minormost, whose tiled
        # layouts padded the 3D 1M-dof probe out of device memory.
        esz = dtype.itemsize
        # slab budget (bytes per bbox x-row), padded sizes included:
        #   val+kap slices, E + T plane lists, Kc gather + transpose,
        #   (f32 dot path) Et/Tt in (n_sl, w, ne·L) padded to lane/sublane
        #   multiples, and the G output (n_sl, w, w) padded likewise.
        pad_s = -(-w // 8) * 8                       # sublane multiple
        pad_l = -(-(ne * L) // 128) * 128            # lane multiple
        per_x = rest * (
            L * (ne * km * (esz + 1) + 2 * ne * w * esz + 2 * ne * ne * esz)
            + 2 * pad_s * pad_l * esz
            + pad_s * (-(-w // 128) * 128) * esz
        )
        slab = max(1, min(int(slab_bytes // max(per_x, 1)), sx))

        def slab_g(lo, n_sl):
            """Window congruence of slot columns [lo, lo+n_sl) -> (w², n_sl)."""
            val = jax.lax.dynamic_slice_in_dim(
                self.val_b, lo, n_sl, 3
            ).astype(dtype)
            if self.val_lo is not None and dtype == jnp.float64:
                val = val + jax.lax.dynamic_slice_in_dim(
                    self.val_lo, lo, n_sl, 3
                ).astype(dtype)
            kap = jax.lax.dynamic_slice_in_dim(self.kappa, lo, n_sl, 3)
            prm = jax.lax.dynamic_slice_in_dim(self.perm, lo, n_sl, 1)
            # (L, ne², n_sl): slot axis minormost, no (ne, ne) minor tile
            Kc = jnp.transpose(
                rows[prm.reshape(-1)].reshape(L, n_sl, ne * ne), (0, 2, 1)
            )
            # E[b][d]: (L, n_sl) — unrolled masked-class select
            E = [[None] * w for _ in range(ne)]
            for b in range(ne):
                for d in range(w):
                    acc = val[b, 0] * (kap[b, 0] == d).astype(dtype)
                    for kb in range(1, km):
                        acc = acc + val[b, kb] * (kap[b, kb] == d).astype(
                            dtype
                        )
                    E[b][d] = acc
            # T[a][d]: (L, n_sl) = Σ_b K[a,b]·E[b][d] — unrolled plane FMAs
            T = [[None] * w for _ in range(ne)]
            for a in range(ne):
                for d in range(w):
                    t = Kc[:, a * ne] * E[0][d]
                    for b in range(1, ne):
                        t = t + Kc[:, a * ne + b] * E[b][d]
                    T[a][d] = t
            if dtype == jnp.float32:
                # one large batched contraction: the combined (a, l) axis
                # of size ne·L is the contraction — instead of w² unrolled
                # plane reductions re-reading E/T w times each
                Ehat = jnp.stack([
                    jnp.concatenate([E[b][d] for b in range(ne)])
                    for d in range(w)
                ])                                       # (w, ne·L, n_sl)
                That = jnp.stack([
                    jnp.concatenate([T[a][d] for a in range(ne)])
                    for d in range(w)
                ])
                Et = jnp.transpose(Ehat, (2, 0, 1))      # (n_sl, w, ne·L)
                Tt = jnp.transpose(That, (2, 0, 1))
                G = jax.lax.dot_general(
                    Et, Tt, (((2,), (2,)), ((0,), (0,))), precision=hi,
                )                                        # (n_sl, w, w)
                return G.reshape(n_sl, w * w).T          # (w², n_sl)
            return jnp.stack([
                sum((E[a][d1] * T[a][d2] for a in range(1, ne)),
                    E[0][d1] * T[0][d2]).sum(axis=0)
                for d1 in range(w) for d2 in range(w)
            ])                                           # (w², n_sl)

        # Phase 1 — congruence: stream slot slabs into a (w², nc) window-
        # operator buffer, ONE contiguous-column update per slab. (The
        # earlier design placed each slab's w² contributions onto the
        # planes directly: w² tiny slice-updates × ~100 slabs = ~75k
        # sequential ~33 KB kernels, measured 21.2 s of the 27.6 s 3D
        # 1M-dof solve — pure per-op overhead, not traffic.)
        Gbuf = jnp.zeros((w * w, nc), dtype)
        n_full = sx // slab
        if n_full:
            def body(g, i):
                lo = i * (slab * rest)
                return jax.lax.dynamic_update_slice(
                    g, slab_g(lo, slab * rest), (0, lo)
                ), None

            Gbuf, _ = jax.lax.scan(body, Gbuf, jnp.arange(n_full), unroll=1)
        tail = sx - n_full * slab
        if tail:
            Gbuf = jax.lax.dynamic_update_slice(
                Gbuf, slab_g(n_full * slab * rest, tail * rest),
                (0, n_full * slab * rest),
            )

        # Phase 2 — placement: w² full-bbox shifted accumulations, each one
        # slice-read + add + slice-write of the whole (sx, sy, ...) region
        planes = jnp.zeros((m ** dim,) + self.shape, dtype)
        for d1 in range(w):
            at = (0,) + tuple(
                starts[d] + int(offs[d1, d]) for d in range(dim)
            )
            for d2 in range(w):
                o = offs[d2] - offs[d1]
                k = 0
                for d in range(dim):
                    k = k * m + int(o[d]) + radius
                at_k = (k,) + at[1:]
                cur = jax.lax.dynamic_slice(
                    planes, at_k, (1,) + tuple(sizes)
                )
                contrib = Gbuf[d1 * w + d2].reshape((1,) + tuple(sizes))
                planes = jax.lax.dynamic_update_slice(
                    planes, cur + contrib, at_k
                )
        return planes

    # -- rhs projection + df operator application -------------------------------

    def _x_class_slices(self, x_nd):
        """Per-class source planes x[bbox + δ(d)] as (nc,) vectors."""
        starts, sizes = self.bbox
        offs = _class_offsets(self.dim)
        out = []
        for d in range(self.w):
            place = tuple(starts[k] + int(offs[d, k]) for k in range(self.dim))
            out.append(
                jax.lax.dynamic_slice(x_nd, place, sizes).reshape(-1)
            )
        return out

    # Class selection / projection run as fori_loops over the w window
    # classes (27 in 3D): the loop body — one masked pass over the (L, nc)
    # slot table — is traced ONCE, keeping jit graphs small where an
    # unrolled per-class expansion (w · km · ne bodies) stalls XLA.

    def _select_classes(self, kap, Xh, Xl):
        """Slot-table gather-free select: out[l,c] = X[kap[l,c], c].
        Classes partition slots, so the masked accumulation is exact
        (plain f32 adds of disjoint supports). X*: (w, nc); kap: (L, nc)."""
        f32 = jnp.float32
        L, nc = kap.shape

        def body(d, acc):
            m = (kap == d.astype(kap.dtype)).astype(f32)
            return (acc[0] + m * Xh[d][None, :], acc[1] + m * Xl[d][None, :])

        init = (jnp.zeros((L, nc), f32), jnp.zeros((L, nc), f32))
        return jax.lax.fori_loop(0, self.w, body, init)

    def _project_classes(self, kap, V):
        """Per-class slot sums: out[d, c] = Σ_l V[l, c]·[kap[l,c] = d],
        V a (L, nc) df pair -> (w, nc) df. Each class row is written once
        (disjoint partition); the L-sum is the compensated tree df_sum."""
        from iifea.ops import df as dfm

        f32 = jnp.float32
        nc = kap.shape[1]

        def body(d, out):
            m = (kap == d.astype(kap.dtype)).astype(f32)
            sh, sl = dfm.df_sum((V[0] * m, V[1] * m), 0)
            return (
                jax.lax.dynamic_update_index_in_dim(out[0], sh, d, 0),
                jax.lax.dynamic_update_index_in_dim(out[1], sl, d, 0),
            )

        init = (jnp.zeros((self.w, nc), f32), jnp.zeros((self.w, nc), f32))
        return jax.lax.fori_loop(0, self.w, body, init)

    def _place_classes(self, acc, dtype):
        """Inverse of _x_class_slices: accumulate per-class (w, nc) planes
        onto the lattice."""
        starts, sizes = self.bbox
        offs = _class_offsets(self.dim)
        Y = jnp.zeros(self.shape, dtype)
        for d in range(self.w):
            place = tuple(starts[k] + int(offs[d, k]) for k in range(self.dim))
            cur = jax.lax.dynamic_slice(Y, place, sizes)
            Y = jax.lax.dynamic_update_slice(
                Y, cur + acc[d].reshape(sizes), place
            )
        return Y.reshape(-1)

    def _place_classes_df(self, acc_df):
        """df variant of _place_classes: acc_df a (w, nc) df pair."""
        from iifea.ops import df as dfm

        starts, sizes = self.bbox
        offs = _class_offsets(self.dim)
        f32 = jnp.float32
        Yh = jnp.zeros(self.shape, f32)
        Yl = jnp.zeros(self.shape, f32)
        for d in range(self.w):
            place = tuple(starts[k] + int(offs[d, k]) for k in range(self.dim))
            cur = (jax.lax.dynamic_slice(Yh, place, sizes),
                   jax.lax.dynamic_slice(Yl, place, sizes))
            new = dfm.df_add(cur, (acc_df[0][d].reshape(sizes),
                                   acc_df[1][d].reshape(sizes)))
            Yh = jax.lax.dynamic_update_slice(Yh, new[0], place)
            Yl = jax.lax.dynamic_update_slice(Yl, new[1], place)
        return Yh.reshape(-1), Yl.reshape(-1)

    def project_rhs(self, r_el: jnp.ndarray) -> jnp.ndarray:
        """y = Mᵀ_term r from bound element residuals (ne, L, nc), f32/f64."""
        self._no_spill("project_rhs")
        ne, km, L, nc = self.meta
        dt = r_el.dtype

        def body(d, acc):
            s = jnp.zeros((nc,), dt)
            for a in range(ne):
                for ka in range(km):
                    m = (self.kappa[a, ka] == d.astype(self.kappa.dtype))
                    V = self.val_b[a, ka].astype(dt) * r_el[a]
                    s = s + (V * m.astype(dt)).sum(axis=0)
            return jax.lax.dynamic_update_index_in_dim(acc, s, d, 0)

        acc = jax.lax.fori_loop(
            0, self.w, body, jnp.zeros((self.w, nc), dt)
        )
        return self._place_classes(acc, dt)

    def project_rhs_df(self, r_el_df):
        """df rhs projection (the la_utils.py:143-163 AT_x role), gather-free."""
        from iifea.ops import df as dfm

        ne, km, L, nc = self.meta
        r_hi, r_lo = r_el_df
        f32 = jnp.float32
        out = (jnp.zeros((self.w, nc), f32), jnp.zeros((self.w, nc), f32))
        for a in range(ne):
            for ka in range(km):
                V = dfm.df_mul(
                    (self.val_b[a, ka], self.val_lo[a, ka]),
                    (r_hi[a], r_lo[a]),
                )
                out = dfm.df_add(
                    out, self._project_classes(self.kappa[a, ka], V)
                )
        return self._place_classes_df(out)

    def apply_df(self, Kb_df, x_df):
        """y = (Mᵀ A_term M) x in double-float, gather-free (~1e-14 relative;
        the iterative-refinement residual path — same role as
        lattice_bin.LatticeBinnedTerm2D.apply_df, w classes)."""
        from iifea.ops import df as dfm

        ne, km, L, nc = self.meta
        K_hi, K_lo = Kb_df
        f32 = jnp.float32
        Xh = jnp.stack(self._x_class_slices(x_df[0].reshape(self.shape)))
        Xl = jnp.stack(self._x_class_slices(x_df[1].reshape(self.shape)))

        xe = []
        for b in range(ne):
            acc = (jnp.zeros((L, nc), f32), jnp.zeros((L, nc), f32))
            for kb in range(km):
                v = (self.val_b[b, kb], self.val_lo[b, kb])
                s = self._select_classes(self.kappa[b, kb], Xh, Xl)
                acc = dfm.df_add(acc, dfm.df_mul(v, s))
            xe.append(acc)
        ye = []
        for a in range(ne):
            acc = (jnp.zeros((L, nc), f32), jnp.zeros((L, nc), f32))
            for b in range(ne):
                acc = dfm.df_add(
                    acc, dfm.df_mul((K_hi[a, b], K_lo[a, b]), xe[b])
                )
            ye.append(acc)
        out = (jnp.zeros((self.w, nc), f32), jnp.zeros((self.w, nc), f32))
        for a in range(ne):
            for ka in range(km):
                V = dfm.df_mul((self.val_b[a, ka], self.val_lo[a, ka]), ye[a])
                out = dfm.df_add(
                    out, self._project_classes(self.kappa[a, ka], V)
                )
        return self._place_classes_df(out)


@jax.tree_util.register_pytree_node_class
class CompactWindowTerm:
    """Probe-only overflow slots of a capped CellWindowTerm.

    Same congruence math as the dense term, but over a COMPACT cell list
    (ncc = cells whose occupancy exceeded l_cap, <1% of the bbox at the 3D
    bench) with scatter-add placement instead of shifted slices:
    ``rows_w[d1]`` holds the flat lattice index of base+δ(d1) per compact
    cell (host-precomputed, unique within a class). Carries no df tables —
    the df apply/project paths never split.
    """

    def __init__(self, val_b, kappa, perm, rows_w, shape, meta):
        self.val_b = val_b               # (ne, km, L2, ncc)
        self.kappa = kappa               # (ne, km, L2, ncc) int8
        self.perm = perm                 # (L2, ncc) int32
        self.rows_w = rows_w             # (w, ncc) int32 flat lattice ids
        self.shape = tuple(shape)
        self.meta = meta                 # (ne, km, L2, ncc)

    @property
    def dim(self) -> int:
        return len(self.shape)

    @property
    def w(self) -> int:
        return 3 ** self.dim

    def tree_flatten(self):
        return (self.val_b, self.kappa, self.perm, self.rows_w), (
            self.shape, self.meta,
        )

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        val_b, kappa, perm, rows_w = leaves
        shape, meta = aux
        return cls(val_b, kappa, perm, rows_w, shape, meta)

    @staticmethod
    def _build(shape, starts, sizes, cell_over, slot2, src_over,
               tval, valid, kap, dtype):
        dim = len(shape)
        ne, km = tval.shape[1], tval.shape[2]
        cells_u, cmap = np.unique(cell_over, return_inverse=True)
        ncc = max(int(cells_u.size), 1)
        L2 = max(int(slot2.max()) + 1 if slot2.size else 0, 1)
        val_t = np.zeros((ne, km, L2, ncc), dtype=dtype)
        kap_t = np.zeros((ne, km, L2, ncc), dtype=np.int8)
        perm = np.zeros((L2, ncc), dtype=np.int32)
        if slot2.size:
            val_t[:, :, slot2, cmap] = np.moveaxis(
                np.where(valid[src_over], tval[src_over], 0.0), 0, -1
            )
            kap_t[:, :, slot2, cmap] = np.moveaxis(kap[src_over], 0, -1)
            perm[slot2, cmap] = (src_over + 1).astype(np.int32)
        # decode bbox-flat cell ids -> per-axis lattice base coords
        rem = cells_u if cells_u.size else np.zeros(1, np.int64)
        bc = []
        for d in range(dim - 1, 0, -1):
            bc.append(rem % sizes[d])
            rem = rem // sizes[d]
        bc.append(rem)
        bc = bc[::-1]
        base_ax = [starts[d] + bc[d] for d in range(dim)]
        offs = _class_offsets(dim)
        strides = np.ones(dim, dtype=np.int64)
        for d in range(dim - 2, -1, -1):
            strides[d] = strides[d + 1] * shape[d + 1]
        rows_w = np.stack([
            sum((base_ax[d] + int(offs[k, d])) * strides[d]
                for d in range(dim))
            for k in range(3 ** dim)
        ]).astype(np.int32)
        return CompactWindowTerm(
            jnp.asarray(val_t), jnp.asarray(kap_t), jnp.asarray(perm),
            jnp.asarray(rows_w), shape, (ne, km, L2, ncc),
        )

    def window_planes(self, K_el: jnp.ndarray, dtype=jnp.float64,
                      radius: int = 2,
                      slab_bytes: float = 1.5e9) -> jnp.ndarray:
        """Planes ((2r+1)^dim, *shape) of this term's overflow slots.

        Chunked over compact cells: with the byte-optimal l_cap the spill
        can hold ~16% of the used cells (140k at the 3D 1M-dof bench), so
        the unchunked E/T/Et/Tt workspace would be ~16 GB — the per-chunk
        footprint is budgeted exactly like the dense slab scan."""
        ne, km, L, ncc = self.meta
        w = self.w
        dim = self.dim
        m = 2 * radius + 1
        dtype = jnp.dtype(dtype)
        esz = dtype.itemsize
        hi = jax.lax.Precision.HIGHEST

        rows = K_el.astype(dtype).reshape(ne * ne, -1).T
        rows = jnp.concatenate(
            [jnp.zeros((1, ne * ne), dtype), rows], axis=0
        )
        pad_s = -(-w // 8) * 8
        pad_l = -(-(ne * L) // 128) * 128
        per_c = (
            L * (ne * km * (esz + 1) + 2 * ne * w * esz + 2 * ne * ne * esz)
            + 2 * pad_s * pad_l * esz
            + pad_s * (-(-w // 128) * 128) * esz
        )
        chunk = max(1, min(int(slab_bytes // max(per_c, 1)), ncc))
        offs = _class_offsets(dim)

        def chunk_g(lo, n_c):
            """Congruence of compact cells [lo, lo+n_c) -> (w², n_c)."""
            val = jax.lax.dynamic_slice_in_dim(
                self.val_b, lo, n_c, 3
            ).astype(dtype)
            kap = jax.lax.dynamic_slice_in_dim(self.kappa, lo, n_c, 3)
            prm = jax.lax.dynamic_slice_in_dim(self.perm, lo, n_c, 1)
            Kc = jnp.transpose(
                rows[prm.reshape(-1)].reshape(L, n_c, ne * ne), (0, 2, 1)
            )
            E = [[None] * w for _ in range(ne)]
            for b in range(ne):
                for d in range(w):
                    acc = val[b, 0] * (kap[b, 0] == d).astype(dtype)
                    for kb in range(1, km):
                        acc = acc + val[b, kb] * (kap[b, kb] == d).astype(
                            dtype
                        )
                    E[b][d] = acc
            T = [[None] * w for _ in range(ne)]
            for a in range(ne):
                for d in range(w):
                    t = Kc[:, a * ne] * E[0][d]
                    for b in range(1, ne):
                        t = t + Kc[:, a * ne + b] * E[b][d]
                    T[a][d] = t
            if dtype == jnp.float32:
                Ehat = jnp.stack([
                    jnp.concatenate([E[b][d] for b in range(ne)])
                    for d in range(w)
                ])
                That = jnp.stack([
                    jnp.concatenate([T[a][d] for a in range(ne)])
                    for d in range(w)
                ])
                G = jax.lax.dot_general(
                    jnp.transpose(Ehat, (2, 0, 1)),
                    jnp.transpose(That, (2, 0, 1)),
                    (((2,), (2,)), ((0,), (0,))), precision=hi,
                )                                        # (n_c, w, w)
                return G.reshape(n_c, w * w).T
            return jnp.stack([
                sum((E[a][d1] * T[a][d2] for a in range(1, ne)),
                    E[0][d1] * T[0][d2]).sum(axis=0)
                for d1 in range(w) for d2 in range(w)
            ])

        # phase 1: congruence into the (w², ncc) buffer, one update/chunk
        Gbuf = jnp.zeros((w * w, ncc), dtype)
        n_full = ncc // chunk
        if n_full:
            def body(g, i):
                lo = i * chunk
                return jax.lax.dynamic_update_slice(
                    g, chunk_g(lo, chunk), (0, lo)
                ), None

            Gbuf, _ = jax.lax.scan(body, Gbuf, jnp.arange(n_full), unroll=1)
        tail = ncc - n_full * chunk
        if tail:
            Gbuf = jax.lax.dynamic_update_slice(
                Gbuf, chunk_g(n_full * chunk, tail), (0, n_full * chunk)
            )

        # phase 2: w² full-ncc scatter-adds (indices unique per row class)
        planes = jnp.zeros((m ** dim, int(np.prod(self.shape))), dtype)
        for d1 in range(w):
            idx = self.rows_w[d1]
            for d2 in range(w):
                o = offs[d2] - offs[d1]
                k = 0
                for d in range(dim):
                    k = k * m + int(o[d]) + radius
                planes = planes.at[k, idx].add(
                    Gbuf[d1 * w + d2], unique_indices=True
                )
        return planes.reshape((m ** dim,) + self.shape)


# -- form-level helpers --------------------------------------------------------


def build_window_projection(form, M, shape, radius: int = 2,
                            dtype=np.float32, df: bool = False,
                            l_cap=None) -> list[CellWindowTerm]:
    """Cell-window tables for every term of a form (host, setup-time)."""
    if form.n_fields != 1:
        raise LatticeBinError("cell-window binning covers scalar fields")
    reducers = []
    for dom, _ in form.terms:
        fl = getattr(dom, "flat_eldofs_np", None)
        if fl is None:
            fl = np.asarray(dom.eldofsT).T
        reducers.append(
            CellWindowTerm.build(fl, M, shape, radius, dtype=dtype, df=df,
                                 l_cap=l_cap)
        )
    return reducers


def stencil_coeffs_windows(reducers, bound_blocks) -> jnp.ndarray:
    """Stencil coefficient planes of Mᵀ A M summed over all form terms.

    bound_blocks: per-term bound (ne, ne, L, nc) f32 blocks (hi parts in the
    df pipeline)."""
    C = None
    for red, Kb in zip(reducers, bound_blocks):
        G = red.window_g(Kb)
        Ct = red.stencil_coeffs(G)
        C = Ct if C is None else C + Ct
    return C


def _planes_with_spill(red, K, dtype, slab_bytes):
    Ct = red.window_planes(K, dtype=dtype, slab_bytes=slab_bytes)
    if red.spill is not None:
        Ct = Ct + red.spill.window_planes(K, dtype=dtype,
                                          slab_bytes=slab_bytes)
    return Ct


def stencil_planes_windows(reducers, K_els, dtype=jnp.float64,
                           slab_bytes: float = 1.5e9) -> jnp.ndarray:
    """Fused memory-bounded form of :func:`stencil_coeffs_windows`: planes
    of Mᵀ A M from COMPACT per-term element blocks (ne, ne, nE) — no
    slot-bound K, no materialized G (see CellWindowTerm.window_planes)."""
    C = None
    for red, K in zip(reducers, K_els):
        Ct = _planes_with_spill(red, K, dtype, slab_bytes)
        C = Ct if C is None else C + Ct
    return C


def apply_df_windows(reducers, bound, x_df):
    from iifea.ops import df as dfm

    y = reducers[0].apply_df(bound[0], x_df)
    for red, Kb in zip(reducers[1:], bound[1:]):
        y = dfm.df_add(y, red.apply_df(Kb, x_df))
    return y


def project_rhs_df_windows(reducers, r_el_dfs):
    from iifea.ops import df as dfm

    y = reducers[0].project_rhs_df(r_el_dfs[0])
    for red, r in zip(reducers[1:], r_el_dfs[1:]):
        y = dfm.df_add(y, red.project_rhs_df(r))
    return y
