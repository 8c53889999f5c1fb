"""Device-friendly preconditioners.

The reference's PC menu (common.py:568-616) maps as follows (SURVEY.md §2.3 N6):
  'jacobi'      -> jacobi()          (exact parity)
  'bjacobi'     -> block_jacobi()    (field-coupled point-block Jacobi)
  'ASM'/'ICC'/'ILU'/'ILUT' (hypre)   -> no data-parallel analog (sequential triangular
      solves); documented substitution is jacobi/block-jacobi + BFR trimming,
      or the host 'direct' path for ill-conditioned systems.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def jacobi(diag: jnp.ndarray, guard: float = 0.0):
    """PCJACOBI. Zero diagonal entries (unsupported background basis functions,
    common.py:207-233) are replaced by 1 so they act as identity rows."""
    safe = jnp.where(jnp.abs(diag) > guard, diag, 1.0)
    inv = 1.0 / safe

    def minv(x):
        return inv * x

    return minv


def block_jacobi(diag_blocks: jnp.ndarray):
    """Point-block Jacobi (PCBJACOBI role): diag_blocks (m, nf, nf) per-node
    field-coupling blocks of the background operator.

    Background vectors are FIELD-BLOCKED (dof = node + field*m, the
    reference's layout — common.py:703), so a length-nf*m vector reshapes to
    (nf, m), not (m, nf).

    Unsupported background nodes (zero rows — basis functions with no active
    foreground support, common.py:207-233) make their block singular; those
    rows/columns fall back to the jacobi convention (identity action) by
    patching zero diagonal entries to 1 before inversion, and any block the
    inverse still fails on (non-finite) degrades to its diagonal inverse.
    """
    nf = diag_blocks.shape[-1]
    d = jnp.einsum("nii->ni", diag_blocks)                 # (m, nf)
    safe_d = jnp.where(jnp.abs(d) > 0, d, 1.0)
    eye = jnp.eye(nf, dtype=diag_blocks.dtype)
    patched = diag_blocks.at[
        :, jnp.arange(nf), jnp.arange(nf)
    ].set(safe_d)
    inv = jnp.linalg.inv(patched)
    diag_inv = eye * (1.0 / safe_d)[:, :, None]
    ok = jnp.isfinite(inv).all(axis=(1, 2), keepdims=True)
    inv = jnp.where(ok, jnp.where(jnp.isfinite(inv), inv, 0.0), diag_inv)

    def minv(x):
        xb = x.reshape(nf, -1)                             # [field, node]
        return jnp.einsum("nab,bn->an", inv, xb,
                          precision=jax.lax.Precision.HIGHEST).reshape(-1)

    return minv


class AdditiveSchwarz:
    """Restricted additive Schwarz with overlapping dense patch solves —
    the reference's PCASM role (common.py:576-587: overlap-1 subdomains,
    per-subdomain LU) for backgrounds where no lattice structure exists and
    pc='mg' does not apply.

    Device formulation: patches are built ONCE on the host from the
    explicit projected CSR (greedy BFS aggregation into cores of
    ``core_size`` dofs, grown by ``overlap`` adjacency layers — the
    PETSc overlap-1 analog), their dense sub-blocks are factorized into
    explicit inverses, and the per-iteration apply is entirely batched
    device work shaped as batched matmuls:

        gather r into (P, w) patch slabs
      -> one batched (P, w, w) x (P, w) matmul against the stored inverses
      -> restricted scatter-add (each dof owned by exactly ONE core, so
         overlap regions are never double-counted — classic RAS)

    Unsupported dofs (zero operator rows) bypass the patches and act as
    identity, matching the jacobi()/trim conventions.
    """

    def __init__(self, A_csr, core_size: int = 64, overlap: int = 1):
        import numpy as np
        import scipy.sparse as sp

        A = sp.csr_matrix(A_csr)
        n = A.shape[0]
        # symmetrized adjacency (pattern only)
        G = (A != 0)
        G = (G + G.T).tocsr()
        diag = np.abs(A.diagonal())
        off = np.asarray(np.abs(A).sum(axis=1)).ravel() - diag
        alive = (diag > 0) | (off > 0)

        indptr, indices = G.indptr, G.indices
        owner = np.full(n, -1, dtype=np.int64)
        cores = []
        for seed in range(n):
            if owner[seed] >= 0 or not alive[seed]:
                continue
            core = [seed]
            owner[seed] = len(cores)
            frontier = [seed]
            while frontier and len(core) < core_size:
                nxt = []
                for u in frontier:
                    for v in indices[indptr[u]:indptr[u + 1]]:
                        if owner[v] < 0 and alive[v]:
                            owner[v] = len(cores)
                            core.append(v)
                            nxt.append(v)
                            if len(core) >= core_size:
                                break
                    if len(core) >= core_size:
                        break
                frontier = nxt
            cores.append(np.asarray(core, dtype=np.int64))

        patches = []
        for core in cores:
            patch = core
            for _ in range(overlap):
                nbrs = np.unique(np.concatenate([
                    indices[indptr[u]:indptr[u + 1]] for u in patch
                ]))
                patch = np.union1d(patch, nbrs[alive[nbrs]])
            patches.append(patch)

        P = len(patches)
        w = max((len(p) for p in patches), default=1)
        idx = np.full((P, w), n, dtype=np.int64)     # n = dummy pad slot
        own = np.zeros((P, w), dtype=A.dtype)
        inv = np.zeros((P, w, w), dtype=A.dtype)
        for p, patch in enumerate(patches):
            k = len(patch)
            idx[p, :k] = patch
            own[p, :k] = (owner[patch] == p)
            Ap = A[np.ix_(patch, patch)].toarray()
            # dead rows inside the patch halo -> identity (jacobi convention)
            dd = np.abs(np.diagonal(Ap)) + np.abs(Ap).sum(axis=1)
            dead_rows = np.where(dd == 0)[0]
            Ap[dead_rows, dead_rows] = 1.0
            # pad slots -> identity so the inverse exists
            full = np.eye(w, dtype=A.dtype)
            full[:k, :k] = Ap
            try:
                inv[p] = np.linalg.inv(full)
            except np.linalg.LinAlgError:
                inv[p] = np.linalg.pinv(full)

        self.n = n
        self.idx = jnp.asarray(idx)
        self.own = jnp.asarray(own)
        self.inv = jnp.asarray(inv)
        self.passthrough = jnp.asarray((~alive).astype(A.dtype))
        self.n_patches = P
        self.width = w

    def minv(self, r):
        rp = jnp.concatenate([r, jnp.zeros(1, r.dtype)])
        g = rp[self.idx]                                  # (P, w)
        y = jnp.einsum("pij,pj->pi", self.inv, g,
                       precision=jax.lax.Precision.HIGHEST) * self.own
        z = jnp.zeros(self.n + 1, r.dtype).at[
            self.idx.reshape(-1)
        ].add(y.reshape(-1))[: self.n]
        return z + self.passthrough * r
