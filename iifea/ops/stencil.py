"""Stencil-form background operators: the fast product path on lattices.

The general matrix-free path (gather -> block matvec -> transpose-gather) is
bound by indexed memory access. But the reference's background spaces are
*structured lattices* (MORIS/XTK grids, our generated grids): on a lattice,
the projected operator A_b = Mᵀ A_f M has a fixed sparsity stencil — every
row couples only dofs within a (2r+1)×(2r+1) offset window. Then

    y[i,j] = Σ_{|di|,|dj| <= r}  C[di,dj][i,j] * x[i+di, j+dj]

which is 25 dense shifted multiply-adds over the whole grid — pure
streaming at memory bandwidth, no indexed memory access at all.

The variable coefficients C are extracted from ANY abstract operator by
lattice probing (matrix probing / graph coloring): apply the slow matvec to
(2r+1)² indicator combs; because same-color lattice points have disjoint
stencil neighborhoods, one application recovers one diagonal band of A_b per
color. 25 slow applications at setup buy unlimited fast applications.

Coefficient planes are stored in their logical ((2r+1)^d, *shape) form.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def chunked_mv_multi(matvec_multi, X, chunk=None):
    """Apply a stacked multi-RHS matvec in bounded-memory column chunks.

    The general projected apply gathers ~(dofs-per-element × n_elem) floats
    per probe column; at (2r+1)³ = 343 colors on a million-element quadratic
    foreground that is hundreds of GB live at once (observed: a 223 GB
    allocation on the 3D biharmonic ref-2 probe). ``lax.map`` over fixed-size
    column chunks bounds the workspace to a few applies while staying one
    traced graph.
    """
    k, n = X.shape
    if chunk is None or chunk >= k:
        return matvec_multi(X)
    chunk = max(int(chunk), 1)
    pad = (-k) % chunk
    Xp = jnp.pad(X, ((0, pad), (0, 0))) if pad else X
    Y = jax.lax.map(matvec_multi, Xp.reshape(-1, chunk, n))
    Y = Y.reshape(-1, Y.shape[-1])
    return Y[:k] if pad else Y


@jax.tree_util.register_pytree_node_class
class StencilOperator2D:
    """A_b in variable-coefficient stencil form on an (nx+1, ny+1) lattice.

    Node id layout must match mesh.generators.rectangle_mesh:
    id = i * (ny + 1) + j.
    """

    def __init__(self, coeffs: jnp.ndarray, shape: tuple[int, int], radius: int):
        self.coeffs = coeffs          # ((2r+1)², nx1, ny1)
        self.shape = tuple(shape)
        self.radius = radius
        self.n = shape[0] * shape[1]

    @property
    def dtype(self):
        return self.coeffs.dtype

    def tree_flatten(self):
        return (self.coeffs,), (self.shape, self.radius)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        shape, radius = aux
        return cls(leaves[0], shape, radius)

    def astype(self, dtype) -> "StencilOperator2D":
        return StencilOperator2D(
            self.coeffs.astype(dtype), self.shape, self.radius
        )

    @staticmethod
    def probe_multi(matvec_multi, shape: tuple[int, int], radius: int = 2,
                    dtype=jnp.float32, chunk: int | None = None,
                    ) -> "StencilOperator2D":
        """Like probe(), but all (2r+1)² indicator combs go through ONE
        stacked multi-RHS operator application (k, n) — amortizing the slow
        general path's per-index gather latency across the probe columns.

        The coefficient distribution Y -> C exploits that the color seen at
        offset k from a point depends only on the point's (i mod m, j mod m)
        phase: it reduces to m² x m² *static* strided-slice copies — no
        masked full-grid ops, trivial to compile and execute.

        (No boundary masking is needed: for probe points that would fall
        outside the grid, every in-grid point of that color is farther than
        the stencil radius, so the probed value is exactly 0 already.)
        """
        nx1, ny1 = shape
        r = radius
        m = 2 * r + 1
        I, J = jnp.meshgrid(jnp.arange(nx1), jnp.arange(ny1), indexing="ij")
        X = jnp.stack(
            [
                ((I % m == a) & (J % m == b)).astype(dtype).reshape(-1)
                for a in range(m)
                for b in range(m)
            ],
            axis=0,
        )                                                       # (m², n)
        # the operator may compute in a wider dtype (e.g. f64 extraction
        # weights promoting an f32 probe): coefficients honor `dtype`
        Y = chunked_mv_multi(matvec_multi, X, chunk).astype(dtype)  # (m², n)
        return StencilOperator2D.from_probe_y(Y, shape, radius, dtype)

    @staticmethod
    def from_probe_y(Y: jnp.ndarray, shape: tuple[int, int], radius: int = 2,
                     dtype=jnp.float32) -> "StencilOperator2D":
        """Distribute probe responses Y (m², n) — colors ordered c = a·m + b
        with the point's phase (i mod m, j mod m) = (a, b) — into stencil
        coefficient planes. Y may come from probe_multi's general applies or
        from the gather-free lattice-binned path (ops/lattice_bin.py).
        """
        nx1, ny1 = shape
        r = radius
        m = 2 * r + 1
        Y = Y.astype(dtype)
        # pad to phase-aligned blocks and slice per (phase, offset)
        nxp = -(-nx1 // m) * m
        nyp = -(-ny1 // m) * m
        Y3 = jnp.pad(
            Y.reshape(m * m, nx1, ny1), ((0, 0), (0, nxp - nx1), (0, nyp - ny1))
        ).reshape(m * m, nxp // m, m, nyp // m, m)
        Cs = []
        for oi in range(-r, r + 1):
            for oj in range(-r, r + 1):
                rows = []
                for p in range(m):
                    cols = []
                    for q in range(m):
                        c = ((p + oi) % m) * m + ((q + oj) % m)
                        cols.append(Y3[c, :, p, :, q])   # (nxp/m, nyp/m)
                    rows.append(jnp.stack(cols, axis=-1))  # (.., nyp/m, m)
                blk = jnp.stack(rows, axis=1)            # (nxp/m, m, nyp/m, m)
                Cs.append(blk.reshape(nxp, nyp))
        C = jnp.stack(Cs)
        return StencilOperator2D(C[:, :nx1, :ny1], shape, r)

    @staticmethod
    def probe(matvec, shape: tuple[int, int], radius: int = 2,
              dtype=jnp.float32) -> "StencilOperator2D":
        """Extract stencil coefficients from an abstract matvec by coloring.

        matvec: the slow/general A_b application on flat vectors of length
        shape[0]*shape[1].
        """
        nx1, ny1 = shape
        r = radius
        m = 2 * r + 1
        ii = jnp.arange(nx1)
        jj = jnp.arange(ny1)
        I, J = jnp.meshgrid(ii, jj, indexing="ij")

        coeffs = []
        for a in range(m):
            for b in range(m):
                comb = ((I % m == a) & (J % m == b)).astype(dtype)
                y = matvec(comb.reshape(-1)).reshape(nx1, ny1)
                # the probe point p seen from q=(i,j): p ≡ (a,b) (mod m),
                # within radius r — unique. offset d = p - q in [-r, r].
                di = (a - I) % m
                di = jnp.where(di > r, di - m, di)
                dj = (b - J) % m
                dj = jnp.where(dj > r, dj - m, dj)
                coeffs.append((y, di, dj))
        # regroup by offset: C[d][q] = y_color(q) where color matches d at q
        C = jnp.zeros((m * m, nx1, ny1), dtype)
        for y, di, dj in coeffs:
            for oi in range(-r, r + 1):
                for oj in range(-r, r + 1):
                    sel = (di == oi) & (dj == oj)
                    k = (oi + r) * m + (oj + r)
                    C = C.at[k].add(jnp.where(sel, y, 0.0))
        # zero out-of-grid offsets (probe points beyond the boundary)
        for oi in range(-r, r + 1):
            for oj in range(-r, r + 1):
                k = (oi + r) * m + (oj + r)
                valid = (
                    (I + oi >= 0) & (I + oi < nx1)
                    & (J + oj >= 0) & (J + oj < ny1)
                )
                C = C.at[k].multiply(valid.astype(dtype))
        return StencilOperator2D(C, shape, r)

    def mv(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A_b x as (2r+1)² shifted dense multiply-adds."""
        nx1, ny1 = self.shape
        r = self.radius
        m = 2 * r + 1
        C = self.coeffs
        x2 = x.reshape(nx1, ny1)
        xp = jnp.pad(x2, ((r, r), (r, r)))
        y = jnp.zeros_like(x2)
        for oi in range(-r, r + 1):
            for oj in range(-r, r + 1):
                k = (oi + r) * m + (oj + r)
                shifted = jax.lax.dynamic_slice(
                    xp, (oi + r, oj + r), (nx1, ny1)
                )
                y = y + C[k] * shifted
        return y.reshape(-1)

    def diag(self) -> jnp.ndarray:
        r = self.radius
        m = 2 * r + 1
        k0 = r * m + r
        return self.coeffs[k0].reshape(-1)

    def verify(self, matvec, seed: int = 0, n_checks: int = 2) -> float:
        """Max relative error of the stencil form vs the abstract operator."""
        rng = np.random.default_rng(seed)
        worst = 0.0
        for _ in range(n_checks):
            x = jnp.asarray(
                rng.standard_normal(self.n).astype(self.coeffs.dtype)
            )
            y_ref = matvec(x)
            y = self.mv(x)
            num = float(jnp.linalg.norm(y - y_ref))
            den = float(jnp.linalg.norm(y_ref)) or 1.0
            worst = max(worst, num / den)
        return worst


@jax.tree_util.register_pytree_node_class
class StencilOperatorBlock2D:
    """Block (multi-field) stencil operator on an (nx+1, ny+1) lattice.

    Extends the scalar fast path to vector problems (elasticity, NS-VMS) on
    lattice backgrounds. Background dofs are field-blocked
    (bg_id = node + field*m, common.py:703), so the solution reshapes to
    (nF, nx1, ny1) planes and

        y[f1] = Σ_{f2} Σ_{|d|<=r} C[f1, f2, d] ⊙ shift_d(x[f2])

    — nF² variable-coefficient stencils, still pure shifted FMAs. Probing
    uses nF·(2r+1)² colors (field indicator × lattice phase): same-color
    dofs have disjoint stencil neighborhoods, so ONE stacked multi-RHS
    apply recovers every block coefficient exactly.
    """

    def __init__(self, coeffs: jnp.ndarray, shape, radius: int):
        self.coeffs = coeffs          # (nF, nF, (2r+1)², nx1, ny1)
        self.shape = tuple(shape)
        self.radius = radius
        self.n_fields = coeffs.shape[0]
        self.nn = shape[0] * shape[1]
        self.n = self.n_fields * self.nn

    @property
    def dtype(self):
        return self.coeffs.dtype

    def tree_flatten(self):
        return (self.coeffs,), (self.shape, self.radius)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        shape, radius = aux
        return cls(leaves[0], shape, radius)

    def astype(self, dtype) -> "StencilOperatorBlock2D":
        return StencilOperatorBlock2D(
            self.coeffs.astype(dtype), self.shape, self.radius
        )

    @staticmethod
    def probe_multi(matvec_multi, shape, n_fields: int, radius: int = 2,
                    dtype=jnp.float32, chunk: int | None = None,
                    ) -> "StencilOperatorBlock2D":
        nx1, ny1 = shape
        nn = nx1 * ny1
        r = radius
        m = 2 * r + 1
        I, J = jnp.meshgrid(jnp.arange(nx1), jnp.arange(ny1), indexing="ij")
        combs = [
            ((I % m == a) & (J % m == b)).astype(dtype).reshape(-1)
            for a in range(m)
            for b in range(m)
        ]
        zero = jnp.zeros(nn, dtype)
        X = jnp.stack(
            [
                jnp.concatenate(
                    [c if f2 == f else zero for f in range(n_fields)]
                )
                for f2 in range(n_fields)
                for c in combs
            ],
            axis=0,
        )                                      # (nF·m², nF·nn)
        Y = chunked_mv_multi(matvec_multi, X, chunk).astype(dtype)

        nxp = -(-nx1 // m) * m
        nyp = -(-ny1 // m) * m
        C_blocks = []
        for f1 in range(n_fields):
            rows_f1 = []
            for f2 in range(n_fields):
                Yb = Y[f2 * m * m:(f2 + 1) * m * m,
                       f1 * nn:(f1 + 1) * nn]
                Y3 = jnp.pad(
                    Yb.reshape(m * m, nx1, ny1),
                    ((0, 0), (0, nxp - nx1), (0, nyp - ny1)),
                ).reshape(m * m, nxp // m, m, nyp // m, m)
                Cs = []
                for oi in range(-r, r + 1):
                    for oj in range(-r, r + 1):
                        rows = []
                        for p in range(m):
                            cols = [
                                Y3[((p + oi) % m) * m + ((q + oj) % m),
                                   :, p, :, q]
                                for q in range(m)
                            ]
                            rows.append(jnp.stack(cols, axis=-1))
                        blk = jnp.stack(rows, axis=1)
                        Cs.append(blk.reshape(nxp, nyp)[:nx1, :ny1])
                rows_f1.append(jnp.stack(Cs))
            C_blocks.append(jnp.stack(rows_f1))
        C = jnp.stack(C_blocks)                # (nF, nF, m², nx1, ny1)
        return StencilOperatorBlock2D(C, shape, r)

    def mv(self, x: jnp.ndarray) -> jnp.ndarray:
        nF = self.n_fields
        nx1, ny1 = self.shape
        r = self.radius
        m = 2 * r + 1
        x3 = x.reshape(nF, nx1, ny1)
        xp = jnp.pad(x3, ((0, 0), (r, r), (r, r)))
        y = jnp.zeros_like(x3)
        for f1 in range(nF):
            acc = jnp.zeros((nx1, ny1), x.dtype)
            for f2 in range(nF):
                for oi in range(m):
                    for oj in range(m):
                        k = oi * m + oj
                        acc = acc + self.coeffs[f1, f2, k] * (
                            jax.lax.dynamic_slice(
                                xp[f2], (oi, oj), (nx1, ny1)
                            )
                        )
            y = y.at[f1].set(acc)
        return y.reshape(-1)

    def diag(self) -> jnp.ndarray:
        r = self.radius
        m = 2 * r + 1
        k0 = r * m + r
        nF = self.n_fields
        return jnp.stack(
            [self.coeffs[f, f, k0] for f in range(nF)]
        ).reshape(-1)

    def point_block_diag(self) -> jnp.ndarray:
        """(nF, nF, nn) nodal blocks for block-Jacobi preconditioning."""
        r = self.radius
        m = 2 * r + 1
        k0 = r * m + r
        return self.coeffs[:, :, k0].reshape(
            self.n_fields, self.n_fields, self.nn
        )

    def verify(self, matvec, seed: int = 0, n_checks: int = 2) -> float:
        rng = np.random.default_rng(seed)
        worst = 0.0
        for _ in range(n_checks):
            x = jnp.asarray(
                rng.standard_normal(self.n).astype(self.coeffs.dtype)
            )
            y_ref = matvec(x)
            y = self.mv(x)
            num = float(jnp.linalg.norm(y - y_ref))
            den = float(jnp.linalg.norm(y_ref)) or 1.0
            worst = max(worst, num / den)
        return worst


def _distribute_probe3(Y: jnp.ndarray, shape, radius: int) -> jnp.ndarray:
    """Distribute 3D colored-probe responses Y (m³, n) into coefficient
    planes C (m³, nx1, ny1, nz1).

    Coefficient k (offset o = (oi,oj,ok)) at node (i,j,k) is
    Y[color((i+oi)%m, (j+oj)%m, (k+ok)%m), i, j, k] — one leading-axis
    take_along_axis per offset inside a scan. The scan keeps the jit graph
    O(1) in m³ (the unrolled per-color slice form is 15k+ ops in 3D and
    compiles for minutes)."""
    nx1, ny1, nz1 = shape
    r = radius
    m = 2 * r + 1
    I, J, K = jnp.meshgrid(
        jnp.arange(nx1), jnp.arange(ny1), jnp.arange(nz1), indexing="ij"
    )
    Yr = Y.reshape(m**3, nx1, ny1, nz1)
    P = I % m
    Q = J % m
    S_ = K % m
    offs = jnp.asarray(
        [
            (oi, oj, ok)
            for oi in range(-r, r + 1)
            for oj in range(-r, r + 1)
            for ok in range(-r, r + 1)
        ],
        dtype=jnp.int32,
    )

    def body(_, o):
        idx = ((P + o[0]) % m * m + (Q + o[1]) % m) * m + (S_ + o[2]) % m
        return None, jnp.take_along_axis(Yr, idx[None], axis=0)[0]

    _, C = jax.lax.scan(body, None, offs)
    return C


@jax.tree_util.register_pytree_node_class
class StencilOperator3D:
    """A_b in variable-coefficient stencil form on an (nx+1, ny+1, nz+1)
    lattice (mesh.generators.box_mesh numbering: id = (i·ny1 + j)·nz1 + k).

    The 3D fast path for the reference's cube workloads (poisson --dim 3,
    biharmonic --dim 3): (2r+1)³ dense shifted multiply-adds replace the
    gather-bound general projected matvec. Same colored-probing extraction
    as 2D with (i, j, k) mod-m phases.
    """

    def __init__(self, coeffs: jnp.ndarray, shape, radius: int):
        self.coeffs = coeffs          # ((2r+1)³, nx1, ny1, nz1)
        self.shape = tuple(shape)
        self.radius = radius
        self.n = shape[0] * shape[1] * shape[2]

    @property
    def dtype(self):
        return self.coeffs.dtype

    def tree_flatten(self):
        return (self.coeffs,), (self.shape, self.radius)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        shape, radius = aux
        return cls(leaves[0], shape, radius)

    def astype(self, dtype) -> "StencilOperator3D":
        return StencilOperator3D(
            self.coeffs.astype(dtype), self.shape, self.radius
        )

    @staticmethod
    def probe_multi(matvec_multi, shape, radius: int = 2,
                    dtype=jnp.float32, chunk: int | None = None,
                    ) -> "StencilOperator3D":
        """Extract the (2r+1)³ stencil by one stacked (m³, n) probe."""
        nx1, ny1, nz1 = shape
        r = radius
        m = 2 * r + 1
        I, J, K = jnp.meshgrid(
            jnp.arange(nx1), jnp.arange(ny1), jnp.arange(nz1), indexing="ij"
        )
        X = jnp.stack(
            [
                ((I % m == a) & (J % m == b) & (K % m == c))
                .astype(dtype).reshape(-1)
                for a in range(m)
                for b in range(m)
                for c in range(m)
            ],
            axis=0,
        )                                                       # (m³, n)
        Y = chunked_mv_multi(matvec_multi, X, chunk).astype(dtype)  # (m³, n)
        C = _distribute_probe3(Y, shape, r)
        return StencilOperator3D(C, shape, r)

    def mv(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A_b x as (2r+1)³ shifted dense multiply-adds."""
        nx1, ny1, nz1 = self.shape
        r = self.radius
        m = 2 * r + 1
        x3 = x.reshape(nx1, ny1, nz1)
        xp = jnp.pad(x3, ((r, r), (r, r), (r, r)))
        y = jnp.zeros_like(x3)
        C = self.coeffs
        for oi in range(m):
            for oj in range(m):
                for ok in range(m):
                    kk = (oi * m + oj) * m + ok
                    shifted = jax.lax.dynamic_slice(
                        xp, (oi, oj, ok), (nx1, ny1, nz1)
                    )
                    y = y + C[kk] * shifted
        return y.reshape(-1)

    def diag(self) -> jnp.ndarray:
        r = self.radius
        m = 2 * r + 1
        k0 = (r * m + r) * m + r
        return self.coeffs[k0].reshape(-1)

    def verify(self, matvec, seed: int = 0, n_checks: int = 2) -> float:
        rng = np.random.default_rng(seed)
        worst = 0.0
        for _ in range(n_checks):
            x = jnp.asarray(
                rng.standard_normal(self.n).astype(self.coeffs.dtype)
            )
            y_ref = matvec(x)
            y = self.mv(x)
            num = float(jnp.linalg.norm(y - y_ref))
            den = float(jnp.linalg.norm(y_ref)) or 1.0
            worst = max(worst, num / den)
        return worst


@jax.tree_util.register_pytree_node_class
class StencilOperatorBlock3D:
    """Block (multi-field) stencil operator on an (nx+1, ny+1, nz+1)
    lattice — the 3D analog of StencilOperatorBlock2D for vector problems
    on box backgrounds. Background dofs are field-blocked
    (bg_id = node + field*m, common.py:703):

        y[f1] = Σ_{f2} Σ_{|d|<=r} C[f1, f2, d] ⊙ shift_d(x[f2])
    """

    def __init__(self, coeffs: jnp.ndarray, shape, radius: int):
        self.coeffs = coeffs      # (nF, nF, (2r+1)³, nx1, ny1, nz1)
        self.shape = tuple(shape)
        self.radius = radius
        self.n_fields = coeffs.shape[0]
        self.nn = shape[0] * shape[1] * shape[2]
        self.n = self.n_fields * self.nn

    @property
    def dtype(self):
        return self.coeffs.dtype

    def tree_flatten(self):
        return (self.coeffs,), (self.shape, self.radius)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        shape, radius = aux
        return cls(leaves[0], shape, radius)

    def astype(self, dtype) -> "StencilOperatorBlock3D":
        return StencilOperatorBlock3D(
            self.coeffs.astype(dtype), self.shape, self.radius
        )

    @staticmethod
    def probe_multi(matvec_multi, shape, n_fields: int, radius: int = 2,
                    dtype=jnp.float32, chunk: int | None = None,
                    ) -> "StencilOperatorBlock3D":
        """Extract the nF² (2r+1)³ stencils by one stacked (nF·m³, n)
        probe: field indicator × lattice phase colors (same disjoint-
        neighborhood argument as the 2D block probe)."""
        nx1, ny1, nz1 = shape
        nn = nx1 * ny1 * nz1
        r = radius
        m = 2 * r + 1
        I, J, K = jnp.meshgrid(
            jnp.arange(nx1), jnp.arange(ny1), jnp.arange(nz1), indexing="ij"
        )
        combs = [
            ((I % m == a) & (J % m == b) & (K % m == c))
            .astype(dtype).reshape(-1)
            for a in range(m)
            for b in range(m)
            for c in range(m)
        ]
        zero = jnp.zeros(nn, dtype)
        X = jnp.stack(
            [
                jnp.concatenate(
                    [c if f == f2 else zero for f in range(n_fields)]
                )
                for f2 in range(n_fields)
                for c in combs
            ],
            axis=0,
        )                                      # (nF·m³, nF·nn)
        Y = chunked_mv_multi(matvec_multi, X, chunk).astype(dtype)
        C = jnp.stack(
            [
                jnp.stack(
                    [
                        _distribute_probe3(
                            Y[f2 * m**3:(f2 + 1) * m**3,
                              f1 * nn:(f1 + 1) * nn],
                            shape, r,
                        )
                        for f2 in range(n_fields)
                    ]
                )
                for f1 in range(n_fields)
            ]
        )                                      # (nF, nF, m³, nx1, ny1, nz1)
        return StencilOperatorBlock3D(C, shape, radius)

    def mv(self, x: jnp.ndarray) -> jnp.ndarray:
        nF = self.n_fields
        nx1, ny1, nz1 = self.shape
        r = self.radius
        m = 2 * r + 1
        x4 = x.reshape(nF, nx1, ny1, nz1)
        xp = jnp.pad(x4, ((0, 0), (r, r), (r, r), (r, r)))

        # scan over the m³ offsets (unrolled, this is nF²·125 slice-FMAs —
        # the same compile-size hazard the scalar 3D probe avoids)
        offs = jnp.asarray(
            [
                (oi, oj, ok)
                for oi in range(m)
                for oj in range(m)
                for ok in range(m)
            ],
            dtype=jnp.int32,
        )
        Cr = self.coeffs                      # (nF, nF, m³, ...)

        def body(y, ko):
            k, o = ko
            sh = jnp.stack([
                jax.lax.dynamic_slice(
                    xp[f2], (o[0], o[1], o[2]), (nx1, ny1, nz1)
                )
                for f2 in range(nF)
            ])                                 # (nF, nx1, ny1, nz1)
            Ck = jnp.take(Cr, k, axis=2)       # (nF, nF, nx1, ny1, nz1)
            return y + jnp.einsum(
                "abxyz,bxyz->axyz", Ck, sh,
                precision=jax.lax.Precision.HIGHEST,
            ), None

        y0 = jnp.zeros_like(x4)
        y, _ = jax.lax.scan(
            body, y0, (jnp.arange(m**3, dtype=jnp.int32), offs)
        )
        return y.reshape(-1)

    def mv_multi(self, X: jnp.ndarray) -> jnp.ndarray:
        return jax.vmap(self.mv)(X)

    def diag(self) -> jnp.ndarray:
        r = self.radius
        m = 2 * r + 1
        k0 = (r * m + r) * m + r
        return jnp.stack(
            [self.coeffs[f, f, k0] for f in range(self.n_fields)]
        ).reshape(-1)

    def point_block_diag(self) -> jnp.ndarray:
        """(nF, nF, nn) nodal blocks for point-block-Jacobi smoothing."""
        r = self.radius
        m = 2 * r + 1
        k0 = (r * m + r) * m + r
        return self.coeffs[:, :, k0].reshape(
            self.n_fields, self.n_fields, self.nn
        )

    def verify(self, matvec, seed: int = 0, n_checks: int = 2) -> float:
        rng = np.random.default_rng(seed)
        worst = 0.0
        for _ in range(n_checks):
            x = jnp.asarray(
                rng.standard_normal(self.n).astype(self.coeffs.dtype)
            )
            y_ref = matvec(x)
            y = self.mv(x)
            num = float(jnp.linalg.norm(y - y_ref))
            den = float(jnp.linalg.norm(y_ref)) or 1.0
            worst = max(worst, num / den)
        return worst


def dirichlet_laplace_3d(shape, dtype=jnp.float64) -> StencilOperator3D:
    """Analytic 7-point finite-difference Dirichlet Laplacian on a box
    lattice, with identity rows on the boundary layer.

    The operator maps the subspace {x : x|boundary = 0} to itself, and on
    that subspace it is the SPD interior Laplacian — so CG with a zero
    initial guess and a boundary-zero rhs is well-posed. Used by the driver
    multichip dryrun and the sharding tests to exercise the sharded stencil
    path at scales where probing an element operator is unaffordable on the
    virtual CPU mesh.
    """
    nx1, ny1, nz1 = shape
    C = np.zeros((27, nx1, ny1, nz1), dtype=np.dtype(dtype))
    interior = np.zeros(shape, dtype=bool)
    interior[1:-1, 1:-1, 1:-1] = True
    C[13] = np.where(interior, 6.0, 1.0)      # center: (1,1,1) offset
    for k in (4, 22, 10, 16, 12, 14):         # the six axis neighbors
        C[k] = np.where(interior, -1.0, 0.0)
    return StencilOperator3D(jnp.asarray(C), shape, radius=1)
