"""Geometric multigrid preconditioning on stencil-form background operators.

The reference's strongest preconditioners (MUMPS LU, hypre ILU — SURVEY.md
§2.3 N5/N6) are sequential-factorization methods. The data-parallel
equivalent for lattice backgrounds is geometric multigrid over the probed
stencil operators:

* transfers are 3x3 full-weighting (strided convolution) and bilinear
  (interleaved midpoints) operators — dense ops, P = 4 Rᵀ so the V-cycle is
  symmetric;
* coarse operators are Galerkin products R A P, extracted *again by stencil
  probing* of the composed operator (ops/stencil.py) — each level's operator
  stays a 5x5 variable-coefficient stencil;
* smoothing is weighted Jacobi (fixed sweep counts -> a linear, symmetric
  preconditioner, valid inside CG); the coarsest level is handled by a dense
  Newton–Schulz pseudo-inverse (or fixed Jacobi sweeps).

Zero rows (background dofs with no foreground support — the BFR situation,
common.py:261-332) get unit diagonal guards; their components stay zero
through the whole cycle.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from iifea.ops.stencil import (
    StencilOperator2D,
    StencilOperator3D,
    StencilOperatorBlock2D,
)

def _warn_weak_coarse(shape, dense_ok: bool) -> None:
    """Flag a hierarchy that bottoms out too large for the dense inverse.

    The vertex-centered coarsening halves a side s only while (s - 1) is
    even, so a lattice whose sides are not (2^k·m + 1) with small m stops
    early; the Jacobi-sweep 'coarse solve' then leaves low frequencies
    untouched and the V-cycle degrades to a smoother. This is a sizing
    mistake worth a loud warning: the first 3D 1M-dof bench ran n_bg=100
    (101-51-26 ladder, 17.6k-dof coarse level) and spent 3132 CG
    iterations where the 105-53-27-14 ladder takes ~1/20th of that.
    """
    if not dense_ok:
        from iifea.utils.logging import log_info

        log_info(
            f"[multigrid] WARNING: coarsest level {shape} exceeds the "
            "dense-inverse cap; the V-cycle will be weak on low "
            "frequencies. Choose the lattice so every side coarsens to "
            "O(10): side = 2^k*m + 1 with a small odd m."
        )


# Every f32 contraction and convolution in the hierarchy build and the cycle
# pins full f32 precision: at DEFAULT precision a backend may compute them
# in reduced precision (TF32 on NVIDIA tensor cores keeps ~3 decimal
# digits), which turns the V-cycle into a noisy, non-symmetric operator.
_HI = jax.lax.Precision.HIGHEST

_KERNEL = np.array(
    [[0.25, 0.5, 0.25], [0.5, 1.0, 0.5], [0.25, 0.5, 0.25]]
)
_W1 = np.array([0.5, 1.0, 0.5])
_KERNEL3 = _W1[:, None, None] * _W1[None, :, None] * _W1[None, None, :]


def _restrict(x2: jnp.ndarray) -> jnp.ndarray:
    """Full-weighting: y[i,j] = (1/4) Σ k[a,b] x[2i+a-1, 2j+b-1]."""
    k = jnp.asarray(_KERNEL / 4.0, x2.dtype)[None, None]
    y = jax.lax.conv_general_dilated(
        x2[None, None], k, window_strides=(2, 2), padding=((1, 1), (1, 1)),
        precision=_HI,
    )
    return y[0, 0]


def _interleave_cols(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(m, n), (m, n-1) -> (m, 2n-1): a0 b0 a1 b1 ... a_{n-1}."""
    m, n = a.shape
    body = jnp.stack([a[:, :-1], b], axis=2).reshape(m, 2 * (n - 1))
    return jnp.concatenate([body, a[:, -1:]], axis=1)


def _interleave_rows(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(m, n), (m-1, n) -> (2m-1, n): a0 b0 a1 b1 ... a_{m-1}."""
    m, n = a.shape
    body = jnp.stack([a[:-1], b], axis=1).reshape(2 * (m - 1), n)
    return jnp.concatenate([body, a[-1:]], axis=0)


def _prolong(xc2: jnp.ndarray) -> jnp.ndarray:
    """Bilinear interpolation (P = 4 Rᵀ): separable interleave of midpoints."""
    rows = _interleave_rows(xc2, 0.5 * (xc2[:-1] + xc2[1:]))
    return _interleave_cols(rows, 0.5 * (rows[:, :-1] + rows[:, 1:]))


def _restrict3(x3: jnp.ndarray) -> jnp.ndarray:
    """3D full-weighting: trilinear kernel / 8, stride 2."""
    k = jnp.asarray(_KERNEL3 / 8.0, x3.dtype)[None, None]
    y = jax.lax.conv_general_dilated(
        x3[None, None], k, window_strides=(2, 2, 2),
        padding=((1, 1), (1, 1), (1, 1)), precision=_HI,
    )
    return y[0, 0]


def _interleave_axis(a: jnp.ndarray, axis: int) -> jnp.ndarray:
    """(..., m, ...) -> (..., 2m-1, ...): values interleaved with midpoints."""
    a = jnp.moveaxis(a, axis, 0)
    mid = 0.5 * (a[:-1] + a[1:])
    m = a.shape[0]
    body = jnp.stack([a[:-1], mid], axis=1).reshape((2 * (m - 1),) + a.shape[1:])
    out = jnp.concatenate([body, a[-1:]], axis=0)
    return jnp.moveaxis(out, 0, axis)


def _prolong3(xc3: jnp.ndarray) -> jnp.ndarray:
    """Trilinear interpolation (P = 8 Rᵀ): separable interleave per axis."""
    y = _interleave_axis(xc3, 0)
    y = _interleave_axis(y, 1)
    return _interleave_axis(y, 2)


@jax.jit
def _coarsen_probe(fine: "StencilOperator2D") -> "StencilOperator2D":
    """Galerkin coarse operator R A P, re-probed into stencil form.

    Kept as the test oracle for :func:`_coarsen` (the direct composition):
    the (2r+1)² probe columns go through a vmapped prolong->A->restrict
    batch; above 2M dofs the columns are chunked through lax.map so the
    25-wide padded intermediates stay within HBM."""
    cshape = tuple((s - 1) // 2 + 1 for s in fine.shape)

    def rap_one(xc):
        xf = _prolong(xc.reshape(cshape))
        yf = fine.mv(xf.reshape(-1)).reshape(fine.shape)
        return _restrict(yf).reshape(-1)

    if fine.n > 2_000_000:
        def rap_multi(X):
            return jax.lax.map(rap_one, X, batch_size=5)
    else:
        rap_multi = jax.vmap(rap_one)

    return StencilOperator2D.probe_multi(
        rap_multi, cshape, radius=fine.radius, dtype=fine.dtype
    )


# -- direct Galerkin composition (no probing) ---------------------------------
#
# For stencil A (y[p] = Σ_d C[d,p] x[p+d]), full-weighting R (weights
# w[u]/2^dim on u ∈ {-1,0,1}^dim) and bilinear P = 2^dim Rᵀ, the coarse
# stencil is itself a closed-form contraction: with f = 2I+u and g = f+d,
#
#   (R A P)[I, I+T] = (1/2^dim) Σ_{u,d} w[u] w[u+d-2T] C[d, 2I+u]
#
# where v = u+d-2T must lie in {-1,0,1}^dim (P's support). For fixed (T,d)
# that inner sum over u is a 3^dim kernel applied to the coefficient plane
# C[d] at stride 2 — i.e. the whole RAP is ONE strided convolution with
# (2r+1)^dim input channels (fine planes, index d), (2r+1)^dim output
# channels (coarse planes, index T), and a 3^dim window. One pass over the
# fine coefficient planes replaces (2r+1)^dim full prolong->A->restrict
# probe applications (the dominant mg_build cost, PERF.md §6).


def _rap_k1(radius: int) -> np.ndarray:
    """Per-dimension factor k1[t+r, d+r, u+1] = w[u] · w[u+d-2t]."""
    r = radius
    m = 2 * r + 1
    k1 = np.zeros((m, m, 3))
    for t in range(-r, r + 1):
        for dk in range(-r, r + 1):
            for u in (-1, 0, 1):
                v = u + dk - 2 * t
                if -1 <= v <= 1:
                    k1[t + r, dk + r, u + 1] = _W1[u + 1] * _W1[v + 1]
    return k1


def _rap_kernel2(radius: int) -> np.ndarray:
    """(m², m², 3, 3) OIHW conv kernel for the 2D direct RAP."""
    k1 = _rap_k1(radius)
    m = 2 * radius + 1
    K = 0.25 * np.einsum("adu,bev->abdeuv", k1, k1)
    return np.ascontiguousarray(K.reshape(m * m, m * m, 3, 3))


def _rap_kernel3(radius: int) -> np.ndarray:
    """(m³, m³, 3, 3, 3) OIDHW conv kernel for the 3D direct RAP."""
    k1 = _rap_k1(radius)
    m = 2 * radius + 1
    K = 0.125 * np.einsum("adu,bev,cfw->abcdefuvw", k1, k1, k1)
    return np.ascontiguousarray(K.reshape(m ** 3, m ** 3, 3, 3, 3))


def _offgrid_mask2(shape, radius) -> np.ndarray:
    """mask[d, i, j] = 1 where the offset-d neighbor of (i, j) is in-grid.

    Probed stencils already carry exact zeros at off-grid columns (their
    indicator combs have no source there), but operators built by other
    constructors may hold garbage the zero-padded matvec never reads; the
    direct RAP *does* read those slots, so they are masked."""
    nx1, ny1 = shape
    r = radius
    m = 2 * r + 1
    ii = np.arange(nx1)[:, None]
    jj = np.arange(ny1)[None, :]
    mask = np.empty((m * m, nx1, ny1), dtype=np.float32)
    for oi in range(-r, r + 1):
        for oj in range(-r, r + 1):
            k = (oi + r) * m + (oj + r)
            mask[k] = (
                (ii + oi >= 0) & (ii + oi < nx1)
                & (jj + oj >= 0) & (jj + oj < ny1)
            )
    return mask


def _offgrid_mask3(shape, radius) -> np.ndarray:
    nx1, ny1, nz1 = shape
    r = radius
    m = 2 * r + 1
    ii = np.arange(nx1)[:, None, None]
    jj = np.arange(ny1)[None, :, None]
    kk = np.arange(nz1)[None, None, :]
    mask = np.empty((m ** 3, nx1, ny1, nz1), dtype=np.float32)
    for oi in range(-r, r + 1):
        for oj in range(-r, r + 1):
            for ok in range(-r, r + 1):
                k = ((oi + r) * m + (oj + r)) * m + (ok + r)
                mask[k] = (
                    (ii + oi >= 0) & (ii + oi < nx1)
                    & (jj + oj >= 0) & (jj + oj < ny1)
                    & (kk + ok >= 0) & (kk + ok < nz1)
                )
    return mask


def _axis_indicators(n, radius):
    """1D in-grid indicators per offset: [(off, (n,) 0/1 vector)].

    The off-grid mask is separable — mask[d] = mx(oi) ⊗ my(oj) (⊗ mz(ok))
    — so building it from per-axis iotas INSIDE the jit keeps the graph
    free of (m^dim, *shape) host constants: baking the numpy mask made the
    fine-level _coarsen3 HLO carry a ~0.5 GB constant at 101³. The
    broadcasted products also fuse into the coeff multiply without ever
    materializing the full mask."""
    ii = jnp.arange(n)
    return [
        ((ii + o >= 0) & (ii + o < n)) for o in range(-radius, radius + 1)
    ]


def _masked_coeffs2(fine):
    mx = _axis_indicators(fine.shape[0], fine.radius)
    my = _axis_indicators(fine.shape[1], fine.radius)
    m = 2 * fine.radius + 1
    mask = jnp.stack([
        (mx[a][:, None] & my[b][None, :]) for a in range(m) for b in range(m)
    ]).astype(fine.dtype)
    return fine.coeffs * mask


def _masked_coeffs3(fine):
    mx = _axis_indicators(fine.shape[0], fine.radius)
    my = _axis_indicators(fine.shape[1], fine.radius)
    mz = _axis_indicators(fine.shape[2], fine.radius)
    m = 2 * fine.radius + 1
    mask = jnp.stack([
        (mx[a][:, None, None] & my[b][None, :, None] & mz[c][None, None, :])
        for a in range(m) for b in range(m) for c in range(m)
    ]).astype(fine.dtype)
    return fine.coeffs * mask


@jax.jit
def _coarsen(fine: "StencilOperator2D") -> "StencilOperator2D":
    """Direct Galerkin coarse operator: one strided conv over the
    coefficient planes (see the derivation above)."""
    cshape = tuple((s - 1) // 2 + 1 for s in fine.shape)
    C = _masked_coeffs2(fine)
    K = jnp.asarray(_rap_kernel2(fine.radius), fine.dtype)
    y = jax.lax.conv_general_dilated(
        C[None], K, window_strides=(2, 2), padding=((1, 1), (1, 1)),
        precision=_HI,
    )
    return StencilOperator2D(y[0], cshape, fine.radius)


@jax.jit
def _invd(S: "StencilOperator2D") -> jnp.ndarray:
    """Flat 1/diag (unit guard on zero rows), loop-invariant smoother operand."""
    d = S.diag()
    return 1.0 / jnp.where(jnp.abs(d) > 0, d, 1.0)


@jax.jit
def _dense_inverse(S: "StencilOperator2D") -> jnp.ndarray:
    """Explicit inverse of the coarsest operator (n ~ 33² = 1089).

    The MUMPS-coarse-grid role (SURVEY.md N5) at a size where a dense
    inverse is trivial. Zero rows (unsupported background
    dofs) get unit diagonals; their components pass through unchanged.
    Galerkin coarse operators of the singular projected system can carry
    null directions that are NOT axis-aligned (coarse basis functions whose
    fine interpolant lives only on unsupported dofs) — a plain inverse is
    NaN there, so the solve is a truncated pseudo-inverse (the dense analog
    of MUMPS null-pivot detection, common.py:535-539).
    """
    n = S.n
    A = jax.vmap(S.mv)(jnp.eye(n, dtype=S.dtype)).T
    d = jnp.diagonal(A)
    A = A + jnp.diag(jnp.where(jnp.abs(d) > 0, 0.0, 1.0).astype(A.dtype))
    return _pinv(A)


def _pinv(A: jnp.ndarray, iters: int = 50) -> jnp.ndarray:
    """Pseudo-inverse by Newton–Schulz iteration: X ← X(2I − AX).

    Matmul-only (no SVD/eigh factorization in the graph). With X₀ = Aᵀ/(‖A‖₁‖A‖∞), singular modes σ ≳ 2^{-iters/2}·σmax
    converge quadratically to 1/σ while exact/tiny null modes never amplify
    past ~1/σmax — a soft truncated pinv, i.e. built-in null-pivot handling.
    Validated to ~3e-12 relative action error on the range of a singular
    Galerkin coarse operator at 40 iterations.
    """
    n1 = jnp.max(jnp.sum(jnp.abs(A), axis=0))
    ninf = jnp.max(jnp.sum(jnp.abs(A), axis=1))
    alpha = 1.0 / (n1 * ninf)        # ≤ 1/σmax² since σmax² ≤ ‖A‖₁‖A‖∞
    I2 = 2.0 * jnp.eye(A.shape[0], dtype=A.dtype)

    def mm(a, b):
        # reduced-precision products destroy the 2I − AX cancellation
        # and the iteration diverges
        return jnp.matmul(a, b, precision=_HI)

    def body(_, X):
        return mm(X, I2 - mm(A, X))

    return jax.lax.fori_loop(0, iters, body, alpha * A.T)


from functools import partial as _partial


def jacobi_sweeps(S, invd, b, x, omega, sweeps: int):
    """``sweeps`` weighted-Jacobi sweeps x ← x + ω·invd·(b − S x)."""

    def body(_, x):
        return x + omega * invd * (b - S.mv(x))

    return jax.lax.fori_loop(0, sweeps, body, x)


def _lmax_jacobi(S, invd, iters: int = 14) -> jnp.ndarray:
    """Spectral radius estimate of the Jacobi-preconditioned operator
    D⁻¹A by power iteration (deterministic start, jit-safe). Feeds the
    Chebyshev smoother's interval; a few % overestimate is harmless (the
    1.05 safety factor at the use site absorbs underestimates)."""
    n = S.n
    x = 1.0 + 0.3 * jnp.cos(jnp.arange(n, dtype=S.dtype))

    def body(_, x):
        y = invd * S.mv(x)
        return y / jnp.linalg.norm(y)

    x = jax.lax.fori_loop(0, iters, body, x)
    return jnp.linalg.norm(invd * S.mv(x))


@_partial(jax.jit, static_argnames=("n_tail", "dense_ok", "need_lmax"))
def _build_tail(S_top, n_tail, dense_ok, need_lmax=False):
    """Coarsen n_tail levels below S_top, their 1/diags, the coarsest dense
    pseudo-inverse, and (for the Chebyshev smoother) per-level λmax — in
    ONE compiled graph (dispatch-latency batching; see
    StencilMultigrid.__init__)."""
    levels = [S_top]
    for _ in range(n_tail):
        levels.append(_coarsen(levels[-1]))
    invds = [_invd(l) for l in levels]
    cinv = _dense_inverse(levels[-1]) if dense_ok else None
    lmaxs = (
        [_lmax_jacobi(l, d) for l, d in zip(levels, invds)]
        if need_lmax else None
    )
    return levels[1:], invds, cinv, lmaxs


@jax.tree_util.register_pytree_node_class
class StencilMultigrid:
    """Symmetric V-cycle preconditioner for a StencilOperator2D.

    Requires the fine lattice to be (2^k m + 1)² shaped; coarsening stops
    when a side would drop below ``min_size``. Registered as a pytree so the
    (setup-heavy) hierarchy can be built in one jit and reused across solves.
    """

    def tree_flatten(self):
        return (self.levels, self.inv_diags, self.coarse_inv, self.lmaxs), (
            self.nu_pre, self.nu_post, self.omega, self.coarse_sweeps,
            self.smoother,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.levels, obj.inv_diags, obj.coarse_inv, obj.lmaxs = children
        (obj.nu_pre, obj.nu_post, obj.omega, obj.coarse_sweeps,
         obj.smoother) = aux
        return obj

    def __init__(
        self,
        S: StencilOperator2D,
        nu_pre: int = 2,
        nu_post: int = 2,
        omega: float = 0.67,
        coarse_sweeps: int = 60,
        min_size: int = 33,
        coarse_dense: bool = True,
        smoother: str = "jacobi",
    ):
        self.nu_pre, self.nu_post = nu_pre, nu_post
        self.omega = omega
        self.coarse_sweeps = coarse_sweeps
        self.smoother = smoother
        # The whole hierarchy builds in ONE jitted graph (one dispatch
        # instead of one per level and quantity).
        shapes = [tuple(S.shape)]
        while all((s - 1) % 2 == 0 and s > min_size for s in shapes[-1]):
            shapes.append(tuple((s - 1) // 2 + 1 for s in shapes[-1]))
        n_levels = len(shapes)
        dense_ok = coarse_dense and (
            shapes[-1][0] * shapes[-1][1] <= 4096
        )
        _warn_weak_coarse(shapes[-1], dense_ok)

        self.levels = [S]
        tail_levels, invds, cinv, lmaxs = _build_tail(
            S, n_levels - 1, dense_ok, need_lmax=(smoother == "chebyshev")
        )
        self.levels.extend(tail_levels)
        self.inv_diags = invds
        self.lmaxs = lmaxs
        # exact coarsest solve: a dense pseudo-inverse both converges better
        # and costs less per cycle than deep towers of tiny smoothing ops
        self.coarse_inv = cinv

    # -- cycle ------------------------------------------------------------------

    def _smooth(self, lvl: int, x, b, sweeps: int):
        if self.smoother == "chebyshev" and self.lmaxs is not None:
            return self._smooth_cheb(lvl, x, b, sweeps)
        return jacobi_sweeps(self.levels[lvl], self.inv_diags[lvl], b, x,
                             self.omega, sweeps)

    def _smooth_cheb(self, lvl: int, x, b, sweeps: int):
        """Chebyshev polynomial smoothing on the Jacobi-preconditioned
        operator (hypre-style): same one-matvec-per-sweep cost as weighted
        Jacobi; fixed coefficients => a linear, D-symmetric smoother,
        valid inside plain CG.

        Measured on the immersed cut-cell operator (128² bench fixture):
        NO iteration win over ω=0.67 Jacobi (26 vs 26-36 over the α sweep;
        the β·h⁻¹ penalty outliers dominate λmax, so the textbook
        upper-quarter interval targets penalty modes instead of rough
        Laplacian modes). Kept as an option for smoother-sensitive
        operators; the default stays 'jacobi'."""
        if sweeps <= 0:
            return x
        S = self.levels[lvl]
        invd = self.inv_diags[lvl]
        hi = 1.05 * self.lmaxs[lvl]
        lo = hi / 4.0
        theta = 0.5 * (hi + lo)
        delta = 0.5 * (hi - lo)
        sigma = theta / delta
        rho = 1.0 / sigma
        r = invd * (b - S.mv(x))
        d = r / theta
        x = x + d
        for _ in range(sweeps - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = invd * (b - S.mv(x))
            d = rho_new * (2.0 * r / delta + rho * d)
            x = x + d
            rho = rho_new
        return x

    def _vcycle(self, lvl: int, b):
        S = self.levels[lvl]
        if lvl == len(self.levels) - 1:
            if self.coarse_inv is not None:
                return jnp.matmul(self.coarse_inv, b, precision=_HI)
            return self._smooth(lvl, jnp.zeros_like(b), b, self.coarse_sweeps)
        x = self._smooth(lvl, jnp.zeros_like(b), b, self.nu_pre)
        r = b - S.mv(x)
        rc = _restrict(r.reshape(S.shape)).reshape(-1)
        xc = self._vcycle(lvl + 1, rc)
        x = x + _prolong(
            xc.reshape(self.levels[lvl + 1].shape)
        ).reshape(-1)
        return self._smooth(lvl, x, b, self.nu_post)

    def minv(self, r):
        return self._vcycle(0, r)


@jax.jit
def _coarsen3_probe(fine: "StencilOperator3D") -> "StencilOperator3D":
    """3D Galerkin coarse operator by re-probing (oracle for _coarsen3)."""
    cshape = tuple((s - 1) // 2 + 1 for s in fine.shape)

    def rap_one(xc):
        xf = _prolong3(xc.reshape(cshape))
        yf = fine.mv(xf.reshape(-1)).reshape(fine.shape)
        return _restrict3(yf).reshape(-1)

    return StencilOperator3D.probe_multi(
        jax.vmap(rap_one), cshape, radius=fine.radius, dtype=fine.dtype
    )


# planes above this size take the chunked-conv path of _coarsen3 (tests
# lower it to pin chunked-vs-monolithic parity on small fixtures)
_COARSEN3_MONO_BYTES = 2 ** 28


@jax.jit
def _coarsen3(fine: "StencilOperator3D") -> "StencilOperator3D":
    """3D direct Galerkin coarse operator (strided conv, see _coarsen).

    At bench scale the monolithic conv's 125-channel im2col workspace is
    several GB on top of the pipeline residents (window tables + bound f64
    blocks + fine planes, tools/audit3d_mem.py). Above a plane-size
    threshold the in-channel axis is scanned in chunks — each step convolves a
    (1, chunk, ...) slab against K[:, chunk] and accumulates, shrinking the
    live conv workspace ~m³/chunk x while keeping one traced graph."""
    cshape = tuple((s - 1) // 2 + 1 for s in fine.shape)
    C = _masked_coeffs3(fine)
    K = jnp.asarray(_rap_kernel3(fine.radius), fine.dtype)
    m3 = C.shape[0]
    if C.size * C.dtype.itemsize <= _COARSEN3_MONO_BYTES:  # small: one conv
        y = jax.lax.conv_general_dilated(
            C[None], K, window_strides=(2, 2, 2),
            padding=((1, 1), (1, 1), (1, 1)), precision=_HI,
        )
        return StencilOperator3D(y[0], cshape, fine.radius)

    chunk = 25 if m3 % 25 == 0 else (9 if m3 % 9 == 0 else 1)

    def body(acc, i):
        Ci = jax.lax.dynamic_slice_in_dim(C, i * chunk, chunk, 0)
        Ki = jax.lax.dynamic_slice_in_dim(K, i * chunk, chunk, 1)
        y = jax.lax.conv_general_dilated(
            Ci[None], Ki, window_strides=(2, 2, 2),
            padding=((1, 1), (1, 1), (1, 1)), precision=_HI,
        )
        return acc + y[0], None

    y0 = jnp.zeros((m3,) + cshape, fine.dtype)
    y, _ = jax.lax.scan(body, y0, jnp.arange(m3 // chunk), unroll=1)
    return StencilOperator3D(y, cshape, fine.radius)


@jax.jit
def _invd3(S: "StencilOperator3D") -> jnp.ndarray:
    d = S.diag()
    return 1.0 / jnp.where(jnp.abs(d) > 0, d, 1.0)


@jax.jit
def _invd3_l1(S: "StencilOperator3D") -> jnp.ndarray:
    """1 / ℓ1 row sums: the hypre-style l1-Jacobi smoother diagonal.

    Sliver-cut 3D stencils have rows with tiny diagonals but significant
    off-diagonal coupling, so λmax(D⁻¹A) is unbounded and plain weighted
    Jacobi DIVERGES (observed ~15x/sweep growth at 17³). For SPD A,
    x'Ax ≤ x'D_l1 x (Young's inequality on Σ aᵢⱼxᵢxⱼ), so λ(D_l1⁻¹A) ∈
    [0, 1] and the ω=1 sweep is unconditionally contractive. Row i's
    entries are exactly coeffs[:, i] — the row sum is an elementwise
    reduction over stencil planes, no matvec needed."""
    d = jnp.abs(S.coeffs).sum(axis=0).reshape(-1)
    return 1.0 / jnp.where(d > 0, d, 1.0)


@jax.jit
def _dense_inverse3(S: "StencilOperator3D") -> jnp.ndarray:
    """Explicit pseudo-inverse of the coarsest 3D operator (n ~ 9³..17³);
    see _dense_inverse for why a plain inverse is not safe here."""
    n = S.n
    A = jax.vmap(S.mv)(jnp.eye(n, dtype=S.dtype)).T
    d = jnp.diagonal(A)
    A = A + jnp.diag(jnp.where(jnp.abs(d) > 0, 0.0, 1.0).astype(A.dtype))
    return _pinv(A)


@jax.tree_util.register_pytree_node_class
class StencilMultigrid3D:
    """Symmetric V-cycle preconditioner for a StencilOperator3D.

    Same structure as the 2D cycle (full-weighting/trilinear transfers,
    Galerkin re-probed coarse stencils, weighted-Jacobi smoothing, dense
    coarsest inverse) — the on-device stand-in for the reference's 3D
    MUMPS path (poisson.py:207-210, SURVEY.md N5)."""

    def tree_flatten(self):
        return (self.levels, self.inv_diags, self.coarse_inv), (
            self.nu_pre, self.nu_post, self.omega, self.coarse_sweeps,
            self.smoother, self.cheb_alpha,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.levels, obj.inv_diags, obj.coarse_inv = children
        (obj.nu_pre, obj.nu_post, obj.omega, obj.coarse_sweeps,
         obj.smoother, obj.cheb_alpha) = aux
        return obj

    def __init__(
        self,
        S: StencilOperator3D,
        nu_pre: int = 2,
        nu_post: int = 2,
        omega: float = 1.0,
        coarse_sweeps: int = 60,
        min_size: int = 9,
        coarse_dense: bool = True,
        smoother: str = "chebyshev",
        cheb_alpha: float = 8.0,
    ):
        self.nu_pre, self.nu_post = nu_pre, nu_post
        self.omega = omega
        self.coarse_sweeps = coarse_sweeps
        self.smoother = smoother
        self.cheb_alpha = cheb_alpha
        self.levels = [S]
        while all((s - 1) % 2 == 0 and s > min_size for s in self.levels[-1].shape):
            self.levels.append(_coarsen3(self.levels[-1]))
        # l1-Jacobi (ω=1): unconditionally stable on sliver-cut stencils,
        # where plain ω=0.67 diagonal Jacobi diverges (see _invd3_l1)
        self.inv_diags = [_invd3_l1(S_l) for S_l in self.levels]
        dense_ok = coarse_dense and self.levels[-1].n <= 8192
        _warn_weak_coarse(self.levels[-1].shape, dense_ok)
        self.coarse_inv = _dense_inverse3(self.levels[-1]) if dense_ok else None

    def _smooth(self, lvl: int, x, b, sweeps: int):
        S = self.levels[lvl]
        invd = self.inv_diags[lvl]
        if self.smoother == "chebyshev":
            # Chebyshev on the l1-scaled operator, fixed interval
            # [λmax/α, λmax] with λmax = 1.05: the l1 scaling bounds the
            # spectrum by 1 (Gershgorin), so no power-iteration estimate is
            # needed and stability on sliver-cut stencils is kept. Measured
            # on the 3D immersed bench fixture (17³, fg/bg 1.26): 20 PCG
            # iters to 1e-6 vs 32 with the ω=1 l1-Jacobi sweeps at the
            # SAME one-matvec-per-sweep cost — unlike 2D, where Chebyshev
            # bought nothing (see StencilMultigrid._smooth_cheb notes),
            # the 3D l1 row sums run ~4x the diagonal and plain l1-Jacobi
            # under-relaxes into a weak smoother.
            if sweeps <= 0:
                return x
            hi = 1.05
            lo = hi / self.cheb_alpha
            theta = 0.5 * (hi + lo)
            delta = 0.5 * (hi - lo)
            sigma = theta / delta
            rho = 1.0 / sigma
            r = invd * (b - S.mv(x))
            d = r / theta
            x = x + d
            for _ in range(sweeps - 1):
                rho_new = 1.0 / (2.0 * sigma - rho)
                r = invd * (b - S.mv(x))
                d = rho_new * (2.0 * r / delta + rho * d)
                x = x + d
                rho = rho_new
            return x
        return jacobi_sweeps(S, invd, b, x, self.omega, sweeps)

    def _vcycle(self, lvl: int, b):
        S = self.levels[lvl]
        if lvl == len(self.levels) - 1:
            if self.coarse_inv is not None:
                return jnp.matmul(self.coarse_inv, b, precision=_HI)
            return self._smooth(lvl, jnp.zeros_like(b), b, self.coarse_sweeps)
        x = self._smooth(lvl, jnp.zeros_like(b), b, self.nu_pre)
        r = b - S.mv(x)
        rc = _restrict3(r.reshape(S.shape)).reshape(-1)
        xc = self._vcycle(lvl + 1, rc)
        x = x + _prolong3(
            xc.reshape(self.levels[lvl + 1].shape)
        ).reshape(-1)
        return self._smooth(lvl, x, b, self.nu_post)

    def minv(self, r):
        return self._vcycle(0, r)


@jax.jit
def _coarsen_block_probe(
    fine: "StencilOperatorBlock2D",
) -> "StencilOperatorBlock2D":
    """Block Galerkin coarse operator by re-probing (oracle for
    _coarsen_block)."""
    cshape = tuple((s - 1) // 2 + 1 for s in fine.shape)
    nF = fine.n_fields

    def rap_one(xc):
        x3 = xc.reshape((nF,) + cshape)
        xf = jnp.stack([_prolong(x3[f]) for f in range(nF)])
        yf = fine.mv(xf.reshape(-1)).reshape((nF,) + fine.shape)
        yc = jnp.stack([_restrict(yf[f]) for f in range(nF)])
        return yc.reshape(-1)

    return StencilOperatorBlock2D.probe_multi(
        jax.vmap(rap_one), cshape, n_fields=nF, radius=fine.radius,
        dtype=fine.dtype,
    )


@jax.jit
def _coarsen_block(fine: "StencilOperatorBlock2D") -> "StencilOperatorBlock2D":
    """Direct block Galerkin coarse operator: the per-field transfers act
    identically on every (f1, f2) coefficient block, so the scalar RAP conv
    (see _coarsen) batches over the nF² blocks."""
    cshape = tuple((s - 1) // 2 + 1 for s in fine.shape)
    nF = fine.n_fields
    m2 = (2 * fine.radius + 1) ** 2
    nx1, ny1 = fine.shape
    C = _masked_coeffs2(fine)
    K = jnp.asarray(_rap_kernel2(fine.radius), fine.dtype)
    y = jax.lax.conv_general_dilated(
        C.reshape(nF * nF, m2, nx1, ny1), K,
        window_strides=(2, 2), padding=((1, 1), (1, 1)), precision=_HI,
    )
    return StencilOperatorBlock2D(
        y.reshape(nF, nF, m2, cshape[0], cshape[1]), cshape, fine.radius
    )


def _adjugate_inv(Bn: jnp.ndarray):
    """Batched closed-form (cofactor) inverse of (n, k, k) blocks, k <= 3.

    The explicit adjugate is plain elementwise arithmetic over the batch
    (no batched LU custom call for 2x2/3x3 blocks). Returns (inv, det)."""
    k = Bn.shape[-1]
    if k == 1:
        det = Bn[:, 0, 0]
        return (1.0 / det)[:, None, None], det
    if k == 2:
        a, b = Bn[:, 0, 0], Bn[:, 0, 1]
        c, d = Bn[:, 1, 0], Bn[:, 1, 1]
        det = a * d - b * c
        adj = jnp.stack(
            [jnp.stack([d, -b], -1), jnp.stack([-c, a], -1)], -2
        )
        return adj / det[:, None, None], det
    if k == 3:
        c00 = Bn[:, 1, 1] * Bn[:, 2, 2] - Bn[:, 1, 2] * Bn[:, 2, 1]
        c01 = Bn[:, 1, 2] * Bn[:, 2, 0] - Bn[:, 1, 0] * Bn[:, 2, 2]
        c02 = Bn[:, 1, 0] * Bn[:, 2, 1] - Bn[:, 1, 1] * Bn[:, 2, 0]
        c10 = Bn[:, 0, 2] * Bn[:, 2, 1] - Bn[:, 0, 1] * Bn[:, 2, 2]
        c11 = Bn[:, 0, 0] * Bn[:, 2, 2] - Bn[:, 0, 2] * Bn[:, 2, 0]
        c12 = Bn[:, 0, 1] * Bn[:, 2, 0] - Bn[:, 0, 0] * Bn[:, 2, 1]
        c20 = Bn[:, 0, 1] * Bn[:, 1, 2] - Bn[:, 0, 2] * Bn[:, 1, 1]
        c21 = Bn[:, 0, 2] * Bn[:, 1, 0] - Bn[:, 0, 0] * Bn[:, 1, 2]
        c22 = Bn[:, 0, 0] * Bn[:, 1, 1] - Bn[:, 0, 1] * Bn[:, 1, 0]
        det = (Bn[:, 0, 0] * c00 + Bn[:, 0, 1] * c01 + Bn[:, 0, 2] * c02)
        adj = jnp.stack(
            [jnp.stack([c00, c10, c20], -1),
             jnp.stack([c01, c11, c21], -1),
             jnp.stack([c02, c12, c22], -1)], -2
        )
        return adj / det[:, None, None], det
    raise NotImplementedError(f"closed-form inverse for k <= 3, got {k}")


@jax.jit
def _point_binv(S: "StencilOperatorBlock2D") -> jnp.ndarray:
    """(nF, nF, nn) inverses of the ℓ1-REGULARIZED nodal diagonal blocks;
    identity on singular blocks (unsupported background nodes — BFR guard).

    Each node's block is B_i + diag(Σ off-block |row sums|): the block
    analog of the l1-Jacobi diagonal (_invd3_l1). For SPD A this bounds
    λ(D⁻¹A) ≤ 1 (ω=1 sweeps contract); on stabilized saddle-point systems
    (NS-VMS: near-zero pressure diagonal) it keeps the smoother bounded
    where the raw block inverse explodes."""
    B = S.point_block_diag()                        # (nF, nF, nn)
    nF = B.shape[0]
    nn = B.shape[-1]
    # Σ_{f2,k} |C[f1, f2, k, :]| minus the center block's |row sums|
    l1_off = (
        jnp.abs(S.coeffs).sum(axis=(1, 2)).reshape(nF, nn)
        - jnp.abs(B).sum(axis=1)
    )
    eye = jnp.eye(nF, dtype=B.dtype)
    Breg = B + eye[:, :, None] * l1_off[:, None, :]
    Bn = jnp.moveaxis(Breg, -1, 0)                  # (nn, nF, nF)
    inv, det = _adjugate_inv(Bn)
    ok = (jnp.abs(det) > 1e-30)[:, None, None]
    return jnp.moveaxis(jnp.where(ok, inv, eye[None]), 0, -1)


@jax.jit
def _dense_inverse_block(S: "StencilOperatorBlock2D") -> jnp.ndarray:
    A = jax.vmap(S.mv)(jnp.eye(S.n, dtype=S.dtype)).T
    d = jnp.diagonal(A)
    A = A + jnp.diag(jnp.where(jnp.abs(d) > 0, 0.0, 1.0).astype(A.dtype))
    return _pinv(A)


@jax.tree_util.register_pytree_node_class
class StencilMultigridBlock:
    """Symmetric V-cycle preconditioner for a StencilOperatorBlock2D.

    The vector-field (elasticity / NS / shell) analog of StencilMultigrid:
    per-field full-weighting/bilinear transfers, Galerkin re-probed block
    coarse stencils, weighted point-block-Jacobi smoothing (the nodal
    nF x nF diagonal blocks inverted once per level), dense Newton–Schulz
    pseudo-inverse on the coarsest level. The on-device replacement for
    the reference's MUMPS route on vector systems
    (linear_elasticity.py:299, tg_vortex.py / cut_shell.py Newton solves).
    """

    def tree_flatten(self):
        return (self.levels, self.binvs, self.coarse_inv), (
            self.nu_pre, self.nu_post, self.omega, self.coarse_sweeps,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.levels, obj.binvs, obj.coarse_inv = children
        obj.nu_pre, obj.nu_post, obj.omega, obj.coarse_sweeps = aux
        return obj

    def __init__(
        self,
        S: StencilOperatorBlock2D,
        nu_pre: int = 2,
        nu_post: int = 2,
        omega: float = 1.0,
        coarse_sweeps: int = 60,
        min_size: int = 9,
        coarse_dense: bool = True,
    ):
        self.nu_pre, self.nu_post = nu_pre, nu_post
        self.omega = omega
        self.coarse_sweeps = coarse_sweeps
        self.levels = [S]
        while all(
            (s - 1) % 2 == 0 and s > min_size for s in self.levels[-1].shape
        ):
            self.levels.append(_coarsen_block(self.levels[-1]))
        self.binvs = [_point_binv(S_l) for S_l in self.levels]
        dense_ok = coarse_dense and self.levels[-1].n <= 8192
        _warn_weak_coarse(self.levels[-1].shape, dense_ok)
        self.coarse_inv = (
            _dense_inverse_block(self.levels[-1]) if dense_ok else None
        )

    def _smooth(self, lvl: int, x, b, sweeps: int):
        S = self.levels[lvl]
        Binv = self.binvs[lvl]
        nF, _, nn = Binv.shape
        om = self.omega

        def body(_, x):
            r = (b - S.mv(x)).reshape(nF, nn)
            z = jnp.einsum("abn,bn->an", Binv, r, precision=_HI)
            return x + om * z.reshape(-1)

        return jax.lax.fori_loop(0, sweeps, body, x)

    def _vcycle(self, lvl: int, b):
        S = self.levels[lvl]
        nF = S.n_fields
        if lvl == len(self.levels) - 1:
            if self.coarse_inv is not None:
                return jnp.matmul(self.coarse_inv, b, precision=_HI)
            return self._smooth(lvl, jnp.zeros_like(b), b, self.coarse_sweeps)
        x = self._smooth(lvl, jnp.zeros_like(b), b, self.nu_pre)
        r = (b - S.mv(x)).reshape((nF,) + S.shape)
        rc = jnp.stack([_restrict(r[f]) for f in range(nF)]).reshape(-1)
        xc = self._vcycle(lvl + 1, rc)
        Sc = self.levels[lvl + 1]
        xc3 = xc.reshape((nF,) + Sc.shape)
        x = x + jnp.stack(
            [_prolong(xc3[f]) for f in range(nF)]
        ).reshape(-1)
        return self._smooth(lvl, x, b, self.nu_post)

    def minv(self, r):
        return self._vcycle(0, r)


# -- 3D block (multi-field) hierarchy ------------------------------------------

from iifea.ops.stencil import StencilOperatorBlock3D  # noqa: E402


@jax.jit
def _coarsen_block3_probe(
    fine: "StencilOperatorBlock3D",
) -> "StencilOperatorBlock3D":
    """3D block Galerkin coarse operator by re-probing (oracle for
    _coarsen_block3)."""
    cshape = tuple((s - 1) // 2 + 1 for s in fine.shape)
    nF = fine.n_fields

    def rap_one(xc):
        x4 = xc.reshape((nF,) + cshape)
        xf = jnp.stack([_prolong3(x4[f]) for f in range(nF)])
        yf = fine.mv(xf.reshape(-1)).reshape((nF,) + fine.shape)
        yc = jnp.stack([_restrict3(yf[f]) for f in range(nF)])
        return yc.reshape(-1)

    return StencilOperatorBlock3D.probe_multi(
        jax.vmap(rap_one), cshape, n_fields=nF, radius=fine.radius,
        dtype=fine.dtype,
    )


@jax.jit
def _coarsen_block3(
    fine: "StencilOperatorBlock3D",
) -> "StencilOperatorBlock3D":
    """Direct 3D block Galerkin coarse operator: the scalar RAP conv
    (see _coarsen3) batched over the nF² coefficient blocks."""
    cshape = tuple((s - 1) // 2 + 1 for s in fine.shape)
    nF = fine.n_fields
    m3 = (2 * fine.radius + 1) ** 3
    nx1, ny1, nz1 = fine.shape
    C = _masked_coeffs3(fine)
    K = jnp.asarray(_rap_kernel3(fine.radius), fine.dtype)
    y = jax.lax.conv_general_dilated(
        C.reshape(nF * nF, m3, nx1, ny1, nz1), K,
        window_strides=(2, 2, 2), padding=((1, 1), (1, 1), (1, 1)),
        precision=_HI,
    )
    return StencilOperatorBlock3D(
        y.reshape((nF, nF, m3) + cshape), cshape, fine.radius
    )


@jax.tree_util.register_pytree_node_class
class StencilMultigridBlock3D:
    """Symmetric V-cycle preconditioner for a StencilOperatorBlock3D —
    completes the (2D/3D) x (scalar/block) stencil-MG matrix. Same design
    as StencilMultigridBlock: per-field full-weighting/trilinear transfers,
    direct-conv block Galerkin coarse stencils, l1-regularized point-block
    Jacobi smoothing, dense Newton–Schulz pseudo-inverse coarsest solve."""

    def tree_flatten(self):
        return (self.levels, self.binvs, self.coarse_inv), (
            self.nu_pre, self.nu_post, self.omega, self.coarse_sweeps,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.levels, obj.binvs, obj.coarse_inv = children
        obj.nu_pre, obj.nu_post, obj.omega, obj.coarse_sweeps = aux
        return obj

    def __init__(
        self,
        S: StencilOperatorBlock3D,
        nu_pre: int = 2,
        nu_post: int = 2,
        omega: float = 1.0,
        coarse_sweeps: int = 60,
        min_size: int = 9,
        coarse_dense: bool = True,
    ):
        self.nu_pre, self.nu_post = nu_pre, nu_post
        self.omega = omega
        self.coarse_sweeps = coarse_sweeps
        self.levels = [S]
        while all(
            (s - 1) % 2 == 0 and s > min_size for s in self.levels[-1].shape
        ):
            self.levels.append(_coarsen_block3(self.levels[-1]))
        # _point_binv and _dense_inverse_block only touch the shared block
        # interface (point_block_diag / coeffs / mv / n) — reused as-is
        self.binvs = [_point_binv(S_l) for S_l in self.levels]
        dense_ok = coarse_dense and self.levels[-1].n <= 8192
        _warn_weak_coarse(self.levels[-1].shape, dense_ok)
        self.coarse_inv = (
            _dense_inverse_block(self.levels[-1]) if dense_ok else None
        )

    def _smooth(self, lvl: int, x, b, sweeps: int):
        S = self.levels[lvl]
        Binv = self.binvs[lvl]
        nF, _, nn = Binv.shape
        om = self.omega

        def body(_, x):
            r = (b - S.mv(x)).reshape(nF, nn)
            z = jnp.einsum("abn,bn->an", Binv, r, precision=_HI)
            return x + om * z.reshape(-1)

        return jax.lax.fori_loop(0, sweeps, body, x)

    def _vcycle(self, lvl: int, b):
        S = self.levels[lvl]
        nF = S.n_fields
        if lvl == len(self.levels) - 1:
            if self.coarse_inv is not None:
                return jnp.matmul(self.coarse_inv, b, precision=_HI)
            return self._smooth(lvl, jnp.zeros_like(b), b, self.coarse_sweeps)
        x = self._smooth(lvl, jnp.zeros_like(b), b, self.nu_pre)
        r = (b - S.mv(x)).reshape((nF,) + S.shape)
        rc = jnp.stack([_restrict3(r[f]) for f in range(nF)]).reshape(-1)
        xc = self._vcycle(lvl + 1, rc)
        Sc = self.levels[lvl + 1]
        xc4 = xc.reshape((nF,) + Sc.shape)
        x = x + jnp.stack(
            [_prolong3(xc4[f]) for f in range(nF)]
        ).reshape(-1)
        return self._smooth(lvl, x, b, self.nu_post)

    def minv(self, r):
        return self._vcycle(0, r)
