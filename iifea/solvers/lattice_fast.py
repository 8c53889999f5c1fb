"""The gather-free fast solve pipeline as a library feature.

Packages the full double-float lattice pipeline (bench.py's flow) behind one
class:

  setup (host, once):  lattice-binned reducers (ops/lattice_bin.py), rhs
                       quadrature tables, slot-bound cell geometry
  solve (per call):    df stiffness on bound geometry -> facet bind ->
                       gather-free f32 stencil probe  == explicit PtAP
                       (la_utils.py:165-182 role) -> geometric multigrid ->
                       f32 MG-PCG passes, iteratively refined with
                       double-float binned residuals to the f64 target

Two modes (both end in f32 MG-PCG passes + f64 iterative refinement):

  2D color-probe (default): df slot tables; residuals via the reducer
      apply_df; rhs via the gather-free df projection. Needs the problem
      class to provide ``rhs_df_tables``/``rhs_el_df`` and a P1 df
      stiffness (models/poisson.py).
  window (3D always, 2D under IIFEA_2D_WINDOW=1): f32 tables only; the
      fused slab-scan probe (cell_window.window_planes) consumes COMPACT
      f64 element blocks, and refinement residuals run on the exact
      general operator (ops/projection.BackgroundOperator) — works for
      any two-term P1 scalar form, and keeps the 3D 1M-dof bench's device
      memory small (the slot-bound df pipeline needed ~28 GB there).

Scope: scalar P1 problems with one cell term and one boundary-facet term.
Construction raises ``lattice_bin.LatticeBinError`` when the geometry
cannot be binned — callers fall back to the general path
(ops/projection.py + solve_ksp).
"""
from __future__ import annotations

import os
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from iifea.ops import cell_window, lattice_bin
from iifea.ops import df as dfm
from iifea.ops.multigrid import StencilMultigrid, StencilMultigrid3D
from iifea.ops.stencil import StencilOperator2D, StencilOperator3D
from iifea.solvers import krylov


class BinnedLatticeSolver:
    """End-to-end immersed solve on a lattice background, gather-free.

    2D lattices use the masked color probe (ops/lattice_bin.py); 3D lattices
    use cell-window congruence assembly (ops/cell_window.py) — the same df
    pipeline either way, the on-device stand-in for the reference's 3D
    MUMPS route (demos/poisson.py:207-210).

    >>> solver = BinnedLatticeSolver(prob, M, (n_bg + 1, n_bg + 1))
    >>> u_b, info = solver.solve(rtol=1e-10)

    ``u_b`` is the f64 background solution; ``info`` reports the achieved
    relative f64 residual and total f32 CG iterations.
    """

    def __init__(self, prob, M, lattice_shape):
        from iifea.models.poisson import p1_stiffness_df_arrays
        from iifea.ops.assembly import Form as _Form

        self.prob = prob
        self.M = M
        self.shape = tuple(lattice_shape)
        self.dim = len(self.shape)
        if self.dim not in (2, 3):
            raise lattice_bin.LatticeBinError(
                f"BinnedLatticeSolver covers 2D/3D lattices, got {self.dim}D"
            )
        form = prob.form
        # this pipeline calls p1_stiffness_df_arrays directly (first
        # quadrature point's reference gradients only) — valid for P1 cell
        # terms only; a degree-2 problem would bin fine but produce a
        # silently wrong stiffness whose own df residual still "converges"
        if getattr(prob.space, "degree", 1) != 1:
            raise lattice_bin.LatticeBinError(
                "BinnedLatticeSolver requires a degree-1 (P1) foreground "
                f"space, got degree {prob.space.degree}"
            )
        if len(form.terms) != 2:
            raise lattice_bin.LatticeBinError(
                "BinnedLatticeSolver expects the [cell, facet] two-term "
                f"form structure, got {len(form.terms)} terms"
            )
        # 2D defaults to the color-probe binned reducers; 3D uses the
        # cell-window congruence reducers. IIFEA_2D_WINDOW=1 routes 2D
        # through the window reducers too (direct EᵀKE stencil extraction
        # instead of 25 colored applies — A/B knob for the probe phase).
        self._use_window = self.dim == 3 or bool(
            os.environ.get("IIFEA_2D_WINDOW")
        )
        if not self._use_window:
            self.reducers = lattice_bin.build_binned_projection(
                form, M, self.shape, dtype=np.float32, df=True
            )
            self.rhs_tables = prob.rhs_df_tables(self.reducers)
            red_c = self.reducers[0]
            self.JinvT_b = jnp.asarray(
                red_c.bind_static(np.asarray(prob.cell_dom.JinvT))
            )
            self.wdetT_b = jnp.asarray(
                red_c.bind_static(np.asarray(prob.cell_dom.wdetT))
            )
        else:
            # Window path (3D, and 2D under IIFEA_2D_WINDOW): everything
            # stays COMPACT and f32-probed, f64-refined generally —
            # round-4 redesign after the 3D 1M-dof bench OOMed at 28 GB:
            #   * no df tables (val_lo halved away): the f64 refinement
            #     residual runs on the exact general operator
            #     (BackgroundOperator.mv with the f64 element blocks)
            #     instead of the reducer apply_df;
            #   * no slot-bound f64 geometry (2.6 GB at 17x slot padding)
            #     and no slot-bound element blocks (4.7 GB): the fused
            #     slab-scan probe (cell_window.window_planes) binds
            #     per-slab from the compact (ne, ne, nE) blocks;
            # l_cap='auto': cap the dense slot depth at the p99 occupancy
            # and spill the <1% overflow slots into compact scatter-placed
            # tables — halves the dominant HBM resident at the 3D bench
            # (measured p50=6/p99=24/max=48 occupancy)
            self.reducers = cell_window.build_window_projection(
                form, M, self.shape, dtype=np.float32, df=False,
                l_cap="auto",
            )
            self.rhs_tables = None
            self.JinvT_b = self.wdetT_b = None
        gref = np.asarray(prob.cell_dom.gphi_ref)
        n_dofs, n_fields = form.n_dofs, form.n_fields
        facet_kernel = form.terms[1].kernel

        if not self._use_window:
            _project_rhs_df = lattice_bin.project_rhs_df_binned
            _apply_df = lattice_bin.apply_df_binned
        else:
            _project_rhs_df = cell_window.project_rhs_df_windows
            _apply_df = cell_window.apply_df_windows

        # two executables, not one: splitting rhs-projection from stiffness
        # halves the per-executable peak memory, and the b_df temporaries
        # are freed before the stiffness graph runs
        @jax.jit
        def _assemble_rhs(reds, rhs_tbl):
            r_el = prob.rhs_el_df(rhs_tbl)
            b_df = _project_rhs_df(reds, r_el)
            return b_df[0].astype(jnp.float64) + b_df[1].astype(jnp.float64)

        def _facet_subform(facet_dom):
            return _Form.tree_unflatten(
                ((facet_kernel,), n_dofs, n_fields), (facet_dom,)
            )

        @jax.jit
        def _assemble_K(JinvT_b, wdetT_b, facet_dom, u):
            K_cell_b = p1_stiffness_df_arrays(JinvT_b, wdetT_b, gref)
            K_facet = dfm.df_from_f64(
                _facet_subform(facet_dom).jacobian_blocks(u)[0]
            )
            return K_cell_b, K_facet

        @jax.jit
        def _assemble_win(frm, M_, u):
            # one pass gives BOTH the compact f64 element blocks (probe +
            # exact-residual operator) and the exact f64 rhs — no df, no
            # Poisson-specific stiffness: the window path works for any
            # two-term P1 scalar form
            blocks, r = frm.jacobian_and_residual(u)
            b64 = -M_.rmv(r)
            return b64, blocks[0], blocks[1]

        def _assemble(reds, rhs_tbl, JinvT_b, wdetT_b, facet_dom, u):
            if self._use_window:
                return _assemble_win(form, self.M, u)
            b64 = _assemble_rhs(reds, rhs_tbl)
            K_cell, K_facet = _assemble_K(JinvT_b, wdetT_b, facet_dom, u)
            return b64, K_cell, K_facet

        @jax.jit
        def _bind_facet(reds, K_cell_b, K_facet):
            if self._use_window:
                # fused probe binds per-slab; keep blocks compact
                return [K_cell_b, K_facet]
            return [K_cell_b, reds[1].bind_blocks_df(*K_facet)]

        @jax.jit
        def _probe(reds, bound):
            if not self._use_window:
                if os.environ.get("IIFEA_2D_COLOR_PROBE"):
                    # legacy 25-color probe (A/B knob; ~0.29 s at 1M dofs)
                    Y = lattice_bin.probe_y_binned_bound(reds, bound)
                    return StencilOperator2D.from_probe_y(
                        Y, self.shape, radius=2
                    )
                # direct window-congruence assembly on the binned tables:
                # one table pass instead of 25 colored applies
                C = lattice_bin.stencil_planes_binned_bound(reds, bound)
                return StencilOperator2D(C, self.shape, 2)
            # fused f32 slab-scan probe straight from the compact blocks:
            # no slot-bound K and no materialized G (the round-4 3D OOM).
            # IIFEA_SLAB_BYTES bounds the per-slab workspace (HBM headroom
            # knob for the 1M-dof 3D bench).
            C = cell_window.stencil_planes_windows(
                reds, bound, dtype=jnp.float32,
                slab_bytes=float(os.environ.get("IIFEA_SLAB_BYTES", 1.5e9)),
            )
            if self.dim == 2:
                return StencilOperator2D(C, self.shape, 2)
            return StencilOperator3D(C, self.shape, 2)

        @jax.jit
        def _residual_df(reds, bound, b64, x64):
            x_df = dfm.df_from_f64(x64)
            y_df = _apply_df(reds, bound, x_df)
            r_df = dfm.df_sub(dfm.df_from_f64(b64), y_df)
            r64 = dfm.df_to_f64(r_df)
            return r64, r_df[0], jnp.linalg.norm(r64) / jnp.linalg.norm(b64)

        @jax.jit
        def _residual_gen(A64, b64, x64):
            # exact f64 residual on the general operator (MᵀA_fM as
            # gather/apply/scatter with the f64 blocks) — la_utils.py's
            # AT_R_A semantics, no probed-operator truncation in the loop
            r64 = b64 - A64.mv(x64)
            return (r64, r64.astype(jnp.float32),
                    jnp.linalg.norm(r64) / jnp.linalg.norm(b64))

        def _residual(reds, bound, b64, x64):
            if self._use_window:
                from iifea.ops.projection import BackgroundOperator

                # built fresh from the CURRENT bound blocks each call — a
                # cached operator held the previous solve's blocks alive
                # (an extra ~0.3 GB at the 3D bench) and went stale on
                # reassembly; construction is a pytree wrapper, and the jit
                # cache keys on treedef/shapes, so this costs nothing
                A64 = BackgroundOperator(form, list(bound), self.M)
                return _residual_gen(A64, b64, x64)
            return _residual_df(reds, bound, b64, x64)

        @jax.jit
        def _cg32(S32, mg, r, rtol_pass):
            return krylov.cg(
                S32.mv, r, minv=mg.minv, rtol=rtol_pass, atol=1e-30,
                max_it=500, check_every=4,
            )

        @partial(jax.jit, static_argnames=("max_passes",))
        def _refine_fused(reds, bound, A64, S32, mg, b64, rtol, max_passes):
            # whole refinement in ONE executable: the per-pass driver in
            # refine() syncs float(relres) to the host once per pass — here
            # the pass loop is a lax.while_loop and only the final
            # (x, relres, iters) leaves the device. Semantics match
            # refine(): pass 0 solves on b directly; each pass measures the
            # df/general residual after its CG correction and stops at rtol
            # or the pass budget.
            def cgp(r32, relres):
                rtol_pass = jnp.clip(0.25 * rtol / relres, 1e-6, 3e-2)
                return krylov.cg(
                    S32.mv, r32, minv=mg.minv, rtol=rtol_pass, atol=1e-30,
                    max_it=500, check_every=4,
                )

            def residual(x64):
                if self._use_window:
                    return _residual_gen(A64, b64, x64)
                return _residual_df(reds, bound, b64, x64)

            def body(s):
                x64, r32, relres, iters, p = s
                dx, info = cgp(r32, relres)
                x64 = x64 + dx.astype(jnp.float64)
                _, r32n, rr = residual(x64)
                return (x64, r32n, rr, iters + info.iters, p + 1)

            def cond(s):
                _, _, relres, _, p = s
                return (relres > rtol) & (p < max_passes)

            x0 = jnp.zeros(self.M.n_bg_dofs, jnp.float64)
            state = (x0, b64.astype(jnp.float32), jnp.asarray(1.0),
                     jnp.asarray(0), jnp.asarray(0))
            x64, _, relres, iters, _ = jax.lax.while_loop(cond, body, state)
            return x64, relres, iters

        @jax.jit
        def _accum(x64, dx):
            return x64 + dx.astype(jnp.float64)

        self._assemble_fn = _assemble
        self._bind_facet_fn = _bind_facet
        self._probe_fn = _probe
        self._residual_fn = _residual
        self._cg_fn = _cg32
        self._accum_fn = _accum
        self._refine_fused_fn = _refine_fused

    # -- pipeline stages (individually timeable) -------------------------------

    def assemble(self, u_f=None):
        u = (
            jnp.zeros(self.prob.space.n_dofs, jnp.float64)
            if u_f is None else u_f
        )
        return self._assemble_fn(
            self.reducers, self.rhs_tables, self.JinvT_b, self.wdetT_b,
            self.prob.facet_dom, u,
        )

    def bind(self, K_cell_b, K_facet):
        return self._bind_facet_fn(self.reducers, K_cell_b, K_facet)

    def probe(self, bound):
        return self._probe_fn(self.reducers, bound)

    def build_mg(self, S32):
        # not jitted as a whole: per-level graphs, see StencilMultigrid
        if self.dim == 2:
            return StencilMultigrid(S32)
        return StencilMultigrid3D(S32)

    def refine(self, S32, mg, bound, b64, rtol, max_passes=10, cg_fn=None):
        """f32 MG-PCG passes with df-residual iterative refinement.

        ``cg_fn(S32, mg, r32, rtol_pass) -> (dx32, info)`` defaults to the
        single-device jit CG; bench.py's sharded pipeline injects a
        row-block-sharded CG here instead of duplicating this driver.

        With the default CG the whole refinement runs as ONE jit executable
        (pass loop on device, no per-pass host syncs); an injected
        ``cg_fn`` runs under the per-pass Python driver."""
        if cg_fn is None:
            A64 = None
            if self._use_window:
                from iifea.ops.projection import BackgroundOperator

                A64 = BackgroundOperator(self.prob.form, list(bound), self.M)
            x64, relres, iters = self._refine_fused_fn(
                self.reducers, bound, A64, S32, mg, b64, rtol,
                max_passes,
            )
            return x64, float(relres), int(iters)
        cg_fn = cg_fn or self._cg_fn
        x64 = jnp.zeros(self.M.n_bg_dofs, jnp.float64)
        relres, iters = 1.0, 0
        for i in range(max_passes):
            if i == 0:
                r32 = b64.astype(jnp.float32)
            else:
                _, r32, rr = self._residual_fn(self.reducers, bound, b64, x64)
                relres = float(rr)
                if relres < rtol:
                    break
            # contract only as far as this pass needs (0.25x margin absorbs
            # the f32 apply error), clamped to the f32 floor
            rtol_pass = min(max(0.25 * rtol / relres, 1e-6), 3e-2)
            dx, info = cg_fn(S32, mg, r32, rtol_pass)
            iters += int(info.iters)
            x64 = self._accum_fn(x64, dx)
        else:
            # exhausted max_passes: the last CG correction was applied after
            # the most recent residual measurement — re-measure for the x64
            # actually returned
            _, _, rr = self._residual_fn(self.reducers, bound, b64, x64)
            relres = float(rr)
        return x64, relres, iters

    # -- the whole thing -------------------------------------------------------

    def solve(self, rtol: float = 1e-10, max_passes: int = 10):
        b64, K_cell_b, K_facet = self.assemble()
        bound = self.bind(K_cell_b, K_facet)
        S32 = self.probe(bound)
        mg = self.build_mg(S32)
        x64, relres, iters = self.refine(S32, mg, bound, b64, rtol,
                                         max_passes)
        return x64, {"rel_residual": relres, "cg_iters": iters}
