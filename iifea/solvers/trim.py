"""Basis-function removal (BFR) — conditioning repair.

Parity with trimNodes (common.py:261-332): background basis functions whose
projected diagonal is <= bfr_tol (signed comparison, as in the reference's
``D.getValue(ind) <= bfr_tol``) — typically functions with no foreground
support — are turned into identity rows; the rhs entry is replaced by 0 or by
a target value (Newton's ``du = target`` trick, common.py:271-277).

On the device this is a mask, not a matrix rewrite: the operator applies
``y = where(mask, x, A x)`` (see BackgroundOperator.with_trim).
"""
from __future__ import annotations

import jax.numpy as jnp


def trim_mask_from_diag(diag: jnp.ndarray, bfr_tol: float) -> jnp.ndarray:
    return diag <= bfr_tol


def mask_from_ids(ids, n: int) -> jnp.ndarray:
    return jnp.zeros(n, dtype=bool).at[jnp.asarray(ids)].set(True)


def apply_trim_rhs(b: jnp.ndarray, mask: jnp.ndarray, target=None) -> jnp.ndarray:
    tgt = jnp.zeros_like(b) if target is None else target
    return jnp.where(mask, tgt, b)
