"""Double-float (two-f32) values for f32-table hot paths.

Where ~48-bit mantissa accuracy suffices (stencil coefficients,
iterative-refinement residuals: the bench target is 1e-10 *relative*) and
the operands live in f32 tables, values are stored as unevaluated f32
pairs (hi, lo) with |lo| <= ulp(hi)/2: half the bytes of f64 planes with
nearly f64 accuracy.

Arithmetic on pairs is done in f64 and split back once. The pair's value
hi + lo is exact in f64, and so are the sum and product of two f32 values;
the result of one f64 operation on two pairs is rounded to 2^-53 and split
to 2^-48 relative. The classic f32-only error-free transforms (Knuth's
two_sum, Dekker's split product) are exact only if the compiler keeps every
f32 operation as written; the GPU backend reassociates and contracts them,
which collapses them to plain f32 accuracy.

The split must not round through f32 either: the GPU compiler may drop a
convert(convert(x, f32), f64) pair as excess precision, turning
``x - f64(f32(x))`` into 0 and the pair into plain f32. The high part is
therefore rounded to 24 significant bits on the f64 bit pattern, so it is
exactly representable in f32 and no conversion rounding is there to drop.
tests/test_df.py and chip_smoke.py (phase 2, on the card) guard this.

A df value is a plain (hi, lo) tuple of same-shape f32 arrays — pytree-
friendly, no wrapper class on the hot path.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# f64 bit pattern: keep sign, exponent and the top 23 of 52 mantissa bits;
# adding half of the dropped range first rounds to nearest (ties away)
_HI_MASK = 0xFFFFFFFFE0000000
_HI_HALF = 0x10000000


def df_from_f64(x):
    """Split an f64 array into a df pair: hi is x rounded to 24 significant
    bits (exact in f32), lo the f32-rounded rest, so hi + lo equals x to
    2^-48 relative (f32 normal range), and exactly when x has at most 48
    significant bits (the sum or product of two f32 values)."""
    x = jnp.asarray(x, jnp.float64)
    bits = jax.lax.bitcast_convert_type(x, jnp.uint64)
    hi64 = jax.lax.bitcast_convert_type(
        (bits + jnp.uint64(_HI_HALF)) & jnp.uint64(_HI_MASK), jnp.float64)
    return hi64.astype(jnp.float32), (x - hi64).astype(jnp.float32)


def df_to_f64(d):
    hi, lo = d
    return hi.astype(jnp.float64) + lo.astype(jnp.float64)


def df_zeros(shape, like=None):
    z = jnp.zeros(shape, jnp.float32)
    return z, z


def df_neg(a):
    return -a[0], -a[1]


def df_add(a, b):
    """df + df."""
    return df_from_f64(df_to_f64(a) + df_to_f64(b))


def df_sub(a, b):
    return df_add(a, df_neg(b))


def df_mul(a, b):
    """df * df."""
    return df_from_f64(df_to_f64(a) * df_to_f64(b))


def df_fma(acc, a, b):
    """acc + a*b, all df."""
    return df_from_f64(df_to_f64(acc) + df_to_f64(a) * df_to_f64(b))


def df_sum(a, axis):
    """Sum a df array along an axis (one f64 reduction, split once)."""
    return df_from_f64(jnp.sum(df_to_f64(a), axis=axis))
