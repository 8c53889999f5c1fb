"""Double-float arithmetic (ops/df.py): error-free transforms must survive
XLA compilation — if the compiler ever reassociates, these collapse to f32
accuracy and fail."""
import numpy as np
import jax
import jax.numpy as jnp

from iifea.ops import df


def _rand(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal(n) * scale)


def test_split_roundtrip():
    x = _rand(1000, 0)
    hi, lo = jax.jit(df.df_from_f64)(x)
    assert float(jnp.abs(df.df_to_f64((hi, lo)) - x).max()) < 1e-14
    # normalization: |lo| <= ulp(hi)/2
    assert float(jnp.abs(lo).max()) <= 6e-8 * float(jnp.abs(hi).max())


def test_df_add_mul_accuracy():
    a64 = _rand(4096, 1)
    b64 = _rand(4096, 2, scale=3.0)

    @jax.jit
    def run(a64, b64):
        a = df.df_from_f64(a64)
        b = df.df_from_f64(b64)
        return (df.df_to_f64(df.df_add(a, b)),
                df.df_to_f64(df.df_mul(a, b)),
                df.df_to_f64(df.df_fma(a, a, b)))

    s, p, f = run(a64, b64)
    assert float(jnp.abs(s - (a64 + b64)).max()) < 1e-13
    assert float(jnp.abs(p - a64 * b64).max()) < 1e-13
    assert float(jnp.abs(f - (a64 + a64 * b64)).max()) < 1e-13


def test_df_long_accumulation():
    """Σ of 10k products stays ~1e-12 accurate (f32 alone drifts ~1e-4)."""
    n = 10000
    a64 = _rand(n, 3)
    b64 = _rand(n, 4)

    @jax.jit
    def run(a64, b64):
        a = df.df_from_f64(a64)
        b = df.df_from_f64(b64)
        acc = df.df_zeros(())
        prods = df.df_mul(a, b)

        def body(i, acc):
            return df.df_add(acc, (prods[0][i], prods[1][i]))

        acc = jax.lax.fori_loop(0, n, body, acc)
        return df.df_to_f64(acc)

    got = run(a64, b64)
    want = float((a64 * b64).sum())
    assert abs(float(got) - want) / max(abs(want), 1.0) < 1e-11


def test_df_sum_axis():
    rng = np.random.default_rng(5)
    x64 = jnp.asarray(rng.standard_normal((7, 64)))
    d = df.df_from_f64(x64)
    s = df.df_to_f64(jax.jit(lambda d: df.df_sum(d, 0))(d))
    assert float(jnp.abs(s - x64.sum(0)).max()) < 1e-13
