"""Persistent compile cache placement (iifea/config.py)."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = ("import iifea, jax, jax.numpy as jnp; "
         "jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(3)).block_until_ready(); "
         "print(jax.config.jax_compilation_cache_dir)")


def _run(env_extra):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_extra)
    p = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    return p.stdout.strip().splitlines()[-1]


def test_compile_cache_defaults_to_checkout():
    # caching stays off (tests' env): only the configured path is checked
    assert _run({}) == os.path.join(ROOT, ".jax_cache")


def test_compile_cache_follows_env_dir(tmp_path):
    got = _run({"JAX_COMPILATION_CACHE_DIR": str(tmp_path),
                "JAX_ENABLE_COMPILATION_CACHE": "true",
                "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0"})
    assert got == str(tmp_path)
    assert any(f.name.endswith("-cache") for f in tmp_path.iterdir())
