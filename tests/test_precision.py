"""Every f32 contraction and convolution on the solve path pins HIGHEST
precision: at DEFAULT precision a GPU may run them in TF32."""
import jax
import jax.numpy as jnp
import pytest

from iifea.ops import multigrid as mgm
from iifea.ops.stencil import StencilOperator2D, StencilOperator3D
from iifea.solvers import krylov

_CONTRACTIONS = ("dot_general", "conv_general_dilated")


def _eqns(jaxpr):
    """All equations of a jaxpr, recursing into sub-jaxprs (jit, loops)."""
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _eqns(inner)


def _contraction_precisions(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    return [eqn.params.get("precision") for eqn in _eqns(jaxpr)
            if eqn.primitive.name in _CONTRACTIONS]


def _stencil(op, shape):
    m = 25 if len(shape) == 2 else 125
    return op(jnp.ones((m,) + shape, jnp.float32), shape, 2)


def _gmres_products(b):
    # elementwise matvec: every contraction in the graph is the solver's
    return krylov.gmres(lambda v: 2.0 * v, b, restart=4, max_it=8)


@pytest.mark.parametrize("name,fn,arg", [
    ("_restrict", mgm._restrict, jnp.ones((9, 9), jnp.float32)),
    ("_coarsen", mgm._coarsen, _stencil(StencilOperator2D, (9, 9))),
    ("_coarsen3", mgm._coarsen3, _stencil(StencilOperator3D, (5, 5, 5))),
    ("gmres", _gmres_products, jnp.ones(6, jnp.float32)),
])
def test_contractions_pin_highest(name, fn, arg):
    precs = _contraction_precisions(fn, arg)
    assert precs, f"{name}: no contraction found"
    hi = jax.lax.Precision.HIGHEST
    for p in precs:
        assert p is not None and all(q == hi for q in p), (name, p)
