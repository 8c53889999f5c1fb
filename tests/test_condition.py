"""Condition-number estimation (estimateConditionNumber parity)."""
import numpy as np
import jax.numpy as jnp

from iifea.solvers.condition import estimate_condition_number


class DenseOp:
    def __init__(self, A):
        self.A = jnp.asarray(A)
        self.n = A.shape[0]

    def mv(self, x):
        return self.A @ x

    def mv_t(self, x):
        return self.A.T @ x


def test_extreme_singular_values_spd():
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.standard_normal((40, 40)))
    s = np.linspace(0.5, 80.0, 40)
    A = Q @ np.diag(s) @ Q.T
    smax, smin = estimate_condition_number(DenseOp(A), iters=40)
    assert abs(smax - 80.0) / 80.0 < 1e-6
    assert abs(smin - 0.5) / 0.5 < 1e-6


def test_nonsymmetric_condition():
    rng = np.random.default_rng(1)
    U, _ = np.linalg.qr(rng.standard_normal((30, 30)))
    V, _ = np.linalg.qr(rng.standard_normal((30, 30)))
    s = np.geomspace(1e-2, 1e2, 30)
    A = U @ np.diag(s) @ V.T
    smax, smin = estimate_condition_number(DenseOp(A), iters=30)
    assert abs(smax - 1e2) / 1e2 < 1e-6
    assert abs(smin - 1e-2) / 1e-2 < 1e-4
