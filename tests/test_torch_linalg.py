"""The port's small-matrix linear algebra against rlvae_tpu.ops.linalg.

Same numpy inputs through both; random SPD 16x16 batches.  Tolerance:
rtol 1e-5 (fp32 with the same order of operations per column/row, except
that the port sums each inner product as one reduction)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.ops import linalg as jlin
from rlvae_tpu_torch.ops import linalg as tlin

RTOL, ATOL = 1e-5, 1e-6


def _spd(rng, b, d=16):
    a = rng.normal(size=(b, d, d)).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) / d + 0.5 * np.eye(d, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("jitter", [0.0, 1e-3])
def test_cholesky_small(jitter):
    rng = np.random.default_rng(0)
    a = _spd(rng, 7)
    # only the lower triangle is read: poison the strict upper one
    a_poison = a + np.triu(np.full_like(a, 100.0), 1)
    want = np.asarray(jlin.cholesky_small(jnp.asarray(a), jitter=jitter))
    got = tlin.cholesky_small(torch.from_numpy(a_poison), jitter=jitter).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.all(np.triu(got, 1) == 0)


@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_triangular_solves(rhs):
    rng = np.random.default_rng(1)
    l = np.array(jlin.cholesky_small(jnp.asarray(_spd(rng, 5))))
    b = rng.normal(size=(5, 16) if rhs == "vector" else (5, 16, 3)).astype(np.float32)
    for jf, tf in ((jlin.tri_solve_lower, tlin.tri_solve_lower),
                   (jlin.tri_solve_upper_t, tlin.tri_solve_upper_t)):
        want = np.asarray(jf(jnp.asarray(l), jnp.asarray(b)))
        got = tf(torch.from_numpy(l), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_logdet_from_chol():
    rng = np.random.default_rng(2)
    l = np.array(jlin.cholesky_small(jnp.asarray(_spd(rng, 9))))
    want = np.asarray(jlin.logdet_from_chol(jnp.asarray(l)))
    got = tlin.logdet_from_chol(torch.from_numpy(l)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
