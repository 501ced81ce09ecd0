"""The port's centroid metric and the chol-bundle's plain version against
rlvae_tpu.geometry.metric and chol_bundle_pallas (interpret mode).

Inputs: latents near the shipped centroids (so the weights are not all
underflowed), made with numpy.  Tolerances: weights and G^{-1} rtol 1e-5
(fp32, one [B,K]x[K,D^2] product summed in another order); the Cholesky
factor and logdet rtol 1e-4, atol 1e-5: the 16-step factorization of a
matrix whose smallest eigenvalue is ~lbd = 0.01 amplifies the G^{-1}
rounding by up to its condition number."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.geometry import load_metric as jax_load_metric
from rlvae_tpu.geometry import metric as jgm
from rlvae_tpu.geometry.metric import CentroidMetric as JaxMetric
from rlvae_tpu.ops.metric_kernels import chol_bundle_pallas
from rlvae_tpu_torch.geometry import load_metric
from rlvae_tpu_torch.geometry import metric as tgm
from rlvae_tpu_torch.geometry.metric import CentroidMetric
from rlvae_tpu_torch.ops.metric_kernels import chol_bundle, chol_bundle_ref

DATA = Path(__file__).resolve().parents[1] / "data" / "pretrained"
# (file, temperature override): metric.npz keeps its own T=0.1, where the d^2
# precision matters most; the K=50 metric runs at the model's T=3.0
METRICS = [("metric.npz", None), ("metric_T0.7_scaled.npz", 3.0), ("metric_T0.7_scaled.npz", None)]
W_RTOL, W_ATOL = 1e-5, 1e-7
L_RTOL, L_ATOL = 1e-4, 1e-5


def _both(name, t_override):
    jm = jax_load_metric(DATA / name, temperature_override=t_override)
    tm = load_metric(DATA / name, temperature_override=t_override)
    return jm, tm


def _latents(centroids, b, scale, seed):
    rng = np.random.default_rng(seed)
    c = np.asarray(centroids)
    idx = rng.integers(0, c.shape[0], size=b)
    return (c[idx] + scale * rng.normal(size=(b, c.shape[1]))).astype(np.float32)


@pytest.mark.parametrize("name,t_override", METRICS)
def test_weights_and_g_inv(name, t_override):
    jm, tm = _both(name, t_override)
    z = _latents(jm.centroids, 11, 0.05, 0)
    zt = torch.from_numpy(z)
    np.testing.assert_allclose(tgm.weights(tm, zt).numpy(),
                               np.asarray(jgm.weights(jm, jnp.asarray(z))),
                               rtol=W_RTOL, atol=W_ATOL)
    np.testing.assert_allclose(tgm.g_inv(tm, zt).numpy(),
                               np.asarray(jgm.g_inv(jm, jnp.asarray(z))),
                               rtol=W_RTOL, atol=W_ATOL)


@pytest.mark.parametrize("jitter", [1e-6, 0.0])
@pytest.mark.parametrize("name,t_override", METRICS)
def test_chol_g_inv_and_logdet(name, t_override, jitter):
    jm, tm = _both(name, t_override)
    z = _latents(jm.centroids, 9, 0.05, 1)
    zt = torch.from_numpy(z)
    np.testing.assert_allclose(tgm.chol_g_inv(tm, zt, jitter=jitter).numpy(),
                               np.asarray(jgm.chol_g_inv(jm, jnp.asarray(z), jitter=jitter)),
                               rtol=L_RTOL, atol=L_ATOL)
    np.testing.assert_allclose(tgm.logdet_g_inv(tm, zt).numpy(),
                               np.asarray(jgm.logdet_g_inv(jm, jnp.asarray(z))),
                               rtol=L_RTOL, atol=L_ATOL)


@pytest.mark.parametrize("b", [5, 37])
@pytest.mark.parametrize("name,t_override", [("metric_T0.7_scaled.npz", 3.0), ("metric.npz", None)])
def test_chol_bundle_ref_vs_pallas_interpret(name, t_override, b):
    """K=50 and K=200, ragged batches, against the Pallas kernel itself."""
    jm, tm = _both(name, t_override)
    z = _latents(jm.centroids, b, 0.05, 2)
    want = chol_bundle_pallas(jm, jnp.asarray(z), interpret=True)
    l, ld = chol_bundle_ref(torch.from_numpy(z), tm.centroids, tm.matrices,
                            1.0 / tm.temperature ** 2, tm.regularization)
    np.testing.assert_allclose(l.numpy(), np.asarray(want.chol_g_inv), rtol=L_RTOL, atol=L_ATOL)
    np.testing.assert_allclose(ld.numpy(), np.asarray(want.logdet_g_inv), rtol=L_RTOL, atol=L_ATOL)


def _synthetic_bank(k, d=16, seed=3):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(k, d)).astype(np.float32)
    a = rng.normal(size=(k, d, d)).astype(np.float32) / np.sqrt(d)
    m = (a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(d, dtype=np.float32)).astype(np.float32)
    return c, m


def test_chol_bundle_ref_large_bank_vs_xla():
    """K=20 000 (the chunked regime on the TPU), against the JAX XLA path."""
    c, m = _synthetic_bank(20_000)
    jm = JaxMetric.create(c, m, temperature=0.5, regularization=0.01)
    tm = CentroidMetric.create(c, m, temperature=0.5, regularization=0.01)
    z = _latents(c, 7, 0.1, 4)
    want = np.asarray(jgm._chol_g_inv_xla(jm, jnp.asarray(z), jitter=1e-6))
    l, _ = chol_bundle_ref(torch.from_numpy(z), tm.centroids, tm.matrices, 1.0 / 0.25, 0.01 + 1e-6)
    np.testing.assert_allclose(l.numpy(), want, rtol=L_RTOL, atol=L_ATOL)


def test_chol_bundle_cpu_route_and_checks():
    """On CPU tensors the wrapper is the plain version and launches nothing."""
    c, m = _synthetic_bank(50)
    z = torch.from_numpy(_latents(c, 4, 0.1, 5))
    before = chol_bundle.launches
    l1, ld1 = chol_bundle(z, torch.from_numpy(c), torch.from_numpy(m), 4.0, 0.01)
    l2, ld2 = chol_bundle_ref(z, torch.from_numpy(c), torch.from_numpy(m), 4.0, 0.01)
    assert chol_bundle.launches == before
    assert torch.equal(l1, l2) and torch.equal(ld1, ld2)
