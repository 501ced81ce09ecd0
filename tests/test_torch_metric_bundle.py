"""The metric bundle and G^{-1} of the port against the JAX package on the CPU.

- ``metric_bundle_ref``/``g_inv_ref`` (the plain versions of the kernels in
  ``csrc/metric_bundle.cu``) against ``metric_bundle_pallas``/``g_inv_pallas``
  in interpret mode and against JAX's XLA ``gm.g_inv``/``chol_g_inv``/
  ``logdet_g_inv``/``g``, at K=50 (T=3.0), K=200 (T=0.7) and a synthetic
  K=2000 bank, B=37 (a batch that is no multiple of any tile).
- The autograd Functions ``MetricBundleG`` and ``GInv``, and ``dist2``,
  against ``jax.grad`` through JAX's ``_g_xla``, ``g_inv`` and ``dist2``.
- ``riemannian_full_kl`` (also its all-or-nothing fallback), ``chol_g``,
  ``logdet_g`` and ``diagnostics`` against JAX's.

Tolerances are the JAX package's own for its kernels
(``tests/test_metric_kernels.py``): G^{-1} rtol 1e-5, atol 1e-6; L and
logdet rtol 1e-4, atol 1e-4; G rtol 1e-3, atol 1e-3 (G is an inverse, so
G^{-1}'s rounding comes back amplified by its condition number).  Gradients
rtol 1e-4 with atol 1e-5 of the gradient's scale (fp32, another summation
order through the 16-step factorization and solves); KL and diagnostics
rtol 1e-4.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.geometry import load_metric as jax_load_metric
from rlvae_tpu.geometry import metric as jgm
from rlvae_tpu.geometry.metric import CentroidMetric as JaxMetric
from rlvae_tpu.models import losses as jlosses
from rlvae_tpu.ops.metric_kernels import g_inv_pallas, metric_bundle_pallas
from rlvae_tpu_torch.geometry import load_metric
from rlvae_tpu_torch.geometry import metric as tgm
from rlvae_tpu_torch.geometry.metric import CentroidMetric
from rlvae_tpu_torch.models import losses as tlosses
from rlvae_tpu_torch.ops.metric_kernels import (
    GInv,
    MetricBundleG,
    g_inv,
    g_inv_ref,
    metric_bundle,
    metric_bundle_ref,
)

DATA = Path(__file__).resolve().parents[1] / "data" / "pretrained"
TOL = {"g_inv": (1e-5, 1e-6), "chol_g_inv": (1e-4, 1e-4), "logdet_g_inv": (1e-4, 1e-4),
       "g": (1e-3, 1e-3)}
BANKS = ("K50", "K200", "K2000")
B = 37  # every test's batch: JAX compiles each eager op once per shape, and the
# factorizations and solves of [B, 16, 16] are then shared by every test and bank


def synthetic_bank(k, seed=0):
    """K centroids ~ N(0, I) and exactly symmetric SPD matrices."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(k, 16)).astype(np.float32)
    a = (rng.normal(size=(k, 16, 16)) / 4).astype(np.float32)
    m = a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(16, dtype=np.float32)
    return c, (0.5 * (m + np.swapaxes(m, -1, -2))).astype(np.float32)


def metric_pair(bank):
    """(JAX metric, port metric) of one bank."""
    if bank == "K2000":
        c, m = synthetic_bank(2000)
        return (JaxMetric.create(c, m, temperature=1.5, regularization=0.01),
                CentroidMetric.create(c, m, temperature=1.5, regularization=0.01))
    name, t_over = {"K50": ("metric_T0.7_scaled.npz", 3.0), "K200": ("metric.npz", 0.7)}[bank]
    return (jax_load_metric(DATA / name, temperature_override=t_over),
            load_metric(DATA / name, temperature_override=t_over))


def rows_near_centroids(c, b, seed=1, scale=0.1):
    rng = np.random.default_rng(seed)
    return (c[rng.integers(0, c.shape[0], size=b)]
            + scale * rng.normal(size=(b, c.shape[1]))).astype(np.float32)


@pytest.fixture(scope="module", params=BANKS)
def bank(request):
    """(JAX metric, port metric, z [B, 16], JAX's references at z): the
    Pallas kernels in interpret mode and the XLA path, evaluated once."""
    jm, tm = metric_pair(request.param)
    z = rows_near_centroids(np.asarray(jm.centroids), B)
    zj = jnp.asarray(z)
    want = {"pallas": metric_bundle_pallas(jm, zj, interpret=True),
            "pallas_g_inv": g_inv_pallas(jm, zj, interpret=True),
            "xla": {"g_inv": jgm.g_inv(jm, zj), "chol_g_inv": jgm.chol_g_inv(jm, zj, jitter=0.0),
                    "logdet_g_inv": jgm.logdet_g_inv(jm, zj), "g": jgm.g(jm, zj)}}
    return jm, tm, z, want


def _bank_args(tm):
    return tm.centroids, tm.matrices, 1.0 / tm.temperature ** 2, tm.regularization


def _close(got, want, key):
    rtol, atol = TOL[key]
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=key)


def test_metric_bundle_ref_matches_pallas_and_xla(bank):
    _, tm, z, want = bank
    gi, l, ld, g = (t.numpy() for t in metric_bundle_ref(torch.from_numpy(z), *_bank_args(tm)))
    got = {"g_inv": gi, "chol_g_inv": l, "logdet_g_inv": ld, "g": g}
    for key, value in got.items():
        _close(value, want["pallas"][key], key)
        _close(value, want["xla"][key], key)
    assert np.all(np.triu(l, 1) == 0)


def test_g_inv_ref_matches_pallas_and_xla(bank):
    _, tm, z, want = bank
    gi = g_inv_ref(torch.from_numpy(z), *_bank_args(tm)).numpy()
    _close(gi, want["pallas_g_inv"], "g_inv")
    _close(gi, want["xla"]["g_inv"], "g_inv")


def test_wrappers_on_cpu_are_the_plain_versions():
    """On CPU tensors the wrappers return the plain versions, bit for bit,
    and launch nothing; the Functions' forward is the wrapper's output."""
    _, tm = metric_pair("K50")
    z = torch.from_numpy(rows_near_centroids(tm.centroids.numpy(), 5))
    args = _bank_args(tm)
    launches = (metric_bundle.launches, g_inv.launches)
    for got, want in zip(metric_bundle(z, *args), metric_bundle_ref(z, *args)):
        assert torch.equal(got, want)
    assert torch.equal(g_inv(z, *args), g_inv_ref(z, *args))
    zg = z.clone().requires_grad_(True)
    assert torch.equal(MetricBundleG.apply(zg, *args), metric_bundle(z, *args)[3])
    assert torch.equal(GInv.apply(zg, *args), g_inv(z, *args))
    assert (metric_bundle.launches, g_inv.launches) == launches


def test_plain_versions_evaluate_in_fp64():
    _, tm = metric_pair("K50")
    z = torch.from_numpy(rows_near_centroids(tm.centroids.numpy(), 3)).double()
    args = (tm.centroids.double(), tm.matrices.double(), 1.0 / 9.0, tm.regularization)
    assert all(t.dtype == torch.float64 for t in metric_bundle_ref(z, *args))
    gi, _, _, g = metric_bundle_ref(z, *args)
    eye = torch.eye(16, dtype=torch.float64).expand(3, 16, 16)
    torch.testing.assert_close(g @ gi, eye, rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------



@pytest.mark.parametrize("which,name", [("g", "K200"), ("g_inv", "K50"), ("g_inv", "K2000")])
def test_function_gradients_match_jax(name, which):
    """MetricBundleG / GInv (forward: the wrapper, backward: autograd through
    the plain version) against jax.grad through _g_xla / g_inv, in z only."""
    jm, tm = metric_pair(name)
    z = rows_near_centroids(np.asarray(jm.centroids), B, seed=2, scale=0.05)
    w = np.random.default_rng(3).normal(size=(B, 16, 16)).astype(np.float32)
    jfn = {"g": jgm._g_xla, "g_inv": jgm.g_inv}[which]
    want = np.asarray(jax.grad(lambda zz: jnp.sum(jfn(jm, zz) * w))(jnp.asarray(z)))
    zt = torch.from_numpy(z).requires_grad_(True)
    tfn = {"g": tgm.g, "g_inv": tgm.g_inv}[which]
    (tfn(tm, zt) * torch.from_numpy(w)).sum().backward()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(zt.grad.numpy(), want, rtol=1e-4, atol=1e-5 * scale)
    assert tm.centroids.grad is None and tm.matrices.grad is None


def test_dist2_and_its_gradient_match_jax():
    jm, tm = metric_pair("K200")
    c = np.asarray(jm.centroids)
    z1 = rows_near_centroids(c, B, seed=4, scale=0.05)
    z2 = (z1 + 0.05 * np.random.default_rng(5).normal(size=z1.shape)).astype(np.float32)
    want = np.asarray(jgm.dist2(jm, jnp.asarray(z1), jnp.asarray(z2)))
    want_g = np.asarray(jax.grad(lambda a: jnp.sum(jgm.dist2(jm, a, jnp.asarray(z2))))(
        jnp.asarray(z1)))
    t1 = torch.from_numpy(z1).requires_grad_(True)
    got = tgm.dist2(tm, t1, torch.from_numpy(z2))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(t1.grad.numpy(), want_g, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want_g).max()))


def test_g_with_jitter_takes_the_solves():
    """jitter != 0: G = (G^{-1} + jitter I)^{-1} by solves, as JAX's _g_xla."""
    jm, tm = metric_pair("K50")
    z = rows_near_centroids(np.asarray(jm.centroids), B)
    got = tgm.g(tm, torch.from_numpy(z), jitter=1e-3).numpy()
    _close(got, jgm.g(jm, jnp.asarray(z), jitter=1e-3), "g")


# ---------------------------------------------------------------------------
# other consumers of G
# ---------------------------------------------------------------------------


def test_chol_g_and_logdet_g_match_jax():
    jm, tm = metric_pair("K200")
    z = rows_near_centroids(np.asarray(jm.centroids), B)
    zj, zt = jnp.asarray(z), torch.from_numpy(z)
    np.testing.assert_allclose(tgm.chol_g(tm, zt).numpy(), np.asarray(jgm.chol_g(jm, zj)),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tgm.logdet_g(tm, zt).numpy(), np.asarray(jgm.logdet_g(jm, zj)),
                               rtol=1e-4, atol=1e-4)


def _kl_inputs(jm, b=B, seed=6):
    rng = np.random.default_rng(seed)
    c = np.asarray(jm.centroids)
    mu = rows_near_centroids(c, b, seed=seed)
    log_var = rng.normal(scale=0.5, size=(b, 16)).astype(np.float32)
    z = (mu + 0.1 * rng.normal(size=mu.shape)).astype(np.float32)
    return mu, log_var, z


@pytest.mark.parametrize("name", BANKS[:2])
def test_riemannian_full_kl_matches_jax(name):
    jm, tm = metric_pair(name)
    mu, log_var, z = _kl_inputs(jm)
    log_var[0, 0] = 12.0  # beyond the clamp: the trace term reads it unclamped
    want = float(jlosses.riemannian_full_kl(jm, *map(jnp.asarray, (mu, log_var, z))))
    got = float(tlosses.riemannian_full_kl(tm, *map(torch.from_numpy, (mu, log_var, z))))
    assert np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_riemannian_full_kl_falls_back_to_the_standard_kl():
    """One non-finite entry sends the whole batch to the standard-KL mean."""
    jm, tm = metric_pair("K50")
    mu, log_var, z = _kl_inputs(jm)
    log_var[2, 3] = 100.0  # exp(100) overflows fp32 in the unclamped trace term
    want = float(jlosses.riemannian_full_kl(jm, *map(jnp.asarray, (mu, log_var, z))))
    got = float(tlosses.riemannian_full_kl(tm, *map(torch.from_numpy, (mu, log_var, z))))
    std = float(tlosses.standard_kl(torch.from_numpy(mu), torch.from_numpy(log_var)))
    assert np.isfinite(got) and got == std
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("name", BANKS[:2])
def test_diagnostics_match_jax(name):
    jm, tm = metric_pair(name)
    z = rows_near_centroids(np.asarray(jm.centroids), B)
    want = jgm.diagnostics(jm, jnp.asarray(z))
    got = tgm.diagnostics(tm, torch.from_numpy(z))
    assert set(got) == set(want)
    for key, value in want.items():
        assert type(got[key]) is type(value), key
        np.testing.assert_allclose(got[key], value, rtol=1e-4, err_msg=key)
