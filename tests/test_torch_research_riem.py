"""The port's RIEM (``rlvae_tpu_torch.models.research``) against the JAX
package's on the CPU.

A random K=6 metric in latent 4 (JAX compiles the gradient of its
unrolled Cholesky for many seconds at D=16), input 3x8x8, n_obs 3, MLP nets
192->32->4 in fp32, B=3; the IAF posterior as the reference's, 3 blocks of
2 hidden layers (of 16 here).  One forward runs on the model's own K=50
metric (``metric_T0.7_scaled.npz`` at T=3.0, latent 16).  JAX's variables
are carried into the port (``convert.research_state_from_jax``) and JAX's
draws handed to it as ``noise``: the uniform candidates and their
uniforms, the posterior ε and the metric step's γ.

Tolerances: losses rtol 1e-5 (atol 1e-5); z_seq and reconstructions rtol
1e-5 (atol 1e-5); gradients within 1e-4 of each tensor's largest entry.
The metric's factorizations run in fp32 on both sides in another order
(JAX's unrolled Cholesky of G, the port's plain metric bundle then the
same unrolled Cholesky): the metric step within 1e-4 of max(1, |z|), the
volume's log det within 1e-4.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.geometry import load_metric as jax_load_metric
from rlvae_tpu.geometry.metric import CentroidMetric as JaxMetric
from rlvae_tpu.models.research import RIEM as JaxRIEM
from rlvae_tpu.models.research.riem import sample_uniform_riemann as jax_uniform
from rlvae_tpu.models.research.riem import sample_with_metric as jax_with_metric
from rlvae_tpu_torch.convert import research_state_from_jax
from rlvae_tpu_torch.geometry import CentroidMetric, load_metric
from rlvae_tpu_torch.models.research import RIEM
from rlvae_tpu_torch.models.research.riem import sample_uniform_riemann, sample_with_metric

DATA = Path(__file__).resolve().parents[1] / "data" / "pretrained" / "metric_T0.7_scaled.npz"
INPUT, LATENT, N_OBS, B, TRIALS = (3, 8, 8), 4, 3, 3, 64
NET = {"architecture": "mlp", "hidden_dims": [32], "dtype": "float32"}
KW = dict(input_dim=INPUT, latent_dim=LATENT, n_obs=N_OBS, warmup=5, flow_hidden_size=16,
          encoder_config=NET, decoder_config=NET)
RTOL, ATOL, GRAD_RTOL, METRIC_RTOL = 1e-5, 1e-5, 1e-4, 1e-4
OUT_KEYS = ("loss", "reconstruction_loss", "reg_loss", "z_seq", "recon_x")


@pytest.fixture(scope="module")
def metrics():
    """(JAX, port) copies of a random K=6 metric in latent 4 at T=1."""
    rng = np.random.default_rng(0)
    c = (0.5 * rng.normal(size=(6, LATENT))).astype(np.float32)
    a = (rng.normal(size=(6, LATENT, LATENT)) / 2).astype(np.float32)
    m = (a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(LATENT, dtype=np.float32)).astype(np.float32)
    return (JaxMetric.create(c, m, temperature=1.0, regularization=0.01),
            CentroidMetric.create(c, m, temperature=1.0, regularization=0.01))


def pair(metrics, **kw):
    jm = JaxRIEM(metric=metrics[0], **{**KW, **kw})
    jv = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    pm = RIEM(metric=metrics[1], **{**KW, **kw})
    pm.load_state_dict(research_state_from_jax(jv))
    return jm, jv, pm


def batch(seed=1):
    return np.random.default_rng(seed).uniform(size=(B, N_OBS, *INPUT)).astype(np.float32)


def visit_noise(key, uniform: bool, d: int = LATENT):
    """JAX's draws of the visit branch: split(key, 4) -> (s, m, f, e)."""
    k_s, k_m, _, _ = jax.random.split(key, 4)
    noise = {"gamma": jax.random.normal(k_m, (B, d))}
    if uniform:
        k_c, k_u = jax.random.split(k_s)
        noise["cand"] = jax.random.uniform(k_c, (B, TRIALS, d), minval=-1.0, maxval=1.0)
        noise["u"] = jax.random.uniform(k_u, (B, TRIALS))
    else:
        noise["eps"] = jax.random.normal(k_s, (B, d))
    return {k: torch.from_numpy(np.array(v)) for k, v in noise.items()}


def jax_loss_and_grads(jm, jv, x, key, **kw):
    def loss(p):
        out = jm.forward({"params": p}, jnp.asarray(x), key, **kw)
        return out.loss, {k: out[k] for k in OUT_KEYS}

    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jv["params"])
    return out, research_state_from_jax(jax.tree_util.tree_map(np.asarray, g))


def check(pm, jout, jg, x, noise, **kw):
    pm.zero_grad()
    pout = pm(torch.from_numpy(x), noise=noise, **kw)
    pout.loss.backward()
    for k in OUT_KEYS:
        np.testing.assert_allclose(pout[k].detach().numpy(), np.asarray(jout[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    for k, p in pm.named_parameters():
        w = jg[k]
        g = p.grad if p.grad is not None else torch.zeros_like(w)
        assert float((g - w).abs().max()) <= GRAD_RTOL * max(float(w.abs().max()), 1e-12), k
    return pout


def test_visit_branch_on_the_model_metric():
    """The forward on the K=50 metric at latent 16, at the last visit."""
    mets = (jax_load_metric(DATA, temperature_override=3.0),
            load_metric(DATA, temperature_override=3.0))
    jm, jv, pm = pair(mets, latent_dim=16)
    x, key = batch(), jax.random.PRNGKey(8)
    jout = jax.jit(lambda p: {k: v for k, v in jm.forward(
        {"params": p}, jnp.asarray(x), key, vi_index=N_OBS - 1).items() if k in OUT_KEYS})(
        jv["params"])
    with torch.no_grad():
        pout = pm(torch.from_numpy(x), noise=visit_noise(key, True, 16), vi_index=N_OBS - 1)
    for k in OUT_KEYS:
        np.testing.assert_allclose(pout[k].numpy(), np.asarray(jout[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("vi", [0, 1, N_OBS - 1])
def test_visit_branch_uniform_sample(metrics, vi):
    """z0 uniform on the manifold (the rejection's B*64 volumes: one
    logdet_g), the metric step (chol_g), the boundary-gated KL (zero at the
    middle visit, the volume prior at the last)."""
    jm, jv, pm = pair(metrics)
    x, key = batch(), jax.random.PRNGKey(30 + vi)
    jout, jg = jax_loss_and_grads(jm, jv, x, key, vi_index=vi, epoch=10, train=True)
    pout = check(pm, jout, jg, x, visit_noise(key, True), vi_index=vi, epoch=10, train=True)
    assert (float(pout.reg_loss) == 0.0) == (vi == 1)


def test_visit_branch_iaf_posterior_reparameterized(metrics):
    """z0 = mu + eps sigma (the gradient reaches the encoder through the
    metric step's Cholesky of G), the IAF posterior, beta scheduling."""
    jm, jv, pm = pair(metrics, posterior="iaf", use_uniform_sample=False,
                      linear_scheduling_steps=20)
    x, key = batch(), jax.random.PRNGKey(4)
    jout, jg = jax_loss_and_grads(jm, jv, x, key, vi_index=N_OBS - 1, epoch=10, train=True)
    check(pm, jout, jg, x, visit_noise(key, False), vi_index=N_OBS - 1, epoch=10, train=True)


def test_warmup_branch(metrics):
    jm, jv, pm = pair(metrics, posterior="iaf")
    x, key = batch(), jax.random.PRNGKey(5)
    jout, jg = jax_loss_and_grads(jm, jv, x, key, epoch=1, train=True)
    k_s, k_m = jax.random.split(key)
    noise = {"eps": jax.random.normal(k_s, (B * N_OBS, LATENT)),
             "gamma": jax.random.normal(k_m, (B * N_OBS, LATENT))}
    check(pm, jout, jg, x, {k: torch.from_numpy(np.array(v)) for k, v in noise.items()},
          epoch=1, train=True)


def test_samplers_match_jax(metrics):
    """sample_uniform_riemann (the accepted-first and the fallback rows) and
    sample_with_metric on JAX's draws."""
    key = jax.random.PRNGKey(6)
    for m_bound in (10.0, 1e30):  # 1e30: no candidate accepted, the largest volume
        want = jax_uniform(metrics[0], key, 5, LATENT, m_bound=m_bound)
        k_c, k_u = jax.random.split(key)
        noise = {"cand": torch.from_numpy(np.array(jax.random.uniform(
                     k_c, (5, TRIALS, LATENT), minval=-1.0, maxval=1.0))),
                 "u": torch.from_numpy(np.array(jax.random.uniform(k_u, (5, TRIALS))))}
        got = sample_uniform_riemann(metrics[1], 5, LATENT, m_bound=m_bound, noise=noise)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    z = np.random.default_rng(3).normal(size=(7, LATENT)).astype(np.float32)
    gamma = np.asarray(jax.random.normal(key, (7, LATENT)))
    want = jax_with_metric(metrics[0], key, jnp.asarray(z), 2.0)
    got = sample_with_metric(metrics[1], torch.from_numpy(z), torch.from_numpy(gamma), 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=METRIC_RTOL,
                               atol=METRIC_RTOL * max(1.0, float(np.abs(want).max())))


def test_generate_and_predict_match_jax(metrics):
    jm, jv, pm = pair(metrics, posterior="iaf")
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda v: jm.generate(v, key, 4))(jv)
    k_z, k_m, _ = jax.random.split(key, 3)
    noise = {"z": torch.from_numpy(np.array(jax.random.normal(k_z, (4, LATENT)))),
             "gamma": torch.from_numpy(np.array(jax.random.normal(k_m, (4, LATENT))))}
    x = batch()
    with torch.no_grad():
        np.testing.assert_allclose(pm.generate(4, noise=noise).numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
        want = jax.jit(lambda v: jm.predict(v, jnp.asarray(x[:, 1]), 1, key))(jv)
        np.testing.assert_allclose(pm.predict(torch.from_numpy(x[:, 1]), 1).numpy(),
                                   np.asarray(want), rtol=RTOL, atol=ATOL)
