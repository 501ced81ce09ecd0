"""The port's GPVAE and ``gp_kernel`` against the JAX package's on the CPU.

Small widths: frames 1x16x16, latent 4, 4 visits (``time_length``), MLP
nets 256->32->12 (the encoder's 3L outputs) and 4->32->256 in fp32, B=8.
One set of JAX variables (``init(PRNGKey(0))``) is carried into the port
by ``convert.research_state_from_jax``; JAX's draws are handed to the port
as ``noise``: the forward's ``normal(key, (B, L, T))``, ``generate``'s
``normal(key, (n, L, T))``.  Every kernel kind, at one and two length
scales (``kernel_scales``).

Tolerances: ``gp_kernel`` bitwise (the same numpy arithmetic); the prior's
Cholesky factor, inverse and log-determinant within 1e-5 of scale (the
port computes them in fp64 and rounds, JAX in fp32); the posterior's
covariance factor, losses, KL and latents rtol 1e-5 (atol 1e-5);
reconstructions atol 1e-5; gradients within 1e-4 of each tensor's largest
entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.models.research import GPVAE as JaxGPVAE
from rlvae_tpu.models.research.gpvae import gp_kernel as jax_gp_kernel
from rlvae_tpu_torch.convert import research_state_from_jax
from rlvae_tpu_torch.models.research import GPVAE, gp_kernel

INPUT, LATENT, T, B = (1, 16, 16), 4, 4, 8
NET = {"architecture": "mlp", "hidden_dims": [32], "dtype": "float32"}
KW = dict(input_dim=INPUT, latent_dim=LATENT, time_length=T, encoder_config=NET,
          decoder_config=NET)
RTOL, ATOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4
# (kind, length scale): diffusion needs < 0.5 (diagonal dominance)
KINDS = [("cauchy", 1.0), ("rbf", 2.0), ("diffusion", 0.3), ("matern", 1.5)]


def _pair(**kw):
    jm = JaxGPVAE(**{**KW, **kw})
    jv = jax.tree_util.tree_map(lambda a: np.array(a), jm.init(jax.random.PRNGKey(0)))
    pm = GPVAE(**{**KW, **kw})
    pm.load_state_dict(research_state_from_jax(jv))
    return jm, jv, pm


@pytest.fixture(scope="module")
def pair():
    return _pair(beta=0.7)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _scaled(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert float(np.abs(got - want).max()) <= rtol * max(float(np.abs(want).max()), 1.0)


@pytest.mark.parametrize("kind,length_scale", KINDS)
def test_gp_kernel_and_prior_match_jax(kind, length_scale):
    for t in (1, T, 8):
        np.testing.assert_array_equal(gp_kernel(kind, t, length_scale, 0.8),
                                      jax_gp_kernel(kind, t, length_scale, 0.8))
    for scales in (1, 2):
        jm = JaxGPVAE(**KW, kernel_choice=kind, length_scale=length_scale, kernel_scales=scales)
        pm = GPVAE(**KW, kernel_choice=kind, length_scale=length_scale, kernel_scales=scales)
        np.testing.assert_array_equal(pm.prior_cov.numpy(), np.asarray(jm.prior_cov))
        for name in ("prior_chol", "prior_cov_inv", "prior_logdet"):
            _scaled(getattr(pm, name).numpy(), getattr(jm, name))


def test_unknown_kernel_and_diffusion_scale_raise():
    with pytest.raises(ValueError, match="kernel"):
        gp_kernel("laplace", T, 1.0)
    with pytest.raises(ValueError, match="0.5"):
        gp_kernel("diffusion", T, 0.7)


def test_posterior_and_kl_match_jax(pair):
    """The upper-bidiagonal factor's inverse from random precision
    statistics (softplus'd), and the KL to the prior on it."""
    jm, jv, pm = pair
    rng = np.random.default_rng(3)
    diag = np.log1p(np.exp(rng.normal(size=(B, T, LATENT)))).astype(np.float32)
    off = np.log1p(np.exp(rng.normal(size=(B, T, LATENT)))).astype(np.float32)
    mu = rng.normal(size=(B, LATENT, T)).astype(np.float32)
    want = jm._posterior_from_stats(jnp.asarray(diag), jnp.asarray(off))
    got = pm.posterior_from_stats(torch.from_numpy(diag), torch.from_numpy(off))
    _close(got, want)
    assert torch.equal(torch.tril(got, -1), torch.zeros_like(got))  # upper triangular
    _close(pm.kl_to_prior(torch.from_numpy(mu), got), jm._kl_to_prior(jnp.asarray(mu), want))


@pytest.mark.parametrize("masked", [False, True])
def test_forward_losses_and_gradients(pair, masked):
    jm, jv, pm = pair
    x = np.random.default_rng(4).uniform(size=(B, T, *INPUT)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    kw, pkw = dict(train=True), dict(train=True)
    if masked:
        rng = np.random.default_rng(6)
        seq = np.ones((B, T), np.float32)
        seq[:, 2] = 0.0
        pix = (rng.uniform(size=x.shape) > 0.2).astype(np.float32)
        kw.update(seq_mask=jnp.asarray(seq), pix_mask=jnp.asarray(pix))
        pkw.update(seq_mask=torch.from_numpy(seq), pix_mask=torch.from_numpy(pix))
    keys = ("loss", "recon_loss", "mmd_loss", "z", "recon_x")

    def loss(p):
        out = jm.forward({"params": p}, jnp.asarray(x), key, **kw)
        return out.loss, {k: out[k] for k in keys}

    (_, jout), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(jv["params"])
    jg = research_state_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    eps = np.asarray(jax.random.normal(key, (B, LATENT, T)))
    pm.zero_grad()
    pout = pm(torch.from_numpy(x), noise={"eps": torch.from_numpy(eps)}, **pkw)
    pout.loss.backward()
    for k in ("loss", "recon_loss", "mmd_loss", "z"):
        _close(pout[k], jout[k], what=k)
    _close(pout["recon_x"], jout["recon_x"], rtol=0, what="recon_x")
    for k, w in jg.items():
        g = dict(pm.named_parameters())[k].grad
        assert float((g - w).abs().max()) <= GRAD_RTOL * max(float(w.abs().max()), 1e-12), k


def test_generate_matches_jax(pair):
    jm, jv, pm = pair
    key, n = jax.random.PRNGKey(7), 3
    want = jax.jit(lambda v: jm.generate(v, key, n))(jv)
    eps = np.asarray(jax.random.normal(key, (n, LATENT, T)))
    with torch.no_grad():
        got = pm.generate(n, noise={"eps": torch.from_numpy(eps)})
    assert got.shape == (n, T, *INPUT)
    _close(got, want, rtol=0)
    with pytest.raises(ValueError, match="time_length"):
        pm(torch.zeros(2, T + 1, *INPUT))
