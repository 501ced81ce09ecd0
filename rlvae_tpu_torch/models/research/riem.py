"""RIEM: the Riemannian longitudinal VAE with latent temporal dynamics.

Port of ``rlvae_tpu/models/research/riem.py``:

- metric-adjusted sampling z + chol(G(z)) gamma / sqrt(beta0)
  (:func:`sample_with_metric`);
- z0 uniform on the manifold, by rejection against the volume element
  sqrt(det G) over a fixed number of trials (:func:`sample_uniform_riemann`);
- per-visit training: encode ONE visit, evolve its latent backward and
  forward through :class:`LatentDynamics` (deterministic DDIM-style steps on
  a linear schedule) to every other visit, decode all;
- the per-visit loss: per-frame masked 0.5 MSE + a KL active only at the
  boundary visits, whose prior carries the volume 0.5 log det G(z), clamped
  to [-2, 500], with beta scheduling; warmup epochs train the plain VAE
  objective (optionally with the IAF posterior).

G goes through :mod:`rlvae_tpu_torch.geometry.metric`, so tensors on the
card run its kernels: ``logdet_g`` the chol-bundle (B1: the rejection's
B*64 candidates and the boundary prior), ``chol_g`` the metric bundle (its
G, then an unrolled Cholesky).  Both are differentiable.

Randomness can be passed in as ``noise`` (the tests pass JAX's draws) or
is drawn from ``generator``: ``cand`` [B, trials, D] (uniform in the box)
and ``u`` [B, trials] for the uniform sample, ``eps`` [B, D] for the
posterior sample when it is not uniform, ``gamma`` [B, D] for the metric
step (the warmup branch: ``eps`` and ``gamma`` [B*T, D]); ``generate``
takes ``z`` and ``gamma`` [n, D].
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rlvae_tpu_torch.flows.iaf import IAF, iaf_inverse
from rlvae_tpu_torch.geometry import metric as gm
from rlvae_tpu_torch.geometry.metric import CentroidMetric
from rlvae_tpu_torch.models.research.lvae_iaf import Noise, _normal
from rlvae_tpu_torch.nets.layers import init_net
from rlvae_tpu_torch.nets.registry import create_decoder, create_encoder
from rlvae_tpu_torch.utils.output import ModelOutput


def sample_with_metric(metric: CentroidMetric, z: torch.Tensor, gamma: torch.Tensor,
                       beta_zero_sqrt: float = 1.0) -> torch.Tensor:
    """z + chol(G(z)) gamma / sqrt(beta0)."""
    l = gm.chol_g(metric, z)
    return z + torch.einsum("bij,bj->bi", l, gamma / beta_zero_sqrt)


def sample_uniform_riemann(metric: CentroidMetric, n_samples: int, latent_dim: int,
                           domain_low: float = -1.0, domain_high: float = 1.0,
                           m_bound: float = 10.0, n_trials: int = 64, noise: Noise = None,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Uniform with respect to the Riemannian volume on a box, by rejection
    against sqrt(det G)/M: of ``n_trials`` candidates per sample the first
    accepted one, else the one of largest volume.  ``noise``: ``cand``
    [n, trials, D] uniform in the box, ``u`` [n, trials] uniform in [0, 1)."""
    dev = metric.centroids.device
    if noise is not None and "cand" in noise:
        cand = torch.as_tensor(noise["cand"], dtype=torch.float32, device=dev)
    else:
        cand = domain_low + (domain_high - domain_low) * torch.rand(
            (n_samples, n_trials, latent_dim), generator=generator).to(dev)
    if noise is not None and "u" in noise:
        u = torch.as_tensor(noise["u"], dtype=torch.float32, device=dev)
    else:
        u = torch.rand((n_samples, n_trials), generator=generator).to(dev)
    flat = cand.reshape(n_samples * n_trials, latent_dim)
    vol = torch.exp(0.5 * gm.logdet_g(metric, flat)).reshape(n_samples, n_trials)
    accept = u < vol / m_bound
    first = torch.argmax(accept.to(torch.uint8), dim=1)
    idx = torch.where(accept.any(dim=1), first, torch.argmax(vol, dim=1))
    return cand[torch.arange(n_samples, device=dev), idx]


def _f32(x: np.float32) -> float:
    """A schedule scalar computed in fp32 (as JAX computes it), as a Python
    float: exact, so an fp32 tensor op sees the same value."""
    return float(x)


class LatentDynamics:
    """Deterministic DDIM-style latent dynamics over the sequence axis on a
    linear beta schedule: ``forward_step`` (t -> t+1) renoises toward the
    terminal prior, ``backward_step`` (t -> t-1) denoises, both through the
    noise predictor ``eps_fn(params, z, t)`` (default: the parameter-free
    z / sqrt(1 + t))."""

    def __init__(self, latent_dim: int, n_obs: int, beta_start: float = 1e-3,
                 beta_end: float = 0.25, eps_fn=None):
        self.latent_dim = latent_dim
        self.n_obs = n_obs
        betas = np.linspace(beta_start, beta_end, n_obs, dtype=np.float64)
        self.alpha_bar = np.cumprod(1.0 - betas).astype(np.float32)  # [T]
        self.eps_fn = eps_fn or (lambda params, z, t: z / _f32(np.sqrt(np.float32(1.0) + t)))

    def _step(self, params, z, t: int, to: int) -> torch.Tensor:
        a_t, a_n = self.alpha_bar[t], self.alpha_bar[to]
        one = np.float32(1.0)
        eps = self.eps_fn(params, z, np.float32(t))
        x0 = (z - _f32(np.sqrt(one - a_t)) * eps) / _f32(np.sqrt(a_t))
        return _f32(np.sqrt(a_n)) * x0 + _f32(np.sqrt(one - a_n)) * eps

    def forward_step(self, params, z: torch.Tensor, t: int) -> torch.Tensor:
        """z_t -> z_{t+1}."""
        return self._step(params, z, t, t + 1)

    def backward_step(self, params, z: torch.Tensor, t: int) -> torch.Tensor:
        """z_t -> z_{t-1}."""
        return self._step(params, z, t, t - 1)


class RIEM(nn.Module):
    def __init__(
        self,
        input_dim: Tuple[int, ...] = (3, 64, 64),
        latent_dim: int = 16,
        n_obs: int = 8,
        warmup: int = 50,
        beta: float = 1.0,
        linear_scheduling_steps: int = 0,
        prior: str = "standard",  # standard | vamp (only standard reaches the loss)
        posterior: str = "gaussian",  # gaussian | iaf
        flow_hidden_size: int = 64,
        metric: Optional[CentroidMetric] = None,
        dynamics: Optional[LatentDynamics] = None,
        use_uniform_sample: bool = True,
        temperature: float = 1.0,
        encoder_config: Optional[Mapping[str, Any]] = None,
        decoder_config: Optional[Mapping[str, Any]] = None,
        seed: int = 0,
    ):
        super().__init__()
        if prior not in ("standard", "vamp"):
            raise ValueError("prior must be 'standard' or 'vamp'")
        if posterior not in ("gaussian", "iaf"):
            raise ValueError("posterior must be 'gaussian' or 'iaf'")
        self.input_dim = tuple(input_dim)
        self.latent_dim = latent_dim
        self.n_obs = n_obs
        self.warmup = warmup
        self.beta = float(beta)
        self.linear_scheduling = linear_scheduling_steps
        self.prior = prior
        self.posterior = posterior
        self.use_uniform_sample = use_uniform_sample
        self.temperature = temperature
        self.beta_zero_sqrt = math.sqrt(beta) if beta else 1.0
        self.dynamics = dynamics or LatentDynamics(latent_dim, n_obs)
        generator = torch.Generator().manual_seed(seed)
        self.encoder = create_encoder(self.input_dim, latent_dim, encoder_config)
        self.decoder = create_decoder(self.input_dim, latent_dim, decoder_config)
        for net in (self.encoder, self.decoder):
            init_net(net, generator)
        if posterior == "iaf":
            # the reference's posterior IAF: 3 blocks of 2 hidden layers
            self.posterior_flow = IAF(latent_dim, flow_hidden_size, 3, 2, generator)
        self.set_metric(metric)

    def set_metric(self, metric: Optional[CentroidMetric]) -> None:
        """The metric's bank as non-persistent buffers, so ``to(device)``
        moves it with the weights."""
        self._metric_scalars = self._metric_view = None
        self.register_buffer("metric_centroids", None, persistent=False)
        self.register_buffer("metric_matrices", None, persistent=False)
        if metric is not None:
            self.metric_centroids = metric.centroids
            self.metric_matrices = metric.matrices
            self._metric_scalars = (metric.temperature, metric.regularization)

    @property
    def metric(self) -> Optional[CentroidMetric]:
        """The metric over the bank's buffers; one view while the buffers are
        the same tensors, so its padded kernel bank is made once."""
        if self._metric_scalars is None:
            return None
        view = self._metric_view
        if (view is None or view.centroids is not self.metric_centroids
                or view.matrices is not self.metric_matrices):
            view = self._metric_view = CentroidMetric(
                self.metric_centroids, self.metric_matrices, *self._metric_scalars)
        return view

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # -- pieces -----------------------------------------------------------------

    def _encode(self, x):
        enc = self.encoder(x)
        return enc["embedding"], enc["log_covariance"]

    def _decode(self, z):
        return self.decoder(z)["reconstruction"]

    def _posterior_flow(self, z):
        if self.posterior == "iaf":
            return iaf_inverse(self.posterior_flow, z)
        return z, z.new_zeros(z.shape[0])

    def log_p_j_hat(self, z: torch.Tensor, j: int) -> torch.Tensor:
        """Boundary-visit prior: N(0, I) at j = 0, volume-corrected elsewhere."""
        base = (-0.5 * z ** 2).sum(1)
        if j == 0 or self.metric is None:
            return base
        return base + 0.5 * gm.logdet_g(self.metric, z)

    def _evolve(self, z: torch.Tensor, vi_index: int) -> torch.Tensor:
        """[B, T, D]: the dynamics backward to visit 0, forward to n_obs - 1."""
        zs = {vi_index: z}
        z_b = z
        for i in range(vi_index - 1, -1, -1):
            z_b = self.dynamics.backward_step({}, z_b, i + 1)
            zs[i] = z_b
        z_f = z
        for i in range(vi_index, self.n_obs - 1):
            z_f = self.dynamics.forward_step({}, z_f, i)
            zs[i + 1] = z_f
        return torch.stack([zs[i] for i in range(self.n_obs)], dim=1)

    def _recon_per_frame(self, recon_flat, x_flat, pix_flat):
        return (0.5 * (recon_flat - x_flat) ** 2 * pix_flat).sum(-1)

    def _beta(self, epoch: int, train: bool) -> float:
        if self.linear_scheduling > 0 and train:
            return min(self.beta * epoch / self.linear_scheduling, self.beta)
        return self.beta

    # -- forward ------------------------------------------------------------------

    def forward(self, x: torch.Tensor, noise: Noise = None, vi_index: Optional[int] = None,
                epoch: int = 100, train: bool = False, seq_mask: Optional[torch.Tensor] = None,
                pix_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> ModelOutput:
        """x: [B, n_obs, C, H, W]; ``vi_index`` selects the encoded visit
        (numpy's global generator draws it when None)."""
        b, t = x.shape[0], x.shape[1]
        seq_mask = torch.ones((b, t), dtype=x.dtype, device=x.device) if seq_mask is None \
            else seq_mask
        pix_mask = torch.ones_like(x) if pix_mask is None else pix_mask
        x = x * pix_mask * seq_mask[:, :, None, None, None]
        if epoch < self.warmup:
            return self._forward_warmup(x, noise, seq_mask, pix_mask, generator)

        vi_index = int(np.random.randint(0, self.n_obs)) if vi_index is None else vi_index
        mu, log_var = self._encode(x[:, vi_index])
        metric = self.metric
        if self.use_uniform_sample and metric is not None:
            z = sample_uniform_riemann(metric, b, self.latent_dim, noise=noise,
                                       generator=generator)
        else:
            z = mu + _normal(noise, "eps", mu.shape, generator, mu.device) \
                * torch.exp(0.5 * log_var)
        if metric is not None:
            z = sample_with_metric(metric, z, _normal(noise, "gamma", z.shape, generator,
                                                      z.device), self.beta_zero_sqrt)
        z0 = z
        z, log_det = self._posterior_flow(z)
        z_seq = self._evolve(z, vi_index)
        recon = self._decode(z_seq.reshape(b * t, self.latent_dim))
        loss, recon_mean, kl_mean = self.loss_function(
            recon, x, mu, log_var, z0, vi_index, z, log_det, epoch, pix_mask, train)
        return ModelOutput(loss=loss, reconstruction_loss=recon_mean, reg_loss=kl_mean,
                           recon_x=recon.reshape(x.shape), z=z, z_seq=z_seq, vi_index=vi_index)

    def loss_function(self, recon_x, x, mu, log_var, z_0_vi_index, vi_index, z_vi_index,
                      log_abs_det_jac_posterior, epoch, pix_mask=None, train: bool = False):
        """(loss, mean recon, mean KL): 0.5 MSE per frame averaged over the
        sequence, plus the boundary-gated, [-2, 500]-clamped KL against
        :meth:`log_p_j_hat`, with beta scheduling."""
        b, t = x.shape[0], x.shape[1]
        pix_mask = torch.ones_like(x) if pix_mask is None else pix_mask
        recon_pf = self._recon_per_frame(recon_x.reshape(b * t, -1), x.reshape(b * t, -1),
                                         pix_mask.reshape(b * t, -1))
        recon_per_sample = recon_pf.reshape(b, t).mean(1)
        log_prob_z = (-0.5 * (log_var + (z_0_vi_index - mu) ** 2
                              / (torch.exp(log_var) + 1e-7))).sum(1) - log_abs_det_jac_posterior
        if vi_index in (0, self.n_obs - 1):
            kl = torch.clamp(log_prob_z - self.log_p_j_hat(z_vi_index, vi_index), -2.0, 500.0)
        else:
            kl = torch.zeros_like(log_prob_z)
        loss = torch.mean(recon_per_sample + self._beta(epoch, train) * kl)
        return loss, recon_pf.mean(), kl.mean()

    def _forward_warmup(self, x, noise, seq_mask, pix_mask, generator):
        """The plain per-frame VAE objective of the warmup epochs."""
        b, t = x.shape[0], x.shape[1]
        x_flat = x.reshape(b * t, *self.input_dim)
        mu, log_var = self._encode(x_flat)
        z = mu + _normal(noise, "eps", mu.shape, generator, mu.device) * torch.exp(0.5 * log_var)
        if self.metric is not None:
            z = sample_with_metric(self.metric, z, _normal(noise, "gamma", z.shape, generator,
                                                           z.device), self.beta_zero_sqrt)
        z0 = z
        z, log_det = self._posterior_flow(z)
        recon = self._decode(z)
        recon_pf = self._recon_per_frame(recon.reshape(b * t, -1), x_flat.reshape(b * t, -1),
                                         pix_mask.reshape(b * t, -1))
        if self.posterior == "iaf":
            log_q = (-0.5 * (log_var + (z0 - mu) ** 2 / torch.exp(log_var))).sum(1)
            kld = log_q - (-0.5 * z ** 2).sum(1) - log_det
        else:
            kld = -0.5 * (1 + log_var - mu ** 2 - torch.exp(log_var)).sum(-1)
        loss = torch.mean((recon_pf + kld) * seq_mask.reshape(b * t))
        return ModelOutput(loss=loss, reconstruction_loss=recon_pf.mean(), reg_loss=kld.mean(),
                           recon_x=recon.reshape(x.shape), z=z,
                           z_seq=z.reshape(b, t, self.latent_dim), vi_index=-1)

    # -- generation / prediction ----------------------------------------------------

    def _decode_seq(self, z_seq):
        n = z_seq.shape[0]
        return self._decode(z_seq.reshape(n * self.n_obs, self.latent_dim)).reshape(
            n, self.n_obs, *self.input_dim)

    def generate(self, n: int, noise: Noise = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Terminal latents (``z``, metric-adjusted by ``gamma``) run backward
        through the whole sequence and decoded: [n, n_obs, C, H, W]."""
        z = _normal(noise, "z", (n, self.latent_dim), generator, self.device)
        if self.metric is not None:
            z = sample_with_metric(self.metric, z, _normal(noise, "gamma", z.shape, generator,
                                                           z.device), self.beta_zero_sqrt)
        return self._decode_seq(self._evolve(z, self.n_obs - 1))

    def predict(self, x_vi: torch.Tensor, vi_index: int) -> torch.Tensor:
        """Encode one visit (the posterior mean), evolve to every visit, decode."""
        z, _ = self._encode(x_vi)
        z, _ = self._posterior_flow(z)
        return self._decode_seq(self._evolve(z, vi_index))
