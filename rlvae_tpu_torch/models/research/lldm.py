"""LLDM: the longitudinal latent diffusion model (LLDM_IAF).

Port of ``rlvae_tpu/models/research/lldm.py``.  A sequence of ``n_obs``
visits maps onto a DDIM timeline, ``diff_t_steps = flip(time_steps)``:
index 0 is the most-noised end (prior N(0, I)), index ``n_obs - 1`` the data
end (the volume prior of a sampled observation metric).  Training encodes
ONE visit, optionally refines it with a posterior IAF (3 MADE blocks of 2
hidden layers, sampling direction), then builds the latent sequence by
forward-diffusion noising into the past and DDIM denoising into the future,
and decodes every frame; the KL is live only at the boundary visits and
clamped to [-2, 500].  Warmup epochs train the per-frame VAE objective.

The pieces, with JAX's names:

- :func:`_sinusoidal_embedding`, :class:`EpsNet` (a tanh MLP of two
  ``hidden`` layers over [z, temb]) and :class:`LatentDiffusion` (a frozen
  eps-net over a 1000-step linear DDPM schedule, ``alpha_bar`` the fp64
  cumulative product cast to fp32, and the noising bridge
  :meth:`LatentDiffusion.sequential_diffusion`);
  :func:`pretrain_latent_diffusion` trains the eps-net by denoising score
  matching with Adam at optax's defaults;
- :class:`DDIMSampler`: the uniform time-step subsequence, its schedule
  tables in numpy fp32, the DDIM update;
- :class:`SampledMetric` (the diagonal direct-G Mahalanobis centroid
  metric, its products in IEEE fp32), :func:`_kmedoids`, :func:`retrieve_g`
  and :func:`hmc_sampling` (plain HMC on log_pi, its gradient by autograd);
  ``LVAE_GUGUS`` builds its observation metric from the first two;
- :class:`LLDM`, every method of JAX's.

The model launches no kernel of the port (its nets are PyTorch layers, its
IAF the plain :func:`~rlvae_tpu_torch.flows.iaf.iaf_inverse`), as JAX's
reaches no Pallas kernel.

Randomness is a ``noise`` mapping (the tests pass JAX's draws) or comes
from ``generator`` (a seeded ``torch.Generator``).  The keys follow JAX's
key splits:

- ``forward``: ``eps`` [B, D] (warmup: [B*T, D]) and ``bridge``
  [steps, B, D], one draw per step of :meth:`LLDM._propagate`, the past
  steps (visit - 1 down to 0) first, then the future ones;
- ``reconstruct``, ``oversample``: ``eps`` [B, D] and ``bridge``;
- ``hmc_sampling``: ``idx`` [n], ``rho`` [S, n, D], ``u`` [S, n];
- ``generate``: those of ``hmc_sampling`` (n = 1 with ``freeze``) and
  ``bridge``, a list of one [steps, rows, D] array per batch;
- ``predict``: ``bridge``, a list of one array per batch (future steps only);
- ``get_nll``: ``eps`` [N, batches, bs, D], ``bridge`` [N, batches, steps, bs, D];
- ``encode``: ``eps`` [B, T, D];
- ``pretrain_latent_diffusion``: ``idx``, ``t`` [steps, bs], ``eps`` [steps, bs, D].

``forward(vi_index=None)`` draws the visit with numpy's global generator,
as JAX does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rlvae_tpu_torch.flows.iaf import IAF, iaf_inverse
from rlvae_tpu_torch.models.research.lvae_iaf import Noise, _normal
from rlvae_tpu_torch.nets.layers import dense, ieee_mm, init_net
from rlvae_tpu_torch.nets.registry import create_decoder, create_encoder
from rlvae_tpu_torch.utils.output import ModelOutput


def _uniform(noise: Noise, key: str, shape, generator, device) -> torch.Tensor:
    if noise is not None and key in noise:
        return torch.as_tensor(noise[key], dtype=torch.float32, device=device)
    return torch.rand(shape, generator=generator).to(device)


def _randint(noise: Noise, key: str, high: int, shape, generator, device) -> torch.Tensor:
    if noise is not None and key in noise:
        return torch.as_tensor(noise[key], device=device).long()
    return torch.randint(0, high, shape, generator=generator).to(device)


# ---------------------------------------------------------------------------
# latent diffusion
# ---------------------------------------------------------------------------


def _sinusoidal_embedding(t: torch.Tensor, dim: int = 32,
                          max_period: float = 1e4) -> torch.Tensor:
    """Sinusoidal embedding of (fractional) diffusion steps t [B] -> [B, dim]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EpsNet(nn.Module):
    """The noise predictor eps_theta(z_t, t) on flat latents: Flax's
    ``Dense_0..2`` (fp32, IEEE products), tanh after the first two."""

    def __init__(self, latent_dim: int, hidden: int = 128, temb_dim: int = 32):
        super().__init__()
        self.temb_dim = temb_dim
        self.Dense_0 = nn.Linear(latent_dim + temb_dim, hidden)
        self.Dense_1 = nn.Linear(hidden, hidden)
        self.Dense_2 = nn.Linear(hidden, latent_dim)

    def forward(self, z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        h = torch.cat([z, _sinusoidal_embedding(t, self.temb_dim)], dim=-1)
        h = torch.tanh(dense(self.Dense_0, h, torch.float32))
        h = torch.tanh(dense(self.Dense_1, h, torch.float32))
        return dense(self.Dense_2, h, torch.float32)


class LatentDiffusion(nn.Module):
    """A frozen latent DDPM: a linear beta schedule over ``n_train_steps``
    and an eps-net (seeded ``seed``), with the noising bridge.  ``c, h, w``
    view the latent as 3 x s x s where it factors so, else (1, 1, D)."""

    def __init__(self, latent_dim: int, hidden: int = 128, n_train_steps: int = 1000,
                 beta_start: float = 1e-4, beta_end: float = 2e-2, seed: int = 0):
        super().__init__()
        self.latent_dim = latent_dim
        self.n_train_steps = n_train_steps
        betas = np.linspace(beta_start, beta_end, n_train_steps, dtype=np.float64)
        self.alpha_bar = np.cumprod(1.0 - betas).astype(np.float32)  # [T], numpy fp32
        self.net = EpsNet(latent_dim, hidden)
        init_net(self.net, torch.Generator().manual_seed(seed))
        self.requires_grad_(False)
        side = round((latent_dim / 3) ** 0.5)
        self.c, self.h, self.w = (3, side, side) if 3 * side * side == latent_dim \
            else (1, 1, latent_dim)

    def forward(self, z: torch.Tensor, t) -> torch.Tensor:
        """eps_theta(z_t, t); ``t`` a scalar or [B] (a diffusion step)."""
        t = torch.as_tensor(t, dtype=torch.float32, device=z.device).expand(z.shape[0])
        return self.net(z, t)

    def sequential_diffusion(self, x: torch.Tensor, t1, t2, eps: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """q(z_t2 | z_t1) for t2 > t1: sqrt(r) x + sqrt(1 - r) eps with
        r = clip(abar_t2 / abar_t1, 0, 1) (fp32); ``t1``, ``t2`` ints or
        per-row int arrays; ``eps`` [B, D], or drawn from ``generator``."""
        ratio = np.clip(self.alpha_bar[np.asarray(t2)] / self.alpha_bar[np.asarray(t1)],
                        np.float32(0), np.float32(1))
        keep, add = np.sqrt(ratio), np.sqrt(np.float32(1) - ratio)
        if eps is None:
            eps = torch.randn(x.shape, generator=generator).to(x.device)
        if ratio.ndim == 0:
            return float(keep) * x + float(add) * eps
        keep, add = (torch.from_numpy(np.ascontiguousarray(v[:, None])).to(x.device)
                     for v in (keep, add))
        return keep * x + add * eps


def pretrain_latent_diffusion(latents: torch.Tensor, hidden: int = 128, n_steps: int = 500,
                              batch_size: int = 128, lr: float = 1e-3,
                              n_train_steps: int = 1000, seed: int = 0,
                              ldm: Optional[LatentDiffusion] = None, noise: Noise = None,
                              generator: Optional[torch.Generator] = None) -> LatentDiffusion:
    """Train an eps-net (``ldm``, or a new one seeded ``seed``) on the
    device of ``latents`` [N, D] by denoising score matching, Adam at
    optax's defaults, and return it frozen: the provenance of LLDM's
    ``pretrained_ldm``.  Each step draws ``idx`` (rows), ``t`` (steps) and
    ``eps`` (module docstring)."""
    latents = torch.as_tensor(latents, dtype=torch.float32)
    dev, d = latents.device, latents.shape[-1]
    ldm = (LatentDiffusion(d, hidden=hidden, n_train_steps=n_train_steps, seed=seed)
           if ldm is None else ldm).to(dev)
    ldm.requires_grad_(True)
    opt = torch.optim.Adam(ldm.net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    abar = torch.from_numpy(ldm.alpha_bar).to(dev)
    idx_all = _randint(noise, "idx", latents.shape[0], (n_steps, batch_size), generator, dev)
    t_all = _randint(noise, "t", ldm.n_train_steps, (n_steps, batch_size), generator, dev)
    eps_all = _normal(noise, "eps", (n_steps, batch_size, d), generator, dev)
    for i in range(n_steps):
        z0, t, eps = latents[idx_all[i]], t_all[i], eps_all[i]
        a = abar[t][:, None]
        z_t = torch.sqrt(a) * z0 + torch.sqrt(1.0 - a) * eps
        loss = torch.mean((ldm.net(z_t, t.float()) - eps) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    ldm.requires_grad_(False)
    return ldm


class DDIMSampler:
    """DDIM over a uniform ``n_steps`` subsequence of the diffusion timeline;
    ``time_steps`` ascending (index 0 the least noise).  The schedule tables
    (``ddim_alpha``, ``ddim_alpha_prev``, ``ddim_sigma``) are numpy fp32."""

    def __init__(self, ldm: LatentDiffusion, n_steps: int, ddim_eta: float = 0.0):
        self.ldm = ldm
        self.n_steps = n_steps
        self.ddim_eta = float(ddim_eta)
        big_t = ldm.n_train_steps
        self.time_steps = np.arange(0, big_t, big_t // n_steps)[:n_steps]
        abar = np.asarray(ldm.alpha_bar)
        a = abar[self.time_steps]
        a_prev = np.concatenate([abar[:1], a[:-1]])
        sigma = self.ddim_eta * np.sqrt((1.0 - a_prev) / (1.0 - a) * (1.0 - a / a_prev))
        self.ddim_alpha = a.astype(np.float32)
        self.ddim_alpha_prev = a_prev.astype(np.float32)
        self.ddim_sigma = sigma.astype(np.float32)

    def get_x_prev_and_pred_x0(self, e_t: torch.Tensor, index: int, x: torch.Tensor,
                               noise: Optional[torch.Tensor] = None, temperature: float = 1.0,
                               repeat_noise: bool = False,
                               generator: Optional[torch.Generator] = None):
        """One DDIM step at timeline position ``index``: (x_prev, pred_x0).
        ``noise`` [B, D] ([1, D] with ``repeat_noise``), or drawn."""
        one = np.float32(1)
        a, a_prev = self.ddim_alpha[index], self.ddim_alpha_prev[index]
        sigma = self.ddim_sigma[index]
        pred_x0 = (x - float(np.sqrt(one - a)) * e_t) / float(np.sqrt(a))
        dir_xt = float(np.sqrt(np.maximum(one - a_prev - sigma ** 2, np.float32(0)))) * e_t
        if noise is None:
            shape = (1, *x.shape[1:]) if repeat_noise else x.shape
            noise = torch.randn(shape, generator=generator).to(x.device)
        x_prev = (float(np.sqrt(a_prev)) * pred_x0 + dir_xt
                  + float(sigma * np.float32(temperature)) * noise)
        return x_prev, pred_x0


# ---------------------------------------------------------------------------
# the sampled observation metric
# ---------------------------------------------------------------------------


class SampledMetric:
    """G(z) = sum_k m_k exp(-(z - c_k)^T diag(m_k) (z - c_k) / T^2) + lbd,
    diagonal, from centroids ``c`` [K, D] and diagonal weights ``m`` [K, D].
    The distances take the expanded Mahalanobis form, as JAX's at
    ``Precision.HIGHEST``, its products in IEEE fp32 (no TF32) on the card;
    the tensors follow ``z`` to its device."""

    def __init__(self, centroids, m_flat, temperature: float, regularization: float = 0.01):
        self.centroids = torch.from_numpy(np.array(centroids, np.float32))  # a copy
        self.m_flat = torch.from_numpy(np.array(m_flat, np.float32))
        self.temperature = float(temperature)
        self.lbd = float(regularization)
        self._on: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    def _tensors(self, device: torch.device):
        """(m, m * c, sum_d m c^2) on ``device``, made once per device."""
        if device not in self._on:
            m, c = self.m_flat.to(device), self.centroids.to(device)
            self._on[device] = (m, m * c, (m * c ** 2).sum(-1))
        return self._on[device]

    def g_diag(self, z: torch.Tensor) -> torch.Tensor:
        """The diagonal of G(z), [B, D]."""
        m, mc, c2 = self._tensors(z.device)
        d2 = ieee_mm(z ** 2, m.T) - 2.0 * ieee_mm(z, mc.T) + c2[None, :]
        omega = torch.exp(-d2 / self.temperature ** 2)  # [B, K]
        return ieee_mm(omega, m) + self.lbd

    def g(self, z: torch.Tensor) -> torch.Tensor:
        return torch.diag_embed(self.g_diag(z))

    def log_pi(self, z: torch.Tensor) -> torch.Tensor:
        """0.5 log clamp(det G(z), 0, 1e32)."""
        logdet = torch.log(self.g_diag(z)).sum(-1)
        return 0.5 * torch.clamp(logdet, max=math.log(1e32))


def _kmedoids(x: np.ndarray, k: int, iters: int = 10, seed: int = 0):
    """k-means refined to medoids (the sample nearest each center), seeded:
    (medoids [k, D], their indices [k])."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    k = min(k, n)
    centers = x[rng.choice(n, size=k, replace=False)].copy()
    for _ in range(iters):
        d = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)  # [N, k]
        assign = d.argmin(1)
        for j in range(k):
            sel = x[assign == j]
            if len(sel):
                centers[j] = sel.mean(0)
    d = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    idx = d.argmin(0)
    return x[idx], idx


def retrieve_g(mu, log_var, num_centroids: int = 200, t_multiplier: float = 1.0,
               add_std_norm: bool = False, regularization: float = 0.01,
               seed: int = 0) -> SampledMetric:
    """The sampled observation metric from posterior statistics (numpy, on
    the host): k-medoids centroids, T = the largest nearest-medoid distance
    (times ``t_multiplier``), M_i = exp(-log_var_i); ``add_std_norm``
    appends the N(0, I) component."""
    mu = np.asarray(mu, np.float32)
    log_var = np.asarray(log_var, np.float32)
    medoids, idx = _kmedoids(mu, num_centroids, seed=seed)
    if len(medoids) > 1:
        d = np.sqrt(((medoids[:, None, :] - medoids[None, :, :]) ** 2).sum(-1))
        np.fill_diagonal(d, np.inf)
        temp = float(d.min(axis=1).max())
    else:
        temp = 1.0
    temp *= t_multiplier
    centroids = mu[idx]
    m_flat = np.exp(-log_var[idx])
    if add_std_norm:
        centroids = np.concatenate([centroids, np.zeros((1, mu.shape[1]), np.float32)])
        m_flat = np.concatenate([m_flat, np.ones((1, mu.shape[1]), np.float32)])
    return SampledMetric(centroids, m_flat, temp, regularization)


def hmc_sampling(metric: SampledMetric, mu: torch.Tensor, n_samples: int,
                 mcmc_steps_nbr: int = 100, n_lf: int = 10, eps_lf: float = 0.01,
                 noise: Noise = None, generator: Optional[torch.Generator] = None,
                 trace: Optional[List] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain HMC on log_pi(z) = 0.5 log det G(z), chains started at random
    rows of ``mu``: (z [n, D], log_pi [n]).  The accept rule is
    ``u < exp(h0 - h1)``.  ``trace``, when given, receives (u, alpha,
    accepted, z after the step) of every MCMC step, on the host: the tests
    and ``chip_smoke.py`` read accept ties from it."""
    dev, d = mu.device, mu.shape[-1]
    idx = _randint(noise, "idx", mu.shape[0], (n_samples,), generator, dev)
    rho_all = _normal(noise, "rho", (mcmc_steps_nbr, n_samples, d), generator, dev)
    u_all = _uniform(noise, "u", (mcmc_steps_nbr, n_samples), generator, dev)

    def grad_log_pi(z):
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(metric.log_pi(z).sum(), z)
        return g

    with torch.no_grad():
        z = mu.detach()[idx]
        for s in range(mcmc_steps_nbr):
            rho = rho_all[s]
            h0 = -metric.log_pi(z) + 0.5 * (rho ** 2).sum(-1)
            zl, rl = z, rho + 0.5 * eps_lf * grad_log_pi(z)
            for _ in range(n_lf - 1):
                zl = zl + eps_lf * rl
                rl = rl + eps_lf * grad_log_pi(zl)
            zl = zl + eps_lf * rl
            rl = rl + 0.5 * eps_lf * grad_log_pi(zl)
            h1 = -metric.log_pi(zl) + 0.5 * (rl ** 2).sum(-1)
            alpha = torch.exp(h0 - h1)
            accept = u_all[s] < alpha
            z = torch.where(accept[:, None], zl, z)
            if trace is not None:
                trace.append((u_all[s].cpu(), alpha.cpu(), accept.cpu(), z.cpu()))
        return z, metric.log_pi(z)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class LLDM(nn.Module):
    """LLDM_IAF: per-visit training of a sequence VAE whose latent timeline
    is a frozen latent-diffusion bridge, with a Riemannian volume prior at
    the data end of the timeline (module docstring)."""

    model_name = "LLDM_IAF"

    def __init__(
        self,
        input_dim: Tuple[int, ...] = (3, 64, 64),
        latent_dim: int = 12,
        n_obs: int = 8,
        warmup: int = 50,
        beta: float = 1.0,
        linear_scheduling_steps: int = 0,
        prior: str = "standard",  # standard | vamp
        posterior: str = "gaussian",  # gaussian | iaf
        hidden_size: int = 128,
        context_dim: Optional[int] = None,
        vamp_number_components: int = 50,
        pretrained_metric: Optional[SampledMetric] = None,
        pretrained_ldm: Optional[LatentDiffusion] = None,
        ddim_sampler: Optional[DDIMSampler] = None,
        temperature: float = 1.0,
        reconstruction_loss: str = "mse",
        encoder_config: Optional[Mapping[str, Any]] = None,
        decoder_config: Optional[Mapping[str, Any]] = None,
        seed: int = 0,
    ):
        super().__init__()
        if prior not in ("standard", "vamp"):
            raise ValueError("prior must be 'standard' or 'vamp'")
        if posterior not in ("gaussian", "iaf"):
            raise ValueError("posterior must be 'gaussian' or 'iaf'")
        if reconstruction_loss not in ("mse", "bce"):
            raise ValueError("reconstruction_loss must be 'mse' or 'bce'")
        self.input_dim = tuple(input_dim)
        self.latent_dim = latent_dim
        self.n_obs = n_obs
        self.warmup = warmup
        self.beta = float(beta)
        self.linear_scheduling = linear_scheduling_steps
        self.prior = prior
        self.posterior = posterior
        self.hidden_size = hidden_size
        self.context_dim = context_dim
        self.vamp_number_components = vamp_number_components
        self.temperature = float(temperature)
        self.reconstruction_loss = reconstruction_loss

        # the frozen components: the metric (host-built, follows z's
        # device), the eps-net (a frozen submodule) and the DDIM tables
        self.pretrained_metric = pretrained_metric
        self.ldm = LatentDiffusion(latent_dim, seed=seed) if pretrained_ldm is None \
            else pretrained_ldm
        self.ddim_sampler = ddim_sampler or DDIMSampler(self.ldm, n_steps=n_obs, ddim_eta=1.0)
        if len(self.ddim_sampler.time_steps) != n_obs:
            raise ValueError(
                f"ddim_sampler must define exactly n_obs={n_obs} time steps (got "
                f"{len(self.ddim_sampler.time_steps)}): the sequence axis is the diffusion "
                "timeline; for a denser timeline use oversample()")
        self.diff_t_steps = np.flip(np.asarray(self.ddim_sampler.time_steps)).copy()

        generator = torch.Generator().manual_seed(seed)
        self.encoder = create_encoder(self.input_dim, latent_dim, encoder_config)
        self.decoder = create_decoder(self.input_dim, latent_dim, decoder_config)
        for net in (self.encoder, self.decoder):
            init_net(net, generator)
        if posterior == "iaf":  # the reference's posterior IAF: 3 blocks of 2 hidden layers
            self.posterior_flow = IAF(latent_dim, hidden_size, 3, 2, generator,
                                      context_dim=context_dim)
        if prior == "vamp":  # learned pseudo-inputs, mean-field over the pixels
            self.pseudo_inputs = nn.Parameter(0.1 * torch.randn(
                (vamp_number_components, *self.input_dim), generator=generator))
        # per-visit running loss tallies of the visit-branch forwards
        self.res_dict = {i: {"rec_loss": 0.0, "reg_loss": 0.0, "count": 0}
                         for i in range(n_obs)}

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # -- small pieces ---------------------------------------------------------------

    def _encode(self, x: torch.Tensor):
        """(mu, log_var, context or None) of frames [N, C, H, W]."""
        enc = self.encoder(x)
        h = enc.get("context") if self.context_dim else None
        return enc["embedding"], enc["log_covariance"], h

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)["reconstruction"]

    def _apply_posterior_flow(self, z: torch.Tensor, h: Optional[torch.Tensor] = None):
        """(z, log|det J|): the posterior IAF's sampling direction, or the identity."""
        if self.posterior == "iaf":
            return iaf_inverse(self.posterior_flow, z, h)
        return z, torch.zeros(z.shape[0], dtype=torch.float32, device=z.device)

    def _log_p_z(self, z: torch.Tensor) -> torch.Tensor:
        """The standard-normal or VAMP mixture prior, [B]."""
        if self.prior == "standard":
            return (-0.5 * z ** 2).sum(1)
        c = self.vamp_number_components
        p_mu, p_lv, _ = self._encode(torch.clamp(self.pseudo_inputs, 0.0, 1.0))
        log_p = (-0.5 * (p_lv[None] + (z[:, None, :] - p_mu[None]) ** 2
                         / torch.exp(p_lv[None]))).sum(2) - math.log(c)
        return torch.logsumexp(log_p, dim=1)

    def log_p_j_hat(self, j: int, z: torch.Tensor) -> torch.Tensor:
        """The prior on z_j: N(0, I) at the noised end (and without a
        metric), the metric's volume log_pi elsewhere."""
        assert 0 <= j < self.n_obs
        if j == 0 or self.pretrained_metric is None:
            return (-0.5 * z ** 2).sum(1)
        return self.pretrained_metric.log_pi(z)

    def _n_steps(self, n: int, vi_index: int, future_only: bool = False) -> int:
        """Draws of one :meth:`_propagate` over a timeline of ``n`` points."""
        return (0 if future_only else vi_index) + (n - 1 - vi_index)

    def _propagate(self, z_vi: torch.Tensor, vi_index: int, bridge: torch.Tensor,
                   sampler: Optional[DDIMSampler] = None, t_line: Optional[np.ndarray] = None,
                   future_only: bool = False) -> torch.Tensor:
        """The latent sequence from the visit latent: sequential noising
        into the past, DDIM denoising into the future, each step taking the
        next draw of ``bridge`` [steps, B, D].  [B, T, D] (T = len(t_line),
        from ``vi_index`` on with ``future_only``)."""
        sampler = sampler or self.ddim_sampler
        t_line = self.diff_t_steps if t_line is None else t_line
        n = len(t_line)
        zs: Dict[int, torch.Tensor] = {vi_index: z_vi}
        step = 0
        z_rev = z_vi
        if not future_only:
            for i in range(vi_index - 1, -1, -1):
                z_rev = self.ldm.sequential_diffusion(z_rev, int(t_line[i + 1]), int(t_line[i]),
                                                      bridge[step])
                zs[i] = z_rev
                step += 1
        z_for = z_vi
        for i in range(vi_index, n - 1):
            e_t = self.ldm(z_for, float(t_line[i]))
            z_for, _ = sampler.get_x_prev_and_pred_x0(e_t, n - 1 - i, z_for, bridge[step],
                                                      temperature=self.temperature)
            zs[i + 1] = z_for
            step += 1
        lo = vi_index if future_only else 0
        return torch.stack([zs[i] for i in range(lo, n)], dim=1)

    # -- the reference's per-frame forward --------------------------------------------

    def forward_simple(self, x: torch.Tensor, noise: Noise = None,
                       generator: Optional[torch.Generator] = None) -> ModelOutput:
        """Encode every frame, draw, decode: ``noise["eps"]`` [B, T, D]."""
        if x.dim() == 6 and x.shape[0] == 1:
            x = x[0]
        b, t = x.shape[0], x.shape[1]
        mu, log_var, _ = self._encode(x.reshape(b * t, *x.shape[2:]))
        mu, log_var = mu.reshape(b, t, -1), log_var.reshape(b, t, -1)
        eps = _normal(noise, "eps", mu.shape, generator, mu.device)
        z = mu + eps * torch.exp(0.5 * log_var)
        recon = self._decode(z.reshape(b * t, -1)).reshape(b, t, *x.shape[2:])
        return ModelOutput(reconstruction=recon, z=z, mu=mu, log_var=log_var)

    # -- losses ---------------------------------------------------------------------

    def _recon_term(self, recon_flat, x_flat, pix_flat, half: bool = True) -> torch.Tensor:
        """Masked per-sample reconstruction: 0.5 MSE in the warmup losses
        (``half``), plain MSE in :meth:`loss_function`; BCE (in fp32 before
        the clip) carries no factor."""
        if self.reconstruction_loss == "mse":
            scale = 0.5 if half else 1.0
            return (scale * (recon_flat - x_flat) ** 2 * pix_flat).sum(-1)
        r = torch.clamp(recon_flat.float(), 1e-7, 1.0 - 1e-7)
        return (-(x_flat * torch.log(r) + (1.0 - x_flat) * torch.log(1.0 - r)) * pix_flat).sum(-1)

    def _flat_masks(self, x, seq_mask, pix_mask):
        n = x.shape[0]
        seq_mask = torch.ones(n, dtype=x.dtype, device=x.device) if seq_mask is None \
            else seq_mask.reshape(n)
        pix_mask = torch.ones((n, int(np.prod(self.input_dim))), dtype=x.dtype,
                              device=x.device) if pix_mask is None else pix_mask.reshape(n, -1)
        return seq_mask, pix_mask

    def vae_loss_function(self, recon_x, x, mu, log_var, z0, epoch, zk=None,
                          log_abs_det_jac_posterior=None, seq_mask=None, pix_mask=None,
                          train=True):
        """The warmup objective by prior and posterior: (loss, recon, kld)."""
        if self.prior == "standard" and self.posterior == "gaussian":
            return self._vae_loss_function(recon_x, x, mu, log_var, z0, seq_mask, pix_mask)
        if self.prior == "vamp" and self.posterior == "gaussian":
            return self._vamp_loss_function(recon_x, x, mu, log_var, z0, epoch, seq_mask,
                                            pix_mask, train)
        return self._vae_iaf_loss_function(recon_x, x, mu, log_var, z0, zk,
                                           log_abs_det_jac_posterior, epoch, seq_mask, pix_mask)

    def _vae_loss_function(self, recon_x, x, mu, log_var, z, seq_mask=None, pix_mask=None):
        n = x.shape[0]
        seq_mask, pix_mask = self._flat_masks(x, seq_mask, pix_mask)
        recon = self._recon_term(recon_x.reshape(n, -1), x.reshape(n, -1), pix_mask)
        kld = -0.5 * (1 + log_var - mu ** 2 - torch.exp(log_var)).sum(-1)
        return torch.mean((recon + kld) * seq_mask), recon.mean(), kld.mean()

    def _vae_iaf_loss_function(self, recon_x, x, mu, log_var, z0, zk, log_abs_det_jac, epoch,
                               seq_mask=None, pix_mask=None):
        n = x.shape[0]
        seq_mask, pix_mask = self._flat_masks(x, seq_mask, pix_mask)
        recon = self._recon_term(recon_x.reshape(n, -1), x.reshape(n, -1), pix_mask)
        log_prob_z0 = (-0.5 * (log_var + (z0 - mu) ** 2 / torch.exp(log_var))).sum(1)
        kld = log_prob_z0 - self._log_p_z(zk) - log_abs_det_jac
        return torch.mean((recon + kld) * seq_mask), recon.mean(), kld.mean()

    def _vamp_loss_function(self, recon_x, x, mu, log_var, z, epoch, seq_mask=None,
                            pix_mask=None, train=True):
        n = x.shape[0]
        seq_mask, pix_mask = self._flat_masks(x, seq_mask, pix_mask)
        recon = self._recon_term(recon_x.reshape(n, -1), x.reshape(n, -1), pix_mask)
        log_q_z = (-0.5 * (log_var + (z - mu) ** 2 / torch.exp(log_var))).sum(1)
        kld = -(self._log_p_z(z) - log_q_z)
        beta = min(1.0 * epoch / self.linear_scheduling, 1.0) \
            if self.linear_scheduling > 0 and train else 1.0
        return torch.mean((recon + beta * kld) * seq_mask), recon.mean(), kld.mean()

    def _beta(self, epoch: int, train: bool) -> float:
        """Linear beta warmup."""
        if self.linear_scheduling > 0 and train:
            return min(self.beta * epoch / self.linear_scheduling, self.beta)
        return self.beta

    def loss_function(self, recon_x, x, mu, log_var, z_0_vi_index, z_seq, vi_index, z_vi_index,
                      log_abs_det_jac_posterior, epoch, seq_mask=None, pix_mask=None,
                      train=True):
        """The per-visit sequence loss: plain masked MSE (or BCE) per frame,
        averaged over the visits, and the KL against :meth:`log_p_j_hat` at
        the boundary visits only, clamped to [-2, 500]."""
        b, t = x.shape[0], self.n_obs
        seq_mask = torch.ones((b, t), dtype=x.dtype, device=x.device) if seq_mask is None \
            else seq_mask
        pix_mask = torch.ones_like(x) if pix_mask is None else pix_mask
        recon = self._recon_term(recon_x.reshape(b * t, -1), x.reshape(b * t, -1),
                                 pix_mask.reshape(b * t, -1), half=False).reshape(b, t)
        recon_loss = (recon * seq_mask).mean(-1)
        log_prob_z_vi = (-0.5 * (log_var + (z_0_vi_index - mu) ** 2
                                 / (torch.exp(log_var) + 1e-7))).sum(1) \
            - log_abs_det_jac_posterior
        if vi_index == 0 or vi_index == self.n_obs - 1:
            kld = torch.clamp(log_prob_z_vi - self.log_p_j_hat(vi_index, z_vi_index), -2.0, 500.0)
        else:
            kld = torch.zeros_like(log_prob_z_vi)
        beta = self._beta(epoch, train)
        return torch.mean(recon_loss + beta * kld), recon_loss.mean(), kld.mean()

    # -- the training forward -----------------------------------------------------------

    def forward(self, x: torch.Tensor, noise: Noise = None, vi_index: Optional[int] = None,
                epoch: int = 100, train: bool = False, seq_mask: Optional[torch.Tensor] = None,
                pix_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> ModelOutput:
        """Encode the visit of interest, refine it with the posterior IAF,
        bridge it to the whole timeline, decode every frame, and apply
        :meth:`loss_function`; warmup epochs train the per-frame objective.
        x: [B, n_obs, C, H, W]."""
        b, t = x.shape[0], x.shape[1]
        seq_mask = torch.ones((b, t), dtype=x.dtype, device=x.device) if seq_mask is None \
            else seq_mask
        pix_mask = torch.ones_like(x) if pix_mask is None else pix_mask
        x = x * pix_mask * seq_mask[:, :, None, None, None]
        if epoch < self.warmup:
            return self._forward_warmup(x, noise, epoch, train, seq_mask, pix_mask, generator)

        vi_index = int(np.random.randint(0, self.n_obs)) if vi_index is None else vi_index
        mu, log_var, h = self._encode(x[:, vi_index])
        eps = _normal(noise, "eps", mu.shape, generator, mu.device)
        z_0_vi = mu + eps * torch.exp(0.5 * log_var)
        z_vi, log_det = self._apply_posterior_flow(z_0_vi, h)
        bridge = _normal(noise, "bridge", (self._n_steps(t, vi_index), b, self.latent_dim),
                         generator, mu.device)
        z_seq = self._propagate(z_vi, vi_index, bridge)
        recon = self._decode(z_seq.reshape(b * t, self.latent_dim)).reshape(x.shape)
        loss, recon_loss, kld = self.loss_function(recon, x, mu, log_var, z_0_vi, z_seq,
                                                   vi_index, z_vi, log_det, epoch, seq_mask,
                                                   pix_mask, train)
        tally = self.res_dict[vi_index]
        rec, reg = torch.stack([recon_loss.detach(), kld.detach()]).tolist()  # one host read
        tally["rec_loss"] += rec
        tally["reg_loss"] += reg
        tally["count"] += 1
        return ModelOutput(loss=loss, reconstruction_loss=recon_loss, reg_loss=kld,
                           recon_x=recon, z=z_vi, z_seq=z_seq, vi_index=vi_index)

    def _forward_warmup(self, x, noise, epoch, train, seq_mask, pix_mask, generator):
        """The per-frame objective of the warmup epochs (:meth:`vae_loss_function`)."""
        b, t = x.shape[0], x.shape[1]
        x_flat = x.reshape(b * t, *self.input_dim)
        mu, log_var, h = self._encode(x_flat)
        eps = _normal(noise, "eps", mu.shape, generator, mu.device)
        z0 = mu + eps * torch.exp(0.5 * log_var)
        z, log_det = self._apply_posterior_flow(z0, h)
        recon = self._decode(z)
        loss, recon_loss, kld = self.vae_loss_function(
            recon, x_flat, mu, log_var, z0, epoch, zk=z, log_abs_det_jac_posterior=log_det,
            seq_mask=seq_mask.reshape(b * t), pix_mask=pix_mask.reshape(b * t, -1), train=train)
        return ModelOutput(loss=loss, reconstruction_loss=recon_loss, reg_loss=kld,
                           recon_x=recon.reshape(x.shape), z=z,
                           z_seq=z.reshape(b, t, self.latent_dim), vi_index=-1)

    # -- reconstruct and oversample ---------------------------------------------------

    def _encode_vi(self, x, vi_index, eps):
        mu, log_var, h = self._encode(x[:, vi_index])
        z, log_det = self._apply_posterior_flow(mu + eps * torch.exp(0.5 * log_var), h)
        return z, mu, log_var, log_det

    def _bridged(self, x, vi_index, noise, generator, z_vi_index, sampler=None, t_line=None,
                 match=None):
        x = x[None] if x.dim() == 4 else x
        b = x.shape[0]
        if z_vi_index is None:
            eps = _normal(noise, "eps", (b, self.latent_dim), generator, x.device)
            z = self._encode_vi(x, vi_index, eps)[0]
        else:
            z = torch.as_tensor(z_vi_index, dtype=torch.float32, device=x.device)
        at = vi_index if match is None else match
        n = self.n_obs if t_line is None else len(t_line)
        bridge = _normal(noise, "bridge", (self._n_steps(n, at), z.shape[0], self.latent_dim),
                         generator, x.device)
        z_seq, recon = self._decode_bridged(z, at, bridge, sampler=sampler, t_line=t_line)
        return z_seq.reshape(-1, self.latent_dim), recon

    def reconstruct(self, x: torch.Tensor, vi_index: int, noise: Noise = None,
                    z_vi_index: Optional[torch.Tensor] = None,
                    seq_mask: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
        """Encode visit ``vi_index`` (or take ``z_vi_index``), bridge it to
        the timeline, decode: (z_seq [B*T, D], recon [B*T, ...])."""
        x = x[None] if x.dim() == 4 else x
        if seq_mask is not None:
            x = x * seq_mask[:, :, None, None, None]
        return self._bridged(x, vi_index, noise, generator, z_vi_index)

    def oversample(self, x: torch.Tensor, vi_index: int, sampler: Optional[DDIMSampler] = None,
                   num_supp_steps: Optional[int] = None,
                   z_vi_index: Optional[torch.Tensor] = None, noise: Noise = None,
                   generator: Optional[torch.Generator] = None):
        """The bridge re-timed onto a denser DDIM timeline (``sampler``, or
        one of n_obs - 1 + ``num_supp_steps`` steps at eta 1): (z_seq
        [B*T', D], recon [B*T', ...])."""
        if sampler is None:
            assert num_supp_steps is not None
            sampler = DDIMSampler(self.ldm, n_steps=self.n_obs - 1 + num_supp_steps,
                                  ddim_eta=1.0)
        t_line = np.flip(np.sort(np.asarray(sampler.time_steps))).copy()
        match = int(np.argmin(np.abs(t_line - self.diff_t_steps[vi_index])))
        return self._bridged(x, vi_index, noise, generator, z_vi_index, sampler=sampler,
                             t_line=t_line, match=match)

    # -- the observation metric of the model's own encoder ------------------------------

    def retrieve_g(self, obs_data: torch.Tensor, num_centroids: int = 200,
                   t_multiplier: float = 1.0, add_std_norm: bool = False):
        """Encode frames ``obs_data`` [N, C, H, W] and build the sampled
        observation metric on the host: (metric, mu, log_var)."""
        mu, log_var, _ = self._encode(obs_data)
        metric = retrieve_g(mu.detach().float().cpu().numpy(),
                            log_var.detach().float().cpu().numpy(), num_centroids,
                            t_multiplier, add_std_norm)
        return metric, mu, log_var

    # -- generation and prediction ----------------------------------------------------

    def _decode_bridged(self, z_vi, vi_index, bridge, **propagate):
        """(z_seq [B, T, D], its frames [B*T, ...]): :meth:`_propagate`, decoded."""
        z_seq = self._propagate(z_vi, vi_index, bridge, **propagate)
        return z_seq, self._decode(z_seq.reshape(-1, self.latent_dim))

    def _batch_bridge(self, noise, i, steps, rows, generator, device):
        if noise is not None and "bridge" in noise:
            return torch.as_tensor(noise["bridge"][i], dtype=torch.float32, device=device)
        return torch.randn((steps, rows, self.latent_dim), generator=generator).to(device)

    def generate(self, train_data: torch.Tensor, num_gen_seq: int = 1, vi_index: int = 0,
                 t_multiplier: float = 0.5, batch_size: int = 128, freeze: bool = False,
                 num_centroids: int = 200, mcmc_steps_nbr: int = 100, noise: Noise = None,
                 generator: Optional[torch.Generator] = None):
        """Sequence anchors by HMC on the observation metric of visit
        ``vi_index`` of ``train_data`` [N, T, C, H, W], each bridged to the
        timeline and decoded: (recon [n, T, ...], z_seq [n, T, D]);
        ``freeze`` repeats one anchor."""
        g, mu, _ = self.retrieve_g(train_data[:, vi_index], num_centroids, t_multiplier)
        batch_size = min(num_gen_seq, batch_size)
        all_z, _ = hmc_sampling(g, mu, 1 if freeze else num_gen_seq, mcmc_steps_nbr,
                                noise=noise, generator=generator)
        all_z = all_z.expand(num_gen_seq, -1)
        steps = self._n_steps(self.n_obs, vi_index)
        recs, seqs = [], []
        for i, lo in enumerate(range(0, num_gen_seq, batch_size)):
            z_vi = all_z[lo: lo + batch_size]
            bridge = self._batch_bridge(noise, i, steps, z_vi.shape[0], generator, mu.device)
            z_seq, recon = self._decode_bridged(z_vi, vi_index, bridge)
            recs.append(recon.reshape(-1, self.n_obs, *self.input_dim))
            seqs.append(z_seq)
        return torch.cat(recs, dim=0), torch.cat(seqs, dim=0)

    def predict(self, x: torch.Tensor, vi_index: int, num_gen_seq: int = 1,
                batch_size: int = 100, noise: Noise = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Stochastic futures: the posterior mean of visit ``vi_index``,
        repeated ``num_gen_seq`` times, each copy denoised forward with its
        own DDIM draws, decoded: [n_seq, num_gen_seq, n_obs - vi_index - 1, ...]."""
        x = x[None] if x.dim() == 4 else x
        n_seq = x.shape[0]
        batch_size = min(num_gen_seq, batch_size)
        z_vi = self._encode(x[:, vi_index])[0]
        t_fut = self.n_obs - vi_index - 1
        outs = []
        for i, lo in enumerate(range(0, num_gen_seq, batch_size)):
            m = min(batch_size, num_gen_seq - lo)
            z = torch.repeat_interleave(z_vi, m, dim=0)  # [n_seq*m, D]
            bridge = self._batch_bridge(noise, i, t_fut, z.shape[0], generator, x.device)
            z_seq = self._propagate(z, vi_index, bridge, future_only=True)
            recon = self._decode(z_seq[:, 1:, :].reshape(-1, self.latent_dim))
            outs.append(recon.reshape(n_seq, m, t_fut, *self.input_dim))
        return torch.cat(outs, dim=1)

    def get_nll(self, data: torch.Tensor, vi_index: int, n_samples: int = 1,
                batch_size: int = 100, noise: Noise = None,
                generator: Optional[torch.Generator] = None) -> float:
        """Importance-sampled log-likelihood: per sequence, ``n_samples``
        copies (only ``n_samples // batch_size`` whole batches when
        ``n_samples > batch_size``, as JAX and the reference drop the
        remainder) encoded at the visit, bridged, decoded; the frames'
        log p(x|z) averaged over visits, logsumexp'd over copies; the mean
        over sequences."""
        n_full_batch = max(1, n_samples // batch_size) if n_samples > batch_size else 1
        bs = min(n_samples, batch_size)
        n, d = data.shape[0], self.latent_dim
        steps = self._n_steps(self.n_obs, vi_index)
        eps = _normal(noise, "eps", (n, n_full_batch, bs, d), generator, data.device)
        bridge = _normal(noise, "bridge", (n, n_full_batch, steps, bs, d), generator, data.device)
        dim_prod = float(np.prod(self.input_dim))
        log_p = []
        for i in range(n):
            x_rep = data[i][None].expand(bs, *data.shape[1:])
            log_p_x = []
            for j in range(n_full_batch):
                z = self._encode_vi(x_rep, vi_index, eps[i, j])[0]
                _, recon = self._decode_bridged(z, vi_index, bridge[i, j])
                r_flat = recon.reshape(bs * self.n_obs, -1)
                x_flat = x_rep.reshape(bs * self.n_obs, -1)
                if self.reconstruction_loss == "mse":
                    lp = (-0.5 * ((r_flat - x_flat) ** 2).sum(-1)
                          - dim_prod / 2 * math.log(2 * math.pi))
                else:
                    r = torch.clamp(r_flat.float(), 1e-7, 1.0 - 1e-7)
                    lp = (x_flat * torch.log(r) + (1 - x_flat) * torch.log(1 - r)).sum(-1)
                log_p_x.append(lp.reshape(bs, self.n_obs).mean(-1))
            log_p_x = torch.cat(log_p_x)
            log_p.append(torch.logsumexp(log_p_x, dim=0) - math.log(log_p_x.shape[0]))
        return float(np.mean(torch.stack(log_p).detach().cpu().numpy()))

    def encode(self, x: torch.Tensor, noise: Noise = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Posterior samples of every frame, [B, n_obs, D] (``noise["eps"]`` likewise)."""
        x = x[:, None] if x.dim() == 4 else x
        b, t = x.shape[0], x.shape[1]
        mu, log_var, _ = self._encode(x.reshape(b * t, *x.shape[2:]))
        mu, log_var = mu.reshape(b, t, -1), log_var.reshape(b, t, -1)
        eps = _normal(noise, "eps", mu.shape, generator, mu.device)
        return mu + eps * torch.exp(0.5 * log_var)
