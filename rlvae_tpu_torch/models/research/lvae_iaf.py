"""LVAE_IAF: the longitudinal VAE with one IAF per visit transition.

Port of ``rlvae_tpu/models/research/lvae_iaf.py``.  n_obs-1 IAF flows
connect consecutive visits.  Training encodes ONE visit (``vi_index``) and
propagates its latent to the past through the flows' density direction,
accumulating log|det J|, and to the future through the sampling direction,
then decodes every visit.  The loss is the masked per-visit reconstruction
(mean over visits) plus a KL between the visit posterior (optionally
IAF-transformed, with its log-det) and the prior at z_0 pushed through the
backward chain (standard normal or a VAMP mixture), with linear beta
scheduling; epochs before ``warmup`` train the per-frame VAE objective.

The flows run as the plain :func:`~rlvae_tpu_torch.flows.iaf.iaf_forward`
and :func:`~rlvae_tpu_torch.flows.iaf.iaf_inverse`, one IAF at a time, as
JAX runs ``iaf_forward``/``iaf_inverse`` outside its kernels here: this
model launches no kernel of its own (its nets are PyTorch layers).

All randomness can be passed in as ``noise`` (JAX's ``jax.random`` draws
cannot be reproduced; the tests pass JAX's draws), otherwise it is drawn
from ``generator``: ``eps`` for the posterior samples (``forward``: [B, D],
[B*T, D] in the warmup branch; ``estimate_nll``: [n_samples, B, D];
``infer_missing``: [observed visits, B, D]) and ``z`` for ``generate``.
``vi_index=None`` draws the visit with numpy's global generator, as JAX does.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rlvae_tpu_torch.flows.iaf import IAF, iaf_forward, iaf_inverse
from rlvae_tpu_torch.nets.layers import init_net
from rlvae_tpu_torch.nets.registry import create_decoder, create_encoder
from rlvae_tpu_torch.utils.output import ModelOutput

Noise = Optional[Mapping[str, torch.Tensor]]


def _normal(noise: Noise, key: str, shape, generator, device) -> torch.Tensor:
    """``noise[key]`` on ``device``, or a standard-normal draw of ``shape``."""
    if noise is not None and key in noise:
        return torch.as_tensor(noise[key], dtype=torch.float32, device=device)
    return torch.randn(shape, generator=generator).to(device)


class LVAE_IAF(nn.Module):
    # MSE scale of the reconstruction term: 0.5 here, 1.0 in LVAE_GUGUS
    recon_scale = 0.5

    def __init__(
        self,
        input_dim: Tuple[int, ...] = (3, 64, 64),
        latent_dim: int = 16,
        n_obs: int = 8,
        warmup: int = 50,
        beta: float = 1.0,
        linear_scheduling_steps: int = 0,
        n_made_blocks: int = 2,
        n_hidden_in_made: int = 3,
        hidden_size: int = 128,
        prior: str = "standard",  # standard | vamp
        posterior: str = "gaussian",  # gaussian | iaf
        vamp_number_components: int = 50,
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
        self.vamp_number_components = vamp_number_components
        self.hidden_size = hidden_size
        self.n_made_blocks = n_made_blocks
        self.n_hidden_in_made = n_hidden_in_made
        generator = torch.Generator().manual_seed(seed)
        self.encoder = create_encoder(self.input_dim, latent_dim, encoder_config)
        self.decoder = create_decoder(self.input_dim, latent_dim, decoder_config)
        for net in (self.encoder, self.decoder):
            init_net(net, generator)
        self.flows = nn.ModuleList(
            IAF(latent_dim, hidden_size, n_made_blocks, n_hidden_in_made, generator)
            for _ in range(n_obs - 1))
        if posterior == "iaf":
            # the reference's posterior IAF: 3 blocks of 2 hidden layers
            self.posterior_flow = IAF(latent_dim, hidden_size, 3, 2, generator)
        if prior == "vamp":
            c, d_in = vamp_number_components, int(np.prod(self.input_dim))
            bound = 1.0 / math.sqrt(c)
            self.pseudo_kernel = nn.Parameter(
                (torch.rand((c, d_in), generator=generator) * 2 - 1) * bound)
            self.pseudo_bias = nn.Parameter(torch.zeros(d_in))

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # -- pieces -----------------------------------------------------------------

    def _encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        enc = self.encoder(x)
        return enc["embedding"], enc["log_covariance"]

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)["reconstruction"]

    def log_p_z(self, z: torch.Tensor) -> torch.Tensor:
        """Prior log-density at z_0: standard normal or the VAMP mixture."""
        if self.prior == "standard":
            return (-0.5 * z ** 2).sum(1)
        c = self.vamp_number_components
        pseudo = torch.clamp(self.pseudo_kernel + self.pseudo_bias[None, :], 0.0, 1.0)
        mu_k, lv_k = self._encode(pseudo.reshape(c, *self.input_dim))
        comp = (-0.5 * (lv_k[None] + (z[:, None, :] - mu_k[None]) ** 2
                        / torch.exp(lv_k[None]))).sum(2) - math.log(float(c))
        return torch.logsumexp(comp, dim=1)

    def sample_visit_latent(self, mu: torch.Tensor, log_var: torch.Tensor, vi_index: int,
                            noise: Noise, generator: Optional[torch.Generator]) -> torch.Tensor:
        """The visit-posterior sample (LVAE_GUGUS's ``lvaega`` variants draw
        the visit-0 latent by manifold HMC instead)."""
        eps = _normal(noise, "eps", mu.shape, generator, mu.device)
        return mu + eps * torch.exp(0.5 * log_var)

    def _posterior_flow(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.posterior == "iaf":
            return iaf_inverse(self.posterior_flow, z)
        return z, z.new_zeros(z.shape[0])

    def propagate(self, z_vi: torch.Tensor, vi_index: int):
        """(z_seq [B, T, D], log_det [B]): density direction to the past,
        accumulating log|det J|; sampling direction to the future."""
        past, log_det = [], z_vi.new_zeros(z_vi.shape[0])
        z_rev = z_vi
        for i in range(vi_index - 1, -1, -1):
            z_rev, ld = iaf_forward(self.flows[i], z_rev)
            log_det = log_det + ld
            past.append(z_rev)
        past.reverse()
        seq = past + [z_vi]
        z_for = z_vi
        for i in range(vi_index, self.n_obs - 1):
            z_for, _ = iaf_inverse(self.flows[i], z_for)
            seq.append(z_for)
        return torch.stack(seq, dim=1), log_det

    def _recon_loss(self, recon, x, seq_mask, pix_mask):
        b, t = x.shape[0], x.shape[1]
        per_frame = (self.recon_scale * (recon.reshape(b * t, -1) - x.reshape(b * t, -1)) ** 2
                     * pix_mask.reshape(b * t, -1)).sum(-1)
        return (per_frame.reshape(b, t) * seq_mask).mean(-1)  # [B]

    def _beta(self, epoch: int, train: bool) -> float:
        if self.linear_scheduling > 0 and train:
            return min(self.beta * epoch / self.linear_scheduling, self.beta)
        return self.beta

    # -- forward ------------------------------------------------------------------

    def forward(self, x: torch.Tensor, noise: Noise = None, vi_index: Optional[int] = None,
                epoch: int = 100, train: bool = False, seq_mask: Optional[torch.Tensor] = None,
                pix_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> ModelOutput:
        """x: [B, n_obs, C, H, W]."""
        b, t = x.shape[0], x.shape[1]
        seq_mask = torch.ones((b, t), dtype=x.dtype, device=x.device) if seq_mask is None \
            else seq_mask
        pix_mask = torch.ones_like(x) if pix_mask is None else pix_mask
        x = x * pix_mask * seq_mask[:, :, None, None, None]
        if epoch < self.warmup:
            return self._forward_warmup(x, noise, epoch, train, seq_mask, pix_mask, generator)

        vi_index = int(np.random.randint(0, self.n_obs)) if vi_index is None else vi_index
        mu, log_var = self._encode(x[:, vi_index])
        z0_vi = self.sample_visit_latent(mu, log_var, vi_index, noise, generator)
        z, log_det_post = self._posterior_flow(z0_vi)
        z_seq, log_det = self.propagate(z, vi_index)
        recon = self._decode(z_seq.reshape(b * t, self.latent_dim)).reshape(x.shape)
        recon_loss = self._recon_loss(recon, x, seq_mask, pix_mask)
        log_q = (-0.5 * (log_var + (z0_vi - mu) ** 2 / (torch.exp(log_var) + 1e-7))).sum(1) \
            - log_det_post
        kld = log_q - (self.log_p_z(z_seq[:, 0]) + log_det)
        loss = torch.mean(recon_loss + self._beta(epoch, train) * kld)
        return ModelOutput(loss=loss, reconstruction_loss=recon_loss.mean(), reg_loss=kld.mean(),
                           recon_x=recon, z=z, z_seq=z_seq, vi_index=vi_index)

    def _forward_warmup(self, x, noise, epoch, train, seq_mask, pix_mask, generator):
        """The per-frame VAE objective of the warmup epochs."""
        b, t = x.shape[0], x.shape[1]
        x_flat = x.reshape(b * t, *self.input_dim)
        mu, log_var = self._encode(x_flat)
        eps = _normal(noise, "eps", mu.shape, generator, mu.device)
        z0 = mu + eps * torch.exp(0.5 * log_var)
        z, log_det_post = self._posterior_flow(z0)
        recon = self._decode(z)
        per_frame = (self.recon_scale * (recon.reshape(b * t, -1) - x_flat.reshape(b * t, -1)) ** 2
                     * pix_mask.reshape(b * t, -1)).sum(-1)
        if self.posterior == "iaf":
            log_q = (-0.5 * (log_var + (z0 - mu) ** 2 / torch.exp(log_var))).sum(1) - log_det_post
            kld = log_q - self.log_p_z(z)
        else:
            kld = -0.5 * (1 + log_var - mu ** 2 - torch.exp(log_var)).sum(-1)
        loss = torch.mean((per_frame + kld) * seq_mask.reshape(b * t))
        return ModelOutput(loss=loss, reconstruction_loss=per_frame.mean(), reg_loss=kld.mean(),
                           recon_x=recon.reshape(x.shape), z=z,
                           z_seq=z.reshape(b, t, self.latent_dim), vi_index=-1)

    def estimate_nll(self, x: torch.Tensor, n_samples: int = 50, vi_index: Optional[int] = None,
                     batch_size: int = 100, noise: Noise = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Importance-sampled NLL per sequence [B]: the visit posterior at
        ``vi_index``, propagated, weighted by decoder likelihood times prior
        over posterior density; samples in chunks of ``batch_size``,
        logsumexp'd across chunks.  ``noise["eps"]`` is [n_samples, B, D]."""
        if vi_index is None:
            vi_index = int(np.random.randint(0, self.n_obs))
        b = x.shape[0]
        eps = _normal(noise, "eps", (n_samples, b, self.latent_dim), generator, x.device)
        chunks, start = [], 0
        while start < n_samples:
            s = min(n_samples - start, int(batch_size))
            chunks.append(self._nll_chunk(x, eps[start:start + s], vi_index))
            start += s
        log_w = torch.cat(chunks, dim=0)  # [S, B]
        return -(torch.logsumexp(log_w, dim=0) - math.log(float(log_w.shape[0])))

    def _nll_chunk(self, x, eps, vi_index):
        s, b, t = eps.shape[0], x.shape[0], x.shape[1]
        mu, log_var = self._encode(x[:, vi_index])
        z0_vi = (mu[None] + eps * torch.exp(0.5 * log_var)[None]).reshape(s * b, self.latent_dim)
        z, log_det_post = self._posterior_flow(z0_vi)
        z_seq, log_det = self.propagate(z, vi_index)
        recon = self._decode(z_seq.reshape(s * b * t, self.latent_dim))
        d_x = float(np.prod(self.input_dim))
        x_rep = x[None].expand(s, *x.shape).reshape(s * b * t, -1)
        per_frame = (-0.5 * ((recon.reshape(s * b * t, -1) - x_rep) ** 2).sum(-1)
                     - d_x / 2.0 * math.log(2.0 * math.pi))
        log_p_x = per_frame.reshape(s * b, t).sum(-1)
        log_q = (-0.5 * (log_var[None].expand(s, b, -1).reshape(s * b, -1)
                         + eps.reshape(s * b, -1) ** 2)).sum(1) - log_det_post
        log_prior = self.log_p_z(z_seq[:, 0]) + log_det
        return (log_p_x + log_prior - log_q).reshape(s, b)

    # -- inference ----------------------------------------------------------------

    def _decode_seq(self, z_seq: torch.Tensor) -> torch.Tensor:
        n = z_seq.shape[0]
        return self._decode(z_seq.reshape(n * self.n_obs, self.latent_dim)).reshape(
            n, self.n_obs, *self.input_dim)

    def reconstruct(self, x: torch.Tensor, vi_index: int) -> torch.Tensor:
        """Encode visit ``vi_index`` (the posterior mean), propagate, decode
        the whole sequence."""
        z, _ = self._encode(x[:, vi_index])
        z, _ = self._posterior_flow(z)
        return self._decode_seq(self.propagate(z, vi_index)[0])

    def generate(self, n: int, vi_index: int = 0, noise: Noise = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A standard-normal visit latent (``noise["z"]`` [n, D]), propagated
        and decoded: [n, n_obs, C, H, W]."""
        z = _normal(noise, "z", (n, self.latent_dim), generator, self.device)
        return self._decode_seq(self.propagate(z, vi_index)[0])

    def infer_missing(self, x: torch.Tensor, seq_mask: torch.Tensor, pix_mask: torch.Tensor,
                      noise: Noise = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Fill missing visits: full candidates propagated from every visit
        observed in the first sequence, the best per sample by masked
        reconstruction loss.  ``noise["eps"]`` is [observed visits, B, D]."""
        b = x.shape[0]
        x = x * pix_mask * seq_mask[:, :, None, None, None]
        observed = [i for i in range(self.n_obs) if float(seq_mask[0, i]) != 0.0]
        eps = _normal(noise, "eps", (len(observed), b, self.latent_dim), generator, x.device)
        candidates, scores = [], []
        for k, vi in enumerate(observed):
            mu, log_var = self._encode(x[:, vi])
            z, _ = self._posterior_flow(mu + eps[k] * torch.exp(0.5 * log_var))
            recon = self._decode_seq(self.propagate(z, vi)[0])
            candidates.append(recon)
            scores.append(self._recon_loss(recon, x, seq_mask, pix_mask))
        best = torch.stack(scores).argmin(0)  # [B]
        return torch.stack(candidates)[best, torch.arange(b, device=x.device)]
