"""VAMP: a VAE whose prior is a Variational Mixture of Posteriors.

Port of ``rlvae_tpu/models/research/vamp.py``:

- learnable pseudo-inputs: one Linear ``C -> prod(input_dim)`` applied to the
  identity (its kernel plus its bias), then hardtanh to [0, 1]
  (:meth:`VAMP.pseudo_inputs`);
- the mixture prior log p(z) = logsumexp_k N(z; mu_k, sigma_k) - log C over
  the encoded pseudo-inputs (:meth:`VAMP.log_p_z`);
- frames modelled independently: the masked reconstruction loss (0.5 MSE,
  or BCE computed in fp32 after the clip, so that a bf16 decoder output
  cannot reach log(0)), the KL as log q(z|x) - log p(z), linear KL warmup
  in a train forward;
- :meth:`VAMP.generate` (a component, then its Gaussian) and the
  importance-sampled :meth:`VAMP.estimate_nll`.

The model launches no kernel of its own (its nets are PyTorch layers), as
JAX's runs no Pallas kernel.  Randomness can be passed in as ``noise`` (the
tests pass JAX's draws) or is drawn from ``generator``: ``eps`` [B*T, D]
for ``forward``, ``idx`` [n] (component indices) and ``eps`` [n, D] for
``generate``, ``eps`` [n_samples, B*T, D] for ``estimate_nll``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rlvae_tpu_torch.models.research.lvae_iaf import Noise, _normal
from rlvae_tpu_torch.nets.layers import init_net
from rlvae_tpu_torch.nets.registry import create_decoder, create_encoder
from rlvae_tpu_torch.utils.output import ModelOutput

BCE_EPS = 1e-7


def masked_recon_loss(recon: torch.Tensor, x: torch.Tensor, pix_mask: torch.Tensor,
                      kind: str) -> torch.Tensor:
    """Per-frame masked reconstruction loss [N] of frames [N, ...]: 0.5 MSE,
    or BCE with the decoder output taken to fp32 before the clip (in bf16,
    1 - 1e-7 rounds to 1 and the log to -inf)."""
    n = x.shape[0]
    rf, xf, mf = recon.reshape(n, -1), x.reshape(n, -1), pix_mask.reshape(n, -1)
    if kind == "bce":
        r = torch.clamp(rf.float(), BCE_EPS, 1 - BCE_EPS)
        return (-(xf * torch.log(r) + (1 - xf) * torch.log(1 - r)) * mf).sum(-1)
    return (0.5 * (rf - xf) ** 2 * mf).sum(-1)


class VAMP(nn.Module):
    def __init__(
        self,
        input_dim: Tuple[int, ...] = (3, 64, 64),
        latent_dim: int = 16,
        number_components: int = 50,
        linear_scheduling_steps: int = 0,
        reconstruction_loss: str = "mse",
        encoder_config: Optional[Mapping[str, Any]] = None,
        decoder_config: Optional[Mapping[str, Any]] = None,
        seed: int = 0,
    ):
        super().__init__()
        self.input_dim = tuple(input_dim)
        self.latent_dim = latent_dim
        self.number_components = number_components
        self.linear_scheduling = linear_scheduling_steps
        self.reconstruction_loss = reconstruction_loss
        generator = torch.Generator().manual_seed(seed)
        self.encoder = create_encoder(self.input_dim, latent_dim, encoder_config)
        self.decoder = create_decoder(self.input_dim, latent_dim, decoder_config)
        for net in (self.encoder, self.decoder):
            init_net(net, generator)
        c, d_in = number_components, int(np.prod(self.input_dim))
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

    def decode(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.decoder(z)

    def pseudo_inputs(self) -> torch.Tensor:
        """[C, *input_dim] in [0, 1]: the identity through the Linear, then hardtanh."""
        flat = torch.clamp(self.pseudo_kernel + self.pseudo_bias[None, :], 0.0, 1.0)
        return flat.reshape(self.number_components, *self.input_dim)

    def pseudo_posteriors(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu_k, log_var_k) [C, D] of the encoded pseudo-inputs."""
        return self._encode(self.pseudo_inputs())

    def log_p_z(self, z: torch.Tensor) -> torch.Tensor:
        """The mixture prior's log-density, [B]."""
        mu_k, lv_k = self.pseudo_posteriors()
        comp = (-0.5 * (lv_k[None] + (z[:, None, :] - mu_k[None]) ** 2
                        / torch.exp(lv_k[None]))).sum(2) - math.log(float(self.number_components))
        return torch.logsumexp(comp, dim=1)

    @staticmethod
    def _log_q_z(z, mu, log_var) -> torch.Tensor:
        return (-0.5 * (log_var + (z - mu) ** 2 / torch.exp(log_var))).sum(1)

    # -- forward ------------------------------------------------------------------

    def forward(self, x: torch.Tensor, noise: Noise = None, vi_index: Optional[int] = None,
                epoch: int = 100, train: bool = False, seq_mask: Optional[torch.Tensor] = None,
                pix_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> ModelOutput:
        """x: [B, T, C, H, W], frames modelled independently under the prior.
        ``vi_index`` is unused: every research model takes the same call."""
        b, t = x.shape[0], x.shape[1]
        seq_mask = torch.ones((b, t), dtype=x.dtype, device=x.device) if seq_mask is None \
            else seq_mask
        pix_mask = torch.ones_like(x) if pix_mask is None else pix_mask
        x = x * pix_mask * seq_mask[:, :, None, None, None]
        x_flat = x.reshape(b * t, *self.input_dim)
        mu, log_var = self._encode(x_flat)
        eps = _normal(noise, "eps", mu.shape, generator, mu.device)
        z = mu + eps * torch.exp(0.5 * log_var)
        recon = self.decoder(z)["reconstruction"]
        recon_loss = masked_recon_loss(recon, x_flat, pix_mask.reshape(b * t, *self.input_dim),
                                       self.reconstruction_loss)
        kld = -(self.log_p_z(z) - self._log_q_z(z, mu, log_var))
        # linear KL warmup; an eval forward holds beta at 1
        beta = min(1.0 * epoch / self.linear_scheduling, 1.0) \
            if self.linear_scheduling > 0 and train else 1.0
        loss = torch.mean(recon_loss + beta * kld)
        return ModelOutput(loss=loss, reconstruction_loss=recon_loss.mean(), reg_loss=kld.mean(),
                           recon_x=recon.reshape(x.shape), z=z, mu=mu, log_var=log_var)

    # -- generation and evaluation --------------------------------------------------

    def generate(self, n: int, noise: Noise = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A component per sample (``noise["idx"]``), then its Gaussian
        (``noise["eps"]``), decoded: [n, C, H, W]."""
        mu_k, lv_k = self.pseudo_posteriors()
        if noise is not None and "idx" in noise:
            idx = torch.as_tensor(noise["idx"], device=mu_k.device).long()
        else:
            idx = torch.randint(0, self.number_components, (n,), generator=generator).to(
                mu_k.device)
        eps = _normal(noise, "eps", (n, self.latent_dim), generator, mu_k.device)
        z = mu_k[idx] + torch.exp(0.5 * lv_k[idx]) * eps
        return self.decoder(z)["reconstruction"]

    def estimate_nll(self, x: torch.Tensor, n_samples: int = 50, noise: Noise = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Importance-sampled NLL per frame, [B*T]: log p(x|z) (the unit
        Gaussian's, its constant included) + log p(z) - log q(z|x) over
        ``n_samples`` posterior draws, logsumexp'd."""
        x_flat = x.reshape(-1, *self.input_dim)
        n = x_flat.shape[0]
        mu, log_var = self._encode(x_flat)
        std = torch.exp(0.5 * log_var)
        d_x = int(np.prod(self.input_dim))
        eps = _normal(noise, "eps", (n_samples, n, self.latent_dim), generator, x.device)
        log_w = []
        for s in range(n_samples):
            z = mu + eps[s] * std
            recon = self.decoder(z)["reconstruction"]
            log_pxz = (-0.5 * ((recon.reshape(n, -1) - x_flat.reshape(n, -1)) ** 2).sum(-1)
                       - d_x / 2 * math.log(2 * math.pi))
            log_w.append(log_pxz + self.log_p_z(z) - self._log_q_z(z, mu, log_var))
        return -(torch.logsumexp(torch.stack(log_w), dim=0) - math.log(float(n_samples)))
