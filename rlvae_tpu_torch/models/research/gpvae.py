"""GP-VAE: a VAE with a Gaussian-process prior over the time axis.

Port of ``rlvae_tpu/models/research/gpvae.py``:

- :func:`gp_kernel`, the four time kernels (cauchy, rbf, diffusion,
  matern), tiled over the latent dimensions at ``kernel_scales`` length
  scales; the prior's covariance K [L, T, T], its Cholesky factor, inverse
  and log-determinant are fixed buffers, computed once in fp64 and stored
  in fp32;
- the structured posterior: the per-frame encoder emits 3L values (mean,
  precision diagonal, precision superdiagonal, the last two through
  softplus); the precision's Cholesky factor P is upper bidiagonal (the
  diagonal plus one, and the superdiagonal), and the posterior's covariance
  factor P^{-1} comes from a back substitution over the T rows (fp32,
  deterministic, no jitter);
- the explicit KL between N(mu, (P P^T)^{-1}) and N(0, K), summed over the
  latent dimensions; the masked reconstruction loss summed over visits;
- :meth:`GPVAE.generate`, GP-prior trajectories decoded.

The model launches no kernel of its own, as JAX's runs no Pallas kernel.
``noise``: ``eps`` [B, L, T] for ``forward``, [n, L, T] for ``generate``;
otherwise drawn from ``generator``.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rlvae_tpu_torch.models.research.lvae_iaf import Noise, _normal
from rlvae_tpu_torch.models.research.vamp import masked_recon_loss
from rlvae_tpu_torch.nets.layers import init_net
from rlvae_tpu_torch.nets.registry import create_decoder, create_encoder
from rlvae_tpu_torch.utils.output import ModelOutput

KERNELS = ("cauchy", "rbf", "diffusion", "matern")


def gp_kernel(kind: str, t: int, length_scale: float, sigma: float = 1.0) -> np.ndarray:
    """The [T, T] time kernel of ``kind`` at times 1..T, in fp32."""
    xs = np.arange(1, t + 1, dtype=np.float64)
    d2 = (xs[None, :] - xs[:, None]) ** 2
    if kind == "cauchy":
        k = sigma / (d2 / length_scale ** 2 + 1.0) + 1e-3 * np.eye(t)
    elif kind == "rbf":
        k = np.exp(-d2 / length_scale ** 2)
    elif kind == "diffusion":
        if not length_scale < 0.5:
            raise ValueError("length_scale must be < 0.5 for diagonal dominance")
        tri = np.triu(np.ones((t, t)), -1)
        k = (tri * tri.T) * length_scale + np.eye(t) * (1.0 - length_scale)
    elif kind == "matern":
        k = np.exp(-np.abs(xs[None, :] - xs[:, None]) / math.sqrt(length_scale))
    else:
        raise ValueError(f"kernel must be one of {KERNELS}")
    return k.astype(np.float32)


def upper_bidiagonal_inverse(diag: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """P^{-1} [..., T, T] of the upper-bidiagonal P with ``diag`` [..., T] on
    its diagonal and ``off`` [..., T-1] above it, by back substitution over
    the rows: row i of P^{-1} is (e_i - off_i * row i+1) / diag_i."""
    t = diag.shape[-1]
    eye = torch.eye(t, dtype=diag.dtype, device=diag.device)
    rows = [None] * t
    rows[t - 1] = eye[t - 1] / diag[..., t - 1, None]
    for i in range(t - 2, -1, -1):
        rows[i] = (eye[i] - off[..., i, None] * rows[i + 1]) / diag[..., i, None]
    return torch.stack(rows, dim=-2)


class GPVAE(nn.Module):
    def __init__(
        self,
        input_dim: Tuple[int, ...] = (3, 64, 64),
        latent_dim: int = 16,
        time_length: int = 8,
        kernel_choice: str = "cauchy",
        kernel_scales: int = 1,
        length_scale: float = 1.0,
        sigma: float = 1.0,
        beta: float = 1.0,
        reconstruction_loss: str = "mse",
        encoder_config: Optional[Mapping[str, Any]] = None,
        decoder_config: Optional[Mapping[str, Any]] = None,
        seed: int = 0,
    ):
        super().__init__()
        if kernel_choice not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}")
        self.input_dim = tuple(input_dim)
        self.latent_dim = latent_dim
        self.time_length = time_length
        self.beta = float(beta)
        self.reconstruction_loss = reconstruction_loss
        generator = torch.Generator().manual_seed(seed)
        # the per-frame encoder emits (mu, precision diagonal, superdiagonal) per latent
        self.encoder = create_encoder(self.input_dim, 3 * latent_dim, encoder_config)
        self.decoder = create_decoder(self.input_dim, latent_dim, decoder_config)
        for net in (self.encoder, self.decoder):
            init_net(net, generator)

        # the kernels tiled over the latent dimensions, one length scale per share
        mats, total = [], 0
        for i in range(kernel_scales):
            k = gp_kernel(kernel_choice, time_length, length_scale / 2 ** i, sigma)
            if i == kernel_scales - 1:
                mult = latent_dim - total
            else:
                mult = int(np.ceil(latent_dim / kernel_scales))
                total += mult
            mats.append(np.tile(k[None], (mult, 1, 1)))
        cov = np.concatenate(mats).astype(np.float64)  # [L, T, T]
        for name, value in (("prior_cov", cov), ("prior_chol", np.linalg.cholesky(cov)),
                            ("prior_cov_inv", np.linalg.inv(cov)),
                            ("prior_logdet", np.linalg.slogdet(cov)[1])):
            self.register_buffer(name, torch.tensor(value, dtype=torch.float32),
                                 persistent=False)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # -- structured posterior ---------------------------------------------------------

    def posterior(self, x_flat: torch.Tensor, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu [B, L, T], inv_p [B, L, T, T]): the posterior's covariance is
        inv_p inv_p^T."""
        t, l = self.time_length, self.latent_dim
        enc = self.encoder(x_flat)
        mu = enc["embedding"][:, :l].reshape(b, t, l).transpose(1, 2)
        diag = F.softplus(enc["embedding"][:, l:2 * l]).reshape(b, t, l)
        off = F.softplus(enc["log_covariance"][:, :l]).reshape(b, t, l)
        return mu, self.posterior_from_stats(diag, off)

    @staticmethod
    def posterior_from_stats(diag: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
        """inv_p [B, L, T, T] from the per-frame precision statistics [B, T, L]
        (after softplus): P = diag + I on the diagonal, the first T-1
        superdiagonal entries above it."""
        return upper_bidiagonal_inverse(diag.transpose(1, 2) + 1.0,
                                        off.transpose(1, 2)[..., :-1])

    def kl_to_prior(self, mu: torch.Tensor, inv_p: torch.Tensor) -> torch.Tensor:
        """KL(N(mu, inv_p inv_p^T) || N(0, K)) summed over the latent dims, [B]."""
        t = mu.shape[-1]
        inv_pt = inv_p.transpose(-1, -2)
        cov_q = torch.einsum("bltu,blvu->bltv", inv_pt, inv_pt)
        k_inv = self.prior_cov_inv[None].expand(cov_q.shape)
        trace = torch.einsum("bltu,blut->bl", k_inv, cov_q)
        quad = torch.einsum("blt,bltu,blu->bl", mu, k_inv, mu)
        logdet_q = 2.0 * torch.log(torch.diagonal(inv_p, dim1=-2, dim2=-1).abs()).sum(-1)
        kl = 0.5 * (trace + quad - t + self.prior_logdet[None] - logdet_q)
        return kl.sum(-1)

    # -- forward ------------------------------------------------------------------------

    def forward(self, x: torch.Tensor, noise: Noise = None, vi_index: Optional[int] = None,
                epoch: int = 100, train: bool = False, seq_mask: Optional[torch.Tensor] = None,
                pix_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> ModelOutput:
        """x: [B, T, C, H, W] with T = time_length.  ``vi_index`` and
        ``epoch`` are unused: every research model takes the same call."""
        b, t = x.shape[0], x.shape[1]
        if t != self.time_length:
            raise ValueError(f"GPVAE: {t} frames, time_length is {self.time_length}")
        seq_mask = torch.ones((b, t), dtype=x.dtype, device=x.device) if seq_mask is None \
            else seq_mask
        pix_mask = torch.ones_like(x) if pix_mask is None else pix_mask
        x = x * pix_mask * seq_mask[:, :, None, None, None]
        x_flat = x.reshape(b * t, *self.input_dim)
        mu, inv_p = self.posterior(x_flat, b)
        eps = _normal(noise, "eps", mu.shape, generator, mu.device)
        z = mu + torch.einsum("bltu,blu->blt", inv_p.transpose(-1, -2), eps)
        recon = self.decoder(z.transpose(1, 2).reshape(b * t, self.latent_dim))["reconstruction"]
        per_frame = masked_recon_loss(recon, x_flat, pix_mask.reshape(b * t, *self.input_dim),
                                      self.reconstruction_loss)
        recon_loss = (per_frame.reshape(b, t) * seq_mask).sum(-1)
        kld = self.kl_to_prior(mu, inv_p)
        loss = recon_loss.mean() + self.beta * kld.mean()
        # mmd_loss: the reference fork's name for its KL term
        return ModelOutput(loss=loss, recon_loss=recon_loss.mean(), mmd_loss=kld.mean(),
                           recon_x=recon.reshape(x.shape), z=z)

    # -- generation ------------------------------------------------------------------------

    def generate(self, n: int, noise: Noise = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """GP-prior trajectories (``noise["eps"]`` [n, L, T]) decoded:
        [n, T, C, H, W]."""
        t, l = self.time_length, self.latent_dim
        eps = _normal(noise, "eps", (n, l, t), generator, self.device)
        z = torch.einsum("ltu,blu->blt", self.prior_chol, eps)
        recon = self.decoder(z.transpose(1, 2).reshape(n * t, l))["reconstruction"]
        return recon.reshape(n, t, *self.input_dim)
