"""RHVAE metric pre-training: regenerating ``metric.npz`` from scratch.

Port of ``rlvae_tpu/geometry/pretrain.py`` (the pythae RHVAE training path
that produced the reference's metric artifacts):

- a metric network maps each image to a Cholesky factor L (flatten -> 400
  -> ReLU -> {exp-diagonal, strict-lower} assembly, the strict lower
  triangle in ``tril_indices(d, -1)`` row-major order, so the ``lower``
  weights carry across);
- the training forward integrates Riemannian Hamiltonian dynamics with the
  generalized leapfrog: implicit momentum steps by fixed-point iterations
  over the gradient in z of H = -log p(x, z) + 1/2 rho^T G^{-1} rho + 1/2 log
  det G, where G^{-1} is the batch-local metric of the encoder's mu and the
  metric net's L L^T.  Each gradient is ``torch.autograd.grad`` with
  ``create_graph=True``, so the loss differentiates through it (JAX:
  ``jax.grad`` of the Hamiltonian);
- G^{-1} is ``gm.g_inv``: the G^{-1} kernel on the card (16 launches per
  forward at the defaults), whose VJP gives the cotangents of the bank (mu
  and L L^T) and is itself differentiable;
- per-batch (L L^T, mu) pairs go to a ring buffer of 100 batches and
  consolidate into the centroid metric;
- the loss is -(log p(x, z_K) + log p(rho_K) - log q(z_0 | x)).

The quirks are kept: ``beta_zero_sqrt`` holds beta_zero itself; step 2 of
the integrator uses the stale metric (its fixed point is the explicit z +
eps G^{-1}(z_old) rho); the tempering.  The noise of a forward (``eps0``,
then ``gamma``, each [B, D]) is passed in (:meth:`RHVAE.draw_noise` draws it
from a generator), so tests can feed JAX's draws.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from rlvae_tpu_torch.geometry import metric as gm
from rlvae_tpu_torch.geometry.metric import CentroidMetric
from rlvae_tpu_torch.nets import create_decoder, create_encoder
from rlvae_tpu_torch.ops import linalg as _lin
from rlvae_tpu_torch.train.optim import make_optimizer

Noise = Mapping[str, torch.Tensor]


class MetricMLP(nn.Module):
    """x -> lower-triangular Cholesky factor L [B, D, D] (fp32)."""

    def __init__(self, input_dim: Tuple[int, ...], latent_dim: int):
        super().__init__()
        d = latent_dim
        self.latent_dim = d
        self.hidden = nn.Linear(int(np.prod(input_dim)), 400)
        self.diag = nn.Linear(400, d)
        self.lower = nn.Linear(400, d * (d - 1) // 2)
        rows, cols = np.tril_indices(d, k=-1)  # row-major, as jnp.tril_indices
        self.register_buffer("lower_index", torch.from_numpy(rows * d + cols), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d = x.shape[0], self.latent_dim
        h = torch.relu(self.hidden(x.reshape(b, -1).float()))
        l_flat = h.new_zeros((b, d * d)).index_copy(1, self.lower_index, self.lower(h))
        return l_flat.reshape(b, d, d) + torch.diag_embed(torch.exp(self.diag(h)))


def _batch_g_inv(z, centroids, m_mats, temperature: float, lbd: float) -> torch.Tensor:
    """The batch-local training metric's G^{-1}(z) from the batch's (mu, M)
    pairs, through the centroid metric's ``g_inv`` (the G^{-1} kernel on the
    card at D <= 32, its plain version past it, as JAX's ``g_inv`` routes),
    differentiable in z, the centroids and the matrices."""
    return gm.g_inv(CentroidMetric(centroids, m_mats, temperature, lbd), z)


def _quad(rho: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bi,bij,bj->b", rho, mat, rho)


class RHVAE(nn.Module):
    """Riemannian Hamiltonian VAE for metric learning."""

    def __init__(
        self,
        input_dim: Tuple[int, ...] = (3, 64, 64),
        latent_dim: int = 16,
        n_lf: int = 3,
        eps_lf: float = 1e-3,
        beta_zero: float = 0.3,
        temperature: float = 1.5,
        regularization: float = 0.01,
        fixed_point_steps: int = 3,
        encoder_config: Optional[Mapping[str, Any]] = None,
        decoder_config: Optional[Mapping[str, Any]] = None,
    ):
        super().__init__()
        self.input_dim = tuple(input_dim)
        self.latent_dim = latent_dim
        self.n_lf = n_lf
        self.eps_lf = eps_lf
        self.beta_zero_sqrt = beta_zero  # the pythae quirk: the "sqrt" holds beta_zero
        self.temperature = temperature
        self.lbd = regularization
        self.fixed_point_steps = fixed_point_steps

        self.encoder = create_encoder(self.input_dim, latent_dim, encoder_config)
        self.decoder = create_decoder(self.input_dim, latent_dim, decoder_config)
        self.metric_net = MetricMLP(self.input_dim, latent_dim)

        # host-side ring buffer of per-batch (M, mu), as a deque of maxlen 100
        self.buffer_m: list = []
        self.buffer_mu: list = []
        self.buffer_maxlen = 100

    def draw_noise(self, batch: int, generator: Optional[torch.Generator] = None,
                   device=None) -> Dict[str, torch.Tensor]:
        """A forward's draws, in JAX's order: ``eps0`` then ``gamma``, [B, D] each."""
        shape = (batch, self.latent_dim)
        return {"eps0": torch.randn(shape, generator=generator, device=device),
                "gamma": torch.randn(shape, generator=generator, device=device)}

    # -- physics --------------------------------------------------------------

    def _log_p_xz(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """log p(x|z) (unit-variance Gaussian decoder) + log N(z; 0, I)."""
        b = z.shape[0]
        recon = self.decoder(z)["reconstruction"]
        logpx = -0.5 * ((recon.reshape(b, -1) - x.reshape(b, -1)) ** 2).sum(-1)
        logpz = -0.5 * (z ** 2).sum(-1) - 0.5 * self.latent_dim * math.log(2 * math.pi)
        return logpx + logpz

    def _hamiltonian(self, x, z, rho, centroids, m_mats) -> torch.Tensor:
        gi = _batch_g_inv(z, centroids, m_mats, self.temperature, self.lbd)
        g_log_det = -_lin.logdet_from_chol(_lin.cholesky_small(gi))
        return (-self._log_p_xz(x, z) + 0.5 * _quad(rho, gi) + 0.5 * g_log_det).sum()

    def _grad_z(self, x, z, rho, centroids, m_mats) -> torch.Tensor:
        """The partial dH/dz at (z, rho), itself differentiable
        (``create_graph=True``).  z enters as an alias of its own, so the
        paths through rho (computed from z by earlier steps) and the bank
        (computed from mu, as z) are held fixed, as ``jax.grad(ham,
        argnums=0)`` holds them."""
        with torch.enable_grad():
            zz = z.view_as(z) if z.requires_grad else z.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(self._hamiltonian(x, zz, rho, centroids, m_mats), zz,
                                          create_graph=True)
        return grad

    def forward(self, x: torch.Tensor, noise: Noise) -> Dict[str, torch.Tensor]:
        """Training forward on frames x [B, C, H, W]: encode, metric net,
        generalized leapfrog, loss."""
        enc = self.encoder(x)
        mu, log_var = enc["embedding"], enc["log_covariance"]
        eps0 = noise["eps0"].to(device=mu.device, dtype=torch.float32)
        z0 = mu + eps0 * torch.exp(0.5 * log_var)

        l_mat = self.metric_net(x)
        m_mats = l_mat @ l_mat.transpose(-1, -2)
        centroids = mu  # the batch-local metric is centered on mu(x_i)

        def grad_z(z, rho_):
            return self._grad_z(x, z, rho_, centroids, m_mats)

        gamma = noise["gamma"].to(device=mu.device, dtype=torch.float32)
        rho = gamma / self.beta_zero_sqrt
        rho = torch.einsum("bij,bj->bi", l_mat, rho)  # rho ~ N(0, G) through the net's L

        z = z0
        beta_sqrt_old = self.beta_zero_sqrt
        eps = self.eps_lf
        for k in range(self.n_lf):
            # step 1: the implicit momentum half-step by fixed-point iterations
            rho_ = rho
            for _ in range(self.fixed_point_steps):
                rho_ = rho - 0.5 * eps * grad_z(z, rho_)
            # step 2: the stale-metric fixed point is explicit (module docstring)
            gi_old = _batch_g_inv(z, centroids, m_mats, self.temperature, self.lbd)
            z = z + eps * torch.einsum("bij,bj->bi", gi_old, rho_)
            # step 3: the explicit momentum half-step at the new position
            rho = rho_ - 0.5 * eps * grad_z(z, rho_)
            # tempering
            beta_sqrt = 1.0 / (
                (1.0 - 1.0 / self.beta_zero_sqrt) * ((k + 1) / self.n_lf) ** 2
                + 1.0 / self.beta_zero_sqrt
            )
            rho = (beta_sqrt_old / beta_sqrt) * rho
            beta_sqrt_old = beta_sqrt

        # loss: -(log p(x, z_K) + log p(rho_K) - log q(z_0|x))
        gi_k = _batch_g_inv(z, centroids, m_mats, self.temperature, self.lbd)
        g_log_det_k = -_lin.logdet_from_chol(_lin.cholesky_small(gi_k))
        logpxz = self._log_p_xz(x, z)
        log_rho_k = -0.5 * _quad(rho, gi_k) - 0.5 * g_log_det_k
        logq = (-0.5 * (eps0 ** 2).sum(-1) - 0.5 * self.latent_dim * math.log(2 * math.pi)
                - 0.5 * log_var.sum(-1))
        loss = -(logpxz + log_rho_k - logq).mean()
        recon = self.decoder(z)["reconstruction"]
        return {"loss": loss, "z0": z0, "z": z, "rho": rho, "mu": mu, "log_var": log_var,
                "m_mats": m_mats, "recon_x": recon}

    # -- metric consolidation -------------------------------------------------

    def record_batch(self, m_mats: np.ndarray, mu: np.ndarray) -> None:
        self.buffer_m.append(np.asarray(m_mats))
        self.buffer_mu.append(np.asarray(mu))
        if len(self.buffer_m) > self.buffer_maxlen:
            self.buffer_m.pop(0)
            self.buffer_mu.pop(0)

    def consolidate_metric(self) -> CentroidMetric:
        """The ring buffer concatenated into the centroid metric (on the CPU)."""
        if not self.buffer_m:
            raise RuntimeError("No batches recorded; train before consolidating")
        m_tens = np.concatenate(self.buffer_m, axis=0)
        centroids = np.concatenate(self.buffer_mu, axis=0)
        return CentroidMetric.create(centroids, m_tens, self.temperature, self.lbd)


def train_metric(
    rhvae: RHVAE,
    data: np.ndarray,
    n_epochs: int = 10,
    batch_size: int = 32,
    learning_rate: float = 1e-3,
    seed: int = 42,
    log_every: int = 0,
    warm_start: Optional[Mapping[str, Mapping[str, torch.Tensor]]] = None,
    noise: Optional[Sequence[Noise]] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[CentroidMetric, Dict[str, Any]]:
    """Train the RHVAE (on its parameters' device) on frames [N, C, H, W]
    and return the consolidated metric with ``{"params", "loss_history"}``.

    ``warm_start`` maps ``encoder``/``decoder`` to state dicts loaded before
    the optimizer is made (the VAE whose latents the centroids should share).
    Adam at ``learning_rate``; each epoch takes ``default_rng(seed + epoch)``'s
    permutation, whole batches only.  The forward's draws are ``noise[i]``
    for the i-th step, else :meth:`RHVAE.draw_noise` from ``generator`` (by
    default one on the device seeded ``seed``)."""
    device = next(rhvae.parameters()).device
    for name, state in (warm_start or {}).items():
        if name in ("encoder", "decoder"):
            getattr(rhvae, name).load_state_dict(state)
    optimizer = make_optimizer(rhvae.parameters(), learning_rate)
    if noise is None and generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)

    n = (data.shape[0] // batch_size) * batch_size
    history, step = [], 0
    for epoch in range(n_epochs):
        perm = np.random.default_rng(seed + epoch).permutation(data.shape[0])[:n]
        epoch_loss = []
        for b in range(n // batch_size):
            batch = torch.from_numpy(np.ascontiguousarray(
                data[perm[b * batch_size:(b + 1) * batch_size]], np.float32)).to(device)
            draws = noise[step] if noise is not None else rhvae.draw_noise(
                batch_size, generator, device)
            out = rhvae(batch, draws)
            optimizer.zero_grad(set_to_none=True)
            out["loss"].backward()
            optimizer.step()
            rhvae.record_batch(out["m_mats"].detach().cpu().numpy(),
                               out["mu"].detach().cpu().numpy())
            epoch_loss.append(float(out["loss"].detach()))
            step += 1
        history.append(float(np.mean(epoch_loss)))
        if log_every and epoch % log_every == 0:
            print(f"[rhvae] epoch {epoch}: loss {history[-1]:.3f}")

    params = {k: v.detach().clone() for k, v in rhvae.state_dict().items()}
    return rhvae.consolidate_metric(), {"params": params, "loss_history": history}
