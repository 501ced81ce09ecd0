"""Posterior sampling: plain reparameterisation and the metric-aware posterior.

Port of ``reparam`` and ``sample_metric_aware_posterior``
(``rlvae_tpu/samplers/riemannian.py:58-176``).  The noise ε may be passed
in: JAX draws it from its own key, and the tests hand both sides the same
numbers.  Without ε, it is drawn from ``generator`` on z's device.
"""

from __future__ import annotations

from typing import Optional

import torch

from rlvae_tpu_torch.geometry import metric as gm
from rlvae_tpu_torch.geometry.metric import CentroidMetric


def _noise(mu: torch.Tensor, eps: Optional[torch.Tensor],
           generator: Optional[torch.Generator]) -> torch.Tensor:
    if eps is None:
        return torch.randn(mu.shape, generator=generator, dtype=mu.dtype, device=mu.device)
    if eps.shape != mu.shape:
        raise ValueError(f"eps shape {tuple(eps.shape)} != mu shape {tuple(mu.shape)}")
    return eps.to(device=mu.device, dtype=mu.dtype)


def reparam(mu: torch.Tensor, log_var: torch.Tensor, eps: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return mu + _noise(mu, eps, generator) * torch.exp(0.5 * log_var)


def sample_metric_aware_posterior(
    metric: CentroidMetric, mu: torch.Tensor, log_var: torch.Tensor,
    eps: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The 'riemannian_metric' posterior: z0 = mu + chol(G^{-1}(mu) + 1e-6 I) ε."""
    l = gm.chol_g_inv(metric, mu, jitter=1e-6)
    return mu + torch.einsum("bij,bj->bi", l, _noise(mu, eps, generator))
