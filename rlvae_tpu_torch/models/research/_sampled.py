"""The sampled Mahalanobis observation metric and the k-medoids it is built
on: the port's own copy of ``SampledMetric`` and ``_kmedoids``
(``rlvae_tpu/models/research/lldm.py:246-298``), which ``LVAE_GUGUS``'s
``lvaegg`` local-metric estimation builds (the LLDM model itself is not
ported).

Every component of the metric is diagonal, so G(z) is diagonal and its
determinant a product: two [B, D] x [D, K] products and elementwise ops.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class SampledMetric:
    """G(z) = sum_k m_k exp(-(z - c_k)^T diag(m_k) (z - c_k) / T^2) + lbd,
    diagonal, from centroids ``c`` [K, D] and diagonal weights ``m`` [K, D]."""

    def __init__(self, centroids, m_flat, temperature: float, regularization: float = 0.01):
        self.centroids = torch.as_tensor(np.asarray(centroids, np.float32))
        self.m_flat = torch.as_tensor(np.asarray(m_flat, np.float32))
        self.temperature = float(temperature)
        self.lbd = float(regularization)
        # constant term of the Mahalanobis expansion: sum_d m_kd c_kd^2
        self._c2 = (self.m_flat * self.centroids ** 2).sum(-1)  # [K]

    def g_diag(self, z: torch.Tensor) -> torch.Tensor:
        """The diagonal of G(z), [B, D]."""
        z2 = (z ** 2) @ self.m_flat.T
        zc = z @ (self.m_flat * self.centroids).T
        d2 = z2 - 2.0 * zc + self._c2[None, :]
        omega = torch.exp(-d2 / self.temperature ** 2)  # [B, K]
        return omega @ self.m_flat + self.lbd

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
