"""Centroid-based Riemannian metric.

Port of ``rlvae_tpu/geometry/metric.py``:

    G^{-1}(z) = sum_k M_k * exp(-||z - c_k||^2 / T^2) + lbd * I

with centroids ``c_k`` [K, D], SPD matrices ``M_k`` [K, D, D], temperature
``T`` and regularization ``lbd``.  The squared distances are direct
differences in fp32 (never the expanded quadratic form: the exponent is
scaled by 1/T^2, which amplifies cancellation error).  The jitter is
deterministic, added to the diagonal before factorization.

``chol_g_inv`` and ``logdet_g_inv`` run the chol-bundle CUDA kernel for
tensors on the card and its plain PyTorch version for tensors on the CPU,
through the autograd Functions
:class:`~rlvae_tpu_torch.ops.metric_kernels.CholBundle` and
:class:`~rlvae_tpu_torch.ops.metric_kernels.CholBundleLogdet`, so both are
differentiable in ``z`` on either device.  ``g``, ``log_sqrt_det_g_inv`` and
``grad_log_sqrt_det_g_inv`` are the plain versions of the HMC chain's terms;
the chain itself calls the fused ``hmc_terms`` kernel
(:mod:`rlvae_tpu_torch.ops.metric_kernels`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rlvae_tpu_torch.ops import linalg as _lin
from rlvae_tpu_torch.ops import metric_kernels as _mk


@dataclass
class CentroidMetric:
    """Metric parameters; the scalars are Python floats (no device sync)."""

    centroids: torch.Tensor  # [K, D] fp32
    matrices: torch.Tensor  # [K, D, D] fp32, SPD
    temperature: float
    regularization: float

    @classmethod
    def create(cls, centroids, matrices, temperature: float = 0.1,
               regularization: float = 0.01) -> "CentroidMetric":
        centroids = torch.tensor(np.asarray(centroids, np.float32))
        matrices = torch.tensor(np.asarray(matrices, np.float32))
        if centroids.dim() != 2 or matrices.shape != (*centroids.shape, centroids.shape[1]):
            raise ValueError(
                f"Inconsistent metric shapes: centroids {tuple(centroids.shape)}, "
                f"matrices {tuple(matrices.shape)}"
            )
        return cls(centroids.contiguous(), matrices.contiguous(),
                   float(temperature), float(regularization))

    @property
    def n_centroids(self) -> int:
        return int(self.centroids.shape[0])


def weights(metric: CentroidMetric, z: torch.Tensor) -> torch.Tensor:
    """w_k(z) = exp(-||z - c_k||^2 / T^2), shape [B, K], d^2 as direct differences."""
    diff = z.float()[:, None, :] - metric.centroids[None, :, :]  # [B, K, D]
    d2 = (diff * diff).sum(-1)
    return torch.exp(-d2 / (metric.temperature ** 2))


def g_inv(metric: CentroidMetric, z: torch.Tensor) -> torch.Tensor:
    """Inverse metric G^{-1}(z), shape [B, D, D]: one [B, K] @ [K, D*D] product."""
    k, d = metric.centroids.shape
    w = weights(metric, z)
    gi = (w @ metric.matrices.reshape(k, d * d)).reshape(-1, d, d)
    return gi + metric.regularization * torch.eye(d, dtype=gi.dtype, device=gi.device)


def chol_g_inv(metric: CentroidMetric, z: torch.Tensor, jitter: float = 1e-6) -> torch.Tensor:
    """L with L L^T = G^{-1}(z) + jitter*I, from the chol-bundle kernel
    (its plain version for CPU tensors); differentiable in ``z``."""
    return _mk.CholBundle.apply(
        z, metric.centroids, metric.matrices,
        1.0 / metric.temperature ** 2, metric.regularization + jitter,
    )


def logdet_g_inv(metric: CentroidMetric, z: torch.Tensor) -> torch.Tensor:
    """log det G^{-1}(z), shape [B]: the bundle's logdet output (jitter 0),
    from one chol-bundle launch; differentiable in ``z``."""
    return _mk.CholBundleLogdet.apply(
        z, metric.centroids, metric.matrices,
        1.0 / metric.temperature ** 2, metric.regularization,
    )


def g(metric: CentroidMetric, z: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Metric tensor G(z) = [G^{-1}(z)]^{-1}, shape [B, D, D], by unrolled
    Cholesky solves (the plain path, ``_g_xla`` of the JAX package)."""
    return _lin.inv_psd_small(g_inv(metric, z), jitter=jitter)


def log_sqrt_det_g_inv(metric: CentroidMetric, z: torch.Tensor,
                       eps: float = 1e-10) -> torch.Tensor:
    """log(sqrt(det G^{-1}(z)) + eps), the HMC target, as
    logaddexp(1/2 logdet, log eps); ``eps=0`` gives the pure log-density.
    The guard is the reference sampler's: far from the centroids det G^{-1}
    is ~lbd^D and the target sits on the log(eps) plateau."""
    half_ld = 0.5 * logdet_g_inv(metric, z)
    if eps == 0.0:
        return half_ld
    return torch.logaddexp(half_ld, half_ld.new_tensor(float(np.log(np.float32(eps)))))


def grad_log_sqrt_det_g_inv(metric: CentroidMetric, z: torch.Tensor) -> torch.Tensor:
    """The reference sampler's closed-form gradient of log sqrt det G^{-1}(z),
    shape [B, D]: -1/2 G^T v with v_j = (-2/T^2) sum_k w_k sum_i
    (c_k - z)_i M_k[i, j].  It is not the exact gradient (that has
    tr(G M_k)(c_k - z) in place of G M_k^T (c_k - z)); it is reproduced, not
    fixed.  It is the gradient output of the HMC terms' plain version."""
    return _mk.hmc_terms_ref(z, metric.centroids, metric.matrices, 1.0 / metric.temperature ** 2,
                             metric.regularization, float(np.log(np.float32(1e-10))))[1]

