"""Centroid-based Riemannian metric.

Port of ``rlvae_tpu/geometry/metric.py``:

    G^{-1}(z) = sum_k M_k * exp(-||z - c_k||^2 / T^2) + lbd * I

with centroids ``c_k`` [K, D], SPD matrices ``M_k`` [K, D, D], temperature
``T`` and regularization ``lbd``.  The squared distances are direct
differences in fp32 (never the expanded quadratic form: the exponent is
scaled by 1/T^2, which amplifies cancellation error).  The jitter is
deterministic, added to the diagonal before factorization.

Each function runs a CUDA kernel for tensors on the card and its plain
PyTorch version for tensors on the CPU, through an autograd Function of
:mod:`rlvae_tpu_torch.ops.metric_kernels`, so each is differentiable in
``z``, and in the bank where its tensors require grad, on either device:

- ``chol_g_inv`` and ``logdet_g_inv``: the chol-bundle (``CholBundle``,
  ``CholBundleLogdet``);
- ``g_inv``: the G^{-1} kernel (``GInv``);
- ``g``: the metric bundle (``MetricBundleG``) when ``jitter == 0`` and ``z``
  is [B, D], as the JAX package's ``g`` dispatches to its fused kernel;
  otherwise G^{-1} and unrolled Cholesky solves;
- ``g_inv_and_g``: G^{-1} and G of one metric-bundle launch
  (``MetricBundleGInvG``), for the Christoffel symbols.

``chol_g``, ``logdet_g``, ``dist2`` and ``diagnostics`` read G through those.
The kernels read the bank at their compiled width: the metric pads it once
(:meth:`CentroidMetric.kernel_bank`) and hands the padded pair down.  Past
the kernels' envelope (D > 32, ``metric_kernels.fused_supported``) every
function takes its plain version (``ops._launch.plain_route``),
differentiable by autograd, as the JAX package takes its XLA path.
``log_sqrt_det_g_inv`` (from ``logdet_g_inv``) and ``grad_log_sqrt_det_g_inv``
(the gradient output of ``hmc_terms``, not differentiable) are the HMC
chain's terms one at a time; the chain itself calls the fused ``hmc_terms``
kernel for both.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from rlvae_tpu_torch.ops import linalg as _lin
from rlvae_tpu_torch.ops import metric_kernels as _mk
from rlvae_tpu_torch.ops._launch import plain_route


@dataclass
class CentroidMetric:
    """Metric parameters; the scalars are Python floats (no device sync)."""

    centroids: torch.Tensor  # [K, D] fp32
    matrices: torch.Tensor  # [K, D, D] fp32, SPD
    temperature: float
    regularization: float
    # kernel_bank's padded pair: (centroids, matrices, their versions, (c, M))
    _padded: Optional[tuple] = field(default=None, init=False, repr=False, compare=False)

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

    @classmethod
    def identity(cls, latent_dim: int, n_centroids: int = 1, temperature: float = 0.1,
                 regularization: float = 0.01,
                 generator: Optional[torch.Generator] = None) -> "CentroidMetric":
        """Identity metric matrices at zero centroids, or at standard-normal
        ones drawn from ``generator`` (JAX's ``key``)."""
        if generator is None:
            centroids = torch.zeros((n_centroids, latent_dim))
        else:
            centroids = torch.randn((n_centroids, latent_dim), generator=generator,
                                    device=generator.device)
        matrices = torch.eye(latent_dim).expand(n_centroids, latent_dim, latent_dim)
        return cls(centroids.float().contiguous(),
                   matrices.to(centroids.device).contiguous(),
                   float(temperature), float(regularization))

    @property
    def n_centroids(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def latent_dim(self) -> int:
        return int(self.centroids.shape[1])

    def to(self, device) -> "CentroidMetric":
        """The same metric with its bank on ``device``."""
        return CentroidMetric(self.centroids.to(device), self.matrices.to(device),
                              self.temperature, self.regularization)

    def kernel_bank(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(c, M) as the kernels read them: the bank zero-padded to its
        compiled width (``metric_kernels.bank_width``), padded once and kept
        while ``centroids`` and ``matrices`` are the same tensors at the same
        versions (an in-place update, an optimizer step, re-pads; inference
        tensors keep no version and are matched by identity).  The bank
        itself on the CPU, at a compiled width, past the kernels' envelope,
        and while a program is exported (its registered ops pad per launch)."""
        c, m, d = self.centroids, self.matrices, self.latent_dim
        if (c.device.type == "cpu" or not _mk.fused_supported(d) or d == _mk.bank_width(d)
                or torch.compiler.is_exporting()):
            return c, m
        versions = tuple(None if t.is_inference() else t._version for t in (c, m))
        hit = self._padded
        if hit is None or hit[0] is not c or hit[1] is not m or hit[2] != versions:
            hit = self._padded = (c, m, versions, _mk.pad_bank(c, m, _mk.bank_width(d)))
        return hit[3]

    # Method views over the functional API, as the JAX package's ----------
    def weights(self, z: torch.Tensor) -> torch.Tensor:
        return weights(self, z)

    def g_inv(self, z: torch.Tensor) -> torch.Tensor:
        return g_inv(self, z)

    def g(self, z: torch.Tensor) -> torch.Tensor:
        return g(self, z)

    def chol_g_inv(self, z: torch.Tensor, jitter: float = 1e-6) -> torch.Tensor:
        return chol_g_inv(self, z, jitter)

    def logdet_g(self, z: torch.Tensor) -> torch.Tensor:
        return logdet_g(self, z)

    def log_sqrt_det_g_inv(self, z: torch.Tensor) -> torch.Tensor:
        return log_sqrt_det_g_inv(self, z)

    def grad_log_sqrt_det_g_inv(self, z: torch.Tensor) -> torch.Tensor:
        return grad_log_sqrt_det_g_inv(self, z)

    def dist2(self, z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
        return dist2(self, z1, z2)

    def diagnostics(self, z: torch.Tensor) -> Dict[str, Any]:
        return diagnostics(self, z)


def weights(metric: CentroidMetric, z: torch.Tensor) -> torch.Tensor:
    """w_k(z) = exp(-||z - c_k||^2 / T^2), shape [B, K], d^2 as direct differences."""
    diff = z.float()[:, None, :] - metric.centroids[None, :, :]  # [B, K, D]
    d2 = (diff * diff).sum(-1)
    return torch.exp(-d2 / (metric.temperature ** 2))


def _bank(metric: CentroidMetric):
    """The kernels' bank arguments: (centroids, matrices, 1/T^2, lbd)."""
    return (metric.centroids, metric.matrices, 1.0 / metric.temperature ** 2,
            metric.regularization)


def _rows(z: torch.Tensor) -> torch.Tensor:
    """z as the kernels take it: fp32 and contiguous (a slice such as
    ``z_seq[:, 0]`` is not)."""
    return z.float().contiguous()


def g_inv(metric: CentroidMetric, z: torch.Tensor) -> torch.Tensor:
    """Inverse metric G^{-1}(z), shape [B, D, D], from the G^{-1} kernel (its
    plain version, one [B, K] @ [K, D*D] product, for CPU tensors)."""
    if not _mk.fused_supported(metric.latent_dim):
        return plain_route(_mk.g_inv_ref, _rows(z), *_bank(metric))
    return _mk.GInv.apply(_rows(z), *_bank(metric), metric.kernel_bank())


def chol_g_inv(metric: CentroidMetric, z: torch.Tensor, jitter: float = 1e-6) -> torch.Tensor:
    """L with L L^T = G^{-1}(z) + jitter*I, from the chol-bundle kernel
    (its plain version for CPU tensors); differentiable."""
    args = (_rows(z), metric.centroids, metric.matrices,
            1.0 / metric.temperature ** 2, metric.regularization + jitter)
    if not _mk.fused_supported(metric.latent_dim):
        return plain_route(_mk.chol_bundle_ref, *args)[0]
    return _mk.CholBundle.apply(*args, metric.kernel_bank())


def logdet_g_inv(metric: CentroidMetric, z: torch.Tensor) -> torch.Tensor:
    """log det G^{-1}(z), shape [B]: the bundle's logdet output (jitter 0),
    from one chol-bundle launch; differentiable."""
    args = (_rows(z), metric.centroids, metric.matrices,
            1.0 / metric.temperature ** 2, metric.regularization)
    if not _mk.fused_supported(metric.latent_dim):
        return plain_route(_mk.chol_bundle_ref, *args)[1]
    return _mk.CholBundleLogdet.apply(*args, metric.kernel_bank())


def g(metric: CentroidMetric, z: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Metric tensor G(z) = [G^{-1}(z)]^{-1}, shape [B, D, D]: the metric
    bundle's G when ``jitter == 0``, ``z`` is [B, D] and the kernels take D;
    otherwise unrolled Cholesky solves of G^{-1} + jitter I (``_g_xla`` of
    the JAX package)."""
    if jitter == 0.0 and z.dim() == 2 and _mk.fused_supported(metric.latent_dim):
        return _mk.MetricBundleG.apply(_rows(z), *_bank(metric), metric.kernel_bank())
    return _lin.inv_psd_small(g_inv(metric, z), jitter=jitter)


def g_inv_and_g(metric: CentroidMetric, z: torch.Tensor):
    """(G^{-1}(z), G(z)), each [B, D, D], from one metric-bundle launch
    (``MetricBundleGInvG``; the plain version for CPU tensors); differentiable."""
    if not _mk.fused_supported(metric.latent_dim):
        gi, _, _, gz = plain_route(_mk.metric_bundle_ref, _rows(z), *_bank(metric))
        return gi, gz
    return _mk.MetricBundleGInvG.apply(_rows(z), *_bank(metric), metric.kernel_bank())


def chol_g(metric: CentroidMetric, z: torch.Tensor, jitter: float = 1e-6) -> torch.Tensor:
    """L with L L^T = G(z) + jitter*I."""
    return _lin.cholesky_small(g(metric, z), jitter=jitter)


def logdet_g(metric: CentroidMetric, z: torch.Tensor) -> torch.Tensor:
    """log det G(z) = -log det G^{-1}(z), shape [B]."""
    return -logdet_g_inv(metric, z)


def quadratic_form(g_matrix: torch.Tensor, diff: torch.Tensor) -> torch.Tensor:
    """diff^T G diff for batched G [B, D, D], diff [B, D] -> [B]."""
    diff = diff.float()
    return torch.einsum("bi,bij,bj->b", diff, g_matrix, diff)


def dist2(metric: CentroidMetric, z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
    """Local squared Riemannian distance (z1-z2)^T G(mid) (z1-z2), mid the
    midpoint, shape [B]."""
    return quadratic_form(g(metric, 0.5 * (z1 + z2)), z1 - z2)


def diagnostics(metric: CentroidMetric, z: torch.Tensor) -> Dict[str, Any]:
    """Metric-geometry diagnostics with the JAX package's keys: eigenvalues
    of G and G^{-1} at the first row, mean determinants and traces over the
    batch, and the condition numbers derived from them.  One device->host
    transfer for every scalar."""
    gz, giz = g(metric, z), g_inv(metric, z)
    eig_g = torch.linalg.eigvalsh(gz[0])
    eig_gi = torch.linalg.eigvalsh(giz[0])
    names = ("eigenvals_G_min", "eigenvals_G_max", "eigenvals_G_mean",
             "eigenvals_G_inv_min", "eigenvals_G_inv_max", "eigenvals_G_inv_mean",
             "det_G_mean", "det_G_inv_mean", "trace_G_mean", "trace_G_inv_mean")
    logdet_gi = logdet_g_inv(metric, z)
    values = torch.stack([
        eig_g.min(), eig_g.max(), eig_g.mean(),
        eig_gi.min(), eig_gi.max(), eig_gi.mean(),
        torch.exp(-logdet_gi).mean(), torch.exp(logdet_gi).mean(),
        torch.diagonal(gz, dim1=-2, dim2=-1).sum(-1).mean(),
        torch.diagonal(giz, dim1=-2, dim2=-1).sum(-1).mean(),
    ]).tolist()
    out = dict(zip(names, values))
    out["temperature"] = float(np.float32(metric.temperature))
    out["regularization"] = float(np.float32(metric.regularization))
    out["condition_number_G"] = out["eigenvals_G_max"] / (out["eigenvals_G_min"] + 1e-8)
    out["condition_number_G_inv"] = out["eigenvals_G_inv_max"] / (
        out["eigenvals_G_inv_min"] + 1e-8
    )
    out["batch_size"] = int(z.shape[0])
    out["n_centroids"] = metric.n_centroids
    return out


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
    fixed.  It is the gradient output of :func:`~rlvae_tpu_torch.ops.metric_kernels.hmc_terms`:
    the HMC-terms kernel on the card, its plain version on the CPU."""
    if _mk.fused_supported(metric.latent_dim):
        terms, bank = _mk.hmc_terms, metric.kernel_bank()
    else:
        terms, bank = lambda *a: plain_route(_mk.hmc_terms_ref, *a), _bank(metric)[:2]
    return terms(_rows(z).detach(), *bank, 1.0 / metric.temperature ** 2,
                 metric.regularization, float(np.log(np.float32(1e-10))))[1]

