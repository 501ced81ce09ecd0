"""Posterior and prior sampling.

Port of ``reparam``, ``sample_posterior`` and ``sample_metric_aware_posterior``
(``rlvae_tpu/samplers/riemannian.py:58-176``) and of the prior methods of
``sample_prior`` (:184-296): ``geodesic`` (the default), ``geodesic_exact``
(the interpolation point on the energy-minimized geodesic between the
centroid pair: ``energy_path`` with 12 points and 80 Adam steps, one
metric-bundle launch each, then the metric noise through one G^{-1}
launch), ``centroid_aware``, ``weighted_mixture`` and ``basic``.

Posterior methods (``sampling.method`` of a Gaussian-posterior model):

    standard  plain reparameterization
    basic     0.1-scale chol(G^{-1}(z_std)) metric noise mix
    enhanced  metric noise at the virtual top-2-centroid point, 0.15 mix
    geodesic  a point on the segment between the two nearest centroids plus
              G-shaped noise (one metric-bundle launch for G)
    official  0.1-scale chol(G^{-1}(mu)) at the hardcoded T = 0.1
    hmc       posterior-tempered HMC from mu + ε σ, 20 x 5 leapfrog steps
              (:func:`~rlvae_tpu_torch.samplers.hmc.sample_posterior_hmc`:
              200 HMC-terms launches; no gradient on the card)

The posterior's noise is always passed in: JAX draws it from its own keys,
and the tests hand both sides the same numbers.  It is ε [B, D], for
``geodesic`` also t [B, 1] (uniform), and for ``hmc`` also the momenta
``gammas`` [20, B, D], drawn in that order by :func:`draw_posterior_noise`,
the one place that draws it.  A prior's
noise may be passed in too: a mapping with one entry per draw, in the order
:func:`draw_prior_noise` draws them from a ``torch.Generator`` when it is not
given:

    geodesic          i1 [n], i2 [n] (centroid indices), t [n, 1] (uniform),
                      eps [n, D] (standard normal)
    geodesic_exact    i1 [n], i2 [n], s [n] (uniform, before the scaling to
                      the path's n_points - 1 segments), eps [n, D]
    centroid_aware    idx [n], eps [n, D]
    weighted_mixture  idx [n] (categorical, p ~ exp(-|c|/2)), eps [n, D]
    basic             eps [n, D]
    (no metric)       eps [n, D]
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from rlvae_tpu_torch.geometry import metric as gm
from rlvae_tpu_torch.geometry.geodesics import energy_path
from rlvae_tpu_torch.geometry.metric import CentroidMetric
from rlvae_tpu_torch.ops import linalg as _lin
from rlvae_tpu_torch.samplers.hmc import draw_posterior_hmc_noise, sample_posterior_hmc

Noise = Mapping[str, torch.Tensor]


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


# ---------------------------------------------------------------------------
# Posterior sampling (Gaussian posterior, ``sampling.method``)
# ---------------------------------------------------------------------------

POSTERIOR_METHODS = ("standard", "basic", "enhanced", "geodesic", "official", "hmc")


POSTERIOR_HMC_STEPS = 20  # sample_posterior_hmc's n_steps as sample_posterior calls it


def _check_posterior_method(method: str) -> None:
    if method not in POSTERIOR_METHODS:
        raise ValueError(f"Unknown posterior sampling method: {method}")


def draw_posterior_noise(metric: Optional[CentroidMetric], method: str, batch: int,
                         latent_dim: int, generator: Optional[torch.Generator],
                         device=None) -> Dict[str, torch.Tensor]:
    """Every draw of posterior ``method`` for ``batch`` rows, in order: ε
    [B, D], then with a metric t [B, 1] for ``geodesic`` or ``gammas``
    [20, B, D] for ``hmc``."""
    if metric is not None:
        _check_posterior_method(method)
    if metric is not None and method == "hmc":
        return draw_posterior_hmc_noise(batch, latent_dim, POSTERIOR_HMC_STEPS, generator,
                                        device)
    noise = {"eps": torch.randn((batch, latent_dim), generator=generator, device=device)}
    if metric is not None and method == "geodesic":
        noise["t"] = torch.rand((batch, 1), generator=generator, device=device)
    return noise


def sample_posterior(metric: Optional[CentroidMetric], mu: torch.Tensor,
                     log_var: torch.Tensor, method: str, noise: Noise) -> torch.Tensor:
    """z0 [B, D] by posterior ``method``, from the draws in ``noise`` (those
    of :func:`draw_posterior_noise`)."""
    if metric is not None:
        _check_posterior_method(method)
    eps = _noise(mu, noise["eps"], None)
    if metric is None or method == "standard":
        return reparam(mu, log_var, eps)
    if method == "basic":
        return _posterior_basic(metric, mu, log_var, eps)
    if method == "enhanced":
        return _posterior_enhanced(metric, mu, log_var, eps)
    if method == "geodesic":
        return _posterior_geodesic(metric, mu, log_var, eps,
                                   noise["t"].to(device=mu.device, dtype=mu.dtype))
    if method == "hmc":
        return sample_posterior_hmc(metric, mu, log_var, eps, noise["gammas"])
    return _posterior_official(metric, mu, log_var, eps)


def _std(log_var: torch.Tensor) -> torch.Tensor:
    return torch.exp(0.5 * log_var)


def _posterior_basic(metric, mu, log_var, eps):
    z_std = mu + eps * _std(log_var)
    l = gm.chol_g_inv(metric, z_std, jitter=1e-6)
    eps_t = torch.einsum("bij,bj->bi", l, eps)
    scale = 0.1
    return mu + eps_t * _std(log_var) * scale + eps * _std(log_var) * (1.0 - scale)


def _top2_centroids(metric: CentroidMetric, mu: torch.Tensor):
    """(distances [B, 2], indices [B, 2]) of the two nearest centroids.  Ties
    go to the lower index, as ``jax.lax.top_k`` breaks them (a stable sort;
    ``torch.topk`` leaves the order among ties unspecified).  With a single
    centroid both slots point at it."""
    dist = torch.linalg.vector_norm(mu[:, None, :] - metric.centroids[None, :, :], dim=-1)
    if metric.n_centroids < 2:
        return dist.repeat(1, 2), torch.zeros((mu.shape[0], 2), dtype=torch.long,
                                              device=mu.device)
    top, idx = torch.sort(dist, dim=1, stable=True)
    return top[:, :2], idx[:, :2]


def _posterior_enhanced(metric, mu, log_var, eps):
    d2, idx = _top2_centroids(metric, mu)
    w = 1.0 / (d2 + 1e-8)
    w = w / w.sum(-1, keepdim=True)
    c1, c2 = metric.centroids[idx[:, 0]], metric.centroids[idx[:, 1]]
    virtual = w[:, 0:1] * c1 + w[:, 1:2] * c2
    l = gm.chol_g_inv(metric, virtual, jitter=1e-6)
    eps_t = torch.einsum("bij,bj->bi", l, eps)
    influence = 0.15
    return mu + eps_t * _std(log_var) * influence + eps * _std(log_var) * (1.0 - influence)


def _posterior_geodesic(metric, mu, log_var, eps, t):
    _, idx = _top2_centroids(metric, mu)
    c1, c2 = metric.centroids[idx[:, 0]], metric.centroids[idx[:, 1]]
    z_geo = (1.0 - t) * c1 + t * c2
    direction = c2 - c1
    direction = direction / (torch.linalg.vector_norm(direction, dim=-1, keepdim=True) + 1e-8)
    parallel = ((mu - z_geo) * direction).sum(-1, keepdim=True) * direction
    l = _lin.cholesky_small(gm.g(metric, z_geo), jitter=1e-6)
    eps_perp = torch.einsum("bij,bj->bi", l, eps)
    scale = 0.3
    return (z_geo + scale * eps_perp * _std(log_var) + (1.0 - scale) * (mu - z_geo)
            + 0.1 * parallel)


def _posterior_official(metric, mu, log_var, eps):
    """Cholesky of G^{-1}(mu) at the reference sampler's hardcoded T = 0.1,
    0.1 noise scale."""
    official = CentroidMetric(metric.centroids, metric.matrices, 0.1, metric.regularization)
    l = gm.chol_g_inv(official, mu, jitter=1e-6)
    return mu + torch.einsum("bij,bj->bi", l, eps) * _std(log_var) * 0.1


# ---------------------------------------------------------------------------
# Prior sampling
# ---------------------------------------------------------------------------

PRIOR_METHODS = ("geodesic", "geodesic_exact", "centroid_aware", "weighted_mixture", "basic")


def _sym_sqrt(mat: torch.Tensor, clamp: float = 1e-8) -> torch.Tensor:
    """Symmetric PSD square root via eigh, eigenvalues clamped at ``clamp``."""
    vals, vecs = torch.linalg.eigh(mat)
    vals = torch.clamp(vals, min=clamp)
    return torch.einsum("bij,bj,bkj->bik", vecs, torch.sqrt(vals), vecs)


def _check_method(method: str) -> None:
    if method not in PRIOR_METHODS:
        raise ValueError(f"Unknown prior sampling method: {method}")


def draw_prior_noise(metric: Optional[CentroidMetric], method: str, n: int, latent_dim: int,
                     generator: Optional[torch.Generator], device=None) -> Dict[str, torch.Tensor]:
    """Every draw of prior ``method`` for ``n`` samples, in order (see the
    module docstring)."""
    if metric is not None:
        device = metric.centroids.device if device is None else device
        latent_dim = metric.centroids.shape[1]
        _check_method(method)

    def randint():
        return torch.randint(0, metric.n_centroids, (n,), generator=generator, device=device)

    def randn():
        return torch.randn((n, latent_dim), generator=generator, device=device)

    if metric is None or method == "basic":
        return {"eps": randn()}
    if method == "geodesic":
        i1, i2 = randint(), randint()
        t = torch.rand((n, 1), generator=generator, device=device)
        return {"i1": i1, "i2": i2, "t": t, "eps": randn()}
    if method == "geodesic_exact":
        i1, i2 = randint(), randint()
        s = torch.rand((n,), generator=generator, device=device)
        return {"i1": i1, "i2": i2, "s": s, "eps": randn()}
    if method == "centroid_aware":
        return {"idx": randint(), "eps": randn()}
    # weighted_mixture: categorical with p ~ exp(-|c| / 2)
    probs = torch.softmax(-torch.linalg.vector_norm(metric.centroids, dim=-1) / 2.0, dim=0)
    idx = torch.multinomial(probs, n, replacement=True, generator=generator)
    return {"idx": idx, "eps": randn()}


def sample_prior(metric: Optional[CentroidMetric], num_samples: int, latent_dim: int,
                 method: str = "geodesic", generator: Optional[torch.Generator] = None,
                 noise: Optional[Noise] = None) -> torch.Tensor:
    """Prior latents [num_samples, D] by ``method``; the draws come from
    ``noise`` or, when it is not given, from ``generator``."""
    if noise is None:
        noise = draw_prior_noise(metric, method, num_samples, latent_dim, generator)
    if metric is None:
        return noise["eps"]
    _check_method(method)
    dev = metric.centroids.device
    noise = {k: v.to(dev) for k, v in noise.items()}
    if method == "geodesic":
        return _prior_geodesic(metric, noise)
    if method == "geodesic_exact":
        return _prior_geodesic_exact(metric, noise)
    if method == "centroid_aware":
        return _prior_centroid_aware(metric, noise)
    if method == "weighted_mixture":
        return _prior_weighted_mixture(metric, noise)
    return _prior_basic(metric, noise)


def _prior_geodesic(metric: CentroidMetric, noise: Noise) -> torch.Tensor:
    """A point on the straight line between two centroids plus metric noise
    perpendicular to the line, at scale 0.2."""
    start, end = metric.centroids[noise["i1"].long()], metric.centroids[noise["i2"].long()]
    t = noise["t"].float()
    z_path = (1.0 - t) * start + t * end
    direction = end - start
    direction = direction / (torch.linalg.vector_norm(direction, dim=-1, keepdim=True) + 1e-8)
    eps = noise["eps"].float()
    parallel = (eps * direction).sum(-1, keepdim=True) * direction
    perp = eps - parallel
    sqrt_gi = _sym_sqrt(gm.g_inv(metric, z_path))
    return z_path + 0.2 * torch.einsum("bij,bj->bi", sqrt_gi, perp)


def _prior_geodesic_exact(metric: CentroidMetric, noise: Noise, n_points: int = 12,
                          n_iters: int = 80) -> torch.Tensor:
    """The ``geodesic`` prior with the point taken on the energy-minimized
    geodesic between the centroid pair (linear inside the discrete segment
    that holds it), and the metric noise perpendicular to that segment."""
    start, end = metric.centroids[noise["i1"].long()], metric.centroids[noise["i2"].long()]
    paths = energy_path(metric, start, end, n_points=n_points, n_iters=n_iters)
    n = paths.shape[0]
    s = noise["s"].float() * (n_points - 1)
    lo = torch.clamp(torch.floor(s).long(), 0, n_points - 2)
    frac = (s - lo)[:, None]
    rows = torch.arange(n, device=paths.device)
    z_lo, z_hi = paths[rows, lo], paths[rows, lo + 1]
    z_path = (1.0 - frac) * z_lo + frac * z_hi
    tangent = z_hi - z_lo
    tangent = tangent / (torch.linalg.vector_norm(tangent, dim=-1, keepdim=True) + 1e-8)
    eps = noise["eps"].float()
    perp = eps - (eps * tangent).sum(-1, keepdim=True) * tangent
    sqrt_gi = _sym_sqrt(gm.g_inv(metric, z_path))
    return z_path + 0.2 * torch.einsum("bij,bj->bi", sqrt_gi, perp)


def _prior_centroid_aware(metric: CentroidMetric, noise: Noise) -> torch.Tensor:
    base = metric.centroids[noise["idx"].long()]
    eps = noise["eps"].float() * 0.3
    sqrt_gi = _sym_sqrt(gm.g_inv(metric, base))
    return base + 0.5 * torch.einsum("bij,bj->bi", sqrt_gi, eps)


def _prior_weighted_mixture(metric: CentroidMetric, noise: Noise) -> torch.Tensor:
    sel = metric.centroids[noise["idx"].long()].contiguous()
    l = gm.chol_g_inv(metric, sel, jitter=1e-6)
    eps_metric = torch.einsum("bij,bj->bi", l, noise["eps"].float())
    det_gi = torch.exp(gm.logdet_g_inv(metric, sel))
    local_scale = det_gi ** (1.0 / (2.0 * metric.centroids.shape[1]))
    adaptive = torch.clamp(0.4 / (local_scale + 1e-6), 0.1, 1.0)
    return sel + eps_metric * adaptive[:, None]


def basic_grad(metric: CentroidMetric, z: torch.Tensor) -> torch.Tensor:
    """The gradient in z of the ``basic`` prior's sum(1/2 max(logdet G^{-1},
    log 1e-10) - 1/2 |z|^2), through the chol-bundle's autograd Function
    (the kernel's forward on the card).  While a program is exported, the
    registered op ``rlvae::basic_grad``, whose implementation is this
    function (:mod:`rlvae_tpu_torch.ops.export_ops`)."""
    if torch.compiler.is_exporting():
        from rlvae_tpu_torch.ops import export_ops

        return export_ops.basic_grad(z, metric.centroids, metric.matrices, metric.temperature,
                                     metric.regularization)
    log_floor = float(np.log(np.float32(1e-10)))
    with torch.enable_grad():
        zz = z.detach().requires_grad_(True)
        ld = gm.logdet_g_inv(metric, zz)
        ld = torch.maximum(ld, ld.new_tensor(log_floor))
        log_prob = (0.5 * ld - 0.5 * torch.linalg.vector_norm(zz, dim=1) ** 2).sum()
        (grad,) = torch.autograd.grad(log_prob, zz)
    return grad


def _prior_basic(metric: CentroidMetric, noise: Noise, steps: int = 10) -> torch.Tensor:
    """``steps`` steps of gradient ascent (:func:`basic_grad`) with a
    decaying step."""
    f32 = np.float32
    z = noise["eps"].float() * 0.5
    for step in range(steps):
        step_size = float(f32(0.01) * (f32(1.0) - f32(step) / f32(steps)))  # fp32, as JAX
        z = z + step_size * basic_grad(metric, z)
    return z
