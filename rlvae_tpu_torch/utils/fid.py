"""Fréchet distance (FID-style) evaluation of generated images.

A copy of ``rlvae_tpu/utils/fid.py`` (host numpy; the port imports nothing
of the JAX package).  :func:`encoder_features` takes any batch encoder; for
the port, ``lambda x: manager.encode(x).embedding`` runs the
:class:`~rlvae_tpu_torch.inference.ModelManager`'s encoder on its device.

Reimplements the capability of the reference's FID script (reference:
src/lib/scripts/fid.py:50-156, which generates from a saved model and calls
``pytorch_fid.calculate_fid_given_arrays``).  The Inception-V3 feature
network pytorch_fid downloads is unavailable here (no network egress), so
the Fréchet machinery is implemented natively with pluggable feature
extractors:

- ``pixel_features``: downsampled pixel space — model-free, deterministic,
  comparable across runs on the same dataset,
- ``encoder_features``: a trained encoder's embedding (the common
  "domain-FID" substitute when Inception is inappropriate, e.g. sprites).

The Fréchet distance itself is exact: d^2 = |mu1 - mu2|^2 +
tr(S1 + S2 - 2 (S1^{1/2} S2 S1^{1/2})^{1/2}), with the matrix square roots
via symmetric eigendecomposition in float64 (the covariances are PSD).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np


def _sqrtm_psd(mat: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Symmetric PSD matrix square root via eigendecomposition (float64)."""
    vals, vecs = np.linalg.eigh(mat.astype(np.float64))
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals + eps)) @ vecs.T


def compute_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu [D], sigma [D, D]) of a [N, D] feature matrix."""
    if features.shape[0] < 2:
        # np.cov's ddof=1 divides by N-1: a single sample yields an all-NaN
        # covariance and a silently meaningless Frechet distance downstream
        raise ValueError(
            f"need >= 2 samples for covariance statistics, got {features.shape[0]}"
        )
    feats = np.asarray(features, np.float64).reshape(features.shape[0], -1)
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    if sigma.ndim == 0:  # D == 1
        sigma = sigma.reshape(1, 1)
    return mu, sigma


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray
) -> float:
    """Exact Fréchet distance between two Gaussians (pytorch_fid's
    calculate_frechet_distance semantics, eigh-based sqrtm)."""
    diff = np.asarray(mu1, np.float64) - np.asarray(mu2, np.float64)
    s1_half = _sqrtm_psd(np.asarray(sigma1))
    covmean = _sqrtm_psd(s1_half @ np.asarray(sigma2, np.float64) @ s1_half)
    return float(
        diff @ diff
        + np.trace(sigma1)
        + np.trace(sigma2)
        - 2.0 * np.trace(covmean)
    )


def fid_score(features_real: np.ndarray, features_gen: np.ndarray) -> float:
    """Fréchet distance between two feature sets ([N, ...] each)."""
    mu1, s1 = compute_statistics(features_real)
    mu2, s2 = compute_statistics(features_gen)
    return frechet_distance(mu1, s1, mu2, s2)


def pixel_features(images: np.ndarray, size: int = 16) -> np.ndarray:
    """Model-free features: images ([N, C, H, W] or [N, T, C, H, W] flattened
    over time) average-pooled to [N', C*size*size]."""
    x = np.asarray(images, np.float32)
    if x.ndim == 5:
        x = x.reshape(-1, *x.shape[2:])
    n, c, h, w = x.shape
    fh, fw = max(1, h // size), max(1, w // size)
    oh, ow = h // fh, w // fw
    pooled = x[:, :, : oh * fh, : ow * fw].reshape(n, c, oh, fh, ow, fw).mean((3, 5))
    return pooled.reshape(n, -1)


def encoder_features(
    encode_fn: Callable[[np.ndarray], np.ndarray],
    images: np.ndarray,
    batch_size: int = 256,
) -> np.ndarray:
    """Features from a trained encoder: ``encode_fn`` maps [B, C, H, W] ->
    [B, D] (e.g. ``lambda x: manager.encode(x).embedding``)."""
    x = np.asarray(images, np.float32)
    if x.ndim == 5:
        x = x.reshape(-1, *x.shape[2:])
    out = []
    for i in range(0, x.shape[0], batch_size):
        out.append(np.asarray(encode_fn(x[i : i + batch_size])))
    return np.concatenate(out, axis=0)
