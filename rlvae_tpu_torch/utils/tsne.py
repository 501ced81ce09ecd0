"""Dependency-free t-SNE (numpy, exact O(N^2)).

A copy of ``rlvae_tpu/utils/tsne.py`` (host numpy; the port imports nothing
of the JAX package), so a seed gives JAX's embedding.

The reference app's latent-exploration page offers PCA / t-SNE / UMAP
embeddings (reference: app/pages/ latent exploration page); neither sklearn's
TSNE nor umap-learn is installable here, so this is a small faithful
implementation of the standard t-SNE algorithm (perplexity-calibrated
Gaussian affinities via bisection, Student-t low-dimensional kernel, KL
gradient descent with momentum and early exaggeration).  The app's point
counts are tiny (tens), so the exact quadratic form is the right tool — no
Barnes-Hut approximation needed.
"""

from __future__ import annotations

import numpy as np


def _pairwise_sq_dists(x: np.ndarray) -> np.ndarray:
    s = (x**2).sum(1)
    d2 = s[:, None] - 2.0 * x @ x.T + s[None, :]
    np.fill_diagonal(d2, 0.0)
    return np.maximum(d2, 0.0)


def _calibrate_p(d2: np.ndarray, perplexity: float, tol: float = 1e-4,
                 max_iter: int = 64) -> np.ndarray:
    """Per-point Gaussian bandwidths by bisection on entropy = log(perplexity)."""
    n = d2.shape[0]
    target = np.log(perplexity)
    p = np.zeros((n, n))
    for i in range(n):
        di = np.delete(d2[i], i)
        beta, lo, hi = 1.0, 0.0, np.inf
        for _ in range(max_iter):
            w = np.exp(-di * beta)
            sw = max(w.sum(), 1e-12)
            h = np.log(sw) + beta * float((di * w).sum()) / sw
            if abs(h - target) < tol:
                break
            if h > target:
                lo = beta
                beta = beta * 2.0 if not np.isfinite(hi) else (beta + hi) / 2.0
            else:
                hi = beta
                beta = (beta + lo) / 2.0
        w = np.exp(-di * beta)
        w /= max(w.sum(), 1e-12)
        p[i, np.arange(n) != i] = w
    return p


def tsne(
    x: np.ndarray,
    n_components: int = 2,
    perplexity: float = 10.0,
    n_iter: int = 400,
    learning_rate: float = 100.0,
    seed: int = 0,
    early_exaggeration: float = 4.0,
) -> np.ndarray:
    """Embed x [N, D] -> [N, n_components]."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    if n <= n_components:
        return np.zeros((n, n_components))
    perplexity = min(perplexity, max((n - 1) / 3.0, 1.0))
    p = _calibrate_p(_pairwise_sq_dists(x), perplexity)
    p = (p + p.T) / (2.0 * n)
    p = np.maximum(p, 1e-12)

    rng = np.random.default_rng(seed)
    y = 1e-4 * rng.standard_normal((n, n_components))
    vel = np.zeros_like(y)
    exagg_until = n_iter // 4
    for it in range(n_iter):
        pe = p * early_exaggeration if it < exagg_until else p
        num = 1.0 / (1.0 + _pairwise_sq_dists(y))
        np.fill_diagonal(num, 0.0)
        q = np.maximum(num / max(num.sum(), 1e-12), 1e-12)
        pq = (pe - q) * num
        grad = 4.0 * ((np.diag(pq.sum(1)) - pq) @ y)
        momentum = 0.5 if it < exagg_until else 0.8
        vel = momentum * vel - learning_rate * grad
        y = y + vel
        y = y - y.mean(0)
    return y
