"""Dependency-free UMAP approximation (numpy, exact O(N^2) graph).

A copy of ``rlvae_tpu/utils/umap_lite.py`` (host numpy; the port imports
nothing of the JAX package), so a seed gives JAX's embedding.

The reference app's latent-exploration page offers PCA / t-SNE / UMAP
(reference: app/components/sidebar.py:109-115); umap-learn is uninstallable
in this environment, so this implements the core UMAP algorithm (McInnes,
Healy & Melville 2018) directly on numpy, at the app's tiny point counts
(tens to hundreds — exact kNN, no NN-descent needed):

1. per-point smooth kNN calibration: rho_i = nearest-neighbor distance,
   sigma_i solved by bisection so sum_j exp(-(d_ij - rho_i)/sigma_i) =
   log2(k)  (the fuzzy-simplicial-set membership strengths),
2. symmetrization by probabilistic t-conorm  P = A + A^T - A∘A^T,
3. cross-entropy layout via SGD over the weighted edges with the standard
   low-dimensional kernel  1 / (1 + a*d^(2b)), attractive moves sampled by
   edge weight, repulsive moves by negative sampling.

This is the UMAP *algorithm*, not a port of umap-learn's codebase; defaults
(k=15, min_dist=0.1, 200 epochs, 5 negative samples) mirror the library's.
"""

from __future__ import annotations

import numpy as np


def _fit_ab(min_dist: float, spread: float = 1.0) -> tuple[float, float]:
    """Least-squares fit of the (a, b) low-dim kernel parameters to the
    piecewise target curve exp(-(d - min_dist)/spread) for d > min_dist,
    1 otherwise — umap-learn's find_ab_params, via coarse grid + refinement
    instead of scipy.curve_fit."""
    d = np.linspace(0.0, 3.0 * spread, 300)
    target = np.where(d <= min_dist, 1.0, np.exp(-(d - min_dist) / spread))

    def loss(a, b):
        k = 1.0 / (1.0 + a * d ** (2.0 * b))
        return float(((k - target) ** 2).sum())

    best = (1.0, 1.0, loss(1.0, 1.0))
    a_grid = np.linspace(0.2, 3.0, 29)
    b_grid = np.linspace(0.5, 2.0, 31)
    for _ in range(3):
        for a in a_grid:
            for b in b_grid:
                l = loss(a, b)
                if l < best[2]:
                    best = (a, b, l)
        a0, b0 = best[0], best[1]
        a_grid = np.linspace(max(a0 * 0.8, 1e-3), a0 * 1.2, 21)
        b_grid = np.linspace(max(b0 * 0.8, 1e-3), b0 * 1.2, 21)
    return best[0], best[1]


def _knn_graph(x: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Exact kNN: (indices [N, k], distances [N, k]), self excluded."""
    s = (x**2).sum(1)
    d2 = np.maximum(s[:, None] - 2.0 * x @ x.T + s[None, :], 0.0)
    np.fill_diagonal(d2, np.inf)
    idx = np.argsort(d2, axis=1)[:, :k]
    return idx, np.sqrt(np.take_along_axis(d2, idx, axis=1))


def _smooth_knn(dists: np.ndarray, tol: float = 1e-5,
                max_iter: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """Per-point (rho, sigma): rho = nearest distance; sigma by bisection so
    the membership strengths sum to log2(k)."""
    n, k = dists.shape
    rho = dists[:, 0].copy()
    target = np.log2(k)
    sigma = np.ones(n)
    for i in range(n):
        lo, hi, mid = 0.0, np.inf, 1.0
        d = np.maximum(dists[i] - rho[i], 0.0)
        for _ in range(max_iter):
            val = float(np.exp(-d / mid).sum())
            if abs(val - target) < tol:
                break
            if val > target:
                hi = mid
                mid = (lo + hi) / 2.0
            else:
                lo = mid
                mid = mid * 2.0 if not np.isfinite(hi) else (lo + hi) / 2.0
        sigma[i] = max(mid, 1e-3 * max(float(dists[i].mean()), 1e-12))
    return rho, sigma


def umap(
    x: np.ndarray,
    n_components: int = 2,
    n_neighbors: int = 15,
    min_dist: float = 0.1,
    n_epochs: int = 200,
    learning_rate: float = 1.0,
    negative_samples: int = 5,
    seed: int = 0,
) -> np.ndarray:
    """Embed x [N, D] -> [N, n_components]."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    if n <= n_components + 1:
        return np.zeros((n, n_components))
    k = int(min(n_neighbors, n - 1))

    idx, dists = _knn_graph(x, k)
    rho, sigma = _smooth_knn(dists)
    w = np.exp(-np.maximum(dists - rho[:, None], 0.0) / sigma[:, None])
    # symmetrize by probabilistic t-conorm on the sparse graph
    a = np.zeros((n, n))
    rows = np.repeat(np.arange(n), k)
    a[rows, idx.ravel()] = w.ravel()
    p = a + a.T - a * a.T

    heads, tails = np.nonzero(p > 0.0)
    weights = p[heads, tails]
    # per-edge epoch cadence proportional to weight (umap-learn's
    # make_epochs_per_sample), realized as a Bernoulli draw per epoch
    prob = weights / weights.max()

    a_k, b_k = _fit_ab(min_dist)
    rng = np.random.default_rng(seed)
    # spectral-ish init: PCA of the membership matrix (cheap, deterministic)
    pc = p - p.mean(0)
    _, _, vt = np.linalg.svd(pc, full_matrices=False)
    y = (pc @ vt[:n_components].T)
    y = 10.0 * y / max(np.abs(y).max(), 1e-12)
    y += 1e-4 * rng.standard_normal(y.shape)

    def clip(g):
        return np.clip(g, -4.0, 4.0)

    m = heads.shape[0]
    for epoch in range(n_epochs):
        alpha = learning_rate * (1.0 - epoch / n_epochs)
        live = rng.random(m) < prob
        hs, ts = heads[live], tails[live]
        d2 = ((y[hs] - y[ts]) ** 2).sum(1)
        # attractive: d/dy of log(1/(1 + a d^{2b}))
        grad_coef = (-2.0 * a_k * b_k * d2 ** (b_k - 1.0)) / (
            1.0 + a_k * d2**b_k
        )
        delta = clip(grad_coef[:, None] * (y[hs] - y[ts]))
        np.add.at(y, hs, alpha * delta)
        np.add.at(y, ts, -alpha * delta)
        # repulsive: negative sampling per live edge
        for _ in range(negative_samples):
            ns = rng.integers(0, n, hs.shape[0])
            diff = y[hs] - y[ns]
            d2n = (diff**2).sum(1)
            rep = (2.0 * b_k) / ((0.001 + d2n) * (1.0 + a_k * d2n**b_k))
            np.add.at(y, hs, alpha * clip(rep[:, None] * diff))
    return y - y.mean(0)
