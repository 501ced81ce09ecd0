"""MCMC chain quality metrics — effective sample size.

A copy of ``rlvae_tpu/utils/mcmc.py`` (host numpy; the port imports
nothing of the JAX package).

The reference ships no sampler diagnostics at all (its HMC quality story is
"run 100x15 steps and hope"; pythae rhvae_sampler.py:98-148).  ESS is the
standard currency for comparing samplers at equal wall-clock: N correlated
draws are worth ESS < N independent ones, and a tuned chain can dominate a
mis-tuned one by orders of magnitude at identical step counts — exactly the
comparison scripts/bench_adaptive_hmc.py publishes.

Implementation: per-(chain, dimension) autocorrelations via FFT, truncated
by Geyer's initial monotone positive sequence (Geyer 1992, the estimator
Stan/ArviZ use per chain); per-dimension ESS sums over independent chains;
the reported scalar is the MINIMUM over dimensions (the most conservative
coordinate).  Host-side numpy — chains are fetched once, sizes are tiny
([S, B, D] ~ MBs).
"""

from __future__ import annotations

import numpy as np


def _autocorr_fft(x: np.ndarray) -> np.ndarray:
    """Normalized autocorrelation rho[t] of a 1-D series (biased, FFT)."""
    n = x.shape[0]
    x = x - x.mean()
    var = np.dot(x, x)
    if var <= 0.0:
        return np.zeros(n)
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, nfft)
    acov = np.fft.irfft(f * np.conj(f), nfft)[:n].real
    return acov / var


def ess_1d(x: np.ndarray) -> float:
    """ESS of one chain's scalar series via Geyer's initial monotone
    positive sequence: sum consecutive autocorrelation pairs
    Gamma_m = rho[2m] + rho[2m+1], truncate at the first negative pair,
    enforce monotone non-increasing, ESS = N / (-1 + 2 sum Gamma)."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    if n < 4:
        return float(n)
    # A frozen chain (zero accepted moves -> zero variance) is ONE effective
    # sample, not n: _autocorr_fft returns all-zero rho for it, which the
    # generic path below would turn into tau=1/n -> ESS=n — maximally wrong
    # for a sampler diagnostic (a stuck chain would look perfect).  This
    # exact case inflated the official 4.7%-accept chain's ESS in the first
    # adaptive-HMC head-to-head run.
    xc = x - x.mean()
    if float(np.dot(xc, xc)) <= 1e-12 * n * max(1.0, float(np.dot(x, x)) / n):
        return 1.0
    rho = _autocorr_fft(x)
    m_max = (n - 1) // 2
    gam = rho[0 : 2 * m_max : 2] + rho[1 : 2 * m_max : 2]
    neg = np.nonzero(gam < 0.0)[0]
    cut = int(neg[0]) if neg.size else m_max
    gam = np.minimum.accumulate(gam[:cut]) if cut else gam[:0]
    tau = -1.0 + 2.0 * float(gam.sum())  # integrated autocorrelation time
    tau = max(tau, 1.0 / n)  # guard: antithetic chains can push tau below 0
    return float(min(n / tau, float(n)))


def effective_sample_size(chains: np.ndarray) -> float:
    """Conservative ESS of a set of independent chains.

    ``chains``: [S, B] (scalar summary per step per chain) or [S, B, D].
    Per-dimension ESS is the SUM over the B independent chains (each chain's
    Geyer estimate); the return value is the minimum over dimensions.
    """
    chains = np.asarray(chains, np.float64)
    if chains.ndim == 2:
        chains = chains[:, :, None]
    s, b, d = chains.shape
    per_dim = np.empty(d)
    for j in range(d):
        per_dim[j] = sum(ess_1d(chains[:, c, j]) for c in range(b))
    return float(per_dim.min())
