"""Manifold Hamiltonian Monte Carlo on the metric's prior.

Port of ``rlvae_tpu/samplers/hmc.py:37-206``: the reference sampler's prior
chain, 100 MCMC steps x 15 leapfrog steps at eps=0.03 by default, targeting
pi(z) ~ sqrt(det G^{-1}(z)) with the sampler's closed-form gradient.  The
chain is a Python loop over the steps; each evaluation of the target and its
gradient is one :func:`~rlvae_tpu_torch.ops.metric_kernels.hmc_terms` call
(the CUDA kernel for tensors on the card, its plain version on the CPU).

What is reproduced exactly:

- The gradient at the end of one leapfrog step is the one at the start of
  the next, so it is carried: one terms call at the start, one per leapfrog
  step and one per MCMC step, 1 + 100 * 16 = 1601 per chain at the defaults.
- Tempering beta_k = (1 - 1/sqrt(b0)) (k/K)^2 + 1/sqrt(b0), applied as the
  ratio ``beta_sqrt_old / beta_sqrt`` and carried across MCMC steps.
- The accept test: for ``init="centroids"`` (the official chain) the
  unguarded ``alpha = exp(-h) / exp(-h0)``, computed as that quotient, so
  0/0 and inf/inf give NaN and reject; for ``init="randn"``
  ``clip(exp(-h) / (exp(-h0) + 1e-10), 0, 1)``.  Accepted rows take the
  proposal's z, log pi and gradient; the others keep theirs.

All randomness is injectable: the starts ``z0``, the momenta ``gammas``
[S, B, D] and the uniforms ``unifs`` [S, B].  Otherwise they are drawn from a
``torch.Generator`` in that order (:func:`draw_chain_noise` for the last
two).  JAX's ``jax.random`` bits cannot be reproduced; tests pass JAX's draws
in.  Every row of the chain is independent of the others.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from rlvae_tpu_torch.geometry.metric import CentroidMetric
from rlvae_tpu_torch.ops.metric_kernels import hmc_terms

Terms = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
_F32 = np.float32
LOG_EPS = float(np.log(_F32(1e-10)))  # the target's guard, log pi = logaddexp(., LOG_EPS)


@dataclass(frozen=True)
class HMCConfig:
    mcmc_steps: int = 100
    n_lf: int = 15
    eps_lf: float = 0.03
    beta_zero: float = 1.0
    init: str = "centroids"  # or "randn"

    def __post_init__(self):
        if self.init not in ("centroids", "randn"):
            raise ValueError(f"HMCConfig.init must be 'centroids' or 'randn', got {self.init!r}")


def _terms_fn(metric: CentroidMetric) -> Terms:
    """(log pi, grad log pi) evaluator of the chain: one ``hmc_terms`` call."""
    inv_t2 = 1.0 / metric.temperature ** 2
    return lambda z: hmc_terms(z, metric.centroids, metric.matrices, inv_t2,
                               metric.regularization, LOG_EPS)


def tempering(k: float, big_k: int, beta_zero_sqrt: np.float32) -> np.float32:
    """1/beta_k with beta_k = ((1 - 1/sqrt(b0)) (k/K)^2) + 1/sqrt(b0), in fp32
    as the JAX chain computes it."""
    inv_b = _F32(1.0) / beta_zero_sqrt
    beta_k = (_F32(1.0) - inv_b) * (_F32(k) / _F32(big_k)) ** 2 + inv_b
    return _F32(1.0) / beta_k


def draw_chain_noise(generator: Optional[torch.Generator], steps: int, num_samples: int,
                     d: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain's randomness: momenta ``gammas [S, B, D]`` (standard normal),
    then acceptance uniforms ``unifs [S, B]``, from ``generator``."""
    gammas = torch.randn((steps, num_samples, d), generator=generator, device=device)
    unifs = torch.rand((steps, num_samples), generator=generator, device=device)
    return gammas, unifs


ChainState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, np.float32]


def mcmc_step(terms: Terms, state: ChainState, gamma: torch.Tensor, accept_u: torch.Tensor,
              config: HMCConfig):
    """One MCMC step: ``n_lf`` leapfrog steps from ``state`` = (z, log pi(z),
    -grad(z), beta_sqrt_old) with momentum ``gamma / sqrt(b0)``, then the
    accept test against ``accept_u``.  Returns (the next state, accept [B],
    alpha [B])."""
    z0, log_pi0, g0, beta_sqrt_old = state
    beta_zero_sqrt = np.sqrt(_F32(config.beta_zero))
    eps = float(_F32(config.eps_lf))
    half_eps = float(_F32(config.eps_lf) / _F32(2.0))

    rho = gamma / float(beta_zero_sqrt)
    h0 = -log_pi0 + 0.5 * (rho ** 2).sum(1)
    z, g = z0, g0
    for k in range(config.n_lf):
        rho_half = rho - half_eps * g
        z = z + eps * rho_half
        _, grad = terms(z)
        g = -grad
        rho_full = rho_half - half_eps * g
        beta_sqrt = tempering(k + 1.0, config.n_lf, beta_zero_sqrt)
        rho = float(beta_sqrt_old / beta_sqrt) * rho_full
        beta_sqrt_old = beta_sqrt
    log_pi, _ = terms(z)
    h = -log_pi + 0.5 * (rho ** 2).sum(1)
    if config.init == "centroids":
        alpha = torch.exp(-h) / torch.exp(-h0)  # unguarded, as the reference
    else:
        alpha = torch.clamp(torch.exp(-h) / (torch.exp(-h0) + 1e-10), 0.0, 1.0)
    accept = accept_u < alpha
    state = (torch.where(accept[:, None], z, z0), torch.where(accept, log_pi, log_pi0),
             torch.where(accept[:, None], g, g0), beta_sqrt_old)
    return state, accept, alpha


def run_prior_chain(terms: Terms, z0: torch.Tensor, gammas: torch.Tensor,
                    unifs: torch.Tensor, config: HMCConfig, collect_states: bool = False,
                    mean_fn: Callable[[torch.Tensor], torch.Tensor] = torch.mean):
    """The prior-chain integrator on given noise: :func:`mcmc_step` for each
    of the ``S`` steps, from z0 at tempering 1/sqrt(b0).

    Returns ``(z, accept_rate, log_pi_final)``, and with ``collect_states``
    also ``zs [S, B, D]``, the state after every MCMC step (the chain is the
    same either way).  ``accept_rate`` is the mean over steps of
    ``mean_fn(accept)``, the step's accept mask (as fp32) reduced to a rate:
    the mean over rows by default; the centroid-sharded chain passes a mean
    over every rank's rows (``rlvae_tpu/samplers/hmc.py:99``)."""
    log_pi, grad = terms(z0)
    state = (z0, log_pi, -grad, np.sqrt(_F32(config.beta_zero)))
    rates, zs = [], []
    for s in range(config.mcmc_steps):
        state, accept, _ = mcmc_step(terms, state, gammas[s], unifs[s], config)
        rates.append(mean_fn(accept.float()))
        if collect_states:
            zs.append(state[0])
    z, log_pi = state[0], state[1]
    rate = torch.stack(rates).mean() if rates else z.new_zeros(())
    if collect_states:
        return z, rate, log_pi, torch.stack(zs) if zs else z.new_zeros((0, *z.shape))
    return z, rate, log_pi


def draw_hmc_noise(metric: CentroidMetric, num_samples: int, config: HMCConfig,
                   generator: Optional[torch.Generator], device=None) -> Dict[str, torch.Tensor]:
    """The chain's starts and noise, drawn in order: ``z0`` (centroids at
    uniform indices, or standard normal for ``init="randn"``), then
    ``gammas`` and ``unifs``."""
    device = metric.centroids.device if device is None else device
    d = metric.centroids.shape[1]
    if config.init == "centroids":
        idx = torch.randint(0, metric.n_centroids, (num_samples,), generator=generator,
                            device=device)
        z0 = metric.centroids[idx]
    else:
        z0 = torch.randn((num_samples, d), generator=generator, device=device)
    gammas, unifs = draw_chain_noise(generator, config.mcmc_steps, num_samples, d, device)
    return {"z0": z0, "gammas": gammas, "unifs": unifs}


def sample_prior_hmc(metric: CentroidMetric, num_samples: int, config: HMCConfig = HMCConfig(),
                     generator: Optional[torch.Generator] = None,
                     z0: Optional[torch.Tensor] = None, gammas: Optional[torch.Tensor] = None,
                     unifs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """HMC chains targeting pi(z) ~ sqrt(det G^{-1}(z)), [num_samples, D].

    ``z0``, ``gammas`` and ``unifs`` override the draws (``z0`` overrides
    ``config.init``); what is not given is drawn from ``generator`` as
    :func:`draw_hmc_noise` draws it."""
    if z0 is None or gammas is None or unifs is None:
        drawn = draw_hmc_noise(metric, num_samples, config, generator)
        z0 = drawn["z0"] if z0 is None else z0
        gammas = drawn["gammas"] if gammas is None else gammas
        unifs = drawn["unifs"] if unifs is None else unifs
    dev = metric.centroids.device
    z0, gammas, unifs = (t.to(device=dev, dtype=torch.float32).contiguous()
                         for t in (z0, gammas, unifs))
    return run_prior_chain(_terms_fn(metric), z0, gammas, unifs, config)[0]


def concat_rows(noises: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """One-row draws (of :func:`draw_hmc_noise` or
    :func:`~rlvae_tpu_torch.samplers.riemannian.draw_prior_noise`) stacked
    into one batch: the chain's ``gammas`` [S, n, D] and ``unifs`` [S, n]
    along dim 1, every other draw along dim 0."""
    return {k: torch.cat([n[k] for n in noises], dim=1 if k in ("gammas", "unifs") else 0)
            for k in noises[0]}
