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

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_map

from rlvae_tpu_torch.geometry.metric import CentroidMetric
from rlvae_tpu_torch.ops._launch import plain_route
from rlvae_tpu_torch.ops.metric_kernels import fused_supported, hmc_terms, hmc_terms_ref
from rlvae_tpu_torch.utils.loops import loop_steps

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
    """(log pi, grad log pi) evaluator of the chain: one ``hmc_terms`` call,
    or past the kernel's envelope (D > 32, JAX's ``fused_supported``) its
    plain version, as JAX's ``_terms_fn`` takes XLA there."""
    inv_t2 = 1.0 / metric.temperature ** 2
    if not fused_supported(metric.latent_dim):
        return lambda z: plain_route(hmc_terms_ref, z, metric.centroids, metric.matrices,
                                     inv_t2, metric.regularization, LOG_EPS)
    c, m = metric.kernel_bank()
    return lambda z: hmc_terms(z, c, m, inv_t2, metric.regularization, LOG_EPS)


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


class StepConstants(NamedTuple):
    """The Python floats of one MCMC step (numpy's fp32 arithmetic done on
    the host, so a traced loop body holds constants, not numpy): 1/sqrt(b0)'s
    divisor sqrt(b0), the leapfrog's eps and eps/2, and the momentum factor
    beta_sqrt_old / beta_sqrt of each leapfrog step."""
    beta_zero_sqrt: float
    eps: float
    half_eps: float
    factors: Tuple[float, ...]


def step_constants(config: HMCConfig, beta_sqrt_old: np.float32
                   ) -> Tuple[StepConstants, np.float32]:
    """The constants of an MCMC step that starts at tempering
    ``beta_sqrt_old``, and the tempering it ends at (the same for every
    start: the last leapfrog's)."""
    beta_zero_sqrt = np.sqrt(_F32(config.beta_zero))
    factors = []
    for k in range(config.n_lf):
        beta_sqrt = tempering(k + 1.0, config.n_lf, beta_zero_sqrt)
        factors.append(float(beta_sqrt_old / beta_sqrt))
        beta_sqrt_old = beta_sqrt
    consts = StepConstants(float(beta_zero_sqrt), float(_F32(config.eps_lf)),
                           float(_F32(config.eps_lf) / _F32(2.0)), tuple(factors))
    return consts, beta_sqrt_old


def _mcmc_body(terms: Terms, carry, gamma: torch.Tensor, accept_u: torch.Tensor,
               consts: StepConstants, quotient: bool):
    """One MCMC step's tensor work from ``carry`` = (z, log pi(z), -grad(z)):
    the leapfrog steps and the accept test (``quotient``: the official
    chain's unguarded exp(-h) / exp(-h0)).  Returns (the next carry, accept,
    alpha)."""
    z0, log_pi0, g0 = carry
    eps, half_eps = consts.eps, consts.half_eps
    rho = gamma / consts.beta_zero_sqrt
    h0 = -log_pi0 + 0.5 * (rho ** 2).sum(1)
    z, g = z0, g0
    for factor in consts.factors:
        rho_half = rho - half_eps * g
        z = z + eps * rho_half
        _, grad = terms(z)
        g = -grad
        rho_full = rho_half - half_eps * g
        rho = factor * rho_full
    log_pi, _ = terms(z)
    h = -log_pi + 0.5 * (rho ** 2).sum(1)
    if quotient:
        alpha = torch.exp(-h) / torch.exp(-h0)  # unguarded, as the reference
    else:
        alpha = torch.clamp(torch.exp(-h) / (torch.exp(-h0) + 1e-10), 0.0, 1.0)
    accept = accept_u < alpha
    carry = (torch.where(accept[:, None], z, z0), torch.where(accept, log_pi, log_pi0),
             torch.where(accept[:, None], g, g0))
    return carry, accept, alpha


def mcmc_step(terms: Terms, state: ChainState, gamma: torch.Tensor, accept_u: torch.Tensor,
              config: HMCConfig):
    """One MCMC step: ``n_lf`` leapfrog steps from ``state`` = (z, log pi(z),
    -grad(z), beta_sqrt_old) with momentum ``gamma / sqrt(b0)``, then the
    accept test against ``accept_u``.  Returns (the next state, accept [B],
    alpha [B])."""
    consts, beta_sqrt = step_constants(config, state[3])
    carry, accept, alpha = _mcmc_body(terms, state[:3], gamma, accept_u, consts,
                                      config.init == "centroids")
    return (*carry, beta_sqrt), accept, alpha


def run_prior_chain(terms: Terms, z0: torch.Tensor, gammas: torch.Tensor,
                    unifs: torch.Tensor, config: HMCConfig, collect_states: bool = False,
                    mean_fn: Callable[[torch.Tensor], torch.Tensor] = torch.mean):
    """The prior-chain integrator on given noise: :func:`mcmc_step` for each
    of the ``S`` steps, from z0 at tempering 1/sqrt(b0), through
    :func:`loop_steps` (one loop op in an exported program).  Every step
    after the first starts at the tempering the last ended at, so one body
    serves them all; the first gets its own when b0 != 1.

    Returns ``(z, accept_rate, log_pi_final)``, and with ``collect_states``
    also ``zs [S, B, D]``, the state after every MCMC step (the chain is the
    same either way).  ``accept_rate`` is the mean over steps of
    ``mean_fn(accept)``, the step's accept mask (as fp32) reduced to a rate:
    the mean over rows by default; the centroid-sharded chain passes a mean
    over every rank's rows (``rlvae_tpu/samplers/hmc.py:99``); None while a
    program is exported (its loop keeps no per-step outputs)."""
    if gammas.shape[0] < config.mcmc_steps or unifs.shape[0] < config.mcmc_steps:
        raise ValueError(f"the chain takes {config.mcmc_steps} steps; the given draws have "
                         f"{gammas.shape[0]} and {unifs.shape[0]}")
    log_pi, grad = terms(z0)
    carry = (z0, log_pi, -grad)
    quotient = config.init == "centroids"

    def body(consts):
        def step(carry, x):
            carry, accept, _ = _mcmc_body(terms, carry, x[0], x[1], consts, quotient)
            rate = mean_fn(accept.float())
            return carry, ((rate, carry[0].clone()) if collect_states else rate)
        return step

    beta = np.sqrt(_F32(config.beta_zero))
    first, beta_after = step_constants(config, beta)
    steady, _ = step_constants(config, beta_after)
    xs = (gammas[:config.mcmc_steps], unifs[:config.mcmc_steps])
    parts = []  # the ys of each loop
    if config.mcmc_steps and first != steady:
        carry, y = body(first)(carry, tuple(x[0] for x in xs))
        parts.append(tree_map(lambda t: t[None], y))
        xs = tuple(x[1:] for x in xs)
    if xs[0].shape[0]:
        carry, ys = loop_steps(body(steady), carry, xs)
        parts.append(ys)
    z, log_pi = carry[0], carry[1]
    if not parts:
        rate = z.new_zeros(())
        return (z, rate, log_pi, z.new_zeros((0, *z.shape))) if collect_states else \
            (z, rate, log_pi)
    if any(ys is None for ys in parts):  # an exported loop keeps no per-step outputs
        if collect_states:
            raise NotImplementedError("an exported chain returns its last state only")
        return z, None, log_pi
    ys = tree_map(lambda *t: torch.cat(t), parts[0], *parts[1:])
    if collect_states:
        return z, ys[0].mean(), log_pi, ys[1]
    return z, ys.mean(), log_pi


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


STEP_MAJOR = ("gammas", "unifs", "jitters")  # draws laid out [S, n, ...]


def concat_rows(noises: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """One-row draws (of :func:`draw_hmc_noise`, :func:`draw_planned_noise`
    or :func:`~rlvae_tpu_torch.samplers.riemannian.draw_prior_noise`)
    stacked into one batch: the chains' ``gammas`` [S, n, D], ``unifs``
    [S, n] and ``jitters`` [S, n] along dim 1, every other draw along dim 0."""
    return {k: torch.cat([n[k] for n in noises], dim=1 if k in STEP_MAJOR else 0)
            for k in noises[0]}


# ---------------------------------------------------------------------------
# Adaptive manifold HMC (rlvae_tpu/samplers/hmc.py:209-696)
# ---------------------------------------------------------------------------

# the budgeted adaptive sampler's plan constants (rlvae_tpu/samplers/hmc.py:391-395)
ADAPTIVE_WARMUP_A = 40        # phase-A steps (rough eps, short trajectories)
ADAPTIVE_NLF_A = 5            # phase-A trajectory length
ADAPTIVE_TARGET_A = 0.75      # phase-A dual-averaging target
ADAPTIVE_TARGET = 0.65        # phase-B/C acceptance target
ADAPTIVE_EPS_JITTER = 0.2     # phase-C step-size jitter (Neal 2011 4.2)
# Nesterov dual averaging on log eps (Hoffman & Gelman 2014 3.2)
DA_GAMMA, DA_T0, DA_KAPPA = 0.05, 10.0, 0.75


def adaptive_warmup_b_steps(warmup_a: int) -> int:
    """Phase-B (re-tune at the sampling n_lf) step count."""
    return max(8, warmup_a // 3)


def jax_median(x: torch.Tensor) -> float:
    """``float(jnp.median(x))``: over an even count the two middle values'
    ``(lo + hi) * 0.5`` in fp32 (``torch.median`` returns the lower one);
    NaN if any entry is NaN."""
    flat = x.reshape(-1).float()
    if bool(torch.isnan(flat).any()):
        return float("nan")
    s = torch.sort(flat).values
    n = s.numel()
    return float((s[(n - 1) // 2] + s[n // 2]) * 0.5)


def sampling_n_lf(lam: float, eps_med: float, n_lf_max: int) -> int:
    """The sampling phase's trajectory length, the host-side decision of
    JAX's budget sampler and calibration: ``lam / median(eps)`` in Python
    floats, rounded half to even by ``round``, clipped to [2, n_lf_max]."""
    return int(np.clip(round(lam / max(eps_med, 1e-6)), 2, n_lf_max))


def _leapfrog(terms: Terms, z, rho, g, eps, n_lf: int):
    """``n_lf`` untempered leapfrog steps at step size ``eps`` ([B, 1] or a
    scalar tensor), carrying -grad."""
    for _ in range(n_lf):
        rho_half = rho - (eps / 2.0) * g
        z = z + eps * rho_half
        _, grad = terms(z)
        g = -grad
        rho = rho_half - (eps / 2.0) * g
    return z, rho, g


def _metropolis(terms: Terms, z0, log_pi0, g0, z, rho, h0, g, accept_u):
    """The adaptive and fixed chains' accept test: alpha = exp(min(h0 - h,
    0)), NaN (a diverged trajectory) counted as 0.  Returns ((z, log pi,
    -grad) after the test, accept, alpha)."""
    log_pi, _ = terms(z)
    h = -log_pi + 0.5 * (rho ** 2).sum(1)
    alpha = torch.exp(torch.minimum(h0 - h, h.new_zeros(())))
    alpha = torch.where(torch.isnan(alpha), torch.zeros_like(alpha), alpha)
    accept = accept_u < alpha
    return ((torch.where(accept[:, None], z, z0), torch.where(accept, log_pi, log_pi0),
             torch.where(accept[:, None], g, g0)), accept, alpha)


class DualAveraging(NamedTuple):
    """The dual-averaging constants of one adaptive run: ``mu`` = log(10
    eps0) ([B] or a scalar tensor, fp32), the target acceptance, the number
    of adapting steps, and whether each chain adapts its own eps."""
    mu: torch.Tensor
    target: float
    warmup: int
    per_chain: bool


# (z, log pi(z), -grad(z), x, x_bar, h_bar): the adaptive chain's carry
AdaptiveCarry = Tuple[torch.Tensor, ...]


def adaptive_mcmc_step(terms: Terms, carry: AdaptiveCarry, gamma: torch.Tensor,
                       accept_u: torch.Tensor, t: int, n_lf: int, da: DualAveraging):
    """MCMC step ``t`` of the adaptive chain from ``carry``: ``n_lf``
    leapfrog steps at eps = exp(x) while adapting (t < warmup), exp(x_bar)
    after; the accept test; then, while adapting, the dual-averaging update
    from the step's acceptance probability (per chain, or its mean).  The
    update's scalars are fp32 tensors on the chain's device, as JAX's weakly
    typed fp32 arithmetic computes them.  Returns (the next carry, accept,
    alpha)."""
    z0, log_pi0, g0, x, x_bar, h_bar = carry
    adapting = t < da.warmup
    eps = torch.exp(x if adapting else x_bar)
    eps_col = eps[:, None] if da.per_chain else eps
    rho = gamma
    h0 = -log_pi0 + 0.5 * (rho ** 2).sum(1)
    z, rho, g = _leapfrog(terms, z0, rho, g0, eps_col, n_lf)
    (z, log_pi, g), accept, alpha = _metropolis(terms, z0, log_pi0, g0, z, rho, h0, g, accept_u)
    if adapting:
        stat = alpha if da.per_chain else alpha.mean()
        t1 = torch.tensor(float(t), dtype=torch.float32, device=z.device) + 1.0
        t1_t0 = t1 + DA_T0
        h_bar = (1.0 - 1.0 / t1_t0) * h_bar + (da.target - stat) / t1_t0
        x = da.mu - torch.sqrt(t1) / t1.new_tensor(DA_GAMMA) * h_bar
        eta = t1 ** -DA_KAPPA
        x_bar = eta * x + (1.0 - eta) * x_bar
    return (z, log_pi, g, x, x_bar, h_bar), accept, alpha


def run_adaptive_prior_chain(terms: Terms, z0: torch.Tensor, gammas: torch.Tensor,
                             unifs: torch.Tensor, config: HMCConfig,
                             target_accept: float = 0.65, warmup: int = 50,
                             per_chain: bool = True, eps_init=None):
    """The prior chain with dual-averaging step-size adaptation on given
    noise: :func:`adaptive_mcmc_step` for each of the ``S`` steps, at
    ``config.n_lf`` leapfrog steps, no tempering.  ``eps_init`` (a scalar or
    [B]) warm-starts the step size, else ``config.eps_lf``.

    Returns ``(zs [S, B, D], diagnostics)``: ``accept_rate`` and
    ``accept_prob_mean`` over the steps from ``warmup`` on (the tail half
    when ``warmup >= S``), ``eps_final`` = exp(x_bar) and ``log_pi``."""
    dev = z0.device
    eps0 = torch.as_tensor(config.eps_lf if eps_init is None else eps_init,
                           dtype=torch.float32, device=dev)
    stat_shape = (z0.shape[0],) if per_chain else ()
    da = DualAveraging(torch.log(10.0 * eps0), float(target_accept), int(warmup), per_chain)
    log_eps0 = torch.broadcast_to(torch.log(eps0), stat_shape)
    log_pi, grad = terms(z0)
    carry = (z0, log_pi, -grad, log_eps0, log_eps0,
             torch.zeros(stat_shape, dtype=torch.float32, device=dev))
    zs, rates, alphas = [], [], []
    for t in range(gammas.shape[0]):
        carry, accept, alpha = adaptive_mcmc_step(terms, carry, gammas[t], unifs[t], t,
                                                  config.n_lf, da)
        zs.append(carry[0])
        rates.append(accept.float().mean())
        alphas.append(alpha.mean())
    steps = gammas.shape[0]
    cut = warmup if warmup < steps else steps // 2
    diagnostics = {
        "accept_rate": torch.stack(rates[cut:]).mean(),
        "accept_prob_mean": torch.stack(alphas[cut:]).mean(),
        "eps_final": torch.exp(carry[4]),
        "log_pi": carry[1],
    }
    return torch.stack(zs), diagnostics


# (z, log pi(z), -grad(z)): the fixed-eps chain's carry
FixedCarry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def fixed_mcmc_step(terms: Terms, carry: FixedCarry, gamma: torch.Tensor,
                    accept_u: torch.Tensor, eps: torch.Tensor, n_lf: int):
    """One plain HMC step at per-chain step sizes ``eps`` [B] (the tuned eps
    times that step's jitter).  Returns (the next carry, accept, alpha)."""
    z0, log_pi0, g0 = carry
    rho = gamma
    h0 = -log_pi0 + 0.5 * (rho ** 2).sum(1)
    z, rho, g = _leapfrog(terms, z0, rho, g0, eps[:, None], n_lf)
    return _metropolis(terms, z0, log_pi0, g0, z, rho, h0, g, accept_u)


def run_hmc_chain_fixed(terms: Terms, z0: torch.Tensor, gammas: torch.Tensor,
                        unifs: torch.Tensor, eps: torch.Tensor, n_lf: int,
                        jitters: Optional[torch.Tensor] = None):
    """Untempered HMC at fixed per-chain step sizes ``eps`` [B], each step's
    scaled by ``jitters`` [S, B] when given.  Returns ``(zs [S, B, D],
    accept_rate, log_pi_final)``."""
    eps = torch.as_tensor(eps, dtype=torch.float32, device=z0.device)
    if jitters is None:
        jitters = torch.ones(gammas.shape[:2], dtype=torch.float32, device=z0.device)
    log_pi, grad = terms(z0)
    carry = (z0, log_pi, -grad)
    zs, rates = [], []
    for s in range(gammas.shape[0]):
        carry, accept, _ = fixed_mcmc_step(terms, carry, gammas[s], unifs[s], eps * jitters[s],
                                           n_lf)
        zs.append(carry[0])
        rates.append(accept.float().mean())
    return torch.stack(zs), torch.stack(rates).mean(), carry[1]


def draw_jitters(generator: Optional[torch.Generator], steps: int, num_samples: int,
                 eps_jitter: float = ADAPTIVE_EPS_JITTER, device=None) -> torch.Tensor:
    """Per-step step-size factors ``1 + j (2u - 1)`` [S, n], u uniform."""
    u = torch.rand((steps, num_samples), generator=generator, device=device)
    return 1.0 + eps_jitter * (2.0 * u - 1.0)


def _on(metric: CentroidMetric, t: torch.Tensor) -> torch.Tensor:
    return t.to(device=metric.centroids.device, dtype=torch.float32)


def _starts(metric: CentroidMetric, num_samples: int, config: HMCConfig,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Chain starts by ``config.init``: centroids at uniform indices, or
    standard normal."""
    dev = metric.centroids.device
    if config.init == "centroids":
        idx = torch.randint(0, metric.n_centroids, (num_samples,), generator=generator,
                            device=dev)
        return metric.centroids[idx]
    return torch.randn((num_samples, metric.centroids.shape[1]), generator=generator,
                       device=dev)


def _drawn(noise: Optional[Mapping[str, torch.Tensor]], key: str, draw):
    """``noise[key]`` if given, else ``draw()``."""
    if noise is not None and key in noise:
        return noise[key]
    return draw()


def _phase_noise(metric: CentroidMetric, noise: Optional[Mapping[str, torch.Tensor]], tag: str,
                 steps: int, rows: int, generator: Optional[torch.Generator]):
    """A phase's (gammas, unifs): ``noise["gammas_<tag>"]`` and
    ``noise["unifs_<tag>"]`` if given, else drawn from ``generator``."""
    if noise is not None and f"gammas_{tag}" in noise:
        return _on(metric, noise[f"gammas_{tag}"]), _on(metric, noise[f"unifs_{tag}"])
    return draw_chain_noise(generator, steps, rows, metric.centroids.shape[1],
                            metric.centroids.device)


def sample_prior_hmc_adaptive(metric: CentroidMetric, num_samples: int,
                              config: HMCConfig = HMCConfig(), target_accept: float = 0.65,
                              warmup: Optional[int] = None, per_chain: bool = True,
                              return_chain: bool = False,
                              generator: Optional[torch.Generator] = None,
                              noise: Optional[Mapping[str, torch.Tensor]] = None):
    """Single-phase adaptive-HMC prior sampling: ``config.mcmc_steps`` steps
    of :func:`run_adaptive_prior_chain`, adapting for the first ``warmup``
    (default ``mcmc_steps // 2``).  The draws are ``z0`` (by
    ``config.init``), ``gammas`` and ``unifs``, taken from ``noise`` where
    given, else from ``generator`` in that order.  Returns the final draws
    [n, D], or with ``return_chain`` ``(zs [S, n, D], diagnostics)``."""
    d = metric.centroids.shape[1]
    if warmup is None:
        warmup = config.mcmc_steps // 2
    z0 = _drawn(noise, "z0", lambda: _starts(metric, num_samples, config, generator))
    gammas, unifs = (noise["gammas"], noise["unifs"]) if noise and "gammas" in noise else \
        draw_chain_noise(generator, config.mcmc_steps, num_samples, d, metric.centroids.device)
    zs, diagnostics = run_adaptive_prior_chain(
        _terms_fn(metric), _on(metric, z0), _on(metric, gammas), _on(metric, unifs), config,
        target_accept=target_accept, warmup=warmup, per_chain=per_chain)
    return (zs, diagnostics) if return_chain else zs[-1]


def sample_prior_hmc_adaptive_budget(
    metric: CentroidMetric, num_samples: int, config: HMCConfig = HMCConfig(),
    budget_lf: Optional[int] = None, path_length: Optional[float] = None,
    warmup: int = ADAPTIVE_WARMUP_A, n_lf_warmup: int = ADAPTIVE_NLF_A,
    warmup_target_accept: float = ADAPTIVE_TARGET_A, n_lf_max: int = 128,
    eps_jitter: float = ADAPTIVE_EPS_JITTER, return_chain: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Mapping[str, torch.Tensor]] = None,
):
    """The budgeted three-phase adaptive prior sampler
    (``rlvae_tpu/samplers/hmc.py:403-512``): A, dual averaging at
    ``n_lf_warmup`` leapfrog steps toward ``warmup_target_accept``; then on
    the host n_lf_s = round(path_length / median(eps_A)); B, re-tuning at
    n_lf_s from A's per-chain eps; C, ``steps_s = max(1, (budget - spent) //
    n_lf_s)`` fixed-eps steps with jitter, where ``budget`` defaults to the
    official chain's ``mcmc_steps * n_lf`` leapfrog steps per chain.

    The draws, taken from ``noise`` where given, else from ``generator`` in
    this order: ``z0``; ``gammas_a``, ``unifs_a`` [warmup, n]; ``gammas_b``,
    ``unifs_b`` [warm_b, n]; after the n_lf decision ``gammas_s``,
    ``unifs_s`` and ``jitters`` [steps_s, n].  The decision takes the median
    over all rows, so a row's result depends on the batch.

    Returns the final draws [n, D], or with ``return_chain`` ``(zs
    [steps_s, n, D], diagnostics)``."""
    dev = metric.centroids.device
    terms = _terms_fn(metric)
    budget = int(budget_lf if budget_lf is not None else config.mcmc_steps * config.n_lf)
    lam = float(path_length if path_length is not None else config.n_lf * config.eps_lf)
    warm_b = adaptive_warmup_b_steps(warmup)
    z0 = _on(metric, _drawn(noise, "z0", lambda: _starts(metric, num_samples, config, generator)))
    g_a, u_a = _phase_noise(metric, noise, "a", warmup, num_samples, generator)
    g_b, u_b = _phase_noise(metric, noise, "b", warm_b, num_samples, generator)

    zs_a, diag_a = run_adaptive_prior_chain(
        terms, z0, g_a, u_a, replace(config, mcmc_steps=warmup, n_lf=n_lf_warmup),
        target_accept=warmup_target_accept, warmup=warmup, per_chain=True)
    eps_a = diag_a["eps_final"]
    n_lf_s = sampling_n_lf(lam, jax_median(eps_a), n_lf_max)

    zs_b, diag_b = run_adaptive_prior_chain(
        terms, zs_a[-1], g_b, u_b, replace(config, mcmc_steps=warm_b, n_lf=n_lf_s),
        target_accept=ADAPTIVE_TARGET, warmup=warm_b, per_chain=True, eps_init=eps_a)
    eps = diag_b["eps_final"]

    spent_warm = warmup * n_lf_warmup + warm_b * n_lf_s
    steps_s = max(1, (budget - spent_warm) // n_lf_s)
    g_s, u_s = _phase_noise(metric, noise, "s", steps_s, num_samples, generator)
    jitters = _on(metric, _drawn(noise, "jitters", lambda: draw_jitters(
        generator, steps_s, num_samples, eps_jitter, dev)))
    if g_s.shape[0] != steps_s or jitters.shape[0] != steps_s:
        raise ValueError(f"the sampling phase takes {steps_s} steps (n_lf {n_lf_s}); the given "
                         f"draws have {g_s.shape[0]} and {jitters.shape[0]}")
    zs, rate, log_pi = run_hmc_chain_fixed(terms, zs_b[-1], g_s, u_s, eps, n_lf_s, jitters)
    if not return_chain:
        return zs[-1]
    return zs, {
        "accept_rate": rate,
        "eps_tuned": eps,
        "warmup_accept_rate": diag_b["accept_rate"],
        "n_lf_sampling": n_lf_s,
        "steps_sampling": steps_s,
        "leapfrog_spent": spent_warm + steps_s * n_lf_s,
        "log_pi": log_pi,
    }


def calibrate_adaptive_plan(
    metric: CentroidMetric, config: HMCConfig = HMCConfig(),
    path_length: Optional[float] = None, warmup: int = ADAPTIVE_WARMUP_A,
    n_lf_warmup: int = ADAPTIVE_NLF_A, n_lf_max: int = 128,
    pool_size: Optional[int] = None, spread_steps: int = 128,
    eps_jitter: float = ADAPTIVE_EPS_JITTER,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Mapping[str, torch.Tensor]] = None,
) -> dict:
    """One-time calibration of the adaptive prior sampler for ``metric``
    (``rlvae_tpu/samplers/hmc.py:515-599``): one warmup chain from each of
    the K centroids tunes a per-centroid eps (phase A at ``n_lf_warmup``,
    then phase B at the path-length-preserving n_lf), and with
    ``pool_size`` a warm-start pool: ``pool_size`` chains from uniform
    centroid starts run ``spread_steps`` fixed-eps steps at their
    centroid's eps, and their final states are kept.

    The draws, from ``noise`` where given, else from ``generator`` in this
    order: ``gammas_a``, ``unifs_a`` [warmup, K]; ``gammas_b``, ``unifs_b``
    [warm_b, K]; with a pool ``cidx`` [P] (centroid indices), ``gammas_p``,
    ``unifs_p`` [spread_steps, P] and ``jitters_p`` [spread_steps, P].

    Returns {"eps" [K], "n_lf", "accept_rate" (phase B's), "path_length",
    "calibration_lf", "chains"}, with a pool also "pool" [P, D] and
    "pool_eps" [P]; tensors on the metric's device."""
    dev = metric.centroids.device
    terms = _terms_fn(metric)
    lam = float(path_length if path_length is not None else config.n_lf * config.eps_lf)
    k = metric.n_centroids
    warm_b = adaptive_warmup_b_steps(warmup)
    g_a, u_a = _phase_noise(metric, noise, "a", warmup, k, generator)
    g_b, u_b = _phase_noise(metric, noise, "b", warm_b, k, generator)
    zs_a, diag_a = run_adaptive_prior_chain(
        terms, metric.centroids, g_a, u_a, replace(config, mcmc_steps=warmup, n_lf=n_lf_warmup),
        target_accept=ADAPTIVE_TARGET_A, warmup=warmup, per_chain=True)
    eps_a = diag_a["eps_final"]
    n_lf = sampling_n_lf(lam, jax_median(eps_a), n_lf_max)
    _, diag_b = run_adaptive_prior_chain(
        terms, zs_a[-1], g_b, u_b, replace(config, mcmc_steps=warm_b, n_lf=n_lf),
        target_accept=ADAPTIVE_TARGET, warmup=warm_b, per_chain=True, eps_init=eps_a)
    plan = {
        "eps": diag_b["eps_final"],
        "n_lf": n_lf,
        "accept_rate": float(diag_b["accept_rate"]),
        "path_length": lam,
        "calibration_lf": k * (warmup * n_lf_warmup + warm_b * n_lf),
        "chains": k,
    }
    if pool_size:
        cidx = _drawn(noise, "cidx", lambda: torch.randint(
            0, k, (pool_size,), generator=generator, device=dev)).to(dev).long()
        g_p, u_p = _phase_noise(metric, noise, "p", spread_steps, pool_size, generator)
        jit_p = _on(metric, _drawn(noise, "jitters_p", lambda: draw_jitters(
            generator, spread_steps, pool_size, eps_jitter, dev)))
        eps_p = plan["eps"][cidx]
        zs_p, _, _ = run_hmc_chain_fixed(terms, metric.centroids[cidx], g_p, u_p, eps_p, n_lf,
                                         jit_p)
        plan["pool"] = zs_p[-1]
        plan["pool_eps"] = eps_p
        plan["calibration_lf"] += pool_size * spread_steps * n_lf
    return plan


def draw_planned_noise(metric: CentroidMetric, num_samples: int, plan: Mapping[str, Any],
                       steps: int = 12, eps_jitter: float = ADAPTIVE_EPS_JITTER,
                       generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """The draws of :func:`sample_prior_hmc_planned`, in order: ``idx`` [n]
    (into the plan's pool: a permutation's first n entries when n <= P,
    uniform with replacement otherwise; without a pool, uniform centroid
    indices), ``gammas`` [S, n, D], ``unifs`` [S, n], ``jitters`` [S, n],
    all on the metric's device."""
    dev = metric.centroids.device
    if "pool" in plan:
        p = plan["pool"].shape[0]
        if num_samples <= p:
            idx = torch.randperm(p, generator=generator, device=dev)[:num_samples]
        else:
            idx = torch.randint(0, p, (num_samples,), generator=generator, device=dev)
    else:
        idx = torch.randint(0, metric.n_centroids, (num_samples,), generator=generator,
                            device=dev)
    gammas, unifs = draw_chain_noise(generator, steps, num_samples, metric.centroids.shape[1],
                                     dev)
    return {"idx": idx, "gammas": gammas, "unifs": unifs,
            "jitters": draw_jitters(generator, steps, num_samples, eps_jitter, dev)}


def planned_starts(metric: CentroidMetric, plan: Mapping[str, Any],
                   idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z0, eps) of the chains at ``idx``: pool states and their eps, or
    centroids and the plan's per-centroid eps without a pool."""
    idx = idx.to(metric.centroids.device).long()
    if "pool" in plan:
        return _on(metric, plan["pool"])[idx], _on(metric, plan["pool_eps"])[idx]
    return metric.centroids[idx], _on(metric, plan["eps"])[idx]


def sample_prior_hmc_planned(metric: CentroidMetric, num_samples: int, plan: Mapping[str, Any],
                             steps: int = 12, eps_jitter: float = ADAPTIVE_EPS_JITTER,
                             return_chain: bool = False,
                             generator: Optional[torch.Generator] = None,
                             noise: Optional[Mapping[str, torch.Tensor]] = None):
    """Prior sampling from a calibrated plan (``rlvae_tpu/samplers/hmc.py:
    602-653``): ``steps`` fixed-eps HMC steps with jitter at the plan's
    n_lf, from the plan's pool (or from centroids with their eps).  The
    draws are those of :func:`draw_planned_noise`, from ``noise`` or
    ``generator``; rows are independent.  Returns the final draws [n, D],
    or with ``return_chain`` ``(zs [S, n, D], {"accept_rate", "log_pi"})``."""
    if noise is None:
        noise = draw_planned_noise(metric, num_samples, plan, steps, eps_jitter, generator)
    z0, eps = planned_starts(metric, plan, noise["idx"])
    zs, rate, log_pi = run_hmc_chain_fixed(
        _terms_fn(metric), z0, _on(metric, noise["gammas"]), _on(metric, noise["unifs"]), eps,
        int(plan["n_lf"]), _on(metric, noise["jitters"]))
    if return_chain:
        return zs, {"accept_rate": rate, "log_pi": log_pi}
    return zs[-1]


# ---------------------------------------------------------------------------
# Posterior HMC (rlvae_tpu/samplers/hmc.py:699-768)
# ---------------------------------------------------------------------------


def refuse_grad_through_terms(metric: CentroidMetric, *tensors: torch.Tensor) -> None:
    """The HMC terms kernel (B4) has no backward, as JAX's Pallas kernel has
    none: a chain on non-CPU tensors that autograd would differentiate
    raises instead of giving a silent zero gradient through the target.  On
    the CPU, and past the kernel's envelope (D > 32: the plain terms, as
    JAX's XLA route there), the terms are differentiable, as JAX's XLA terms
    are."""
    if not fused_supported(metric.latent_dim):
        return
    if torch.is_grad_enabled() and any(t.requires_grad and t.device.type != "cpu"
                                       for t in tensors):
        raise NotImplementedError(
            "the posterior HMC chain has no gradient on the card: the hmc_terms kernel (B4) "
            "has no backward (JAX's hmc_terms_pallas has no VJP either); run it under "
            "torch.no_grad() or on CPU tensors (ROADMAP queue A1)")


def draw_posterior_hmc_noise(batch: int, latent_dim: int, n_steps: int = 20,
                             generator: Optional[torch.Generator] = None,
                             device=None) -> Dict[str, torch.Tensor]:
    """The posterior chain's draws, in order: ε [B, D] for the start, then
    the momenta ``gammas`` [n_steps, B, D]."""
    eps = torch.randn((batch, latent_dim), generator=generator, device=device)
    gammas = torch.randn((n_steps, batch, latent_dim), generator=generator, device=device)
    return {"eps": eps, "gammas": gammas}


def posterior_hmc_step(terms: Terms, z: torch.Tensor, gamma: torch.Tensor, mu: torch.Tensor,
                       inv_var: torch.Tensor, n_lf: int = 5, eps_lf: float = 0.01) -> torch.Tensor:
    """One step of the posterior chain from ``z``: momentum 0.1 ``gamma``,
    then ``n_lf`` leapfrog steps on the energy's gradient -grad log pi(z) +
    (z - mu) ``inv_var``, evaluated twice per leapfrog step as JAX writes
    it.  The position update subtracts eps_lf rho, the reference's quirk,
    kept: with a large ``inv_var`` the chain diverges, in JAX as here."""
    return _posterior_leapfrogs(terms, z, gamma, mu, inv_var, n_lf, eps_lf)[0]


def _posterior_leapfrogs(terms: Terms, z, gamma, mu, inv_var, n_lf: int, eps_lf: float):
    """:func:`posterior_hmc_step`'s leapfrog steps: (z, rho) at their end."""

    def grad_e(z):
        _, grad_log_pi = terms(z)
        return -grad_log_pi + (z - mu) * inv_var

    rho = gamma * 0.1
    for _ in range(n_lf):
        rho = rho - (eps_lf / 2.0) * grad_e(z)
        z = z - eps_lf * rho  # the reference's quirk: minus
        rho = rho - (eps_lf / 2.0) * grad_e(z)
    return z, rho


def sample_posterior_hmc(metric: CentroidMetric, mu: torch.Tensor, log_var: torch.Tensor,
                         eps: torch.Tensor, gammas: torch.Tensor, n_lf: int = 5,
                         eps_lf: float = 0.01) -> torch.Tensor:
    """Posterior-tempered HMC from z = mu + ε σ: one
    :func:`posterior_hmc_step` for each of the ``gammas`` (200 terms calls
    at 20 x 5), through :func:`loop_steps` (one loop op in an exported
    program)."""
    refuse_grad_through_terms(metric, mu, log_var)
    terms = _terms_fn(metric)
    inv_var = torch.exp(-log_var)
    z = mu + eps.to(mu) * torch.exp(0.5 * log_var)
    gammas = gammas.to(mu)
    if not gammas.shape[0]:
        return z

    def step(carry, x):
        # the last momentum rides in the carry: a program would otherwise drop
        # the step's last gradient evaluation as dead code, and launch 180
        # terms where the eager chain launches 200
        return _posterior_leapfrogs(terms, carry[0], x[0], mu, inv_var, n_lf, eps_lf), ()

    return loop_steps(step, (z, torch.zeros_like(z)), (gammas,))[0][0]


def refine_for_training(metric: CentroidMetric, mu: torch.Tensor, log_var: torch.Tensor,
                        eps: torch.Tensor, n_steps: int = 3,
                        step_size: float = 0.01) -> torch.Tensor:
    """The training refinement (``rlvae_tpu/samplers/hmc.py:749-768``): z =
    mu + ε σ, then ``n_steps`` of z += step_size (-grad log pi), one terms
    call each."""
    refuse_grad_through_terms(metric, mu, log_var)
    terms = _terms_fn(metric)
    z = mu + eps.to(mu) * torch.exp(0.5 * log_var)
    for _ in range(n_steps):
        _, grad = terms(z)
        z = z + step_size * (-grad)
    return z
