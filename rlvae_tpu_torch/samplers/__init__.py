"""Posterior and prior sampling, and the manifold-HMC prior chain."""

from rlvae_tpu_torch.samplers.hmc import (
    HMCConfig,
    concat_rows,
    draw_chain_noise,
    draw_hmc_noise,
    mcmc_step,
    run_prior_chain,
    sample_prior_hmc,
    tempering,
)
from rlvae_tpu_torch.samplers.riemannian import (
    POSTERIOR_METHODS,
    PRIOR_METHODS,
    draw_posterior_noise,
    draw_prior_noise,
    reparam,
    sample_metric_aware_posterior,
    sample_posterior,
    sample_prior,
)

__all__ = [
    "HMCConfig", "POSTERIOR_METHODS", "PRIOR_METHODS", "concat_rows", "draw_chain_noise",
    "draw_hmc_noise", "draw_posterior_noise", "draw_prior_noise", "mcmc_step", "reparam",
    "run_prior_chain", "sample_metric_aware_posterior", "sample_posterior", "sample_prior",
    "sample_prior_hmc", "tempering",
]
