"""Posterior and prior sampling, the manifold-HMC chains (official, adaptive,
planned, posterior) and the generation-sampler zoo."""

from rlvae_tpu_torch.samplers.generation import (
    SAMPLER_REGISTRY,
    AdaptiveRHVAEGenerationSampler,
    BaseGenerationSampler,
    NormalSampler,
    RHVAEGenerationSampler,
    VampSampler,
)
from rlvae_tpu_torch.samplers.hmc import (
    HMCConfig,
    adaptive_mcmc_step,
    calibrate_adaptive_plan,
    concat_rows,
    draw_chain_noise,
    draw_hmc_noise,
    draw_planned_noise,
    fixed_mcmc_step,
    mcmc_step,
    posterior_hmc_step,
    refine_for_training,
    run_adaptive_prior_chain,
    run_hmc_chain_fixed,
    run_prior_chain,
    sample_posterior_hmc,
    sample_prior_hmc,
    sample_prior_hmc_adaptive,
    sample_prior_hmc_adaptive_budget,
    sample_prior_hmc_planned,
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
    "AdaptiveRHVAEGenerationSampler", "BaseGenerationSampler", "HMCConfig", "NormalSampler",
    "POSTERIOR_METHODS", "PRIOR_METHODS", "RHVAEGenerationSampler", "SAMPLER_REGISTRY",
    "adaptive_mcmc_step", "calibrate_adaptive_plan", "concat_rows", "draw_chain_noise",
    "draw_hmc_noise", "draw_planned_noise", "draw_posterior_noise", "draw_prior_noise",
    "fixed_mcmc_step", "mcmc_step", "posterior_hmc_step", "refine_for_training", "reparam",
    "run_adaptive_prior_chain", "run_hmc_chain_fixed", "run_prior_chain",
    "sample_metric_aware_posterior", "sample_posterior", "sample_posterior_hmc",
    "sample_prior", "sample_prior_hmc", "sample_prior_hmc_adaptive",
    "sample_prior_hmc_adaptive_budget", "sample_prior_hmc_planned", "tempering", "VampSampler",
]
