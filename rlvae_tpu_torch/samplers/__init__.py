"""Posterior sampling."""

from rlvae_tpu_torch.samplers.riemannian import reparam, sample_metric_aware_posterior

__all__ = ["reparam", "sample_metric_aware_posterior"]
