"""The Riemannian Flow VAE, its factory and the comparison-study helpers."""

from rlvae_tpu_torch.models.factory import (
    PRESETS,
    VANILLA_OVERRIDES,
    apply_model_overrides,
    create_comparison_suite,
    create_hybrid_model,
    create_model,
)
from rlvae_tpu_torch.models.metrics import MetricsCollector
from rlvae_tpu_torch.models.rlvae import RlVAE

__all__ = ["MetricsCollector", "PRESETS", "RlVAE", "VANILLA_OVERRIDES", "apply_model_overrides",
           "create_comparison_suite", "create_hybrid_model", "create_model"]
