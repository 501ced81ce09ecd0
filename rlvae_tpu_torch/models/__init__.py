"""The Riemannian Flow VAE and its factory."""

from rlvae_tpu_torch.models.factory import PRESETS, create_hybrid_model, create_model
from rlvae_tpu_torch.models.rlvae import RlVAE

__all__ = ["PRESETS", "RlVAE", "create_hybrid_model", "create_model"]
