"""Encoder and decoder networks."""

from rlvae_tpu_torch.nets.mlp import MLPDecoder, MLPEncoder
from rlvae_tpu_torch.nets.registry import create_decoder, create_encoder

__all__ = ["MLPDecoder", "MLPEncoder", "create_decoder", "create_encoder"]
