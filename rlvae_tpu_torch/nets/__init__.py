"""Encoder and decoder networks: MLP, CNN and ResNet."""

from rlvae_tpu_torch.nets.cnn import CNNDecoder, CNNEncoder
from rlvae_tpu_torch.nets.layers import DropoutMasks
from rlvae_tpu_torch.nets.mlp import MLPDecoder, MLPEncoder
from rlvae_tpu_torch.nets.registry import create_decoder, create_encoder
from rlvae_tpu_torch.nets.resnet import ResidualBlock, ResNetDecoder, ResNetEncoder

__all__ = ["CNNDecoder", "CNNEncoder", "DropoutMasks", "MLPDecoder", "MLPEncoder",
           "ResNetDecoder", "ResNetEncoder", "ResidualBlock", "create_decoder",
           "create_encoder"]
