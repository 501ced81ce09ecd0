"""Encoder and decoder networks: MLP, CNN and ResNet, and the research
heads ``SVAEEncoderMLP`` and ``DiscriminatorMLP``."""

from rlvae_tpu_torch.nets.cnn import CNNDecoder, CNNEncoder
from rlvae_tpu_torch.nets.layers import DropoutMasks
from rlvae_tpu_torch.nets.mlp import DiscriminatorMLP, MLPDecoder, MLPEncoder, SVAEEncoderMLP
from rlvae_tpu_torch.nets.registry import create_decoder, create_encoder
from rlvae_tpu_torch.nets.resnet import ResidualBlock, ResNetDecoder, ResNetEncoder

__all__ = ["CNNDecoder", "CNNEncoder", "DiscriminatorMLP", "DropoutMasks", "MLPDecoder",
           "MLPEncoder", "SVAEEncoderMLP",
           "ResNetDecoder", "ResNetEncoder", "ResidualBlock", "create_decoder",
           "create_encoder"]
