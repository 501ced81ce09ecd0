"""MLP encoder and decoder, the default architectures, and the research heads.

Port of ``rlvae_tpu/nets/mlp.py``: flatten -> 512 -> ReLU ->
{embedding, log_var} heads, and latent -> 512 -> ReLU -> C*H*W -> sigmoid
(:27-76); :class:`SVAEEncoderMLP` (a von Mises-Fisher posterior's
{embedding, log_concentration}) and :class:`DiscriminatorMLP` (an
adversarial head, flatten -> 256 -> ReLU -> 1 -> sigmoid, its hidden
activations exposed as ``embedding_layer_<i>``) (:77-119).
With ``dropout`` > 0 every hidden layer is followed by dropout in a train
forward (``forward(x, train=True, masks=...)``; :mod:`.layers`).
The dtype policy is the JAX package's: parameters stay fp32; the hidden
layers run in ``dtype`` (bf16 by default: inputs and parameters cast, as a
Flax ``Dense(dtype=...)`` does); the encoder heads run in fp32 and the
decoder's output layer in ``out_dtype`` (fp32 by default).
``MLPDecoder.hidden`` is the decoder's hidden stack alone: the fused
decode+MSE loss (``RlVAE`` with ``fused_decode_mse``) takes the output layer
from there, as ``_fused_recon_loss`` of the JAX package recomputes it.

Layers are named as the Flax modules (``hidden_0``, ``embedding``,
``log_var``, ``log_concentration``, ``out``) so the converted ``.npz`` keys
and Flax ``params`` map one to one (``convert.net_state_from_flax``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from rlvae_tpu_torch.nets.layers import MaskFn, dense, dropout


class MLPEncoder(nn.Module):
    def __init__(self, input_dim: Tuple[int, ...], latent_dim: int,
                 hidden_dims: Sequence[int] = (512,), dtype: torch.dtype = torch.bfloat16,
                 dropout: float = 0.0):
        super().__init__()
        self.input_dim = tuple(input_dim)
        self.latent_dim = latent_dim
        self.hidden_dims = tuple(hidden_dims)
        self.dtype = dtype
        self.dropout = float(dropout)
        fan_in = int(np.prod(self.input_dim))
        for i, h in enumerate(self.hidden_dims):
            setattr(self, f"hidden_{i}", nn.Linear(fan_in, h))
            fan_in = h
        self.embedding = nn.Linear(fan_in, latent_dim)
        self.log_var = nn.Linear(fan_in, latent_dim)

    def forward(self, x: torch.Tensor, train: bool = False,
                masks: Optional[MaskFn] = None) -> Dict[str, torch.Tensor]:
        out = x.reshape(x.shape[0], -1)
        for i in range(len(self.hidden_dims)):
            out = torch.relu(dense(getattr(self, f"hidden_{i}"), out, self.dtype))
            out = dropout(out, self.dropout, train, masks)
        return {
            "embedding": dense(self.embedding, out, torch.float32),
            "log_covariance": dense(self.log_var, out, torch.float32),
        }


class MLPDecoder(nn.Module):
    def __init__(self, input_dim: Tuple[int, ...], latent_dim: int,
                 hidden_dims: Sequence[int] = (512,), dtype: torch.dtype = torch.bfloat16,
                 out_dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.input_dim = tuple(input_dim)
        self.latent_dim = latent_dim
        self.hidden_dims = tuple(hidden_dims)
        self.dtype = dtype
        self.out_dtype = out_dtype
        self.dropout = float(dropout)
        fan_in = latent_dim
        for i, h in enumerate(self.hidden_dims):
            setattr(self, f"hidden_{i}", nn.Linear(fan_in, h))
            fan_in = h
        self.out = nn.Linear(fan_in, int(np.prod(self.input_dim)))

    def hidden(self, z: torch.Tensor, train: bool = False,
               masks: Optional[MaskFn] = None) -> torch.Tensor:
        """The last hidden layer's activations [B, hidden_dims[-1]], in ``dtype``."""
        out = z.to(self.dtype)
        for i in range(len(self.hidden_dims)):
            out = torch.relu(dense(getattr(self, f"hidden_{i}"), out, self.dtype))
            out = dropout(out, self.dropout, train, masks)
        return out

    def forward(self, z: torch.Tensor, train: bool = False,
                masks: Optional[MaskFn] = None) -> Dict[str, torch.Tensor]:
        out = dense(self.out, self.hidden(z, train, masks), self.out_dtype)
        return {"reconstruction": torch.sigmoid(out).reshape(z.shape[0], *self.input_dim)}


class SVAEEncoderMLP(nn.Module):
    """Hyperspherical-VAE encoder head: flatten -> 512 -> ReLU ->
    {embedding [B, D], log_concentration [B, 1]}, both heads in fp32."""

    def __init__(self, input_dim: Tuple[int, ...], latent_dim: int,
                 hidden_dims: Sequence[int] = (512,), dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.input_dim = tuple(input_dim)
        self.latent_dim = latent_dim
        self.hidden_dims = tuple(hidden_dims)
        self.dtype = dtype
        fan_in = int(np.prod(self.input_dim))
        for i, h in enumerate(self.hidden_dims):
            setattr(self, f"hidden_{i}", nn.Linear(fan_in, h))
            fan_in = h
        self.embedding = nn.Linear(fan_in, latent_dim)
        self.log_concentration = nn.Linear(fan_in, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = x.reshape(x.shape[0], -1).to(self.dtype)
        for i in range(len(self.hidden_dims)):
            out = torch.relu(dense(getattr(self, f"hidden_{i}"), out, self.dtype))
        return {"embedding": dense(self.embedding, out, torch.float32),
                "log_concentration": dense(self.log_concentration, out, torch.float32)}


class DiscriminatorMLP(nn.Module):
    """Adversarial discriminator head: flatten -> 256 -> ReLU -> 1 ->
    sigmoid (``embedding``), each hidden layer's activations under
    ``embedding_layer_<i>`` (i from 1)."""

    def __init__(self, discriminator_input_dim: Tuple[int, ...],
                 hidden_dims: Sequence[int] = (256,), dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.discriminator_input_dim = tuple(discriminator_input_dim)
        self.hidden_dims = tuple(hidden_dims)
        self.dtype = dtype
        fan_in = int(np.prod(self.discriminator_input_dim))
        for i, h in enumerate(self.hidden_dims):
            setattr(self, f"hidden_{i}", nn.Linear(fan_in, h))
            fan_in = h
        self.out = nn.Linear(fan_in, 1)

    def forward(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = z.reshape(z.shape[0], -1).to(self.dtype)
        inter = {}
        for i in range(len(self.hidden_dims)):
            out = torch.relu(dense(getattr(self, f"hidden_{i}"), out, self.dtype))
            inter[f"embedding_layer_{i + 1}"] = out
        return {"embedding": torch.sigmoid(dense(self.out, out, torch.float32)), **inter}
