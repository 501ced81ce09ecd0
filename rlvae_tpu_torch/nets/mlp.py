"""MLP encoder and decoder, the default architectures.

Port of ``rlvae_tpu/nets/mlp.py:27-76``: flatten -> 512 -> ReLU ->
{embedding, log_var} heads, and latent -> 512 -> ReLU -> C*H*W -> sigmoid.
The dtype policy is the JAX package's: parameters stay fp32; the hidden
layers run in ``dtype`` (bf16 by default: inputs and parameters cast, as a
Flax ``Dense(dtype=...)`` does); the encoder heads run in fp32 and the
decoder's output layer in ``out_dtype`` (fp32 by default).
``MLPDecoder.hidden`` is the decoder's hidden stack alone: the fused
decode+MSE loss (``RlVAE`` with ``fused_decode_mse``) takes the output layer
from there, as ``_fused_recon_loss`` of the JAX package recomputes it.

Layers are named as the Flax modules (``hidden_0``, ``embedding``,
``log_var``, ``out``) so the converted ``.npz`` keys map one to one.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Flax ``Dense(dtype=dtype)``: input and parameters cast to ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class MLPEncoder(nn.Module):
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
        self.log_var = nn.Linear(fan_in, latent_dim)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = x.reshape(x.shape[0], -1)
        for i in range(len(self.hidden_dims)):
            out = torch.relu(_dense(getattr(self, f"hidden_{i}"), out, self.dtype))
        return {
            "embedding": _dense(self.embedding, out, torch.float32),
            "log_covariance": _dense(self.log_var, out, torch.float32),
        }


class MLPDecoder(nn.Module):
    def __init__(self, input_dim: Tuple[int, ...], latent_dim: int,
                 hidden_dims: Sequence[int] = (512,), dtype: torch.dtype = torch.bfloat16,
                 out_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_dim = tuple(input_dim)
        self.latent_dim = latent_dim
        self.hidden_dims = tuple(hidden_dims)
        self.dtype = dtype
        self.out_dtype = out_dtype
        fan_in = latent_dim
        for i, h in enumerate(self.hidden_dims):
            setattr(self, f"hidden_{i}", nn.Linear(fan_in, h))
            fan_in = h
        self.out = nn.Linear(fan_in, int(np.prod(self.input_dim)))

    def hidden(self, z: torch.Tensor) -> torch.Tensor:
        """The last hidden layer's activations [B, hidden_dims[-1]], in ``dtype``."""
        out = z.to(self.dtype)
        for i in range(len(self.hidden_dims)):
            out = torch.relu(_dense(getattr(self, f"hidden_{i}"), out, self.dtype))
        return out

    def forward(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = _dense(self.out, self.hidden(z), self.out_dtype)
        return {"reconstruction": torch.sigmoid(out).reshape(z.shape[0], *self.input_dim)}
