"""CNN encoder and decoder.

Port of ``rlvae_tpu/nets/cnn.py``.  Encoder: per stage a 3x3 stride-2
convolution with explicit (1, 1) padding, BatchNorm, leaky ReLU (0.01) and
dropout, then flatten -> 512 -> 256 (ReLU, dropout) and the fp32
``embedding``/``log_var`` heads.  Decoder: latent -> 512 -> 256 (ReLU,
dropout) -> ``expand`` to the seed grid H/2^n x W/2^n, per stage a SAME
transposed convolution (stride 2), BatchNorm, ReLU and dropout, and
``deconv_out`` to the image's channels in ``out_dtype``, with no output
activation.  Convolutions run in ``dtype`` (bf16 by default), BatchNorm in
fp32 (:mod:`.layers`).

Activations are NCHW; the flatten before ``head_0`` and the reshape after
``expand`` follow JAX's NHWC order, so the dense kernels carry across
unchanged.  ``forward(x, train=False, masks=None)``: ``train`` selects the
batch statistics (and updates the running ones) and turns dropout on, with
keep-masks from ``masks`` (:class:`~.layers.DropoutMasks`).  Layer names
are the Flax modules' (``conv_0``, ``bn_0``, ``head_0``, ``embedding``,
``log_var``; ``expand``, ``deconv_0``, ``deconv_out``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rlvae_tpu_torch.nets.layers import (
    BatchNorm,
    Conv,
    ConvTranspose,
    MaskFn,
    dense,
    dropout,
    init_net,
)


def _conv_out(n: int, k: int, s: int, lo: int = 1, hi: int = 1) -> int:
    return (n + lo + hi - k) // s + 1


class CNNEncoder(nn.Module):
    def __init__(self, input_dim: Tuple[int, int, int], latent_dim: int,
                 hidden_dims: Sequence[int] = (32, 64, 128, 256), kernel_size: int = 3,
                 stride: int = 2, dropout: float = 0.1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.input_dim, self.latent_dim = tuple(input_dim), latent_dim
        self.hidden_dims, self.dropout, self.dtype = tuple(hidden_dims), float(dropout), dtype
        c, h, w = self.input_dim
        for i, ch in enumerate(self.hidden_dims):
            setattr(self, f"conv_{i}", Conv(c, ch, kernel_size, stride, ((1, 1), (1, 1)), dtype))
            setattr(self, f"bn_{i}", BatchNorm(ch))
            c, h, w = ch, _conv_out(h, kernel_size, stride), _conv_out(w, kernel_size, stride)
        self.head_0 = nn.Linear(c * h * w, 512)
        self.head_1 = nn.Linear(512, 256)
        self.embedding = nn.Linear(256, latent_dim)
        self.log_var = nn.Linear(256, latent_dim)
        init_net(self, torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor, train: bool = False,
                masks: Optional[MaskFn] = None) -> Dict[str, torch.Tensor]:
        out = x.to(self.dtype)
        for i in range(len(self.hidden_dims)):
            out = getattr(self, f"bn_{i}")(getattr(self, f"conv_{i}")(out), train)
            out = dropout(F.leaky_relu(out.to(self.dtype), 0.01), self.dropout, train, masks)
        out = out.permute(0, 2, 3, 1).reshape(out.shape[0], -1)  # JAX's NHWC flatten
        for layer in (self.head_0, self.head_1):
            out = dropout(torch.relu(dense(layer, out, self.dtype)), self.dropout, train, masks)
        return {"embedding": dense(self.embedding, out, torch.float32),
                "log_covariance": dense(self.log_var, out, torch.float32)}


class CNNDecoder(nn.Module):
    def __init__(self, input_dim: Tuple[int, int, int], latent_dim: int,
                 hidden_dims: Sequence[int] = (256, 128, 64, 32), kernel_size: int = 3,
                 stride: int = 2, dropout: float = 0.1, dtype: torch.dtype = torch.bfloat16,
                 out_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_dim, self.latent_dim = tuple(input_dim), latent_dim
        self.hidden_dims, self.dropout = tuple(hidden_dims), float(dropout)
        self.dtype, self.out_dtype = dtype, out_dtype
        c, height, width = self.input_dim
        n = len(self.hidden_dims)
        self.seed_hw = (height // 2 ** n, width // 2 ** n)
        self.head_0 = nn.Linear(latent_dim, 512)
        self.head_1 = nn.Linear(512, 256)
        self.expand = nn.Linear(256, self.hidden_dims[0] * self.seed_hw[0] * self.seed_hw[1])
        for i, (cin, cout) in enumerate(zip(self.hidden_dims, self.hidden_dims[1:])):
            setattr(self, f"deconv_{i}", ConvTranspose(cin, cout, kernel_size, stride, dtype))
            setattr(self, f"bn_{i}", BatchNorm(cout))
        self.deconv_out = ConvTranspose(self.hidden_dims[-1], c, kernel_size, stride, out_dtype)
        init_net(self, torch.Generator().manual_seed(0))

    def forward(self, z: torch.Tensor, train: bool = False,
                masks: Optional[MaskFn] = None) -> Dict[str, torch.Tensor]:
        out = z.to(self.dtype)
        for layer in (self.head_0, self.head_1):
            out = dropout(torch.relu(dense(layer, out, self.dtype)), self.dropout, train, masks)
        out = dense(self.expand, out, self.dtype)
        out = out.reshape(out.shape[0], *self.seed_hw, self.hidden_dims[0]).permute(0, 3, 1, 2)
        for i in range(len(self.hidden_dims) - 1):
            out = getattr(self, f"bn_{i}")(getattr(self, f"deconv_{i}")(out), train)
            out = dropout(torch.relu(out.to(self.dtype)), self.dropout, train, masks)
        return {"reconstruction": self.deconv_out(out).contiguous()}
