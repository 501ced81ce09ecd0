"""ResNet encoder and decoder.

Port of ``rlvae_tpu/nets/resnet.py``.  :class:`ResidualBlock`: conv1 (3x3,
SAME, stride s), BatchNorm, ReLU, conv2 (3x3, SAME), BatchNorm, plus the
input, or its 1x1 stride-s ``proj`` where the shapes differ, then ReLU.
Encoder: the 7x7 stride-2 ``stem`` (padding 3), ``stem_bn``, ReLU, a 3x3
stride-2 max pool (padding 1), stages ``stage{i}_block{j}`` of
``num_blocks`` blocks (the first of each at stride 2), the global average
pool, 512 -> 256 (ReLU, dropout) and the fp32 heads.  Decoder: latent ->
1024 -> 512 (ReLU, dropout) -> ``expand`` to the seed grid H/2^(n+1) (at
least 1), ``up0`` (4x4 transposed, stride 2) with ``up0_bn``, then per stage
``up{i+1}`` (3x3 transposed) with its BatchNorm and blocks, and ``final``
(4x4 transposed, in ``out_dtype``), cropped to the image size for tiny
images; no output activation.

As in :mod:`.cnn`: NCHW activations with JAX's NHWC order kept at
``expand``, ``forward(x, train=False, masks=None)``, and the Flax layer
names (:mod:`.layers` for the arithmetic).
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


class ResidualBlock(nn.Module):
    """``proj``: the 1x1 projection shortcut, which JAX adds where the
    block's output shape differs from its input's (a channel change, or a
    stride on an input larger than 1x1)."""

    def __init__(self, in_ch: int, channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16, proj: bool = False):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(in_ch, channels, 3, stride, "SAME", dtype)
        self.bn1 = BatchNorm(channels)
        self.conv2 = Conv(channels, channels, 3, 1, "SAME", dtype)
        self.bn2 = BatchNorm(channels)
        self.proj = Conv(in_ch, channels, 1, stride, "SAME", dtype) if proj else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x), train).to(self.dtype))
        out = self.bn2(self.conv2(out), train)
        residual = x if self.proj is None else self.proj(x)
        if residual.shape != out.shape:
            raise ValueError(f"residual {tuple(residual.shape)} vs {tuple(out.shape)}")
        return torch.relu((out + residual).to(self.dtype))


def _blocks(num_blocks: Sequence[int], stage: int) -> int:
    return num_blocks[min(stage, len(num_blocks) - 1)]


class ResNetEncoder(nn.Module):
    def __init__(self, input_dim: Tuple[int, int, int], latent_dim: int,
                 hidden_dims: Sequence[int] = (64, 128, 256, 512),
                 num_blocks: Sequence[int] = (2, 2, 2, 2), dropout: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.input_dim, self.latent_dim = tuple(input_dim), latent_dim
        self.hidden_dims, self.num_blocks = tuple(hidden_dims), tuple(num_blocks)
        self.dropout, self.dtype = float(dropout), dtype
        self.stem = Conv(self.input_dim[0], self.hidden_dims[0], 7, 2, ((3, 3), (3, 3)), dtype)
        self.stem_bn = BatchNorm(self.hidden_dims[0])
        self.block_names = []
        cin = self.hidden_dims[0]
        # spatial size after the stem (7x7, s2, pad 3) and the pool (3x3, s2, pad 1)
        hw = [((n - 1) // 2) // 2 + 1 for n in self.input_dim[1:]]
        for si, ch in enumerate(self.hidden_dims[1:]):
            for bi in range(_blocks(self.num_blocks, si)):
                stride = 2 if bi == 0 else 1
                out_hw = [-(-n // stride) for n in hw]
                name = f"stage{si}_block{bi}"
                setattr(self, name, ResidualBlock(cin, ch, stride, dtype,
                                                  proj=cin != ch or out_hw != hw))
                self.block_names.append(name)
                cin, hw = ch, out_hw
        self.head_0 = nn.Linear(cin, 512)
        self.head_1 = nn.Linear(512, 256)
        self.embedding = nn.Linear(256, latent_dim)
        self.log_var = nn.Linear(256, latent_dim)
        init_net(self, torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor, train: bool = False,
                masks: Optional[MaskFn] = None) -> Dict[str, torch.Tensor]:
        out = torch.relu(self.stem_bn(self.stem(x), train).to(self.dtype))
        out = F.max_pool2d(out, 3, 2, 1)  # Flax pads with -inf, as PyTorch does
        for name in self.block_names:
            out = getattr(self, name)(out, train)
        out = out.mean((2, 3))  # global average pool
        for layer in (self.head_0, self.head_1):
            out = dropout(torch.relu(dense(layer, out, self.dtype)), self.dropout, train, masks)
        return {"embedding": dense(self.embedding, out, torch.float32),
                "log_covariance": dense(self.log_var, out, torch.float32)}


class ResNetDecoder(nn.Module):
    def __init__(self, input_dim: Tuple[int, int, int], latent_dim: int,
                 hidden_dims: Sequence[int] = (512, 256, 128, 64),
                 num_blocks: Sequence[int] = (2, 2, 2, 2), dropout: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16, out_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_dim, self.latent_dim = tuple(input_dim), latent_dim
        self.hidden_dims, self.num_blocks = tuple(hidden_dims), tuple(num_blocks)
        self.dropout, self.dtype, self.out_dtype = float(dropout), dtype, out_dtype
        c, height, width = self.input_dim
        n = len(self.hidden_dims)
        self.seed_hw = (max(1, height // 2 ** (n + 1)), max(1, width // 2 ** (n + 1)))
        h0 = self.hidden_dims[0]
        self.head_0 = nn.Linear(latent_dim, 1024)
        self.head_1 = nn.Linear(1024, 512)
        self.expand = nn.Linear(512, h0 * self.seed_hw[0] * self.seed_hw[1])
        self.up0 = ConvTranspose(h0, h0, 4, 2, dtype)
        self.up0_bn = BatchNorm(h0)
        self.stages = []
        cin = h0
        for si, ch in enumerate(self.hidden_dims[1:]):
            setattr(self, f"up{si + 1}", ConvTranspose(cin, ch, 3, 2, dtype))
            setattr(self, f"up{si + 1}_bn", BatchNorm(ch))
            names = [f"stage{si}_block{bi}" for bi in range(_blocks(self.num_blocks, si))]
            for name in names:
                setattr(self, name, ResidualBlock(ch, ch, 1, dtype))
            self.stages.append((f"up{si + 1}", names))
            cin = ch
        self.final = ConvTranspose(cin, c, 4, 2, out_dtype)
        init_net(self, torch.Generator().manual_seed(0))

    def forward(self, z: torch.Tensor, train: bool = False,
                masks: Optional[MaskFn] = None) -> Dict[str, torch.Tensor]:
        out = z.to(self.dtype)
        for layer in (self.head_0, self.head_1):
            out = dropout(torch.relu(dense(layer, out, self.dtype)), self.dropout, train, masks)
        out = dense(self.expand, out, self.dtype)
        out = out.reshape(out.shape[0], *self.seed_hw, self.hidden_dims[0]).permute(0, 3, 1, 2)
        out = torch.relu(self.up0_bn(self.up0(out), train).to(self.dtype))
        for up, names in self.stages:
            out = torch.relu(getattr(self, f"{up}_bn")(getattr(self, up)(out), train)
                             .to(self.dtype))
            for name in names:
                out = getattr(self, name)(out, train)
        out = self.final(out)[:, :, :self.input_dim[1], :self.input_dim[2]]  # tiny images
        return {"reconstruction": out.contiguous()}
