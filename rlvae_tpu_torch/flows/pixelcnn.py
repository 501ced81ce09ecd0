"""PixelCNN: an autoregressive image density model.

Port of ``rlvae_tpu/flows/pixelcnn.py:29-120``: ``n_layers`` masked
convolutions (type 'A' first, which masks the centre pixel itself, then
type 'B'), each followed by BatchNorm and ReLU, and a 1x1 convolution head
giving ``n_embeddings`` logits per channel.  The forward returns the logits
[B, E, C, H, W] and the mean per-pixel categorical cross-entropy against
the integer-valued input (values in [0, n_embeddings)).

- :class:`MaskedConv` is the layers' Flax-semantics :class:`Conv` in fp32
  with "SAME" padding and the mask of :func:`conv_mask` multiplied into its
  weight (OIHW here; the mask is built in Flax's HWIO and transposed).
- The BatchNorm is :class:`~rlvae_tpu_torch.nets.layers.BatchNorm`, Flax's
  (momentum 0.99, eps 1e-5, the biased batch variance in train, the running
  averages in eval).
- :func:`pixelcnn_sample` scans the raster over (pixel, channel) and
  re-scores the whole image at each of the H*W*C steps, as JAX's
  ``fori_loop`` does.  JAX's ``jax.random.categorical`` is argmax(logits / T
  + Gumbel); the port draws the Gumbel noise from ``generator``, or takes it
  as ``noise`` [H*W*C, n, E] (one draw per step, in JAX's order: a test
  passes JAX's own draws).

JAX computes these convolutions outside Pallas, so the port runs them as
plain PyTorch ops (cuDNN on the card).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rlvae_tpu_torch.nets.layers import BatchNorm, Conv, init_net
from rlvae_tpu_torch.utils.output import ModelOutput


def conv_mask(kernel_size: int, in_ch: int, out_ch: int, mask_type: str) -> np.ndarray:
    """HWIO mask: type 'A' blocks the centre pixel and everything after it;
    type 'B' allows the centre."""
    k = kernel_size
    mask = np.ones((k, k, in_ch, out_ch), np.float32)
    center = k // 2
    if mask_type == "A":
        mask[center, center:, :, :] = 0.0
    else:
        mask[center, center + 1:, :, :] = 0.0
    mask[center + 1:, :, :, :] = 0.0
    return mask


class MaskedConv(Conv):
    """A masked "SAME" convolution in fp32; weight [out, in, k, k]."""

    def __init__(self, in_ch: int, features: int, kernel_size: int, mask_type: str):
        super().__init__(in_ch, features, kernel_size, 1, "SAME", torch.float32)
        mask = conv_mask(kernel_size, in_ch, features, mask_type).transpose(3, 2, 0, 1)
        self.register_buffer("mask", torch.from_numpy(np.ascontiguousarray(mask)),
                             persistent=False)

    def kernel_weight(self) -> torch.Tensor:
        return self.weight * self.mask


class PixelCNN(nn.Module):
    """Reference defaults: 1x28x28, 10 layers, kernel 5, 64 hidden
    channels, 256 embeddings.  Weights drawn from a CPU generator seeded
    with ``seed`` (``init_net``; JAX's draws differ)."""

    def __init__(self, input_dim: Tuple[int, int, int] = (1, 28, 28), n_embeddings: int = 256,
                 n_layers: int = 10, kernel_size: int = 5, hidden: int = 64, seed: int = 0):
        super().__init__()
        self.input_dim = tuple(input_dim)
        self.n_embeddings = n_embeddings
        c = self.input_dim[0]
        self.convs = nn.ModuleList(
            MaskedConv(c if i == 0 else hidden, hidden, kernel_size, "A" if i == 0 else "B")
            for i in range(n_layers))
        self.norms = nn.ModuleList(BatchNorm(hidden) for _ in range(n_layers))
        self.head = Conv(hidden, n_embeddings * c, 1, 1, "SAME", torch.float32)
        init_net(self, torch.Generator().manual_seed(seed))

    def forward(self, x: torch.Tensor, train: bool = False) -> ModelOutput:
        """x: [B, C, H, W] with integer values in [0, n_embeddings)."""
        b, c, hh, ww = x.shape
        h = x.float()
        for conv, norm in zip(self.convs, self.norms):
            h = torch.relu(norm(conv(h), train))
        # channel e * C + c of the head -> logits [B, E, C, H, W]
        logits = self.head(h).reshape(b, self.n_embeddings, c, hh, ww)
        labels = torch.clamp(x.long(), 0, self.n_embeddings - 1)
        logp = F.log_softmax(logits, dim=1)
        nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
        return ModelOutput(out=logits, loss=nll.mean())


def gumbel(shape, generator: Optional[torch.Generator] = None,
           device=None) -> torch.Tensor:
    """Gumbel(0, 1) draws as ``jax.random.gumbel``: -log(-log(U)), U uniform
    on [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def pixelcnn_sample(model: PixelCNN, n: int, temperature: float = 1.0,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Autoregressive samples [n, C, H, W] (int32) on the model's device:
    a raster scan over (pixel, channel), the full image re-scored at each
    step.  ``noise``: the Gumbel draws [H*W*C, n, E]; else drawn from
    ``generator`` step by step."""
    c, h, w = model.input_dim
    dev = next(model.parameters()).device
    steps = h * w * c
    if noise is not None and tuple(noise.shape) != (steps, n, model.n_embeddings):
        raise ValueError(f"noise of shape {tuple(noise.shape)} for {steps} steps of "
                         f"[{n}, {model.n_embeddings}]")
    x = torch.zeros((n, c, h, w), dtype=torch.int32, device=dev)
    with torch.no_grad():
        for idx in range(steps):
            pix, ch = divmod(idx, c)
            i, j = divmod(pix, w)
            logits = model(x, train=False).out[:, :, ch, i, j] / temperature  # [n, E]
            g = noise[idx].to(dev) if noise is not None else gumbel(
                logits.shape, generator, dev)
            x[:, ch, i, j] = torch.argmax(logits + g, dim=-1).to(torch.int32)
    return x
