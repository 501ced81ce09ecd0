"""MADE: masked autoencoder for autoregressive density estimation.

Port of ``rlvae_tpu/flows/made.py``:

- sequential degrees m_-1 = 1..D,
  m_i = max(min(min(m_{i-1}), D-1), ceil(arange(1..H) * (D-1) / (H+1)));
- hidden masks m_i[None, :] >= m_{i-1}[:, None] in [in, out] orientation;
  the output mask m_last < m_-1, tiled twice for the (mu, log_var) heads;
- NO activation after layer 0; ReLU after every other hidden layer;
- log_var clamped to +-1.5; the final log_var bias initialised to -2.0;
- with ``context_dim``, a context weight ``cw`` [context_dim, H0]
  (U(-1/sqrt(context_dim), +1/sqrt(context_dim))) whose product with a
  context ``h`` is added after layer 0, with no bias.

Weights are kept in the JAX package's [in, out] layout (``x @ (mask * w)``),
so the kernels and the converter share one layout with the reference.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

LOG_VAR_CLAMP = 1.5
LOG_VAR_BIAS_INIT = -2.0


def make_degrees(input_dim: int, hidden_sizes: Sequence[int]) -> List[np.ndarray]:
    """Sequential degree vectors [m_-1, m_0, ..., m_{L-1}]."""
    degrees = [np.arange(1, input_dim + 1)]
    for h in hidden_sizes:
        min_deg = min(int(degrees[-1].min()), input_dim - 1)
        deg = np.maximum(
            min_deg,
            np.ceil(np.arange(1, h + 1) * (input_dim - 1) / float(h + 1)).astype(np.int64),
        )
        degrees.append(deg)
    return degrees


def make_masks(input_dim: int, hidden_sizes: Sequence[int]) -> List[np.ndarray]:
    """One [in, out] float32 mask per masked layer, output layer tiled x2."""
    degrees = make_degrees(input_dim, hidden_sizes)
    masks = [
        (cur[None, :] >= prev[:, None]).astype(np.float32)
        for prev, cur in zip(degrees[:-1], degrees[1:])
    ]
    out_mask = (degrees[-1][:, None] < degrees[0][None, :]).astype(np.float32)  # [H, D]
    masks.append(np.tile(out_mask, (1, 2)))  # [H, 2D]
    return masks


class MADE(nn.Module):
    """One MADE block: ``forward(x) -> (mu, log_var)``, each [B, D]."""

    def __init__(self, input_dim: int, hidden_sizes: Sequence[int],
                 generator: Optional[torch.Generator] = None,
                 log_var_bias_init: float = LOG_VAR_BIAS_INIT,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.input_dim = int(input_dim)
        sizes = [self.input_dim, *hidden_sizes, 2 * self.input_dim]
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        # Torch-Linear-style init, as init_made: U(-1/sqrt(fan_in), +1/sqrt(fan_in))
        for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
            bound = 1.0 / np.sqrt(fan_in)
            w = (torch.rand(fan_in, fan_out, generator=generator) * 2 - 1) * bound
            b = (torch.rand(fan_out, generator=generator) * 2 - 1) * bound
            self.weights.append(nn.Parameter(w))
            self.biases.append(nn.Parameter(b))
        with torch.no_grad():
            self.biases[-1][self.input_dim:] = log_var_bias_init
        if context_dim is not None:
            bound = 1.0 / np.sqrt(context_dim)
            self.cw = nn.Parameter(
                (torch.rand(context_dim, hidden_sizes[0], generator=generator) * 2 - 1) * bound)
        for li, m in enumerate(make_masks(self.input_dim, hidden_sizes)):
            # recomputed from the sizes, so not part of the state dict
            self.register_buffer(f"mask{li}", torch.from_numpy(m), persistent=False)

    @property
    def n_layers(self) -> int:
        return len(self.weights)

    def mask(self, li: int) -> torch.Tensor:
        return getattr(self, f"mask{li}")

    def masked_weight(self, li: int) -> torch.Tensor:
        return self.mask(li) * self.weights[li]

    def forward(self, x: torch.Tensor,
                h: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        d = self.input_dim
        out = x @ self.masked_weight(0) + self.biases[0]  # no activation after layer 0
        if h is not None and hasattr(self, "cw"):
            out = out + h @ self.cw
        for li in range(1, self.n_layers - 1):
            out = torch.relu(out @ self.masked_weight(li) + self.biases[li])
        li = self.n_layers - 1
        out = out @ self.masked_weight(li) + self.biases[li]
        mu, log_var = out[..., :d], out[..., d:]
        return mu, torch.clamp(log_var, -LOG_VAR_CLAMP, LOG_VAR_CLAMP)
