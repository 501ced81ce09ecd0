"""Inverse autoregressive flow, both directions.

Port of ``rlvae_tpu/flows/iaf.py:33-177``.

- Density direction (:func:`iaf_forward`): per MADE block the D-dimensional
  update y_i = (x_i - mu_i(y)) * exp(-s_i(y)) runs dim by dim, log|det J|
  accumulates -s_i, and the dims are flipped after every block.  It is the
  per-transition reference; the temporal chain runs all its transitions
  through :mod:`rlvae_tpu_torch.ops.iaf_kernels`.
- Sampling direction (:func:`iaf_inverse`): the blocks in reverse order,
  each one parallel MADE pass: flip, then y = y * exp(s(y)) + mu(y), and
  log|det J| accumulates sum(s); an optional context ``h`` feeds the
  blocks' context weights.  The temporal chain runs it as it is (the JAX
  package has no kernel for this direction either).
- Jacobi fixed-point density direction (:func:`iaf_forward_fixedpoint`):
  each block solves y = (x - mu(y)) * exp(-s(y)) by ``n_iters`` full MADE
  passes from y = 0 and one more whose s gives the log-det, exact at
  ``n_iters >= D - 1``; :func:`fixedpoint_error` measures it against the
  sequential pass.  The plain per-IAF reference of the chain kernel's
  ``fp_iters`` mode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from rlvae_tpu_torch.flows.made import LOG_VAR_BIAS_INIT, MADE


class IAF(nn.Module):
    """``n_blocks`` MADE blocks of ``n_hidden`` hidden layers of ``hidden_size``."""

    def __init__(self, input_dim: int, hidden_size: int = 256, n_blocks: int = 2,
                 n_hidden: int = 3, generator: Optional[torch.Generator] = None,
                 log_var_bias_init: float = LOG_VAR_BIAS_INIT,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.blocks = nn.ModuleList(
            MADE(input_dim, [hidden_size] * n_hidden, generator, log_var_bias_init, context_dim)
            for _ in range(n_blocks)
        )

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return iaf_forward(self, x)


def _block_forward(block: MADE, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    y = torch.zeros_like(x)
    logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        mu, s = block(y)
        y = y.clone()
        y[:, i] = (x[:, i] - mu[:, i]) * torch.exp(-s[:, i])
        logdet = logdet - s[:, i]
    return y, logdet


def iaf_forward(iaf: IAF, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Density direction f^{-1}: returns (out, sum log|det J|)."""
    logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for block in iaf.blocks:
        x, ld = _block_forward(block, x)
        logdet = logdet + ld
        x = torch.flip(x, dims=(1,))
    return x, logdet


def _block_forward_fixedpoint(block: MADE, x: torch.Tensor,
                              n_iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    y = torch.zeros_like(x)
    for _ in range(n_iters):
        mu, s = block(y)
        y = (x - mu) * torch.exp(-s)
    mu, s = block(y)
    return (x - mu) * torch.exp(-s), -s.sum(-1)


def iaf_forward_fixedpoint(iaf: IAF, x: torch.Tensor,
                           n_iters: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Density direction by Jacobi fixed-point blocks: returns (out, sum
    log|det J|); exact when ``n_iters >= input_dim - 1``."""
    logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for block in iaf.blocks:
        x, ld = _block_forward_fixedpoint(block, x, n_iters)
        logdet = logdet + ld
        x = torch.flip(x, dims=(1,))
    return x, logdet


def fixedpoint_error(iaf: IAF, x: torch.Tensor, n_iters: int) -> Tuple[float, float]:
    """(max_rel_y, max_abs_logdet) of :func:`iaf_forward_fixedpoint` against
    the sequential :func:`iaf_forward` on ``x``: the largest deviation of the
    output relative to max(|y_exact|, 1), and of the log-det.  Convergence
    below D - 1 iterations depends on the weights, so probe trained flows
    here before lowering ``flow_fixedpoint_iters``."""
    with torch.no_grad():
        y_ref, ld_ref = iaf_forward(iaf, x)
        y_fp, ld_fp = iaf_forward_fixedpoint(iaf, x, n_iters)
    rel = (y_fp - y_ref).abs() / y_ref.abs().clamp_min(1.0)
    return float(rel.max()), float((ld_fp - ld_ref).abs().max())


def iaf_inverse(iaf: IAF, y: torch.Tensor,
                h: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sampling direction f: returns (out, sum log|det J|)."""
    logdet = torch.zeros(y.shape[0], dtype=y.dtype, device=y.device)
    for block in reversed(iaf.blocks):
        y = torch.flip(y, dims=(1,))
        mu, s = block(y, h)
        y = y * torch.exp(s) + mu
        logdet = logdet + s.sum(-1)
    return y, logdet
