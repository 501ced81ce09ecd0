"""Invertible BatchNorm flow layer.

Port of ``rlvae_tpu/flows/batchnorm.py:24-79``: learnable ``log_gamma`` and
``beta``, running mean and variance with momentum 0.1; the forward
normalizes with the batch's statistics (unbiased variance, ``ddof=1``) in
train mode and the running ones in eval, with log|det J| = sum(log_gamma -
0.5 log(var + eps)) broadcast to [B].  Plain functions on tensors with the
state threaded explicitly, as JAX threads it: the forward returns the new
state, and in train mode that state also keeps ``batch_mean``/``batch_var``
for a train-mode inverse.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Tensor = torch.Tensor


def init_batchnorm(num_features: int) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """Returns (params, state)."""
    params = {"log_gamma": torch.zeros(num_features), "beta": torch.zeros(num_features)}
    state = {"running_mean": torch.zeros(num_features), "running_var": torch.ones(num_features)}
    return params, state


def batchnorm_forward(params: Dict[str, Tensor], state: Dict[str, Tensor], x: Tensor,
                      train: bool = False, eps: float = 1e-5,
                      momentum: float = 0.1) -> Tuple[Tensor, Tensor, Dict[str, Tensor]]:
    """Forward (density direction); returns (y, log|det J| [B], new_state)."""
    if train:
        mean = x.mean(0)
        var = x.var(0, unbiased=True)
        new_state = {
            "running_mean": (1 - momentum) * state["running_mean"] + momentum * mean,
            "running_var": (1 - momentum) * state["running_var"] + momentum * var,
            "batch_mean": mean,
            "batch_var": var,
        }
    else:
        mean, var = state["running_mean"], state["running_var"]
        new_state = state
    y = (x - mean) / torch.sqrt(var + eps) * torch.exp(params["log_gamma"]) + params["beta"]
    logdet = torch.sum(params["log_gamma"] - 0.5 * torch.log(var + eps))
    return y, logdet.to(x.dtype).expand(x.shape[0]), new_state


def batchnorm_inverse(params: Dict[str, Tensor], state: Dict[str, Tensor], y: Tensor,
                      train: bool = False, eps: float = 1e-5) -> Tuple[Tensor, Tensor]:
    """Inverse (sampling direction); returns (x, log|det J| [B])."""
    if train and "batch_mean" in state:
        mean, var = state["batch_mean"], state["batch_var"]
    else:
        mean, var = state["running_mean"], state["running_var"]
    x = (y - params["beta"]) * torch.exp(-params["log_gamma"]) * torch.sqrt(var + eps) + mean
    logdet = torch.sum(-params["log_gamma"] + 0.5 * torch.log(var + eps))
    return x, logdet.to(y.dtype).expand(y.shape[0])
