"""Encoder/decoder factory: the MLP entries of ``rlvae_tpu/nets/registry.py``.

Config keys are the JAX package's (``architecture``, ``hidden_dims``,
``dropout``, ``dtype``, ``out_dtype``).  Only ``mlp`` (and ``custom``, which
the JAX side maps to mlp with a warning) is ported; CNN and ResNet nets
raise ``NotImplementedError``.  Dropout is a training-time option and is
not ported yet.
"""

from __future__ import annotations

import warnings
from typing import Any, Mapping, Optional, Tuple

import torch
from torch import nn

from rlvae_tpu_torch.nets.mlp import MLPDecoder, MLPEncoder

_DTYPES = {
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float32": torch.float32, "fp32": torch.float32,
}


def _get(cfg: Optional[Mapping[str, Any]], *keys, default=None):
    for k in keys:
        if cfg is not None and cfg.get(k) is not None:
            return cfg[k]
    return default


def _dtype(config, key: str = "dtype", default: str = "bfloat16") -> torch.dtype:
    return _DTYPES[str(_get(config, key, default=default)).lower()]


def _arch(config) -> str:
    arch = str(_get(config, "architecture", default="mlp")).lower()
    if arch == "custom":
        warnings.warn("Custom net not implemented, falling back to MLP")
        arch = "mlp"
    if arch in ("cnn", "resnet"):
        raise NotImplementedError(f"{arch} nets are not ported yet")
    if arch != "mlp":
        raise ValueError(f"Unknown architecture: {arch}")
    if float(_get(config, "dropout", default=0.0)) > 0:
        raise NotImplementedError("dropout is a training option and is not ported yet")
    return arch


def create_encoder(input_dim: Tuple[int, ...], latent_dim: int,
                   config: Optional[Mapping[str, Any]] = None) -> nn.Module:
    _arch(config)
    return MLPEncoder(tuple(input_dim), latent_dim,
                      tuple(_get(config, "hidden_dims", default=(512,))), _dtype(config))


def create_decoder(input_dim: Tuple[int, ...], latent_dim: int,
                   config: Optional[Mapping[str, Any]] = None) -> nn.Module:
    _arch(config)
    return MLPDecoder(tuple(input_dim), latent_dim,
                      tuple(_get(config, "hidden_dims", default=(512,))), _dtype(config),
                      _dtype(config, "out_dtype", "float32"))
