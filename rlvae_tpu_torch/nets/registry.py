"""Encoder/decoder factory: the port of ``rlvae_tpu/nets/registry.py``.

``architecture`` is ``mlp``, ``cnn`` or ``resnet`` (``custom`` falls back
to mlp with a warning, as on the JAX side).  Config keys and defaults are
JAX's: ``hidden_dims`` (mlp; default [512]), ``layers`` or ``hidden_dims``
(cnn: encoder [32, 64, 128, 256], decoder [256, 128, 64, 32]; resnet:
encoder [64, 128, 256, 512], decoder [512, 256, 128, 64]), ``kernel_size``
and ``stride`` (cnn; 3 and 2), ``num_blocks`` (resnet; [2, 2, 2, 2]),
``dropout`` (mlp 0.0; cnn and resnet 0.1 when the config sets none),
``dtype`` (activations, default bfloat16) and ``out_dtype`` (decoders'
reconstruction, default float32).  Other keys of the YAML (``padding``,
``activation``, ``batch_norm``, ``block_type``) are ignored, as JAX does.
"""

from __future__ import annotations

import warnings
from typing import Any, Mapping, Optional, Tuple

import torch
from torch import nn

from rlvae_tpu_torch.nets.cnn import CNNDecoder, CNNEncoder
from rlvae_tpu_torch.nets.mlp import MLPDecoder, MLPEncoder
from rlvae_tpu_torch.nets.resnet import ResNetDecoder, ResNetEncoder

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
    if arch not in ("mlp", "cnn", "resnet"):
        raise ValueError(f"Unknown architecture: {arch}")
    return arch


def _common(config, arch: str, default_dims):
    dims = _get(config, "hidden_dims", default=default_dims) if arch == "mlp" else \
        _get(config, "layers", "hidden_dims", default=default_dims)
    return dict(hidden_dims=tuple(dims), dtype=_dtype(config),
                dropout=float(_get(config, "dropout", default=0.0 if arch == "mlp" else 0.1)))


def create_encoder(input_dim: Tuple[int, ...], latent_dim: int,
                   config: Optional[Mapping[str, Any]] = None) -> nn.Module:
    arch, input_dim = _arch(config), tuple(input_dim)
    if arch == "mlp":
        return MLPEncoder(input_dim, latent_dim, **_common(config, arch, (512,)))
    if arch == "cnn":
        return CNNEncoder(input_dim, latent_dim, kernel_size=int(_get(config, "kernel_size",
                                                                      default=3)),
                          stride=int(_get(config, "stride", default=2)),
                          **_common(config, arch, (32, 64, 128, 256)))
    return ResNetEncoder(input_dim, latent_dim,
                         num_blocks=tuple(_get(config, "num_blocks", default=(2, 2, 2, 2))),
                         **_common(config, arch, (64, 128, 256, 512)))


def create_decoder(input_dim: Tuple[int, ...], latent_dim: int,
                   config: Optional[Mapping[str, Any]] = None) -> nn.Module:
    arch, input_dim = _arch(config), tuple(input_dim)
    out_dtype = _dtype(config, "out_dtype", "float32")
    if arch == "mlp":
        return MLPDecoder(input_dim, latent_dim, out_dtype=out_dtype,
                          **_common(config, arch, (512,)))
    if arch == "cnn":
        return CNNDecoder(input_dim, latent_dim, kernel_size=int(_get(config, "kernel_size",
                                                                      default=3)),
                          stride=int(_get(config, "stride", default=2)), out_dtype=out_dtype,
                          **_common(config, arch, (256, 128, 64, 32)))
    return ResNetDecoder(input_dim, latent_dim,
                         num_blocks=tuple(_get(config, "num_blocks", default=(2, 2, 2, 2))),
                         out_dtype=out_dtype, **_common(config, arch, (512, 256, 128, 64)))
