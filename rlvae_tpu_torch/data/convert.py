"""Converters of the reference's ``.pt`` artifacts to the ``.npz`` files
both packages read: the port's counterpart of ``rlvae_tpu/data/convert.py``.

- :func:`convert_dataset`: a [N, T, C, H, W] tensor ``.pt`` (or a dict
  holding it, ``{'data': ...}`` first) to a compressed ``.npz`` under the
  key ``sequences``.
- :func:`convert_component`: a pythae MLP encoder's or decoder's state dict
  ``.pt`` to a flat component ``.npz`` of Flax parameters
  (``params/hidden_0/kernel``, ...), which :func:`load_component_npz` (the
  one of :mod:`rlvae_tpu_torch.convert`, re-exported here) and
  ``convert.load_pretrained_net`` read.  The key maps are
  :func:`torch_mlp_encoder_to_flax` and :func:`torch_mlp_decoder_to_flax`,
  after the prefixes the reference's loaders accept are stripped.

``.pt`` files are read with ``torch.load(weights_only=True)``: tensors and
dicts of tensors, never arbitrary pickled objects.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np

from rlvae_tpu_torch.convert import load_component_npz

__all__ = ["convert_component", "convert_dataset", "load_component_npz", "state_dict_to_numpy",
           "torch_mlp_decoder_to_flax", "torch_mlp_encoder_to_flax"]


def _torch_load(path):
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def convert_dataset(src: str | Path, dst: str | Path) -> tuple:
    """A [N, T, C, H, W] tensor ``.pt`` dataset to ``.npz``; returns its shape."""
    data = _torch_load(src)
    if isinstance(data, dict):  # the Sprites artifacts wrap the tensor in {'data': ...}
        data = data["data"] if "data" in data else next(iter(data.values()))
    arr = data.detach().cpu().numpy().astype(np.float32)
    dst = Path(dst)
    dst.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(dst, sequences=arr)
    return arr.shape


def state_dict_to_numpy(state_dict) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in state_dict.items()}


def _strip_prefixes(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Each prefix every key shares, removed, as the reference's loaders accept."""
    prefixes = ("encoder.", "decoder.", "model.encoder.", "model.decoder.", "module.")
    out = dict(sd)
    for p in prefixes:
        if all(k.startswith(p) for k in out):
            out = {k[len(p):]: v for k, v in out.items()}
    return out


def _wb(sd, prefix):
    return sd[f"{prefix}.weight"].T.astype(np.float32), sd[f"{prefix}.bias"].astype(np.float32)


def torch_mlp_encoder_to_flax(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """A pythae ``Encoder_VAE_MLP`` state dict as MLPEncoder params:
    ``layers.0.0`` -> ``hidden_0``, ``embedding``, ``log_var``."""
    sd = _strip_prefixes(sd)
    (k0, b0), (ke, be), (kv, bv) = (_wb(sd, p) for p in ("layers.0.0", "embedding", "log_var"))
    return {"params": {"hidden_0": {"kernel": k0, "bias": b0},
                       "embedding": {"kernel": ke, "bias": be},
                       "log_var": {"kernel": kv, "bias": bv}}}


def torch_mlp_decoder_to_flax(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """A pythae ``Decoder_AE_MLP`` state dict as MLPDecoder params:
    ``layers.0.0`` -> ``hidden_0``, ``layers.1.0`` -> ``out``."""
    sd = _strip_prefixes(sd)
    (k0, b0), (k1, b1) = (_wb(sd, p) for p in ("layers.0.0", "layers.1.0"))
    return {"params": {"hidden_0": {"kernel": k0, "bias": b0},
                       "out": {"kernel": k1, "bias": b1}}}


def convert_component(src: str | Path, dst: str | Path, kind: str) -> None:
    """An ``encoder.pt`` or ``decoder.pt`` state dict (``kind``) to a flat
    component ``.npz`` of Flax parameters."""
    sd = state_dict_to_numpy(_torch_load(src))
    params = torch_mlp_encoder_to_flax(sd) if kind == "encoder" else torch_mlp_decoder_to_flax(sd)
    flat = {}

    def walk(node, prefix=""):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = v

    walk(params)
    dst = Path(dst)
    dst.parent.mkdir(parents=True, exist_ok=True)
    np.savez(dst, **flat)
