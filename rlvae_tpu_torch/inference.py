"""ModelManager: the inference API of the port.

Port of ``rlvae_tpu/inference.py:57-115`` for the ops of this slice:
``encode``, ``decode``, ``reconstruct`` and ``embed_sequence``.  Inputs are
numpy arrays (or tensors); outputs are numpy arrays, as on the JAX side.
The model lives on one device, resolved by
:func:`rlvae_tpu_torch.device.resolve_device`: the CUDA card unless the
caller asks for another.  The posterior noise of ``reconstruct`` comes from
a ``torch.Generator`` seeded with ``seed``; it cannot reproduce JAX's bits.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from rlvae_tpu_torch.device import DeviceLike, resolve_device
from rlvae_tpu_torch.models import RlVAE, create_model
from rlvae_tpu_torch.utils.output import ModelOutput


class ModelManager:
    """Hold one inference-mode model on one device."""

    def __init__(self, model: RlVAE, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)

    @classmethod
    def from_config(cls, model_config: Dict[str, Any], seed: int = 0,
                    device: DeviceLike = None) -> "ModelManager":
        """Model from a config dict (e.g. ``PRESETS["riemannian_flow_vae"]``);
        pretrained encoder/decoder/metric where the config names them, seeded
        random flows."""
        device = resolve_device(device)  # fail before the weights are read
        return cls(create_model(model_config, seed=seed), device)

    def _tensor(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=torch.float32)
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

    # -- core ops -------------------------------------------------------------

    def forward(self, x_seq, seed: int = 0, eps: Optional[torch.Tensor] = None) -> ModelOutput:
        """Full forward with losses; tensors stay on the device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.inference_mode():
            return self.model(self._tensor(x_seq), eps=eps, generator=gen)

    def encode(self, x) -> ModelOutput:
        """Frame(s) [B, C, H, W] -> (embedding, log_covariance), numpy."""
        with torch.inference_mode():
            out = self.model.encode(self._tensor(x))
        return ModelOutput({k: v.float().cpu().numpy() for k, v in out.items()})

    def decode(self, z) -> np.ndarray:
        with torch.inference_mode():
            out = self.model.decode(self._tensor(z))["reconstruction"]
        return out.float().cpu().numpy()

    def reconstruct(self, x_seq, seed: int = 0) -> np.ndarray:
        """[B, T, C, H, W] -> reconstructed sequences."""
        return self.forward(x_seq, seed).recon_x.float().cpu().numpy()

    def embed_sequence(self, x_seq, seed: int = 0) -> np.ndarray:
        """[B, T, C, H, W] -> latent trajectories [B, T, D]."""
        return self.forward(x_seq, seed).z.float().cpu().numpy()
