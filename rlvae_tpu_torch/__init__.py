"""rlvae_tpu_torch: the PyTorch/CUDA port of rlvae_tpu.

This slice ports the serving path of the ``riemannian_flow_vae`` model:
:class:`~rlvae_tpu_torch.inference.ModelManager` (``encode``, ``decode``,
``reconstruct``, ``embed_sequence``) behind the dynamic-batching
:class:`~rlvae_tpu_torch.serving.BatchingEngine`, with hand-written CUDA
kernels (``csrc/``) for the chol-bundle and the IAF-chain forward.  The
package imports PyTorch and numpy only; kernels are built with ``nvcc`` at
first use on the card.
"""

from rlvae_tpu_torch.device import resolve_device
from rlvae_tpu_torch.inference import ModelManager
from rlvae_tpu_torch.models import PRESETS, RlVAE, create_model
from rlvae_tpu_torch.serving import BatchingEngine, EngineStats, ServeConfig

__all__ = [
    "BatchingEngine", "EngineStats", "ModelManager", "PRESETS", "RlVAE",
    "ServeConfig", "create_model", "resolve_device",
]
