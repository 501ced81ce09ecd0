"""rlvae_tpu_torch: the PyTorch/CUDA port of rlvae_tpu.

Three slices of the ``riemannian_flow_vae`` model are ported:

- serving: :class:`~rlvae_tpu_torch.inference.ModelManager` (``encode``,
  ``decode``, ``reconstruct``, ``embed_sequence``) behind the
  dynamic-batching :class:`~rlvae_tpu_torch.serving.BatchingEngine`;
- training: :class:`~rlvae_tpu_torch.train.Trainer` with Adam and coupled
  weight decay on :mod:`rlvae_tpu_torch.data` (``python -m
  rlvae_tpu_torch.train``);
- prior generation: ``ModelManager.sample_random``,
  ``sample_random_batched_seeds``, ``sample_latent`` and the engine's
  ``generate`` op, with the geodesic, centroid-aware, weighted-mixture and
  basic priors and the manifold-HMC chains (:mod:`rlvae_tpu_torch.samplers`).

Hand-written CUDA kernels (``csrc/``) compute the chol-bundle, the IAF
chain's forward and backward, and the HMC chain's target and gradient.  The
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
