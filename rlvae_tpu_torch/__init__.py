"""rlvae_tpu_torch: the PyTorch/CUDA port of rlvae_tpu.

Five slices are ported:

- serving: :class:`~rlvae_tpu_torch.inference.ModelManager` (``encode``,
  ``decode``, ``reconstruct``, ``embed_sequence``) behind the
  dynamic-batching :class:`~rlvae_tpu_torch.serving.BatchingEngine`;
- training: :class:`~rlvae_tpu_torch.train.Trainer` with Adam and coupled
  weight decay on :mod:`rlvae_tpu_torch.data` (``python -m
  rlvae_tpu_torch.train``);
- prior generation: ``ModelManager.sample_random``,
  ``sample_random_batched_seeds``, ``sample_latent`` and the engine's
  ``generate`` op, with the geodesic, centroid-aware, weighted-mixture and
  basic priors and the manifold-HMC chains (:mod:`rlvae_tpu_torch.samplers`);
- the consumers of the metric tensor G: ``PRESETS["hybrid_rlvae"]``, a
  Gaussian posterior sampled by ``standard``, ``basic``, ``enhanced``,
  ``geodesic`` or ``official``; the evaluation step's analysis metrics;
  ``riemannian_full_kl`` and the metric's ``g``, ``chol_g``, ``dist2`` and
  ``diagnostics``;
- the fast and stable presets (``PRESETS["riemannian_flow_vae_fast"]``,
  ``["riemannian_flow_vae_stable"]``): sampling-direction flows, and in the
  fast preset's training the fused decode+MSE loss
  (:class:`~rlvae_tpu_torch.ops.recon_kernels.DecodeMSE`).

Hand-written CUDA kernels (``csrc/``) compute the chol-bundle, the IAF
chain's forward and backward, the HMC chain's target and gradient, the
metric bundle (G^{-1}, its Cholesky factor, logdet and G) and G^{-1}, and
the decoder's last layer with its sigmoid and MSE, forward and backward.  The
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
