"""rlvae_tpu_torch: the PyTorch/CUDA port of rlvae_tpu.

What is ported:

- serving: :class:`~rlvae_tpu_torch.inference.ModelManager` (``encode``,
  ``decode``, ``reconstruct``, ``embed_sequence``) behind the
  dynamic-batching :class:`~rlvae_tpu_torch.serving.BatchingEngine`;
- training: :class:`~rlvae_tpu_torch.train.Trainer` with Adam and coupled
  weight decay on :mod:`rlvae_tpu_torch.data` (``python -m
  rlvae_tpu_torch.train``), with a run directory of checkpoint slots
  (``best``, ``last``), resume and preemption; a trained model is served by
  ``ModelManager.from_checkpoint`` / ``from_run``;
- generation and inference: ``ModelManager.sample_random``,
  ``sample_random_batched_seeds``, ``sample_latent``, ``adaptive_plan``,
  ``interpolate`` (with :func:`~rlvae_tpu_torch.inference.slerp`) and the
  engine's ``generate`` op, with the geodesic, centroid-aware,
  weighted-mixture and basic priors and the manifold-HMC chains (official,
  adaptive, planned on a calibrated plan; :mod:`rlvae_tpu_torch.samplers`),
  the generation-sampler zoo (``SAMPLER_REGISTRY``) and
  ``RlVAE.estimate_nll``;
- the consumers of the metric tensor G: ``PRESETS["hybrid_rlvae"]``, a
  Gaussian posterior sampled by ``standard``, ``basic``, ``enhanced``,
  ``geodesic``, ``official`` or ``hmc`` (posterior-tempered HMC, no
  gradient on the card); the evaluation step's analysis metrics;
  ``riemannian_full_kl`` and the metric's ``g``, ``chol_g``, ``dist2`` and
  ``diagnostics``;
- the fast and stable presets (``PRESETS["riemannian_flow_vae_fast"]``,
  ``["riemannian_flow_vae_stable"]``): sampling-direction flows, and in the
  fast preset's training the fused decode+MSE loss
  (:class:`~rlvae_tpu_torch.ops.recon_kernels.DecodeMSE`);
- the experiment runner ``python -m rlvae_tpu_torch.experiment``:
  Hydra-style composition over ``conf/`` (:mod:`rlvae_tpu_torch.config`),
  single runs, comparison studies, sweeps and multiruns, with the trainer's
  callbacks, step timing, trace and NaN checks;
- deployment: :mod:`~rlvae_tpu_torch.export` (``torch.export`` programs
  per op and bucket, the kernels as registered ops), the bundle server,
  the live app server and the static dashboard (``app_server``, ``app``),
  and the evaluation utilities (``utils.evaluation``, ``fid``, ``mcmc``,
  ``tsne``, ``umap_lite``; ``python -m rlvae_tpu_torch.evaluation_cli``).

Hand-written CUDA kernels (``csrc/``) compute the chol-bundle, the IAF
chain's forward and backward, the HMC chain's target and gradient, the
metric bundle (G^{-1}, its Cholesky factor, logdet and G) and G^{-1}, and
the decoder's last layer with its sigmoid and MSE, forward and backward.  The
package imports PyTorch and numpy only; kernels are built with ``nvcc`` at
first use on the card.
"""

import importlib

# The names below load at first use, so that a submodule imports only what it
# needs: the bundle server (rlvae_tpu_torch.bundle_server) runs exported
# programs without importing a model class.
_EXPORTS = {
    "BatchingEngine": "serving", "EngineStats": "serving", "ServeConfig": "serving",
    "ModelManager": "inference", "slerp": "inference",
    "PRESETS": "models", "RlVAE": "models", "create_model": "models",
    "resolve_device": "device",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module 'rlvae_tpu_torch' has no attribute {name!r}")
    value = getattr(importlib.import_module(f"rlvae_tpu_torch.{_EXPORTS[name]}"), name)
    globals()[name] = value
    return value
