"""ModelManager: the inference API of the port.

Port of ``rlvae_tpu/inference.py:48-205``: ``encode``, ``decode``,
``reconstruct``, ``embed_sequence``, the generation ops ``sample_random``,
``sample_random_batched_seeds``, ``sample_latent`` and ``adaptive_plan``,
``interpolate`` (``linear``, ``spherical`` with :func:`slerp`, and
``geodesic`` under the learned metric), and ``get_model_info``.  A manager
holds a model built from a config (``from_config``: pretrained nets, seeded flows) or a trained
one from a Trainer run's checkpoint (``from_checkpoint``, ``from_run``).
Inputs are numpy arrays (or tensors); outputs are numpy arrays, as on the
JAX side.  The model lives on one device, resolved by
:func:`rlvae_tpu_torch.device.resolve_device`: the CUDA card unless the
caller asks for another.  The noise of every op comes from a
``torch.Generator`` on that device seeded with ``seed``; it cannot reproduce
JAX's bits.

``sample_random_batched_seeds`` keeps the JAX contract
(``rlvae_tpu/inference.py:24-45``): row i is the sequence
``sample_random(1, seed=seeds[i])`` gives.  Each row's draws come from its
own generator, in the order a one-row ``sample_random`` draws them; then one
batched call runs every row at once (the prior and the chain treat rows
independently, as JAX's ``vmap`` does).  For ``method="adaptive"`` every
row runs the planned chain on the manager's cached :meth:`adaptive_plan`,
as JAX's does; ``sample_random`` runs the budgeted adaptive sampler.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from rlvae_tpu_torch.device import DeviceLike, resolve_device
from rlvae_tpu_torch.geometry.geodesics import geodesic_interpolate
from rlvae_tpu_torch.models import RlVAE, create_model
from rlvae_tpu_torch.samplers.hmc import HMCConfig, calibrate_adaptive_plan, concat_rows
from rlvae_tpu_torch.train.checkpoints import CheckpointManager
from rlvae_tpu_torch.utils.output import ModelOutput


PLAN_SEED = 12  # the calibration's seed, JAX's PRNGKey(12)


def slerp(t, z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation between latent vectors at ``t`` (a scalar or
    a column broadcast against them), as ``rlvae_tpu/inference.py:48-55``:
    the angle of the normalised vectors (norms guarded by +1e-8, cosine
    clipped to +-(1 - 1e-7)), applied to the unnormalised ones."""
    z1n = z1 / (torch.linalg.vector_norm(z1, dim=-1, keepdim=True) + 1e-8)
    z2n = z2 / (torch.linalg.vector_norm(z2, dim=-1, keepdim=True) + 1e-8)
    omega = torch.arccos(torch.clamp((z1n * z2n).sum(-1, keepdim=True), -1 + 1e-7, 1 - 1e-7))
    so = torch.sin(omega)
    return (torch.sin((1.0 - t) * omega) / so) * z1 + (torch.sin(t * omega) / so) * z2


class ModelManager:
    """Hold one inference-mode model on one device."""

    def __init__(self, model: RlVAE, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self._adaptive_plan: Optional[Dict[str, Any]] = None

    @classmethod
    def from_config(cls, model_config: Dict[str, Any], seed: int = 0,
                    device: DeviceLike = None) -> "ModelManager":
        """Model from a config dict (e.g. ``PRESETS["riemannian_flow_vae"]``);
        pretrained encoder/decoder/metric where the config names them, seeded
        random flows."""
        device = resolve_device(device)  # fail before the weights are read
        return cls(create_model(model_config, seed=seed), device)

    @classmethod
    def from_checkpoint(cls, run_dir: str | Path, model_config: Dict[str, Any],
                        slot: str = "best", device: DeviceLike = None) -> "ModelManager":
        """Model of ``model_config`` with the weights of a Trainer run's
        checkpoint slot (``run_dir/checkpoints/<slot>``).  The slot's
        tensors are read straight onto ``device``.  The config is an
        argument because the run's ``model_config.json`` is the model
        summary, not a ``create_model`` config."""
        device = resolve_device(device)
        state = CheckpointManager(Path(run_dir) / "checkpoints").restore(slot, map_location=device)
        model = create_model(model_config).to(device)
        model.load_state_dict(state["params"])
        return cls(model, device)

    @classmethod
    def from_run(cls, run_dir: str | Path, slot: str = "best",
                 device: DeviceLike = None) -> "ModelManager":
        """``from_checkpoint`` with the ``model`` section of the run's
        ``config.yaml``: the YAML the experiment runner
        (``python -m rlvae_tpu_torch.experiment``) and ``python -m
        rlvae_tpu_torch.train`` write, the JSON text older runs of the
        latter wrote, or a JAX run's.  A JAX run's checkpoint slots are
        orbax directories, which raise: convert them with
        ``rlvae_tpu_torch.convert.checkpoint_from_jax``."""
        from rlvae_tpu_torch.config import load_yaml

        cfg_path = Path(run_dir) / "config.yaml"
        if not cfg_path.exists():
            raise FileNotFoundError(f"No config.yaml in {run_dir}")
        full = load_yaml(cfg_path.read_text()) or {}
        if not isinstance(full.get("model"), dict):
            raise ValueError(f"{cfg_path} has no 'model' section")
        return cls.from_checkpoint(run_dir, full["model"], slot=slot, device=device)

    def _tensor(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=torch.float32)
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

    # -- core ops -------------------------------------------------------------

    def forward(self, x_seq, seed: int = 0, eps: Optional[torch.Tensor] = None,
                noise: Optional[Mapping[str, torch.Tensor]] = None) -> ModelOutput:
        """Full forward with losses; tensors stay on the device.  The
        posterior noise of the model's method (``RlVAE.draw_posterior_noise``)
        is drawn from ``seed`` unless ``noise`` (or ε alone as ``eps``) is
        given."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.inference_mode():
            return self.model(self._tensor(x_seq), noise, generator=gen, eps=eps)

    def encode(self, x) -> ModelOutput:
        """Frame(s) [B, C, H, W] -> (embedding, log_covariance), numpy."""
        return ModelOutput({k: v.float().cpu().numpy() for k, v in self.encode_rows(x).items()})

    def encode_rows(self, x) -> ModelOutput:
        """:meth:`encode` as tensors on the device, without waiting for them."""
        with torch.inference_mode():
            return self.model.encode(self._tensor(x))

    def decode(self, z) -> np.ndarray:
        return self.decode_rows(z).float().cpu().numpy()

    def decode_rows(self, z) -> torch.Tensor:
        """:meth:`decode` as a tensor on the device, without waiting for it."""
        with torch.inference_mode():
            return self.model.decode(self._tensor(z))["reconstruction"]

    def reconstruct(self, x_seq, seed: int = 0) -> np.ndarray:
        """[B, T, C, H, W] -> reconstructed sequences."""
        return self.reconstruct_rows(x_seq, seed).float().cpu().numpy()

    def reconstruct_rows(self, x_seq, seed: int = 0,
                         noise: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
        """:meth:`reconstruct` as a tensor on the device, without waiting for
        it; ``noise``, when given, is the posterior noise (moved to the
        device) in place of the draw from ``seed``."""
        if noise is not None:
            noise = {k: v.to(self.device) for k, v in noise.items()}
        return self.forward(x_seq, seed, noise=noise).recon_x

    def embed_sequence(self, x_seq, seed: int = 0) -> np.ndarray:
        """[B, T, C, H, W] -> latent trajectories [B, T, D]."""
        return self.forward(x_seq, seed).z.float().cpu().numpy()

    # -- generation -----------------------------------------------------------

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def sample_random(self, n: int, method: str = "geodesic", seed: int = 0,
                      n_obs: Optional[int] = None) -> np.ndarray:
        """Prior samples decoded to sequences [n, n_obs, C, H, W];
        ``method="adaptive"`` runs the budgeted adaptive sampler, as JAX's."""
        with torch.no_grad():  # not inference_mode: the 'basic' prior differentiates
            x = self.model.generate(n, n_obs or 8, method, generator=self._generator(seed))
        return x.float().cpu().numpy()

    def sample_random_batched_seeds(self, seeds: Sequence[int], method: str = "geodesic",
                                    n_obs: int = 8) -> np.ndarray:
        """Row i equals ``sample_random(1, method, seed=seeds[i], n_obs)``
        (for ``adaptive``: ``RlVAE.generate`` on the plan of
        :meth:`adaptive_plan` with that seed's generator); all rows run as
        one batch."""
        return self.generate_rows(seeds, method, n_obs).float().cpu().numpy()

    def generate_rows(self, seeds: Sequence[int], method: str = "geodesic",
                      n_obs: int = 8) -> torch.Tensor:
        """:meth:`sample_random_batched_seeds` as a tensor on the device,
        without waiting for it."""
        seeds = [int(s) for s in np.asarray(seeds, dtype=np.uint32).reshape(-1)]
        if not seeds:
            return torch.zeros((0, n_obs, *self.model.input_dim), device=self.device)
        plan = self.adaptive_plan() if method == "adaptive" else None
        noise = concat_rows([self.model.draw_generation_noise(1, method, self._generator(s),
                                                              plan=plan) for s in seeds])
        with torch.no_grad():
            return self.model.generate(len(seeds), n_obs, method, noise=noise, plan=plan)

    def replica(self, device: DeviceLike) -> "ModelManager":
        """This manager on its own device, else a manager of a copy of this
        model on ``device``, sharing this manager's adaptive plan once it is
        built."""
        if torch.device(device) == self.device:
            return self
        other = ModelManager(copy.deepcopy(self.model), device)
        other._adaptive_plan = self._adaptive_plan
        return other

    def adaptive_plan(self, pool_size: int = 4096,
                      config: Optional[HMCConfig] = None) -> Dict[str, Any]:
        """The calibrated adaptive-sampler plan of this model's metric
        (``calibrate_adaptive_plan`` from a generator on the manager's device
        seeded 12, with a warm-start pool of ``pool_size``), built at the
        first call and cached: later calls return it whatever they ask."""
        if self.model.metric is None:
            raise ValueError("adaptive generation requires a metric")
        if self._adaptive_plan is None:
            with torch.no_grad():
                self._adaptive_plan = calibrate_adaptive_plan(
                    self.model.metric, config or HMCConfig(init="centroids"),
                    pool_size=pool_size, generator=self._generator(PLAN_SEED))
        return self._adaptive_plan

    def sample_latent(self, n: int, method: str = "geodesic", seed: int = 0) -> np.ndarray:
        """Prior latents [n, D]."""
        with torch.no_grad():
            z = self.model.sample_riemannian_prior(n, method, generator=self._generator(seed))
        return z.float().cpu().numpy()

    def interpolate(self, x1, x2, n_steps: int = 10, mode: str = "linear") -> np.ndarray:
        """Decoded frames along a path between the embeddings of frames
        ``x1`` and ``x2`` [C, H, W]: ``n_steps`` points at ``linspace(0, 1)``,
        ``spherical`` by :func:`slerp`, otherwise straight (``linear``);
        ``geodesic`` a geodesic under the model's learned metric
        (``geodesic_interpolate``'s energy-minimized path, 200 Adam steps,
        one metric-bundle launch each; ``ValueError`` without a metric)."""
        mu1, mu2 = (self._tensor(self.encode(np.asarray(x, np.float32)[None]).embedding[0])
                    for x in (x1, x2))
        if mode == "geodesic":
            metric = self.model.metric
            if metric is None:
                raise ValueError("geodesic interpolation needs a model with a Riemannian metric")
            return self.decode(geodesic_interpolate(metric, mu1, mu2, n_points=n_steps))
        ts = torch.linspace(0.0, 1.0, n_steps, device=self.device)[:, None]
        if mode == "spherical":
            zs = slerp(ts, mu1, mu2)
        else:
            zs = (1.0 - ts) * mu1[None] + ts * mu2[None]
        return self.decode(zs)

    # -- info -----------------------------------------------------------------

    def get_model_info(self) -> Dict[str, Any]:
        """The model summary with its parameter count (JAX's ``get_model_info``)."""
        return self.model.get_model_summary(include_parameter_count=True)
