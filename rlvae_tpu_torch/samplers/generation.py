"""The generation-sampler zoo: the pythae sampler surface.

Port of ``rlvae_tpu/samplers/generation.py``: latent samplers behind one
``fit`` / ``sample`` surface, each batch of latents decoded in one call of
the model's decoder.

- :class:`BaseGenerationSampler`: ``fit`` (a no-op) and ``sample``, which
  draws ``num_samples`` latents in batches, decodes them and optionally
  writes ``generated.npz`` and ``sampler_config.json``;
- :class:`NormalSampler`: z ~ N(0, I);
- :class:`VampSampler`: a VAMP model's mixture prior, each sample from one
  pseudo-input's posterior, its log-variance through tanh;
- :class:`RHVAEGenerationSampler`: the official manifold-HMC chain from
  centroid starts (1601 ``hmc_terms`` launches a batch);
- :class:`AdaptiveRHVAEGenerationSampler`: ``fit`` calibrates the adaptive
  plan with a warm-start pool; each batch is the planned fixed-eps chain,
  and with ``persistent=True`` each chain's final state goes back into its
  own pool slot (its eps stays paired with the slot).

A sampler's randomness comes from one ``torch.Generator`` on the metric's
(or model's) device seeded with ``sample``'s ``seed``; each batch draws from
it in turn.  ``sample_latents(n, generator, noise)`` takes the draws of one
batch as ``noise`` instead (the tests pass JAX's in).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from rlvae_tpu_torch.samplers.hmc import (
    ADAPTIVE_EPS_JITTER,
    HMCConfig,
    calibrate_adaptive_plan,
    draw_hmc_noise,
    draw_planned_noise,
    sample_prior_hmc,
    sample_prior_hmc_planned,
)

Noise = Optional[Mapping[str, torch.Tensor]]


class BaseGenerationSampler:
    """``fit()`` then ``sample()``, as pythae's BaseSampler.  Subclasses
    implement :meth:`sample_latents`; decoding is the model's decoder."""

    name = "BaseGenerationSampler"

    def __init__(self, model):
        self.model = model

    def fit(self, train_data=None, eval_data=None, training_config=None) -> None:
        """Most samplers need no fitting (reference base_sampler.py:49)."""

    def sample_latents(self, n: int, generator: Optional[torch.Generator] = None,
                       noise: Noise = None) -> torch.Tensor:
        raise NotImplementedError

    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _decode(self, z: torch.Tensor) -> np.ndarray:
        with torch.no_grad():
            out = self.model.decode(z.to(self.device()))["reconstruction"]
        return out.float().cpu().numpy()

    def sample(self, num_samples: int = 1, batch_size: int = 500,
               output_dir: Optional[str | Path] = None, return_gen: bool = True,
               save_sampler_config: bool = False, seed: int = 0):
        """Generate ``num_samples`` images in batches of at most
        ``batch_size`` (reference base_sampler.py:51-95); with
        ``output_dir`` write ``generated.npz`` (key ``images``) and, with
        ``save_sampler_config``, ``sampler_config.json``."""
        generator = torch.Generator(device=self.device()).manual_seed(int(seed))
        out = []
        remaining = int(num_samples)
        while remaining > 0:
            b = min(batch_size, remaining)
            with torch.no_grad():
                z = self.sample_latents(b, generator)
            out.append(self._decode(z))
            remaining -= b
        gen = np.concatenate(out, axis=0)[:num_samples]
        if output_dir is not None:
            outp = Path(output_dir)
            outp.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(outp / "generated.npz", images=gen)
            if save_sampler_config:
                (outp / "sampler_config.json").write_text(
                    json.dumps({"name": self.name, "num_samples": int(num_samples)}))
        return gen if return_gen else None


class NormalSampler(BaseGenerationSampler):
    """Standard-normal prior sampling (reference normal_sampler.py:37-85);
    the draw is ``eps`` [n, D]."""

    name = "NormalSampler"

    def __init__(self, model, latent_dim: Optional[int] = None):
        super().__init__(model)
        self.latent_dim = int(latent_dim or model.latent_dim)

    def sample_latents(self, n, generator=None, noise=None):
        if noise is not None:
            return noise["eps"].to(self.device(), torch.float32)
        return torch.randn((n, self.latent_dim), generator=generator, device=self.device())


class VampSampler(BaseGenerationSampler):
    """VampPrior mixture sampling (reference vamp_sampler.py:40-112) of a
    :class:`~rlvae_tpu_torch.models.research.VAMP`: the pseudo-inputs
    encoded, a component index per sample (``idx`` [n]), and a draw from
    that component's Gaussian (``eps`` [n, D]) with its log-variance clamped
    by tanh, as pythae does (vamp_sampler.py:66,90): without it a sharp
    component samples with exponentially wrong variance."""

    name = "VampSampler"

    def sample_latents(self, n, generator=None, noise=None):
        dev = self.device()
        mu_k, lv_k = self.model.pseudo_posteriors()  # [C, D]
        if noise is not None:
            idx = torch.as_tensor(noise["idx"], device=dev).long()
            eps = torch.as_tensor(noise["eps"], dtype=torch.float32, device=dev)
        else:
            idx = torch.randint(0, self.model.number_components, (n,), generator=generator,
                                device=dev)
            eps = torch.randn((n, self.model.latent_dim), generator=generator, device=dev)
        return mu_k[idx] + torch.exp(0.5 * torch.tanh(lv_k[idx])) * eps


def _model_metric(model, metric):
    metric = metric if metric is not None else model.metric
    if metric is None:
        raise ValueError("RHVAE sampling requires a metric (load_pretrained_metric)")
    return metric


class RHVAEGenerationSampler(BaseGenerationSampler):
    """Manifold-HMC prior sampling from centroid starts (reference
    rhvae_sampler.py:98-148); the draws are those of ``draw_hmc_noise``."""

    name = "RHVAESampler"

    def __init__(self, model, metric=None, hmc_config: Optional[HMCConfig] = None):
        super().__init__(model)
        self.metric = _model_metric(model, metric)
        self.hmc = hmc_config or HMCConfig(init="centroids")

    def sample_latents(self, n, generator=None, noise=None):
        if noise is None:
            noise = draw_hmc_noise(self.metric, n, self.hmc, generator)
        return sample_prior_hmc(self.metric, n, self.hmc, z0=noise["z0"],
                                gammas=noise["gammas"], unifs=noise["unifs"])


class AdaptiveRHVAEGenerationSampler(BaseGenerationSampler):
    """Adaptive manifold sampler (beyond the reference): :meth:`fit` runs
    ``calibrate_adaptive_plan`` with a warm-start pool of ``pool_size``, from
    a generator seeded ``calibration_seed``; each batch then runs
    ``gen_steps`` fixed-eps steps of the planned chain, whose draws are
    those of ``draw_planned_noise``.  With ``persistent`` each call's final
    states are written back into the pool slots they started from, so the
    stored chains keep mixing with use (when n > P the slots repeat and
    which duplicate's state is kept is unspecified, as in JAX)."""

    name = "AdaptiveRHVAESampler"

    def __init__(self, model, metric=None, hmc_config: Optional[HMCConfig] = None,
                 pool_size: int = 4096, gen_steps: int = 12, persistent: bool = True,
                 calibration_seed: int = 12):
        super().__init__(model)
        self.metric = _model_metric(model, metric)
        self.hmc = hmc_config or HMCConfig(init="centroids")
        self.pool_size = pool_size
        self.gen_steps = gen_steps
        self.persistent = persistent
        self.calibration_seed = int(calibration_seed)
        self.plan: Optional[Dict[str, Any]] = None

    def fit(self, train_data=None, eval_data=None, training_config=None) -> None:
        """The calibration is this sampler's fit step: paid once, reused by
        every ``sample_latents``."""
        gen = torch.Generator(device=self.metric.centroids.device).manual_seed(
            self.calibration_seed)
        with torch.no_grad():
            self.plan = calibrate_adaptive_plan(self.metric, self.hmc, pool_size=self.pool_size,
                                                generator=gen)

    def sample_latents(self, n, generator=None, noise=None):
        if self.plan is None:
            self.fit()
        if noise is None:
            noise = draw_planned_noise(self.metric, n, self.plan, self.gen_steps,
                                       ADAPTIVE_EPS_JITTER, generator)
        z = sample_prior_hmc_planned(self.metric, n, self.plan, self.gen_steps, noise=noise)
        if self.persistent and "pool" in self.plan:
            pool = self.plan["pool"].clone()
            pool[noise["idx"].to(pool.device).long()] = z
            self.plan["pool"] = pool
        return z


SAMPLER_REGISTRY = {
    "normal": NormalSampler,
    "vamp": VampSampler,
    "rhvae": RHVAEGenerationSampler,
    "rhvae_adaptive": AdaptiveRHVAEGenerationSampler,
}
