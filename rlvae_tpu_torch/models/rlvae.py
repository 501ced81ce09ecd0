"""RlVAE: the Riemannian Flow VAE.

Port of ``RlVAE.encode``, ``decode``, ``sample_z0`` and ``forward``
(``rlvae_tpu/models/rlvae.py:234-390``): encode frame 0 -> posterior sample
z0 -> temporal IAF chain (one IAF-chain launch) -> open/closed loop handling
-> decode all B*T frames as one batch -> reconstruction + KL + flow + loop
losses.  The default ``riemannian_metric`` posterior draws z0 with one
chol-bundle launch and its KL takes a second.  A ``gaussian`` posterior with a
metric draws z0 by ``sampling.method`` (:func:`sample_posterior`: the
``geodesic`` method launches the metric bundle once for G, ``basic``,
``enhanced`` and ``official`` the chol-bundle once) and takes the standard KL.
The posterior noise (ε, and t for ``geodesic``; see
:meth:`RlVAE.draw_posterior_noise`) can be passed in as ``noise``.
``forward(..., compute_metrics=True)`` adds the evaluation step's analysis
metrics (``losses.additional_metrics``: with a metric, one G^{-1} launch and
one chol-bundle launch at z0).

``forward`` is differentiable: ``loss.backward()`` runs the chol-bundle's
recompute backward twice and, in the density direction, the IAF-chain
backward kernel once (the ``sampling`` direction runs the flows as plain
ops, with no kernel).  ``flow_fixedpoint_iters = K > 0`` runs the chain's
MADE blocks by K Jacobi passes and a final one in the same launch, and its
backward at K + 1 adjoint sweeps (``flows/temporal.py``); the sampling
direction ignores it, as in JAX.  Callers that only infer run it under
``torch.inference_mode()``.  ``train`` reaches the nets, as JAX's
``_apply_net`` (``rlvae_tpu/models/rlvae.py:236-260``) does: BatchNorm
layers (CNN, ResNet) normalise by the batch's statistics and move their
running ones once per train forward (the encoder's over the B frames 0,
the decoder's over the B*T decoded frames), and dropout acts, with
keep-masks from ``dropout`` (a :class:`~rlvae_tpu_torch.nets.DropoutMasks`,
or a ``torch.Generator`` to draw them from; the forward's ``generator``
when not given), the encoder's first.  In eval the running statistics
are read and dropout is off.  ``train`` also lets the two
reconstruction-loss knobs of ``rlvae_tpu/models/rlvae.py:316-356`` act:

- ``fused_decode_mse`` (MLP decoders without dropout, as in JAX): the
  reconstruction loss is one
  :class:`~rlvae_tpu_torch.ops.recon_kernels.DecodeMSE` over the decoder's
  last hidden layer (``decode_mse`` forward, its dh and dW/db kernels in
  the backward), and the full decode is not run: ``recon_x`` is None.  JAX
  still writes the decode in its ``forward`` but its ``jit`` removes it as
  dead code in a train step; run eagerly it would write the [B*T, C*H*W]
  reconstruction that the kernel exists to avoid.
- ``remat_decode`` (when the fused loss is not taken, and the decoder has
  no BatchNorm, whose running statistics the recompute would move twice:
  JAX skips it there too): the decode and the reconstruction loss run
  under ``torch.utils.checkpoint``, so the backward decodes again instead
  of keeping the decoder's activations, on the dropout masks of the first
  pass; the numbers are the plain path's, and ``recon_x`` is None for the
  same reason.

With ``compute_metrics`` the reconstruction is decoded all the same (the
analysis metrics read it).  The metric's centroids and matrices are
non-persistent buffers, so ``model.to(device)`` moves them with the weights,
the state dict holds only the learnable parameters, and the optimizer never
sees them.

Generation (``sample_riemannian_prior``, ``generate``; JAX
``rlvae.py:426-474``) draws prior latents by one of the prior methods or the
manifold-HMC chain (``official``: centroid starts; ``hmc``: normal starts;
one ``hmc_terms`` launch per target evaluation, 1601 per chain; ``adaptive``
with a calibrated ``plan``: the planned fixed-eps chain, 1 + 12 (n_lf + 1)
evaluations; without one, the budgeted three-phase sampler), evolves them
through the temporal flows (one IAF-chain launch) and decodes them.  Every
draw can be passed in as ``noise`` (:meth:`draw_generation_noise` says what
it holds); otherwise it comes from ``generator``.

:meth:`RlVAE.estimate_nll` is the importance-sampled negative
log-likelihood (JAX ``rlvae.py:476-558``): one chol-bundle launch for the
``riemannian_metric`` posterior's proposal, then per sample one IAF-chain
launch and a decode.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import math

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from rlvae_tpu_torch.flows.temporal import TemporalFlows, apply_temporal_flows
from rlvae_tpu_torch.geometry.metric import CentroidMetric
from rlvae_tpu_torch.models import losses
from rlvae_tpu_torch.nets.layers import BatchNorm, DropoutMasks, MaskFn, init_net
from rlvae_tpu_torch.nets.mlp import MLPDecoder
from rlvae_tpu_torch.nets.registry import create_decoder, create_encoder
from rlvae_tpu_torch.ops.recon_kernels import DecodeMSE
from rlvae_tpu_torch.geometry import metric as gm
from rlvae_tpu_torch.samplers.hmc import (
    HMCConfig,
    draw_hmc_noise,
    draw_planned_noise,
    sample_prior_hmc,
    sample_prior_hmc_adaptive_budget,
    sample_prior_hmc_planned,
)
from rlvae_tpu_torch.samplers.riemannian import (
    PRIOR_METHODS,
    draw_posterior_noise,
    draw_prior_noise,
    reparam,
    sample_metric_aware_posterior,
    sample_posterior,
    sample_prior,
)
from rlvae_tpu_torch.utils.output import ModelOutput

POSTERIOR_TYPES = ("gaussian", "iaf", "riemannian_metric")
LOOP_MODES = ("open", "closed")
HMC_METHODS = ("hmc", "official")
GENERATION_METHODS = PRIOR_METHODS + HMC_METHODS + ("adaptive",)


DropoutLike = Union[torch.Generator, MaskFn, None]


class _Rewind:
    """Masks handed out again in order on a rerun: a checkpointed decode's
    recompute sees the masks of its first pass."""

    def __init__(self, masks: MaskFn):
        self.masks, self.drawn, self.i = masks, [], 0

    def __call__(self, shape, rate, device):
        if self.i == len(self.drawn):
            self.drawn.append(self.masks(shape, rate, device))
        self.i += 1
        return self.drawn[self.i - 1]


class RlVAE(nn.Module):
    """Riemannian Flow VAE over cyclic longitudinal sequences."""

    def __init__(
        self,
        input_dim: Tuple[int, ...] = (3, 64, 64),
        latent_dim: int = 16,
        n_flows: int = 8,
        flow_hidden_size: int = 256,
        flow_n_blocks: int = 2,
        flow_n_hidden: int = 3,
        beta: float = 1.0,
        riemannian_beta: float = 8.0,
        posterior_type: str = "riemannian_metric",
        sampling_method: str = "geodesic",
        use_riemannian: bool = True,
        loop_mode: str = "open",
        loop_penalty: float = 5.0,
        flow_direction: str = "density",
        flow_log_var_bias_init: float = -2.0,
        flow_fixedpoint_iters: int = 0,
        flow_loss_mode: str = "reference",
        remat_decode: bool = False,
        fused_decode_mse: bool = False,
        encoder_config: Optional[Mapping[str, Any]] = None,
        decoder_config: Optional[Mapping[str, Any]] = None,
        metric: Optional[CentroidMetric] = None,
        seed: int = 0,
        name: str = "rlvae",
    ):
        super().__init__()
        if posterior_type not in POSTERIOR_TYPES:
            raise ValueError(f"posterior_type must be one of {POSTERIOR_TYPES}")
        if loop_mode not in LOOP_MODES:
            raise ValueError(f"loop_mode must be one of {LOOP_MODES}")
        if flow_loss_mode not in ("reference", "volume"):
            raise ValueError("flow_loss_mode must be 'reference' or 'volume'")
        self.input_dim = tuple(input_dim)
        self.latent_dim = latent_dim
        self.n_flows = n_flows
        self.beta = float(beta)
        self.riemannian_beta = float(riemannian_beta)
        self.posterior_type = posterior_type
        self.sampling_method = sampling_method
        self.use_riemannian = bool(use_riemannian)
        self.loop_mode = loop_mode
        self.loop_lambda = float(loop_penalty)
        self.flow_loss_mode = flow_loss_mode
        self.remat_decode = bool(remat_decode)
        self.fused_decode_mse = bool(fused_decode_mse)
        self.name = name

        generator = torch.Generator().manual_seed(seed)
        self.encoder = create_encoder(self.input_dim, latent_dim, encoder_config)
        self.decoder = create_decoder(self.input_dim, latent_dim, decoder_config)
        for module in (self.encoder, self.decoder):
            init_net(module, generator)
        self.flows = TemporalFlows(
            latent_dim, n_flows, flow_hidden_size, flow_n_blocks, flow_n_hidden,
            direction=flow_direction, log_var_bias_init=flow_log_var_bias_init,
            fixedpoint_iters=flow_fixedpoint_iters, generator=generator,
        )
        self.set_metric(metric)

    # -- metric ---------------------------------------------------------------

    def set_metric(self, metric: Optional[CentroidMetric]) -> None:
        self._metric_scalars = self._metric_view = None
        self.register_buffer("metric_centroids", None, persistent=False)
        self.register_buffer("metric_matrices", None, persistent=False)
        if metric is not None:
            self.metric_centroids = metric.centroids
            self.metric_matrices = metric.matrices
            self._metric_scalars = (metric.temperature, metric.regularization)

    @property
    def metric(self) -> Optional[CentroidMetric]:
        """The metric over the bank's buffers; one view while the buffers are
        the same tensors, so its padded kernel bank is made once."""
        if self._metric_scalars is None:
            return None
        view = self._metric_view
        if (view is None or view.centroids is not self.metric_centroids
                or view.matrices is not self.metric_matrices):
            view = self._metric_view = CentroidMetric(
                self.metric_centroids, self.metric_matrices, *self._metric_scalars)
        return view

    # -- forward --------------------------------------------------------------

    def encode(self, x0: torch.Tensor, train: bool = False,
               masks: Optional[MaskFn] = None) -> Dict[str, torch.Tensor]:
        return self.encoder(x0, train, masks)

    def decode(self, z: torch.Tensor, train: bool = False,
               masks: Optional[MaskFn] = None) -> Dict[str, torch.Tensor]:
        return self.decoder(z, train, masks)

    def has_batch_stats(self, net: str) -> bool:
        """Whether the encoder's or decoder's layers keep BatchNorm statistics."""
        return any(isinstance(m, BatchNorm) for m in getattr(self, net).modules())

    def _posterior_metric(self) -> Optional[CentroidMetric]:
        """The metric a Gaussian posterior samples with (None: plain
        reparameterization), as ``sample_z0`` of the JAX package decides."""
        return self.metric if self.use_riemannian else None

    def draw_posterior_noise(self, batch: int,
                             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Every draw of one forward's posterior sample, in order: ε [B, D],
        and t [B, 1] for the ``geodesic`` method with a metric."""
        if self.posterior_type == "riemannian_metric":
            method, metric = "standard", None
        else:
            method, metric = self.sampling_method, self._posterior_metric()
        return draw_posterior_noise(metric, method, batch, self.latent_dim, generator,
                                    device=self._device())

    def sample_z0(self, mu, log_var, noise: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Posterior sampling switch (``RlVAE.sample_z0`` of the JAX package)."""
        metric = self.metric
        if self.posterior_type == "riemannian_metric":
            if metric is None:
                return reparam(mu, log_var, noise["eps"])
            return sample_metric_aware_posterior(metric, mu, log_var, noise["eps"])
        # the 'iaf' posterior is declared but stubbed in the reference -> gaussian
        return sample_posterior(self._posterior_metric(), mu, log_var, self.sampling_method,
                                noise)

    def forward(self, x: torch.Tensor,
                noise: Union[torch.Tensor, Mapping[str, torch.Tensor], None] = None,
                generator: Optional[torch.Generator] = None, train: bool = False,
                compute_metrics: bool = False, *,
                eps: Optional[torch.Tensor] = None,
                dropout: DropoutLike = None) -> ModelOutput:
        """Forward with losses.  ``noise`` is the posterior noise: a mapping
        as :meth:`draw_posterior_noise` returns, or ε [B, D] alone (also
        accepted as ``eps=``); drawn from ``generator`` when not given.
        ``compute_metrics`` adds ``metrics`` (``losses.additional_metrics``).
        ``train`` runs the nets in train mode, with dropout masks from
        ``dropout`` (else ``generator``), and lets ``fused_decode_mse`` and
        ``remat_decode`` act (module docstring)."""
        batch_size, n_obs = x.shape[0], x.shape[1]
        if eps is not None:
            if noise is not None:
                raise ValueError("pass the posterior noise as noise= or eps=, not both")
            noise = eps
        if noise is None:
            noise = self.draw_posterior_noise(batch_size, generator)
        elif isinstance(noise, torch.Tensor):
            noise = {"eps": noise}
        masks = None
        if train:
            source = generator if dropout is None else dropout
            masks = DropoutMasks(source) if source is None or isinstance(
                source, torch.Generator) else source
        enc = self.encode(x[:, 0], train, masks)
        mu, log_var = enc["embedding"], enc["log_covariance"]
        z0 = self.sample_z0(mu, log_var, noise)

        if self.n_flows > 0:
            z_seq, log_dets = apply_temporal_flows(self.flows, z0, n_obs)
        else:
            z_seq = z0[:, None, :].expand(-1, n_obs, -1).contiguous()
            log_dets = z0.new_zeros((batch_size, 0))

        z_last_raw = z_seq[:, -1]
        if self.loop_mode == "closed":
            z_seq = torch.cat([z_seq[:, :-1], z_seq[:, :1]], dim=1)

        z_flat = z_seq.reshape(batch_size * n_obs, self.latent_dim)
        # as rlvae_tpu/models/rlvae.py:322-333: the fused loss for MLP decoders
        # without dropout, remat only where no BatchNorm statistics would move twice
        recon = None
        if (self.fused_decode_mse and train and isinstance(self.decoder, MLPDecoder)
                and self.decoder.dropout == 0):
            recon_loss = self._fused_recon_loss(z_flat, x)
        elif self.remat_decode and train and not self.has_batch_stats("decoder"):
            rewind = _Rewind(masks)

            def decode_loss(z_flat, x):
                rewind.i = 0
                return self._decode_loss(z_flat, x, rewind)

            recon_loss = checkpoint(decode_loss, z_flat, x, use_reentrant=False)
        else:
            recon = self._decode_seq(z_flat, batch_size, n_obs, train, masks)
            recon_loss = losses.reconstruction_loss(recon, x, self.loop_mode)
        if compute_metrics and recon is None:
            recon = self._decode_seq(z_flat, batch_size, n_obs)

        metric = self.metric
        if self.posterior_type == "riemannian_metric" and metric is not None:
            kl = losses.riemannian_metric_kl(metric, mu, z0)
            kl_weight = self.riemannian_beta
        else:
            kl = losses.standard_kl(mu, log_var)
            kl_weight = self.beta

        flow = losses.flow_loss(log_dets, self.flow_loss_mode)
        loop = (
            losses.loop_penalty(z_last_raw, z_seq[:, 0])
            if self.loop_mode == "closed" else recon_loss.new_zeros(())
        )
        total = losses.total_loss(recon_loss, kl, flow, loop, kl_weight, self.loop_lambda)
        out = ModelOutput(
            recon_x=recon, z=z_seq, mu=mu, log_var=log_var, loss=total,
            recon_loss=recon_loss, kld_loss=kl, flow_loss=flow, loop_penalty=loop,
        )
        if compute_metrics:
            out["metrics"] = losses.additional_metrics(x, recon, z_seq,
                                                       self._posterior_metric())
        return out

    def _decode_seq(self, z_flat: torch.Tensor, batch_size: int, n_obs: int,
                    train: bool = False, masks: Optional[MaskFn] = None) -> torch.Tensor:
        recon = self.decode(z_flat, train, masks)["reconstruction"]
        return recon.reshape(batch_size, n_obs, *self.input_dim)

    def _decode_loss(self, z_flat: torch.Tensor, x: torch.Tensor,
                     masks: MaskFn) -> torch.Tensor:
        """Train decode and reconstruction loss: the body that
        ``remat_decode`` checkpoints."""
        recon = self._decode_seq(z_flat, x.shape[0], x.shape[1], True, masks)
        return losses.reconstruction_loss(recon, x, self.loop_mode)

    def _fused_recon_loss(self, z_flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The reconstruction loss through the fused decode+MSE kernel
        (``RlVAE._fused_recon_loss`` of the JAX package): the decoder's hidden
        stack, then the output layer, sigmoid and MSE in
        :class:`DecodeMSE`.  Row b*T + t carries weight w_t / B, with w_0 = 2
        in closed loop (frame 0 counted twice) and 1 otherwise."""
        batch_size, n_obs = x.shape[0], x.shape[1]
        h = self.decoder.hidden(z_flat)
        w_t = torch.ones(n_obs, dtype=torch.float32, device=x.device)
        if self.loop_mode == "closed":
            w_t[0] = 2.0
        rw = w_t.repeat(batch_size) / batch_size
        out = self.decoder.out
        return DecodeMSE.apply(h, out.weight, out.bias, x.reshape(batch_size * n_obs, -1), rw)

    # -- generation -------------------------------------------------------------

    def _device(self) -> torch.device:
        return next(self.parameters()).device

    def _check_generation_method(self, method: str) -> None:
        """Without a metric every method name is the standard normal draw,
        as JAX's ``sample_prior`` takes it (its evaluation CLI passes
        ``standard``)."""
        if self.metric is not None and method not in GENERATION_METHODS:
            raise ValueError(f"Unknown prior sampling method: {method}")

    def draw_generation_noise(self, num_samples: int, method: str = "geodesic",
                              generator: Optional[torch.Generator] = None,
                              plan: Optional[Mapping[str, Any]] = None) -> Dict[str, torch.Tensor]:
        """Every draw of ``sample_riemannian_prior(num_samples, method)``, in
        order: the chain's ``z0``, ``gammas`` [S, n, D] and ``unifs`` [S, n]
        for ``hmc``/``official``; for ``adaptive`` on a ``plan`` the planned
        chain's ``idx``, ``gammas``, ``unifs`` and ``jitters`` [S, n]; the
        prior's draws otherwise.  ``adaptive`` without a plan raises: the
        budget sampler's sampling-phase draws follow its n_lf decision,
        which takes the median over the whole batch."""
        self._check_generation_method(method)
        metric = self.metric
        if method == "adaptive" and metric is not None:
            if plan is None:
                raise ValueError(
                    "adaptive generation without a plan runs the budget sampler, whose "
                    "sampling-phase draws depend on its n_lf decision over the whole batch; "
                    "pass plan= (ModelManager.adaptive_plan()) or sample with a generator")
            return draw_planned_noise(metric, num_samples, plan, generator=generator)
        if method in HMC_METHODS and metric is not None:
            return draw_hmc_noise(metric, num_samples, _hmc_config(method), generator)
        return draw_prior_noise(metric, method, num_samples, self.latent_dim, generator,
                                device=self._device())

    def sample_riemannian_prior(self, num_samples: int, method: str = "geodesic",
                                generator: Optional[torch.Generator] = None,
                                noise: Optional[Mapping[str, torch.Tensor]] = None,
                                plan: Optional[Mapping[str, Any]] = None) -> torch.Tensor:
        """Prior latents [num_samples, D]: ``hmc``/``official`` run the
        manifold-HMC chain; ``adaptive`` the planned chain on ``plan`` (from
        ``calibrate_adaptive_plan``), else the budgeted adaptive sampler
        (whose draws ``noise`` may hold in part: see
        ``sample_prior_hmc_adaptive_budget``); the other methods
        ``sample_prior``."""
        self._check_generation_method(method)
        metric = self.metric
        if method == "adaptive" and metric is not None:
            if plan is not None:
                return sample_prior_hmc_planned(metric, num_samples, plan, generator=generator,
                                                noise=noise)
            return sample_prior_hmc_adaptive_budget(metric, num_samples,
                                                    HMCConfig(init="centroids"),
                                                    generator=generator, noise=noise)
        if noise is None:
            noise = self.draw_generation_noise(num_samples, method, generator)
        if method in HMC_METHODS and metric is not None:
            return sample_prior_hmc(metric, num_samples, _hmc_config(method), z0=noise["z0"],
                                    gammas=noise["gammas"], unifs=noise["unifs"])
        return sample_prior(metric, num_samples, self.latent_dim, method, noise=noise)

    def generate(self, num_samples: int, n_obs: int = 8, method: str = "geodesic",
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[Mapping[str, torch.Tensor]] = None,
                 plan: Optional[Mapping[str, Any]] = None) -> torch.Tensor:
        """Sample prior latents, evolve them through time, decode them:
        [num_samples, n_obs, *input_dim]."""
        z0 = self.sample_riemannian_prior(num_samples, method, generator, noise, plan)
        z_seq, _ = apply_temporal_flows(self.flows, z0, n_obs)
        recon = self.decode(z_seq.reshape(-1, self.latent_dim))["reconstruction"]
        return recon.reshape(num_samples, n_obs, *self.input_dim)

    def estimate_nll(self, x: torch.Tensor, n_samples: int = 50,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Importance-sampled negative log-likelihood per sequence, [B]:
        -(logsumexp_S(log w) - log S) with log w = log p(x|z0) + log p(z0) -
        log q(z0|x0) over S posterior samples.  The proposal q is the
        ``riemannian_metric`` posterior N(mu, G^{-1}(mu)) (one chol-bundle
        launch for L and its half logdet from L's diagonal) or N(mu, σ^2);
        the prior is the standard normal, as the reference's own estimator;
        p(x|z0) is a unit-variance Gaussian over the decoded sequence (z_t
        the flows' images of z0).  ``noise`` is ε [S, B, D], else drawn
        from ``generator`` one sample's [B, D] at a time."""
        b, n_obs, d = x.shape[0], x.shape[1], self.latent_dim
        if noise is None:
            noise = torch.stack([torch.randn((b, d), generator=generator, device=x.device)
                                 for _ in range(n_samples)])
        noise = noise.to(device=x.device, dtype=torch.float32)
        enc = self.encode(x[:, 0])
        mu, log_var = enc["embedding"], enc["log_covariance"]
        log_2pi = math.log(2 * math.pi)
        metric = self.metric
        riemannian = self.posterior_type == "riemannian_metric" and metric is not None
        if riemannian:
            l_mu = gm.chol_g_inv(metric, mu)
            half_logdet = torch.log(torch.diagonal(l_mu, dim1=-2, dim2=-1)).sum(-1)
        else:
            std = torch.exp(0.5 * log_var)
        log_w = []
        for eps in noise:
            if riemannian:
                z0 = mu + torch.einsum("bij,bj->bi", l_mu, eps)
                log_qz = -0.5 * (eps ** 2).sum(1) - 0.5 * d * log_2pi - half_logdet
            else:
                z0 = mu + eps * std
                log_qz = -0.5 * (eps ** 2).sum(1) - 0.5 * d * log_2pi - 0.5 * log_var.sum(1)
            log_pz = -0.5 * (z0 ** 2).sum(1) - 0.5 * d * log_2pi
            z_seq, _ = apply_temporal_flows(self.flows, z0, n_obs)
            recon = self._decode_seq(z_seq.reshape(b * n_obs, d), b, n_obs).float()
            log_px_z = (-0.5 * ((recon - x) ** 2).reshape(b, -1).sum(1)
                        - 0.5 * x[0].numel() * log_2pi)
            log_w.append(log_px_z + log_pz - log_qz)
        log_w = torch.stack(log_w)
        return -(torch.logsumexp(log_w, dim=0) - log_w.new_tensor(float(len(noise))).log())

    # -- introspection ----------------------------------------------------------

    def param_count(self) -> int:
        """Number of trainable parameters (JAX: ``param_count(variables)``)."""
        return sum(p.numel() for p in self.parameters())

    def get_model_summary(self, include_parameter_count: bool = False) -> Dict[str, Any]:
        """The dict of JAX's ``get_model_summary`` (``rlvae_tpu/models/rlvae.py:568``):
        without the parameter count it is the checkpoints' ``model_config.json``
        sidecar, with it ``ModelManager.get_model_info`` (JAX passes the
        variables for that)."""
        metric = self.metric
        summary: Dict[str, Any] = {
            "model_name": self.name,
            "architecture": {
                "latent_dim": self.latent_dim,
                "n_flows": self.n_flows,
                "input_dim": list(self.input_dim),
                "encoder": type(self.encoder).__name__,
                "decoder": type(self.decoder).__name__,
            },
            "configuration": {
                "posterior_type": self.posterior_type,
                "sampling_method": self.sampling_method,
                "use_riemannian": self.use_riemannian,
                "loop_mode": self.loop_mode,
                "beta": self.beta,
                "riemannian_beta": self.riemannian_beta,
            },
            # JAX holds the metric's scalars as float32 arrays
            "metric": None if metric is None else {
                "n_centroids": metric.n_centroids,
                "temperature": float(np.float32(metric.temperature)),
                "regularization": float(np.float32(metric.regularization)),
            },
        }
        if include_parameter_count:
            summary["parameter_count"] = self.param_count()
        return summary


def _hmc_config(method: str) -> HMCConfig:
    return HMCConfig(init="centroids" if method == "official" else "randn")
