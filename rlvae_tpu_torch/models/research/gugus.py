"""LVAE_GUGUS: the Riemannian-prior line of LVAE_IAF, every variant.

Port of ``rlvae_tpu/models/research/gugus.py``.  The variants are presets
of a few knobs (``variant=``):

- ``base``: the volume-only prior at visit 0,
  log p(z) = -0.5 log det G_0 - 0.5 |z - GM_0|^2;
- ``lvaeg``: the full metric-Gaussian prior
  log p(z) = -0.5 (log det G_0 + z^T G_0^{-1} z + D log 2 pi);
- ``lvaeg2``: per-visit diagonal metrics G_t stored for every visit
  (``metric_mode="stored"``), the pushforward beyond them;
- ``lvaegg``: local metrics (k-medoids centroids, kNN covariance; G_0 the
  local metric nearest the mean latent; a sampled Mahalanobis observation
  metric), and the pushforward field (``metric_mode="push"``);
- ``lvaega``: the visit-0 training latent drawn by manifold HMC from the
  posterior means on the one-centroid metric of (GM_0, G_0)
  (``use_hmc_visit0``);
- ``lvaega2``: as ``lvaega`` with weight-normalized flows (w = g v / |v|,
  per output column; :class:`WeightNormMADE`).

The metrics (``gm_list``, ``g_list``: numpy, on the host) are estimated by
:meth:`LVAE_GUGUS.retrieve_metric_all` or :meth:`retrieve_metric_local`.
The metric field pushes G through the flows by their exact inverses'
Jacobians (``torch.func.vmap`` of ``jacfwd``).

Kernels: the HMC draws (``lvaega``'s visit-0 latent and
:meth:`generate_hmc`) run :func:`~rlvae_tpu_torch.samplers.hmc.sample_prior_hmc`
on a one-centroid :class:`~rlvae_tpu_torch.geometry.metric.CentroidMetric`,
so on the card every target evaluation is one ``hmc_terms`` launch (B4 at
K = 1).  B4 has no backward (nor has JAX's kernel), so the ``lvaega``
training draw, which autograd would differentiate through the chain,
raises on the card (:func:`~rlvae_tpu_torch.samplers.hmc.refuse_grad_through_terms`);
on the CPU the plain terms are differentiable, as JAX's XLA terms are.

The HMC chains' draws are ``noise["gammas"]`` [S, B, D] and
``noise["unifs"]`` [S, B]; ``generate_hmc``'s chains start at the one
centroid, ``lvaega``'s at the posterior means.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rlvae_tpu_torch.flows.iaf import iaf_forward, iaf_inverse
from rlvae_tpu_torch.flows.made import MADE
from rlvae_tpu_torch.geometry.metric import CentroidMetric
from rlvae_tpu_torch.models.research.lldm import SampledMetric, _kmedoids
from rlvae_tpu_torch.models.research.lvae_iaf import LVAE_IAF, Noise
from rlvae_tpu_torch.ops.linalg import inv_psd_small
from rlvae_tpu_torch.samplers.hmc import (
    HMCConfig,
    draw_chain_noise,
    refuse_grad_through_terms,
    sample_prior_hmc,
)

VARIANT_PRESETS: Dict[str, Dict[str, Any]] = {
    "base": dict(riemann_prior_form="volume", metric_mode="stored",
                 use_hmc_visit0=False, weight_norm_flows=False),
    "lvaeg": dict(riemann_prior_form="gaussian", metric_mode="stored",
                  use_hmc_visit0=False, weight_norm_flows=False),
    "lvaeg2": dict(riemann_prior_form="gaussian", metric_mode="stored",
                   use_hmc_visit0=False, weight_norm_flows=False),
    "lvaegg": dict(riemann_prior_form="gaussian", metric_mode="push",
                   use_hmc_visit0=False, weight_norm_flows=False),
    "lvaega": dict(riemann_prior_form="gaussian", metric_mode="push",
                   use_hmc_visit0=True, weight_norm_flows=False),
    "lvaega2": dict(riemann_prior_form="gaussian", metric_mode="push",
                    use_hmc_visit0=True, weight_norm_flows=True),
}
GENERATE_HMC = HMCConfig(mcmc_steps=20, n_lf=15)


class WeightNormMADE(MADE):
    """A MADE block whose weights are stored weight-normalized: ``weights``
    hold the directions v, ``gains`` the per-output-column gains g, and the
    layer uses w = g v / (|v|_col + 1e-12) (converted from a block at its
    current weights: v = w, g = |w|_col)."""

    @classmethod
    def from_made(cls, block: MADE) -> "WeightNormMADE":
        """``block`` itself, recast: its parameters and masks are kept."""
        block.__class__ = cls
        block.gains = nn.ParameterList(
            nn.Parameter(torch.linalg.vector_norm(w.detach(), dim=0)) for w in block.weights)
        return block

    def weight(self, li: int) -> torch.Tensor:
        v = self.weights[li]
        return v * (self.gains[li] / (torch.linalg.vector_norm(v, dim=0) + 1e-12))[None, :]

    def masked_weight(self, li: int) -> torch.Tensor:
        return self.mask(li) * self.weight(li)


class LVAE_GUGUS(LVAE_IAF):
    # plain MSE, no 0.5 factor, unlike the LVAE_IAF parent
    recon_scale = 1.0

    def __init__(self, *args, variant: str = "base", use_riemann_prior: bool = False,
                 riemann_prior_form: Optional[str] = None, metric_mode: Optional[str] = None,
                 use_hmc_visit0: Optional[bool] = None, weight_norm_flows: Optional[bool] = None,
                 metric_eval_period: int = 0, hmc_visit0_steps: int = 10, **kwargs):
        # GUGUS's own config defaults: beta 5.0 and the IAF posterior
        kwargs.setdefault("beta", 5.0)
        kwargs.setdefault("posterior", "iaf")
        super().__init__(*args, **kwargs)
        if variant not in VARIANT_PRESETS:
            raise ValueError(f"unknown variant {variant!r}; one of {list(VARIANT_PRESETS)}")
        preset = VARIANT_PRESETS[variant]
        self.variant = variant
        self.use_riemann_prior = use_riemann_prior
        self.riemann_prior_form = riemann_prior_form or preset["riemann_prior_form"]
        self.metric_mode = metric_mode or preset["metric_mode"]
        self.use_hmc_visit0 = preset["use_hmc_visit0"] if use_hmc_visit0 is None \
            else use_hmc_visit0
        self.weight_norm_flows = preset["weight_norm_flows"] if weight_norm_flows is None \
            else weight_norm_flows
        self.metric_eval_period = int(metric_eval_period)
        self.hmc_visit0_steps = int(hmc_visit0_steps)
        self._fwd_counter = 0
        self.last_metric_diagnostics: Optional[Dict[str, float]] = None
        self.gm_list: List[np.ndarray] = []  # mean latent per visit, [1, D]
        self.g_list: List[np.ndarray] = []  # metric per visit, [D, D]
        self.sampled_metric: Optional[SampledMetric] = None  # lvaegg's observation metric
        if self.weight_norm_flows:
            for iaf in self.flows:
                for block in iaf.blocks:
                    WeightNormMADE.from_made(block)

    # -- metric estimation --------------------------------------------------------

    @torch.no_grad()
    def retrieve_metric_all(self, data: torch.Tensor, add_std_norm: bool = True
                            ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """Per-visit (GM_t, G_t) from the posterior statistics of ``data``
        [N, n_obs, ...]: the mean embedding and diag(mean std^2)."""
        self.gm_list, self.g_list = [], []
        for t in range(self.n_obs):
            mu, log_var = self._encode(data[:, t])
            self.gm_list.append(mu.mean(0, keepdim=True).cpu().numpy())
            if add_std_norm:
                std_avg = torch.exp(0.5 * log_var).mean(0).cpu().numpy()
                g_t = np.diag(std_avg ** 2)
            else:
                g_t = np.eye(self.latent_dim, dtype=np.float32)
            self.g_list.append(g_t.astype(np.float32))
        return self.gm_list, self.g_list

    def retrieve_metric(self, data: torch.Tensor, vi_index: int = 0, add_std_norm: bool = True):
        """The single-visit form: (GM, G) of visit ``vi_index``."""
        gms, gs = self.retrieve_metric_all(data, add_std_norm)
        return gms[vi_index], gs[vi_index]

    @torch.no_grad()
    def retrieve_metric_local(self, data: torch.Tensor, vi_index: int = 0,
                              num_centroids: int = 20, knn_neighbors: int = 30,
                              t_multiplier: float = 1.0, add_std_norm: bool = True):
        """``lvaegg``'s local metrics: k-medoids centroids of the visit's
        embeddings, the kNN covariance around each, G_0 the one nearest the
        mean latent, the temperature the largest nearest-centroid distance;
        also the sampled Mahalanobis observation metric.  Returns
        (mu_avg, G_0, T)."""
        mu_t, log_var_t = self._encode(data[:, vi_index])
        mu, log_var = mu_t.cpu().numpy(), log_var_t.cpu().numpy()
        mu_avg = mu.mean(axis=0, keepdims=True)
        k = min(num_centroids, len(mu))
        centroids, idx = _kmedoids(mu, k)
        if k > 1:
            d = np.sqrt(((centroids[:, None] - centroids[None]) ** 2).sum(-1))
            np.fill_diagonal(d, np.inf)
            temp = float(d.min(axis=1).max()) * t_multiplier
        else:
            temp = t_multiplier
        knn_neighbors = min(knn_neighbors, len(mu))
        local_metrics = []
        for c in centroids:
            order = np.argsort(((mu - c[None]) ** 2).sum(-1))[:knn_neighbors]
            pts = mu[order]
            if add_std_norm and len(pts) > 1:
                g_local = np.cov(pts.T) + 1e-4 * np.eye(mu.shape[1])
            else:
                g_local = np.eye(mu.shape[1])
            local_metrics.append(g_local.astype(np.float32))
        g0 = local_metrics[int(np.argmin(((centroids - mu_avg) ** 2).sum(-1)))]
        self.gm_list, self.g_list = [mu_avg], [g0]
        self.sampled_metric = SampledMetric(mu[idx], np.exp(-log_var[idx]), temp, 0.01)
        return mu_avg, g0, temp

    # -- metric field ---------------------------------------------------------------

    def push_metric(self, z: torch.Tensor, g: torch.Tensor, flow_idx: int,
                    direction: str = "inverse") -> Tuple[torch.Tensor, torch.Tensor]:
        """The metric pushed through one flow: for z' = f(z),
        G'(z') = J^{-T} G J^{-1}, J^{-1} = d f^{-1}/dz' at z' (the two
        directions are exact inverses)."""
        flow = self.flows[flow_idx]
        fwd, bwd = (iaf_inverse, iaf_forward) if direction == "inverse" \
            else (iaf_forward, iaf_inverse)

        def f_inv(single):
            return bwd(flow, single[None, :])[0][0]

        z_next = fwd(flow, z)[0]
        j_inv = torch.func.vmap(torch.func.jacfwd(f_inv))(z_next)  # [B, D, D]
        g_next = torch.einsum("bji,bjk,bkl->bil", j_inv, g.expand(j_inv.shape), j_inv)
        return z_next, g_next

    def metric_tensor_field(self, z: torch.Tensor, t: int) -> torch.Tensor:
        """G_t(z): the stored estimate of visit t where ``metric_mode`` is
        ``stored`` and one exists, otherwise G_0 pushed through the flows."""
        if not self.g_list:
            raise RuntimeError("metric not set; call retrieve_metric_all first")
        shape = (z.shape[0], self.latent_dim, self.latent_dim)
        if self.metric_mode == "stored" and t < len(self.g_list):
            return torch.as_tensor(self.g_list[t], device=z.device).expand(shape)
        g = torch.as_tensor(self.g_list[0], device=z.device).expand(shape)
        z_t = z
        for i in range(t):
            z_t, g = self.push_metric(z_t, g, i, direction="inverse")
        return g

    @torch.no_grad()
    def compare_metrics(self, data: torch.Tensor, t: int) -> Dict[str, float]:
        """The relative Frobenius drift between the pushforward field at t
        (mean over the batch) and the empirical diagonal metric of
        ``data[:, t]``, and both log-determinants."""
        mu, log_var = self._encode(data[:, t])
        std_avg = torch.exp(0.5 * log_var).mean(0).cpu().numpy()
        g_emp = np.diag(std_avg ** 2).astype(np.float32)
        with torch.enable_grad():  # the Jacobians of the pushforward
            g_push = self.metric_tensor_field(mu, t).mean(0).detach().cpu().numpy()
        denom = float(np.linalg.norm(g_emp)) + 1e-12
        diag = {"frobenius_rel": float(np.linalg.norm(g_push - g_emp)) / denom,
                "logdet_push": float(np.linalg.slogdet(g_push)[1]),
                "logdet_empirical": float(np.linalg.slogdet(g_emp)[1])}
        self.last_metric_diagnostics = diag
        return diag

    # -- the Riemannian prior ---------------------------------------------------------

    def log_p_z(self, z: torch.Tensor) -> torch.Tensor:
        """The visit-0 prior: ``volume`` or ``gaussian`` (module docstring); the
        parent's prior when no metric is set or the Riemannian prior is off."""
        if not (self.use_riemann_prior and self.g_list):
            return super().log_p_z(z)
        g0 = torch.as_tensor(self.g_list[0], device=z.device)
        logdet = torch.linalg.slogdet(g0)[1]
        if self.riemann_prior_form == "volume":
            gm0 = torch.as_tensor(self.gm_list[0], device=z.device)
            return (-0.5 * logdet).expand(z.shape[0]) - 0.5 * ((z - gm0) ** 2).sum(1)
        g_inv = inv_psd_small(g0[None])[0]
        quad = torch.einsum("bi,ij,bj->b", z, g_inv, z)
        return -0.5 * (logdet + quad + z.shape[1] * float(np.log(np.float32(2.0 * np.pi))))

    # -- HMC ----------------------------------------------------------------------

    def hmc_metric(self, vi_index: int = 0) -> CentroidMetric:
        """The one-centroid metric of (GM, G) at ``vi_index``: G^{-1}(z) =
        G^{-1} exp(-|z - GM|^2) + 0.01 I, on the model's device."""
        return CentroidMetric.create(np.asarray(self.gm_list[vi_index]),
                                     np.linalg.inv(self.g_list[vi_index])[None],
                                     temperature=1.0, regularization=0.01).to(self.device)

    def _chain(self, metric, n, config, z0, noise, generator):
        if noise is not None and "gammas" in noise:
            gammas, unifs = noise["gammas"], noise["unifs"]
        else:
            gammas, unifs = draw_chain_noise(generator, config.mcmc_steps, n, self.latent_dim)
        return sample_prior_hmc(metric, n, config, z0=z0, gammas=gammas, unifs=unifs)

    def sample_visit_latent(self, mu, log_var, vi_index, noise, generator):
        """``lvaega``: at visit 0 with a metric, manifold HMC from the
        posterior means (``hmc_visit0_steps`` steps of 15 leapfrogs);
        otherwise the parent's reparameterized draw."""
        if self.use_hmc_visit0 and vi_index == 0 and self.g_list:
            metric = self.hmc_metric(0)
            refuse_grad_through_terms(metric, mu)
            config = HMCConfig(mcmc_steps=self.hmc_visit0_steps, n_lf=15)
            return self._chain(metric, mu.shape[0], config, mu, noise, generator)
        return super().sample_visit_latent(mu, log_var, vi_index, noise, generator)

    def forward(self, x, noise: Noise = None, vi_index=None, epoch: int = 100,
                train: bool = False, seq_mask=None, pix_mask=None, generator=None):
        self._fwd_counter += 1
        if (self.metric_eval_period > 0 and self.g_list
                and self._fwd_counter % self.metric_eval_period == 0):
            self.compare_metrics(x, t=0)
        return super().forward(x, noise, vi_index, epoch, train, seq_mask, pix_mask, generator)

    @torch.no_grad()
    def generate_hmc(self, n: int, vi_index: int = 0, noise: Noise = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Visit latents by manifold HMC on the estimated metric (20 steps of
        15 leapfrogs from its centroid), propagated and decoded."""
        if not self.g_list:
            raise RuntimeError("metric not set; call retrieve_metric_all first")
        metric = self.hmc_metric(vi_index)
        z0 = metric.centroids[torch.zeros(n, dtype=torch.long, device=metric.centroids.device)]
        z = self._chain(metric, n, GENERATE_HMC, z0, noise, generator)
        return self._decode_seq(self.propagate(z, vi_index)[0])
