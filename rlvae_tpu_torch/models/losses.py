"""Loss library: port of ``rlvae_tpu/models/losses.py``."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from rlvae_tpu_torch.geometry import metric as gm
from rlvae_tpu_torch.geometry.metric import CentroidMetric
from rlvae_tpu_torch.ops import linalg as _lin

LOG_VAR_CLAMP = 10.0


def reconstruction_loss(recon: torch.Tensor, x: torch.Tensor, loop_mode: str = "open") -> torch.Tensor:
    """Per-frame squared error summed over frames and pixels, mean over the
    batch; closed-loop mode counts frame 0 twice.  A bf16 reconstruction
    keeps its residual in bf16 and sums in fp32, as the JAX side does."""
    if recon.dtype == torch.bfloat16:
        x = x.to(torch.bfloat16)
    frame_losses = (recon - x) ** 2  # [B, T, ...]
    if loop_mode == "closed":
        w = torch.ones(x.shape[1], dtype=frame_losses.dtype, device=x.device)
        w[0] = 2.0
        frame_losses = frame_losses * w.reshape(1, -1, *([1] * (x.dim() - 2)))
    return frame_losses.reshape(x.shape[0], -1).sum(1, dtype=torch.float32).mean()


def standard_kl(mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    lv = torch.clamp(log_var, -LOG_VAR_CLAMP, LOG_VAR_CLAMP)
    return (-0.5 * (1.0 + lv - mu ** 2 - torch.exp(lv)).sum(1)).mean()


def riemannian_metric_kl(metric: CentroidMetric, mu: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """0.5 E||L^{-1}(z) (z - mu)||^2 with L L^T = G^{-1}(z) (jitter 0)."""
    l = gm.chol_g_inv(metric, z, jitter=0.0)
    u = _lin.tri_solve_lower(l, (z - mu).float())
    return 0.5 * (u * u).sum(1).mean()


def riemannian_full_kl(metric: CentroidMetric, mu: torch.Tensor, log_var: torch.Tensor,
                       z: torch.Tensor) -> torch.Tensor:
    """Full Gaussian-vs-Riemannian-prior KL:

        0.5 (tr(G diag(e^lv)) + mu^T G mu - D + log det G - sum lv)

    with G = G(z) (one metric-bundle launch) and det G clamped to
    [1e-10, 1e10].  The trace term reads the unclamped ``log_var``; only the
    posterior log-det sum is clamped.  If any entry is non-finite the whole
    batch falls back to the standard-KL mean, as the reference's
    all-or-nothing guard does."""
    lv = torch.clamp(log_var, -LOG_VAR_CLAMP, LOG_VAR_CLAMP)
    g_z = gm.g(metric, z)
    trace_term = (torch.diagonal(g_z, dim1=-2, dim2=-1) * torch.exp(log_var)).sum(1)
    quad = gm.quadratic_form(g_z, mu)
    log_det_g = torch.log(torch.clamp(torch.exp(gm.logdet_g(metric, z)), 1e-10, 1e10))
    d = mu.shape[1]
    kl_r = 0.5 * (trace_term + quad - d + log_det_g - lv.sum(1))
    kl_std = -0.5 * (1.0 + lv - mu ** 2 - torch.exp(lv)).sum(1)
    return torch.where(torch.isfinite(kl_r).all(), kl_r.mean(), kl_std.mean())


def flow_loss(log_dets: torch.Tensor, mode: str = "reference") -> torch.Tensor:
    """``reference``: -E[sum log|det J|]; ``volume``: E[sum |log|det J||]."""
    if mode not in ("reference", "volume"):
        raise ValueError(f"unknown flow_loss mode {mode!r} (reference|volume)")
    if log_dets.shape[1] == 0:
        return log_dets.new_zeros(())
    if mode == "volume":
        return log_dets.abs().sum(1).mean()
    return -log_dets.sum(1).mean()


def loop_penalty(z_last_raw: torch.Tensor, z_first: torch.Tensor) -> torch.Tensor:
    return ((z_last_raw - z_first) ** 2).mean()


def total_loss(recon, kl, flow, loop, kl_weight: float, loop_lambda: float) -> torch.Tensor:
    return recon + kl_weight * kl + flow + loop_lambda * loop


def additional_metrics(x: torch.Tensor, recon: torch.Tensor, z_seq: torch.Tensor,
                       metric: Optional[CentroidMetric] = None) -> Dict[str, torch.Tensor]:
    """Analysis metrics of the evaluation step: cyclicity error, latent norm
    and variance (population statistics, as ``jnp.var``/``jnp.std``), and
    with a metric its conditioning at z0 (eigenvalues of G^{-1} on the first
    32 rows), the spread of log det G^{-1} and its mean determinant."""
    out = {
        "cyclicity_error": ((recon[:, 0] - recon[:, -1]) ** 2).mean(),
        "latent_norm": torch.linalg.vector_norm(z_seq, dim=-1).mean(),
        "latent_variance": torch.var(z_seq, correction=0),
    }
    if metric is not None:
        z0 = z_seq[:, 0]
        eigvals = torch.linalg.eigvalsh(gm.g_inv(metric, z0)[:32])
        out["metric_conditioning"] = (eigvals[:, -1] / eigvals[:, 0]).mean()
        det_gi = torch.exp(gm.logdet_g_inv(metric, z0))
        out["manifold_regularity"] = torch.std(torch.log(det_gi + 1e-8), correction=0)
        out["metric_determinant"] = det_gi.mean()
    return out
