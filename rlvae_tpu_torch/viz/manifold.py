"""Manifold visualizations: the metric over a PCA plane of the latents.

Port of ``rlvae_tpu/viz/manifold.py:18-160``: five PNGs per epoch
(``manifold_heatmap``, ``curvature`` unless ``disable_curvature``,
``temporal_metric``, ``enhanced_heatmaps``, ``temporal_metric_analysis``).
The device work is in :meth:`ManifoldVisualizations.fields`, on the
metric's device:

- log sqrt det G^{-1} on a 60 x 60 grid of the plane through the latents
  and centroids (one chol-bundle launch, 3 600 rows) and along the
  trajectories (one launch, B*T rows);
- the Gaussian curvature of the induced 2-D metric on a 30 x 30 grid
  (``gaussian_curvature_2d``: plain ops, as JAX's XLA path);
- G^{-1} along the trajectories (one G^{-1} launch) for the eigenvalue,
  condition-number and trace panels.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from rlvae_tpu_torch.viz.base import BaseVisualization, on_device, to_numpy


def plane_basis(pca):
    """(basis [D, 2], origin [D]) of a fitted PCA (sklearn's or the SVD pair)."""
    if hasattr(pca, "components_"):
        return np.asarray(pca.components_[:2].T), np.asarray(pca.mean_)
    mean, comp = pca
    return np.asarray(comp[:2].T), np.asarray(mean)


def back_project(pca, grid2: np.ndarray) -> np.ndarray:
    """Points of the PCA plane [N, 2] in latent space [N, D]."""
    if hasattr(pca, "inverse_transform"):
        return pca.inverse_transform(grid2)
    mean, comp = pca
    return grid2 @ comp + mean


def plane_grid(lo, hi, n: int):
    """(gx, gy, grid2 [n*n, 2]) of an n x n grid over [lo, hi]."""
    gx, gy = np.meshgrid(np.linspace(lo[0], hi[0], n), np.linspace(lo[1], hi[1], n))
    return gx, gy, np.stack([gx.ravel(), gy.ravel()], axis=1)


class ManifoldVisualizations(BaseVisualization):
    N_GRID = 60
    N_CURV = 30

    def fields(self, model, z: np.ndarray) -> Dict[str, np.ndarray]:
        """Every plotted array of latents ``z`` [B, T, D]."""
        from rlvae_tpu_torch.geometry import g_inv, log_sqrt_det_g_inv

        metric = model.metric
        flat = z.reshape(-1, z.shape[-1])
        cents = to_numpy(metric.centroids)
        proj, pca = self.pca_fit_transform(np.concatenate([flat, cents], axis=0))
        lo, hi = proj.min(0) - 1.0, proj.max(0) + 1.0
        gx, gy, grid2 = plane_grid(lo, hi, self.N_GRID)
        out = {"z_proj": proj[: len(flat)], "c_proj": proj[len(flat):], "gx": gx, "gy": gy,
               "lo": lo, "hi": hi}
        out["vals"] = to_numpy(log_sqrt_det_g_inv(
            metric, on_device(metric, back_project(pca, grid2)))).reshape(gx.shape)
        if not getattr(self.config, "disable_curvature", True):
            from rlvae_tpu_torch.geometry.curvature import gaussian_curvature_2d

            basis, origin = plane_basis(pca)
            cgx, cgy, pts = plane_grid(lo, hi, self.N_CURV)
            out.update(cgx=cgx, cgy=cgy, curv=to_numpy(gaussian_curvature_2d(
                metric, on_device(metric, basis), on_device(metric, origin),
                on_device(metric, pts))).reshape(cgx.shape))
        flat_d = on_device(metric, flat)
        out["dets"] = to_numpy(log_sqrt_det_g_inv(metric, flat_d)).reshape(z.shape[:2])
        gi = to_numpy(g_inv(metric, flat_d))
        out["g_inv"] = gi
        eig = np.linalg.eigvalsh(gi).reshape(z.shape[0], z.shape[1], -1)
        out["eig"] = eig
        out["cond"] = eig[..., -1] / np.maximum(eig[..., 0], 1e-12)
        out["trace"] = np.trace(gi, axis1=-2, axis2=-1).reshape(z.shape[:2])
        return out

    def run(self, epoch: int, model, variables, sample_batch) -> List:
        if model.metric is None:
            return []
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        x = np.asarray(sample_batch, np.float32)
        z = to_numpy(self.forward(model, x, epoch).z)  # [B, T, D]
        f = self.fields(model, z)
        gx, gy, vals, c_proj = f["gx"], f["gy"], f["vals"], f["c_proj"]
        z_proj, dets = f["z_proj"], f["dets"]
        written = []

        fig, ax = plt.subplots(figsize=(6.5, 5.5))
        im = ax.pcolormesh(gx, gy, vals, shading="auto", cmap="viridis")
        fig.colorbar(im, ax=ax, label=r"$\log\sqrt{\det G^{-1}(z)}$")
        ax.scatter(c_proj[:, 0], c_proj[:, 1], c="red", s=12, marker="x", label="centroids")
        zs = z_proj.reshape(z.shape[0], z.shape[1], 2)
        for i in range(min(6, zs.shape[0])):
            ax.plot(zs[i, :, 0], zs[i, :, 1], "-o", ms=2, c="white", alpha=0.7)
        ax.legend(loc="upper right")
        ax.set_title(f"Metric heatmap over PCA plane (epoch {epoch})")
        written.append(self.save_figure(fig, epoch, "manifold_heatmap"))

        # the curvature landscape on the PCA plane (exact autodiff Gaussian curvature)
        if "curv" in f:
            cgx, cgy, curv = f["cgx"], f["cgy"], f["curv"]
            fig, ax = plt.subplots(figsize=(6.5, 5.5))
            vmax = np.percentile(np.abs(curv), 95) + 1e-12
            im = ax.pcolormesh(cgx, cgy, curv, shading="auto", cmap="RdBu_r",
                               vmin=-vmax, vmax=vmax)
            fig.colorbar(im, ax=ax, label="Gaussian curvature (induced 2-D metric)")
            ax.scatter(c_proj[:, 0], c_proj[:, 1], c="k", s=10, marker="x")
            ax.set_title(f"Curvature landscape (epoch {epoch})")
            written.append(self.save_figure(fig, epoch, "curvature"))

        # the metric along the temporal trajectories
        fig, ax = plt.subplots(figsize=(6, 4))
        for i in range(min(8, dets.shape[0])):
            ax.plot(dets[i], "-o", ms=3, alpha=0.7)
        ax.set_xlabel("timestep"), ax.set_ylabel(r"$\log\sqrt{\det G^{-1}(z_t)}$")
        ax.set_title(f"Metric along temporal trajectories (epoch {epoch})")
        written.append(self.save_figure(fig, epoch, "temporal_metric"))

        # enhanced heatmaps: one column per shown timestep
        t_show = list(range(0, z.shape[1], max(1, z.shape[1] // 4)))[:4]
        fig, axes = plt.subplots(2, len(t_show), figsize=(4 * len(t_show), 7.5), squeeze=False)
        for col, t in enumerate(t_show):
            zt = z_proj.reshape(z.shape[0], z.shape[1], 2)[:, t]
            ax0 = axes[0, col]
            ax0.pcolormesh(gx, gy, vals, shading="auto", cmap="viridis", alpha=0.85)
            ax0.scatter(zt[:, 0], zt[:, 1], c="white", s=22, edgecolors="k")
            ax0.set_title(f"Flow-evolved coords t={t}")
            ax0.set_xticks([]), ax0.set_yticks([])
            ax1 = axes[1, col]
            ax1.hist(dets[:, t], bins=10, alpha=0.8, color="tab:purple")
            ax1.set_title(f"$\\log\\sqrt{{\\det G^{{-1}}}}$ at t={t}")
        fig.suptitle(f"Enhanced manifold heatmaps (epoch {epoch})")
        fig.tight_layout()
        written.append(self.save_figure(fig, epoch, "enhanced_heatmaps"))

        # temporal metric analysis: mean det, condition number, eigenvalues, trace
        eig, cond, trace = f["eig"], f["cond"], f["trace"]
        fig, axes = plt.subplots(2, 2, figsize=(12, 8))
        axes[0, 0].plot(dets.mean(0), "o-")
        axes[0, 0].fill_between(np.arange(dets.shape[1]), dets.mean(0) - dets.std(0),
                                dets.mean(0) + dets.std(0), alpha=0.3)
        axes[0, 0].set_title(r"Mean $\log\sqrt{\det G^{-1}}$ evolution")
        axes[0, 1].semilogy(cond.mean(0), "o-", color="tab:orange")
        axes[0, 1].set_title("Condition number evolution")
        axes[1, 0].semilogy(eig[..., -1].mean(0), "o-", label=r"$\lambda_{max}$")
        axes[1, 0].semilogy(eig[..., 0].mean(0), "o-", label=r"$\lambda_{min}$")
        axes[1, 0].set_title("Eigenvalue spread of $G^{-1}(z_t)$")
        axes[1, 0].legend()
        axes[1, 1].plot(trace.mean(0), "o-", color="tab:green")
        axes[1, 1].set_title(r"Mean $\mathrm{tr}\,G^{-1}(z_t)$")
        for ax_ in axes.ravel():
            ax_.set_xlabel("timestep")
        fig.suptitle(f"Temporal metric analysis (epoch {epoch})")
        fig.tight_layout()
        written.append(self.save_figure(fig, epoch, "temporal_metric_analysis"))
        return written
