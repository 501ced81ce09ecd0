"""Basic visualizations: reconstructions, cyclicity, latent trajectories.

Port of ``rlvae_tpu/viz/basic.py:19-136``: five PNGs per epoch
(``reconstructions``, ``cyclicity``, ``trajectories``,
``cyclicity_analysis``, ``reconstruction_analysis``).  The device work is
the shared forward alone; :meth:`BasicVisualizations.fields` computes the
plotted statistics from its outputs on the host.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from rlvae_tpu_torch.viz.base import BaseVisualization, to_numpy


def _to_img(frame: np.ndarray) -> np.ndarray:
    """[C, H, W] -> [H, W, C] clipped to [0, 1]."""
    return np.clip(np.transpose(frame, (1, 2, 0)), 0.0, 1.0)


class BasicVisualizations(BaseVisualization):
    def fields(self, x: np.ndarray, recon: np.ndarray, z: np.ndarray) -> Dict[str, np.ndarray]:
        """The plotted statistics of sequences ``x``, their reconstructions
        and latents: first-vs-last MSE of each, the latents' PCA
        projection, per-timestep MSE, sequence 0's absolute error and the
        per-frame PSNR."""
        proj, _ = self.pca_fit_transform(z)
        return {
            "mse_orig": np.mean((x[:, 0] - x[:, -1]) ** 2, axis=(1, 2, 3)),
            "mse_recon": np.mean((recon[:, 0] - recon[:, -1]) ** 2, axis=(1, 2, 3)),
            "mse_latent": np.mean((z[:, 0] - z[:, -1]) ** 2, axis=1),
            "proj": proj,
            "per_t": np.mean((recon - x) ** 2, axis=(0, 2, 3, 4)),
            "err": np.abs(recon[0] - x[0]),
            "psnr": 10 * np.log10(1.0 / np.maximum(np.mean((recon - x) ** 2, axis=(2, 3, 4)),
                                                   1e-12)),
        }

    def run(self, epoch: int, model, variables, sample_batch) -> List:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        x = np.asarray(sample_batch, np.float32)
        out = self.forward(model, x, epoch)
        recon = to_numpy(out.recon_x)
        z = to_numpy(out.z)
        f = self.fields(x, recon, z)
        mse_orig, mse_recon, mse_latent, proj = (f["mse_orig"], f["mse_recon"],
                                                 f["mse_latent"], f["proj"])
        written = []

        # 1. the reconstruction grid as one montage
        n_show = min(4, x.shape[0])
        t_show = x.shape[1]
        rows = []
        for i in range(n_show):
            rows.append(np.concatenate([_to_img(x[i, t]) for t in range(t_show)], axis=1))
            rows.append(np.concatenate([_to_img(recon[i, t]) for t in range(t_show)], axis=1))
        montage = np.concatenate(rows, axis=0)
        fig, ax = plt.subplots(figsize=(1.4 * t_show, 1.4 * 2 * n_show))
        ax.imshow(montage)
        ax.set_xticks([]), ax.set_yticks([])
        ax.set_title(f"Reconstructions (epoch {epoch}) — orig/recon row pairs")
        written.append(self.save_figure(fig, epoch, "reconstructions"))

        # 2. cyclicity: first-vs-last MSE of the originals, reconstructions, latents
        fig, ax = plt.subplots(figsize=(6, 4))
        idx = np.arange(len(mse_orig))
        width = 0.27
        ax.bar(idx - width, mse_orig, width, label="original")
        ax.bar(idx, mse_recon, width, label="reconstruction")
        ax.bar(idx + width, mse_latent, width, label="latent")
        ax.set_xlabel("sequence"), ax.set_ylabel("first-vs-last MSE")
        ax.set_yscale("log")
        ax.legend()
        ax.set_title(f"Cyclicity (epoch {epoch})")
        written.append(self.save_figure(fig, epoch, "cyclicity"))

        # 3. latent trajectories in PCA space
        fig, ax = plt.subplots(figsize=(5, 5))
        for i in range(min(8, proj.shape[0])):
            ax.plot(proj[i, :, 0], proj[i, :, 1], "-o", ms=3, alpha=0.7)
            ax.plot(proj[i, 0, 0], proj[i, 0, 1], "k^", ms=6)
        ax.set_title(f"Latent trajectories, PCA (epoch {epoch})")
        written.append(self.save_figure(fig, epoch, "trajectories"))

        # 4. cyclicity analysis panels
        fig, axes = plt.subplots(2, 3, figsize=(14, 8))
        axes[0, 0].scatter(mse_orig, mse_recon, alpha=0.7)
        lim = max(mse_orig.max(), mse_recon.max()) + 1e-12
        axes[0, 0].plot([0, lim], [0, lim], "r--", alpha=0.5)
        axes[0, 0].set_xlabel("original first-last MSE")
        axes[0, 0].set_ylabel("reconstructed first-last MSE")
        axes[0, 0].set_title("Original vs reconstructed cyclicity")
        axes[0, 1].hist(mse_latent, bins=min(20, len(mse_latent)), alpha=0.8)
        axes[0, 1].set_xlabel("latent first-last MSE")
        axes[0, 1].set_title(f"Latent cyclicity (mean {mse_latent.mean():.2e})")
        axes[0, 2].imshow(np.concatenate([_to_img(x[0, 0]), _to_img(x[0, -1])], axis=1))
        axes[0, 2].set_title("Original: first | last")
        axes[0, 2].axis("off")
        axes[1, 0].imshow(np.concatenate([_to_img(recon[0, 0]), _to_img(recon[0, -1])], axis=1))
        axes[1, 0].set_title("Recon: first | last")
        axes[1, 0].axis("off")
        axes[1, 1].plot(proj[0, :, 0], proj[0, :, 1], "o-", alpha=0.8)
        axes[1, 1].scatter(*proj[0, 0], color="green", s=90, marker="s", label="start", zorder=5)
        axes[1, 1].scatter(*proj[0, -1], color="red", s=110, marker="*", label="end", zorder=5)
        closure = float(np.linalg.norm(proj[0, 0] - proj[0, -1]))
        axes[1, 1].set_title(f"Latent trajectory (closure {closure:.3f})")
        axes[1, 1].legend()
        axes[1, 2].plot(f["per_t"], "o-")
        axes[1, 2].set_xlabel("timestep"), axes[1, 2].set_ylabel("MSE")
        axes[1, 2].set_title("Per-timestep reconstruction error")
        fig.suptitle(f"Cyclicity analysis (epoch {epoch})")
        fig.tight_layout()
        written.append(self.save_figure(fig, epoch, "cyclicity_analysis"))

        # 5. reconstruction analysis: per-frame strips and error statistics
        seq = 0
        err = f["err"]
        fig, axes = plt.subplots(2, 3, figsize=(15, 8))
        strips = [
            ("Original frames",
             np.concatenate([_to_img(x[seq, t]) for t in range(t_show)], axis=1)),
            ("Reconstructed frames",
             np.concatenate([_to_img(recon[seq, t]) for t in range(t_show)], axis=1)),
            ("Absolute error",
             np.concatenate([_to_img(err[t] / (err.max() + 1e-8)) for t in range(t_show)],
                            axis=1)),
        ]
        for ax_, (title, img) in zip(axes[0], strips):
            ax_.imshow(img)
            ax_.set_title(title)
            ax_.axis("off")
        axes[1, 0].plot(err.mean(axis=(1, 2, 3)), "o-")
        axes[1, 0].set_xlabel("timestep"), axes[1, 0].set_title("Mean |error| per frame")
        axes[1, 1].hist(err.ravel()[:: max(1, err.size // 20000)], bins=40, alpha=0.8)
        axes[1, 1].set_title("Pixel error distribution")
        psnr = f["psnr"]
        for i in range(min(4, psnr.shape[0])):
            axes[1, 2].plot(psnr[i], "o-", alpha=0.7, label=f"seq {i}")
        axes[1, 2].set_xlabel("timestep"), axes[1, 2].set_ylabel("PSNR (dB)")
        axes[1, 2].set_title("Per-sequence PSNR")
        axes[1, 2].legend(fontsize=7)
        fig.suptitle(f"Reconstruction analysis (epoch {epoch})")
        fig.tight_layout()
        written.append(self.save_figure(fig, epoch, "reconstruction_analysis"))
        return written
