"""Flow analysis: the flows' Jacobian spectra and the metric along the flows.

Port of ``rlvae_tpu/viz/flow_analysis.py:20-144``: ``flow_jacobians.png``
and, with a metric, ``flow_animation.html`` and ``flow_det_evolution.png``.
The device work is in :meth:`FlowAnalysisVisualizations.fields`, on the
model's device:

- per transition t, the Jacobian of flow t at 4 latents of timestep t by
  ``torch.func.jacfwd`` over the port's ``iaf_forward``, or ``iaf_inverse``
  when the flows run in the ``sampling`` direction (plain ops, as JAX's
  ``jax.jacfwd``), and its mean singular values;
- log sqrt det G^{-1} (the animation's colours) and log det G^{-1} along
  the trajectories, one chol-bundle launch each.
"""

from __future__ import annotations

import base64
import io
import json
from typing import Dict, List

import numpy as np

from rlvae_tpu_torch.viz.base import BaseVisualization, on_device, to_numpy


class FlowAnalysisVisualizations(BaseVisualization):
    def spectra(self, model, z: np.ndarray) -> List[np.ndarray]:
        """Mean singular values of each transition's flow Jacobian at the
        first 4 latents of its timestep."""
        import torch
        from torch.func import jacfwd, vmap

        from rlvae_tpu_torch.flows import iaf_forward, iaf_inverse

        # the temporal map's configured direction ('sampling' runs iaf_inverse)
        step_fn = iaf_inverse if model.flows.direction != "density" else iaf_forward
        flows = model.flows.flows
        dev = next(model.parameters()).device
        out = []
        for t in range(min(z.shape[1] - 1, len(flows))):
            z_t = torch.as_tensor(z[:4, t], dtype=torch.float32, device=dev)

            def f(single, flow=flows[t]):
                y, _ = step_fn(flow, single[None, :])
                return y[0]

            with torch.no_grad():
                jac = vmap(jacfwd(f))(z_t)  # [4, D, D]
            out.append(np.linalg.svd(to_numpy(jac), compute_uv=False).mean(axis=0))
        return out

    def fields(self, model, z: np.ndarray) -> Dict[str, object]:
        """Every plotted array of latents ``z`` [B, T, D]."""
        out: Dict[str, object] = {"spectra": self.spectra(model, z)}
        if model.metric is not None:
            out.update(self.metric_fields(model, z))
        return out

    def metric_fields(self, model, z: np.ndarray) -> Dict[str, np.ndarray]:
        from rlvae_tpu_torch.geometry import log_sqrt_det_g_inv, logdet_g_inv

        metric = model.metric
        flat = on_device(metric, z.reshape(-1, z.shape[-1]))
        return {"dets": to_numpy(log_sqrt_det_g_inv(metric, flat)).reshape(z.shape[:2]),
                "logdet": to_numpy(logdet_g_inv(metric, flat)).reshape(z.shape[:2])}

    def _flow_animation(self, epoch, model, z, spectra, dets):
        """A timestep slider over [PCA scatter coloured by the metric | its
        evolution | each flow's spectral radius], as self-contained HTML."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from rlvae_tpu_torch.viz.interactive import _SLIDER_HTML

        flat = z.reshape(-1, z.shape[-1])
        proj, _ = self.pca_fit_transform(flat)
        z2 = proj.reshape(z.shape[0], z.shape[1], 2)
        rad = [float(s[0]) for s in spectra]  # spectral radius per flow

        frames = []
        for t in range(z.shape[1]):
            fig, (a0, a1, a2) = plt.subplots(1, 3, figsize=(10, 3), dpi=64)
            sc = a0.scatter(z2[:, t, 0], z2[:, t, 1], c=dets[:, t], cmap="viridis", s=28)
            for i in range(min(6, z2.shape[0])):
                a0.plot(z2[i, : t + 1, 0], z2[i, : t + 1, 1], "-", alpha=0.4, lw=1)
            fig.colorbar(sc, ax=a0)
            a0.set_title(f"flow spatial evolution t={t}", fontsize=8)
            a1.plot(dets.T, alpha=0.5)
            a1.axvline(t, color="red")
            a1.set_title(r"$\log\sqrt{\det G^{-1}}$ evolution", fontsize=8)
            a2.bar(np.arange(len(rad)), rad, alpha=0.8)
            if t > 0 and t - 1 < len(rad):
                a2.bar([t - 1], [rad[t - 1]], color="red")
            a2.set_title("flow spectral radius (red = active)", fontsize=8)
            buf = io.BytesIO()
            fig.savefig(buf, format="png", bbox_inches="tight")
            plt.close(fig)
            frames.append(base64.b64encode(buf.getvalue()).decode())
        html = _SLIDER_HTML.format(title=f"Flow evolution animation (epoch {epoch})",
                                   tmax=len(frames) - 1, data_json=json.dumps([frames]))
        path = self._path(epoch, "flow_animation", ext="html")
        path.write_text(html)
        return path

    def run(self, epoch: int, model, variables, sample_batch) -> List:
        if model.n_flows == 0:
            return []
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        x = np.asarray(sample_batch, np.float32)
        z = to_numpy(self.forward(model, x, epoch).z)  # [B, T, D]
        written = []

        spectra = self.spectra(model, z)
        fig, ax = plt.subplots(figsize=(6, 4))
        for t, s in enumerate(spectra):
            ax.semilogy(s, "-o", ms=3, label=f"flow {t}", alpha=0.8)
        ax.set_xlabel("singular value index"), ax.set_ylabel("singular value")
        ax.set_title(f"Flow Jacobian spectra (epoch {epoch})")
        ax.legend(fontsize=7, ncol=2)
        written.append(self.save_figure(fig, epoch, "flow_jacobians"))

        if model.metric is not None:
            f = self.metric_fields(model, z)
            written.append(self._flow_animation(epoch, model, z, spectra, f["dets"]))
            ld = f["logdet"]
            fig, ax = plt.subplots(figsize=(6, 4))
            ax.plot(ld.mean(0), "-o", label="mean")
            ax.fill_between(np.arange(ld.shape[1]), ld.mean(0) - ld.std(0),
                            ld.mean(0) + ld.std(0), alpha=0.3)
            ax.set_xlabel("timestep"), ax.set_ylabel(r"$\log\det G^{-1}(z_t)$")
            ax.set_title(f"Metric determinant along flows (epoch {epoch})")
            ax.legend()
            written.append(self.save_figure(fig, epoch, "flow_det_evolution"))
        return written
