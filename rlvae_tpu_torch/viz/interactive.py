"""Interactive visualizations: self-contained HTML sliders and explorers.

Port of ``rlvae_tpu/viz/interactive.py:24-469``.  Every page is standalone
HTML with base64 PNG frames and a vanilla-JS slider or hover panel (the
templates are copies of JAX's).  Per epoch: ``sequence_slider.html``
(reconstructions), ``geodesic_slider.html`` (9 decoded latents between two
sequences' first latents) and, with a metric, ``metric_slider.html``,
``temporal_animation.html``, ``latent_space_explorer.html``,
``fancy_geodesics.png`` (with ``enable_fancy_plots``) and
``latent_explorer.html`` (4 sequences generated from the prior).

The device work is in methods that return numpy arrays, on the model's
device:

- :meth:`~InteractiveVisualizations.geodesic_frames`: the decoder on 9 latents;
- :meth:`~InteractiveVisualizations.metric_slider_fields`: log sqrt det
  G^{-1} on a 40 x 40 grid at six temperatures (one chol-bundle launch each);
- :meth:`~InteractiveVisualizations.temporal_fields`: a 30 x 30 field and
  the trajectories' values (chol-bundle);
- :meth:`~InteractiveVisualizations.fancy_fields`: a 50 x 50 field and the
  dense paths' values (chol-bundle), G on a 12 x 12 grid (metric bundle),
  ``dist2`` on the transitions and on 2 500 probes (metric bundle);
  :meth:`~InteractiveVisualizations.fancy_geodesic` (``energy_path`` at 16
  points over 120 Adam steps, one metric-bundle launch each, and
  ``path_length``) and :meth:`~InteractiveVisualizations.fancy_curvature`
  (a 24 x 24 curvature grid, plain ops): the plot runs these two inside
  JAX's best-effort ``except Exception`` blocks, as JAX does;
- :meth:`~InteractiveVisualizations.generated`: ``model.generate(4,
  n_obs=T)`` on the geodesic prior (G^{-1}, then the IAF chain).

``run`` keeps JAX's order: each helper imports matplotlib first, so where it
is missing the run fails in ``_metric_slider`` with the two sliders written.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
from typing import Dict, List, Optional

import numpy as np

from rlvae_tpu_torch.viz.base import BaseVisualization, on_device, png_b64, to_numpy
from rlvae_tpu_torch.viz.manifold import back_project, plane_basis, plane_grid

_SLIDER_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>body{{font-family:sans-serif;margin:20px}} .row{{display:flex;gap:8px;flex-wrap:wrap}}
img{{border:1px solid #ccc;width:128px;height:128px;image-rendering:pixelated}}</style></head>
<body><h2>{title}</h2>
<input type="range" id="t" min="0" max="{tmax}" value="0" style="width:400px">
<span id="label">t = 0</span>
<div class="row" id="frames"></div>
<script>
const data = {data_json};
const container = document.getElementById('frames');
const slider = document.getElementById('t');
function render(t) {{
  document.getElementById('label').textContent = 't = ' + t;
  container.innerHTML = '';
  for (const seq of data) {{
    const img = document.createElement('img');
    img.src = 'data:image/png;base64,' + seq[t];
    container.appendChild(img);
  }}
}}
slider.addEventListener('input', () => render(+slider.value));
render(0);
</script></body></html>
"""


_EXPLORER_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>body{{font-family:sans-serif;margin:20px;display:flex;gap:24px}}
#plot{{border:1px solid #aaa;background:#fafafa}}
#panel img{{width:192px;height:192px;image-rendering:pixelated;border:1px solid #ccc}}
.pt{{cursor:pointer}}</style></head>
<body>
<div><h2>{title}</h2><svg id="plot" width="640" height="560"></svg></div>
<div id="panel"><h3>hover a point</h3><img id="img"><p id="info"></p></div>
<script>
const pts = {points_json};
const svg = document.getElementById('plot');
const xs = pts.map(p=>p.x), ys = pts.map(p=>p.y);
const xmin=Math.min(...xs), xmax=Math.max(...xs), ymin=Math.min(...ys), ymax=Math.max(...ys);
const X = v => 30 + (v - xmin) / (xmax - xmin + 1e-9) * 580;
const Y = v => 530 - (v - ymin) / (ymax - ymin + 1e-9) * 500;
const colors = ['#4c78a8','#f58518','#54a24b','#e45756','#72b7b2','#b279a2'];
// trajectory lines per sequence
const seqs = {{}};
for (const p of pts) (seqs[p.seq] = seqs[p.seq] || []).push(p);
for (const [s, arr] of Object.entries(seqs)) {{
  arr.sort((a,b)=>a.t-b.t);
  const d = arr.map((p,i)=>(i?'L':'M')+X(p.x)+','+Y(p.y)).join(' ');
  const path = document.createElementNS('http://www.w3.org/2000/svg','path');
  path.setAttribute('d', d); path.setAttribute('fill','none');
  path.setAttribute('stroke', colors[s % colors.length]); path.setAttribute('opacity','0.5');
  svg.appendChild(path);
}}
for (const p of pts) {{
  const c = document.createElementNS('http://www.w3.org/2000/svg','circle');
  c.setAttribute('cx', X(p.x)); c.setAttribute('cy', Y(p.y)); c.setAttribute('r', 6);
  c.setAttribute('fill', colors[p.seq % colors.length]); c.setAttribute('class','pt');
  c.addEventListener('mouseenter', () => {{
    document.getElementById('img').src = 'data:image/png;base64,' + p.img;
    document.getElementById('info').textContent = `sequence ${{p.seq}}, t = ${{p.t}}`;
  }});
  svg.appendChild(c);
}}
</script></body></html>
"""


def _frames_png(frames: np.ndarray) -> List[str]:
    return [png_b64(f) for f in frames]


def _figure_b64(fig) -> str:
    import matplotlib.pyplot as plt

    buf = io.BytesIO()
    fig.savefig(buf, format="png", bbox_inches="tight")
    plt.close(fig)
    return base64.b64encode(buf.getvalue()).decode()


class InteractiveVisualizations(BaseVisualization):
    N_SLIDER = 40
    TEMPERATURE_SCALES = (0.5, 0.75, 1.0, 1.5, 2.0, 3.0)
    N_TEMPORAL = 30
    N_FANCY = 50
    N_ELLIPSE = 12
    N_FANCY_CURV = 24
    N_INTERP = 10

    # -- device work ---------------------------------------------------------

    def geodesic_frames(self, model, z: np.ndarray) -> np.ndarray:
        """The decoder's frames [9, C, H, W] on the straight path between the
        first latents of sequences 0 and 1."""
        import torch

        z_a, z_b = z[0, 0], z[min(1, z.shape[0] - 1), 0]
        path = np.stack([(1 - t) * z_a + t * z_b for t in np.linspace(0.0, 1.0, 9)])
        dev = next(model.parameters()).device
        with torch.no_grad():
            dec = model.decode(torch.as_tensor(path, dtype=torch.float32, device=dev))
        return to_numpy(dec["reconstruction"])

    def _plane(self, model, z: np.ndarray):
        """(flat latents, PCA projection of latents + centroids, its PCA)."""
        flat = z.reshape(-1, z.shape[-1])
        proj, pca = self.pca_fit_transform(
            np.concatenate([flat, to_numpy(model.metric.centroids)], axis=0))
        return flat, proj, pca

    def metric_slider_fields(self, model, z: np.ndarray) -> Dict[str, np.ndarray]:
        """log sqrt det G^{-1} on a 40 x 40 grid at each temperature scale."""
        from rlvae_tpu_torch.geometry import log_sqrt_det_g_inv

        metric = model.metric
        _, proj, pca = self._plane(model, z)
        gx, gy, grid2 = plane_grid(proj.min(0) - 1.0, proj.max(0) + 1.0, self.N_SLIDER)
        grid_d = on_device(metric, back_project(pca, grid2))
        base_t = float(metric.temperature)
        temps = [base_t * s for s in self.TEMPERATURE_SCALES]
        vals = np.stack([to_numpy(log_sqrt_det_g_inv(
            dataclasses.replace(metric, temperature=t), grid_d)).reshape(gx.shape)
            for t in temps])
        return {"gx": gx, "gy": gy, "vals": vals, "temperatures": np.asarray(temps)}

    def temporal_fields(self, model, z: np.ndarray) -> Dict[str, np.ndarray]:
        """A 30 x 30 log sqrt det G^{-1} field and its values along the
        trajectories [B, T]."""
        from rlvae_tpu_torch.geometry import log_sqrt_det_g_inv

        metric = model.metric
        flat, proj, pca = self._plane(model, z)
        gx, gy, grid2 = plane_grid(proj.min(0) - 1.0, proj.max(0) + 1.0, self.N_TEMPORAL)
        field = to_numpy(log_sqrt_det_g_inv(
            metric, on_device(metric, back_project(pca, grid2)))).reshape(gx.shape)
        dets = to_numpy(log_sqrt_det_g_inv(metric, on_device(metric, flat))).reshape(
            z.shape[:2])
        return {"gx": gx, "gy": gy, "field": field, "dets": dets,
                "z2": proj[: len(flat)].reshape(z.shape[0], z.shape[1], 2)}

    def fancy_fields(self, model, z: np.ndarray) -> Dict[str, np.ndarray]:
        """The fancy-geodesics figure's arrays but the two best-effort
        overlays (:meth:`fancy_geodesic`, :meth:`fancy_curvature`)."""
        from rlvae_tpu_torch.geometry import dist2, g, log_sqrt_det_g_inv

        metric = model.metric
        flat, proj, pca = self._plane(model, z)
        z2 = proj[: len(flat)].reshape(z.shape[0], z.shape[1], 2)
        basis, origin = plane_basis(pca)
        lift = lambda p2: p2 @ basis.T + origin  # noqa: E731  the plane -> latent space
        lo, hi = proj.min(0) - 1.0, proj.max(0) + 1.0
        gx, gy, grid2 = plane_grid(lo, hi, self.N_FANCY)
        out = {"z2": z2, "c2": proj[len(flat):], "basis": basis, "origin": origin, "lo": lo,
               "hi": hi, "gx": gx, "gy": gy}
        out["det_field"] = to_numpy(log_sqrt_det_g_inv(
            metric, on_device(metric, lift(grid2)))).reshape(gx.shape)

        # dense trajectories: N_INTERP points per transition
        n_show = min(4, z.shape[0])
        w = np.linspace(0, 1, self.N_INTERP, endpoint=False)[:, None]
        out["dense2"] = dense2 = np.stack([np.concatenate(
            [(1 - w) * z2[i, t] + w * z2[i, t + 1] for t in range(z.shape[1] - 1)]
            + [z2[i, -1:]], axis=0) for i in range(n_show)])  # [n_show, S, 2]

        # G on the ellipse grid, projected onto the plane
        _, _, e2 = plane_grid(lo, hi, self.N_ELLIPSE)
        out["e2"] = e2
        out["g_full"] = to_numpy(g(metric, on_device(metric, lift(e2))))

        # per-transition Riemannian and Euclidean step lengths
        seqs = flat.reshape(z.shape[0], z.shape[1], -1)[:n_show]
        za = seqs[:, :-1].reshape(-1, z.shape[-1])
        zb = seqs[:, 1:].reshape(-1, z.shape[-1])
        d2 = to_numpy(dist2(metric, on_device(metric, za), on_device(metric, zb)))
        out["riem"] = np.sqrt(np.maximum(d2, 0)).reshape(n_show, -1)
        out["eucl"] = np.linalg.norm(zb - za, axis=-1).reshape(n_show, -1)

        # the amplification field: local Riemannian / Euclidean length
        probe = on_device(metric, lift(grid2))
        eps_vec = on_device(metric, basis[:, 0] * 1e-2)
        out["amp2"] = to_numpy(dist2(metric, probe, probe + eps_vec)) / 1e-4

        # the metric along the dense paths
        out["det_path"] = to_numpy(log_sqrt_det_g_inv(
            metric, on_device(metric, lift(dense2.reshape(-1, 2))))).reshape(n_show, -1)
        return out

    def fancy_geodesic(self, model, z: np.ndarray, basis, origin) -> Dict[str, np.ndarray]:
        """The energy-minimizing path between sequence 0's first and last
        latents (16 points, 120 Adam steps) beside the straight line, both
        projected onto the plane, and their Riemannian lengths."""
        import torch

        from rlvae_tpu_torch.geometry.geodesics import energy_path, path_length

        metric = model.metric
        za_, zb_ = on_device(metric, z[0, 0]), on_device(metric, z[0, -1])
        geo = energy_path(metric, za_, zb_, n_points=16, n_iters=120)
        lin = (torch.linspace(0.0, 1.0, 16, device=za_.device)[:, None] * (zb_ - za_)[None]
               + za_[None])
        with torch.no_grad():
            l_g, l_l = float(path_length(metric, geo)), float(path_length(metric, lin))
        return {"geo": to_numpy(geo), "lin": to_numpy(lin),
                "geo2": (to_numpy(geo) - origin) @ basis, "lin2": (to_numpy(lin) - origin) @ basis,
                "l_g": l_g, "l_l": l_l}

    def fancy_curvature(self, model, basis, origin, lo, hi) -> Dict[str, np.ndarray]:
        """The Gaussian curvature on a 24 x 24 grid of the plane."""
        from rlvae_tpu_torch.geometry.curvature import gaussian_curvature_2d

        metric = model.metric
        cgx, cgy, cpts = plane_grid(lo, hi, self.N_FANCY_CURV)
        curv = to_numpy(gaussian_curvature_2d(metric, on_device(metric, basis),
                                              on_device(metric, origin),
                                              on_device(metric, cpts))).reshape(cgx.shape)
        return {"cgx": cgx, "cgy": cgy, "curv": curv}

    def generated(self, model, epoch: int, n_obs: int,
                  noise: Optional[Dict] = None) -> np.ndarray:
        """``model.generate(4, n_obs)`` on the geodesic prior, its draws from
        a generator on the model's device seeded with ``epoch + 1`` (JAX:
        ``PRNGKey(epoch + 1)``) unless ``noise`` is given."""
        import torch

        dev = next(model.parameters()).device
        gen = None if noise is not None else torch.Generator(device=dev).manual_seed(epoch + 1)
        with torch.no_grad():
            return to_numpy(model.generate(4, n_obs=n_obs, generator=gen, noise=noise))

    def fields(self, model, z: np.ndarray, epoch: int = 0,
               noise: Optional[Dict] = None) -> Dict[str, object]:
        """Every device result of :meth:`run` for latents ``z`` [B, T, D]."""
        out: Dict[str, object] = {"geodesic_frames": self.geodesic_frames(model, z)}
        if model.metric is None:
            return out
        out["metric_slider"] = self.metric_slider_fields(model, z)
        out["temporal"] = self.temporal_fields(model, z)
        if getattr(self.config, "enable_fancy_plots", False):
            fancy = self.fancy_fields(model, z)
            fancy["geodesic"] = self.fancy_geodesic(model, z, fancy["basis"], fancy["origin"])
            fancy["curvature"] = self.fancy_curvature(model, fancy["basis"], fancy["origin"],
                                                      fancy["lo"], fancy["hi"])
            out["fancy"] = fancy
        out["generated"] = self.generated(model, epoch, z.shape[1], noise)
        return out

    # -- pages and figures ----------------------------------------------------

    def _slider(self, epoch, name: str, title: str, data) -> object:
        html = _SLIDER_HTML.format(title=title, tmax=len(data[0]) - 1,
                                   data_json=json.dumps(data))
        path = self._path(epoch, name, ext="html")
        path.write_text(html)
        return path

    def _metric_slider(self, epoch, model, z):
        """Heatmap frames of log sqrt det G^{-1} at a range of temperatures."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        f = self.metric_slider_fields(model, z)
        frames = []
        for vals, t in zip(f["vals"], f["temperatures"]):
            fig, ax = plt.subplots(figsize=(3, 2.6), dpi=64)
            ax.pcolormesh(f["gx"], f["gy"], vals, shading="auto", cmap="viridis")
            ax.set_title(f"T = {t:.2f}", fontsize=8)
            ax.set_xticks([]), ax.set_yticks([])
            frames.append(_figure_b64(fig))
        return self._slider(epoch, "metric_slider",
                            f"Metric temperature slider (epoch {epoch})", [frames])

    def _fancy_geodesics(self, epoch, model, z):
        """Dense trajectories over the det field with the true geodesic, an
        eigenvalue-ellipse field of G on the plane, path analytics, the
        amplification field, the curvature landscape, the metric along the
        dense paths."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.collections import EllipseCollection, LineCollection

        f = self.fancy_fields(model, z)
        z2, c2, basis, origin = f["z2"], f["c2"], f["basis"], f["origin"]
        lo, hi, gx, gy, dense2 = f["lo"], f["hi"], f["gx"], f["gy"], f["dense2"]
        n_show = dense2.shape[0]

        fig, axes = plt.subplots(2, 3, figsize=(17, 10))
        ax = axes[0, 0]
        ax.pcolormesh(gx, gy, f["det_field"], shading="auto", cmap="viridis", alpha=0.9)
        for i in range(n_show):
            ax.plot(dense2[i, :, 0], dense2[i, :, 1], "-", lw=1.2, alpha=0.9)
            ax.plot(z2[i, :, 0], z2[i, :, 1], "o", ms=4, c="white", mec="k")
        ax.scatter(c2[:, 0], c2[:, 1], c="red", marker="x", s=14)
        # the true geodesic between sequence 0's endpoints vs the straight line
        try:
            geo = self.fancy_geodesic(model, z, basis, origin)
            ax.plot(geo["lin2"][:, 0], geo["lin2"][:, 1], ":", c="orange", lw=1.6,
                    label=f"straight (L={geo['l_l']:.2f})")
            ax.plot(geo["geo2"][:, 0], geo["geo2"][:, 1], "--", c="lime", lw=1.8,
                    label=f"true geodesic (L={geo['l_g']:.2f})")
            ax.legend(fontsize=7, loc="best")
        except Exception:  # best-effort overlay, never break the suite
            pass
        ax.set_title("Dense trajectories over $\\log\\sqrt{\\det G^{-1}}$")

        # eigenvalue-ellipse field: axes from the eigenstructure of B^T G B
        ax = axes[0, 1]
        n_e = self.N_ELLIPSE
        g_plane = np.einsum("di,bde,ej->bij", basis, f["g_full"], basis)
        evals, evecs = np.linalg.eigh(g_plane)
        scale = 0.35 * (hi - lo).min() / n_e * 2
        widths = np.sqrt(np.maximum(evals[:, 1], 1e-12))
        heights = np.sqrt(np.maximum(evals[:, 0], 1e-12))
        norm = widths.max() + 1e-12
        angles = np.degrees(np.arctan2(evecs[:, 1, 1], evecs[:, 0, 1]))
        ec = EllipseCollection(
            widths / norm * scale * 4, heights / norm * scale * 4, angles,
            units="x", offsets=f["e2"], transOffset=ax.transData,
            facecolors="none", edgecolors="tab:blue", alpha=0.8,
        )
        ax.add_collection(ec)
        ax.scatter(c2[:, 0], c2[:, 1], c="red", marker="x", s=14)
        ax.set_xlim(lo[0], hi[0]), ax.set_ylim(lo[1], hi[1])
        ax.set_title("Eigenvalue field of $G$ (PCA-plane ellipses)")

        # path analytics: per-transition Euclidean vs local Riemannian length
        ax = axes[0, 2]
        riem, eucl = f["riem"], f["eucl"]
        for i in range(n_show):
            ax.plot(riem[i], "o-", alpha=0.8, label=f"riem seq {i}" if i < 2 else None)
            ax.plot(eucl[i], "s--", alpha=0.5, label=f"eucl seq {i}" if i < 2 else None)
        ax.set_yscale("log")
        ax.set_xlabel("transition t -> t+1"), ax.set_ylabel("step length")
        ax.legend(fontsize=7)
        ax.set_title("Path analytics: Riemannian vs Euclidean steps")

        # amplification heatmap: local Riemannian/Euclidean length ratio
        ax = axes[1, 0]
        amp = np.sqrt(np.maximum(f["amp2"], 1e-12)).reshape(gx.shape)
        im = ax.pcolormesh(gx, gy, np.log10(amp), shading="auto", cmap="magma")
        fig.colorbar(im, ax=ax, label=r"$\log_{10}$ amplification")
        ax.set_title("Riemannian amplification field")

        # curvature landscape (exact autodiff Brioschi)
        ax = axes[1, 1]
        try:
            c = self.fancy_curvature(model, basis, origin, lo, hi)
            curv = c["curv"]
            vmax = np.percentile(np.abs(curv), 95) + 1e-12
            im = ax.pcolormesh(c["cgx"], c["cgy"], curv, shading="auto", cmap="RdBu_r",
                               vmin=-vmax, vmax=vmax)
            fig.colorbar(im, ax=ax, label="Gaussian curvature")
        except Exception as e:  # curvature is best-effort at FULL level
            ax.text(0.5, 0.5, f"curvature unavailable: {e}", ha="center", wrap=True)
        ax.set_title("Curvature landscape")

        # det along the dense paths
        ax = axes[1, 2]
        det_path = f["det_path"]
        segs = [np.column_stack([np.arange(det_path.shape[1]), det_path[i]])
                for i in range(n_show)]
        ax.add_collection(LineCollection(segs, alpha=0.8))
        ax.autoscale()
        ax.set_xlabel("dense path index"), ax.set_ylabel(r"$\log\sqrt{\det G^{-1}}$")
        ax.set_title("Metric along dense geodesic paths")

        fig.suptitle(f"Fancy geodesic analysis (epoch {epoch})")
        fig.tight_layout()
        return self.save_figure(fig, epoch, "fancy_geodesics")

    def _temporal_animation(self, epoch, model, z):
        """A timestep slider over the det field with the batch's positions at
        t beside the det-along-sequence curves."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        f = self.temporal_fields(model, z)
        z2, dets = f["z2"], f["dets"]
        frames = []
        for t in range(z.shape[1]):
            fig, (a0, a1) = plt.subplots(1, 2, figsize=(7, 3), dpi=64)
            a0.pcolormesh(f["gx"], f["gy"], f["field"], shading="auto", cmap="viridis")
            a0.scatter(z2[:, t, 0], z2[:, t, 1], c="white", s=24, edgecolors="k")
            a0.set_title(f"positions at t={t}", fontsize=8)
            a0.set_xticks([]), a0.set_yticks([])
            a1.plot(dets.T, alpha=0.5)
            a1.axvline(t, color="red")
            a1.set_title(r"$\log\sqrt{\det G^{-1}}$ along sequences", fontsize=8)
            frames.append(_figure_b64(fig))
        return self._slider(epoch, "temporal_animation",
                            f"Temporal metric animation (epoch {epoch})", [frames])

    def _html_latent_explorer(self, epoch, z, recon):
        """A PCA scatter where hovering a latent point shows its decoded
        frame, every image embedded as base64."""
        n_seq = min(6, z.shape[0])
        proj, _ = self.pca_fit_transform(z[:n_seq].reshape(-1, z.shape[-1]))
        proj = proj.reshape(-1, 2)
        points = []
        for i in range(n_seq):
            for t in range(z.shape[1]):
                k = i * z.shape[1] + t
                points.append({"x": float(proj[k, 0]), "y": float(proj[k, 1]),
                               "seq": i, "t": t, "img": png_b64(recon[i, t])})
        html = _EXPLORER_HTML.format(title=f"Latent space explorer (epoch {epoch})",
                                     points_json=json.dumps(points))
        path = self._path(epoch, "latent_space_explorer", ext="html")
        path.write_text(html)
        return path

    def run(self, epoch: int, model, variables, sample_batch) -> List:
        x = np.asarray(sample_batch, np.float32)[:4]
        out = self.forward(model, x, epoch)
        recon = to_numpy(out.recon_x)
        z = to_numpy(out.z)
        written = [self._slider(epoch, "sequence_slider",
                                f"Reconstruction sequences (epoch {epoch})",
                                [_frames_png(seq) for seq in recon])]
        written.append(self._slider(epoch, "geodesic_slider",
                                    f"Geodesic (latent interpolation) slider (epoch {epoch})",
                                    [_frames_png(self.geodesic_frames(model, z))]))
        if model.metric is not None:
            written.append(self._metric_slider(epoch, model, z))
            written.append(self._temporal_animation(epoch, model, z))
            written.append(self._html_latent_explorer(epoch, z, recon))
            if getattr(self.config, "enable_fancy_plots", False):
                written.append(self._fancy_geodesics(epoch, model, z))
            gen = self.generated(model, epoch, x.shape[1])
            written.append(self._slider(
                epoch, "latent_explorer",
                f"Generated sequences from Riemannian prior (epoch {epoch})",
                [_frames_png(seq) for seq in gen]))
        return written
