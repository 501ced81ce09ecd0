"""Research dashboard: the port of ``rlvae_tpu/app.py``.

The reference ships a 6-page Streamlit app (reference: app.py + app/pages/:
overview, experiment manager, model inference, latent exploration, model
comparison, visualization gallery) on top of a ModelManager backend.
The app layer is a *static* dashboard generator: it renders the same
pages into one self-contained HTML file (embedded base64 figures, no
external assets, no server) from a port run directory (``config.yaml``,
``checkpoints/{best,last}``, ``metrics.jsonl``, ``summary.json``) and the
:class:`rlvae_tpu_torch.inference.ModelManager` backend on ``device`` (the
card by default).  The figures need matplotlib.

Usage:
    python -m rlvae_tpu_torch.app <run_dir> [--out report.html] [--n-samples 4] [--device cpu]
    python -m rlvae_tpu_torch.app <outputs_dir> --serve [--port N]   # the live app

The live app is :mod:`rlvae_tpu_torch.app_server`.
"""

from __future__ import annotations

import argparse
import base64
import html
import io
import json
from pathlib import Path
from typing import List, Optional

import numpy as np


def _fig_to_b64(fig) -> str:
    import matplotlib.pyplot as plt

    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=90, bbox_inches="tight")
    plt.close(fig)
    return base64.b64encode(buf.getvalue()).decode()


def _img_tag(b64: str, width: int = 720) -> str:
    return f'<img src="data:image/png;base64,{b64}" style="max-width:{width}px;width:100%">'


def _frames_strip(seq_nchw: np.ndarray) -> str:
    """[T, C, H, W] -> one strip image tag."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = seq_nchw.shape[0]
    fig, axes = plt.subplots(1, t, figsize=(1.2 * t, 1.3))
    for i, ax in enumerate(np.atleast_1d(axes)):
        ax.imshow(np.clip(seq_nchw[i].transpose(1, 2, 0), 0, 1))
        ax.axis("off")
    return _img_tag(_fig_to_b64(fig))


class DashboardBuilder:
    def __init__(self, run_dir: Path, manager=None, sample_batch: Optional[np.ndarray] = None):
        self.run_dir = Path(run_dir)
        self.manager = manager
        self.sample_batch = sample_batch
        self.sections: List[str] = []

    def add(self, title: str, body: str) -> None:
        anchor = title.lower().replace(" ", "-")
        self.sections.append(f'<section id="{anchor}"><h2>{html.escape(title)}</h2>{body}</section>')

    # -- pages ---------------------------------------------------------------

    def page_overview(self) -> None:
        body = []
        cfg_path = self.run_dir / "config.yaml"
        if cfg_path.exists():
            body.append(f"<details><summary>Resolved config</summary><pre>{html.escape(cfg_path.read_text())}</pre></details>")
        if self.manager is not None:
            info = self.manager.get_model_info()
            body.append(f"<pre>{html.escape(json.dumps(info, indent=2, default=str))}</pre>")
        summary = self.run_dir / "summary.json"
        if summary.exists():
            body.append(f"<h3>Run summary</h3><pre>{html.escape(summary.read_text())}</pre>")
        self.add("Overview", "\n".join(body) or "<p>no run metadata found</p>")

    def page_training_curves(self) -> None:
        metrics_file = self.run_dir / "metrics.jsonl"
        if not metrics_file.exists():
            return
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        records = [json.loads(line) for line in metrics_file.read_text().splitlines() if line]
        keys = ["train/loss", "val/loss", "train/recon_loss", "val/recon_loss",
                "train/kld_loss", "val/kld_loss"]
        fig, axes = plt.subplots(1, 3, figsize=(13, 3.5))
        for ax, pair in zip(axes, [keys[0:2], keys[2:4], keys[4:6]]):
            for k in pair:
                pts = [(r["_step"], r[k]) for r in records if k in r and "_step" in r]
                if pts:
                    xs, ys = zip(*pts)
                    ax.plot(xs, ys, label=k, alpha=0.8)
            ax.legend(fontsize=7)
            ax.set_xlabel("step")
        self.add("Training curves", _img_tag(_fig_to_b64(fig), width=1100))

    def page_inference(self, n: int = 4, seed: int = 0) -> None:
        if self.manager is None or self.sample_batch is None:
            return
        x = np.asarray(self.sample_batch[:n], np.float32)
        recon = self.manager.reconstruct(x, seed=seed)
        rows = []
        for i in range(x.shape[0]):
            rows.append("<h4>original</h4>" + _frames_strip(x[i]))
            rows.append("<h4>reconstruction</h4>" + _frames_strip(recon[i]))
        self.add("Model inference", "\n".join(rows))

    def page_generation(self, n: int = 3, seed: int = 1) -> None:
        if self.manager is None:
            return
        try:
            gen = self.manager.sample_random(n, n_obs=self.sample_batch.shape[1]
                                             if self.sample_batch is not None else 8,
                                             seed=seed)
        except Exception as e:
            self.add("Generation", f"<p>prior sampling unavailable: {html.escape(str(e))}</p>")
            return
        rows = [_frames_strip(gen[i]) for i in range(gen.shape[0])]
        self.add("Generation", "<h4>sequences from the Riemannian prior</h4>" + "\n".join(rows))

    def page_latent_exploration(self) -> None:
        if self.manager is None or self.sample_batch is None:
            return
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        z = self.manager.embed_sequence(np.asarray(self.sample_batch, np.float32))
        flat = z.reshape(-1, z.shape[-1]).astype(np.float64)
        mean = flat.mean(0)
        u, s, vt = np.linalg.svd(flat - mean, full_matrices=False)
        proj = ((flat - mean) @ vt[:2].T).reshape(z.shape[0], z.shape[1], 2)
        fig, ax = plt.subplots(figsize=(5.5, 5))
        for i in range(proj.shape[0]):
            ax.plot(proj[i, :, 0], proj[i, :, 1], "-o", ms=3, alpha=0.7)
        ax.set_title("latent trajectories (PCA)")
        body = _img_tag(_fig_to_b64(fig), width=520)

        # interpolation gallery between the first two frames
        x1, x2 = np.asarray(self.sample_batch[0, 0]), np.asarray(self.sample_batch[-1, 0])
        lin = self.manager.interpolate(x1, x2, n_steps=8, mode="linear")
        sph = self.manager.interpolate(x1, x2, n_steps=8, mode="spherical")
        body += "<h4>linear interpolation</h4>" + _frames_strip(lin)
        body += "<h4>spherical interpolation</h4>" + _frames_strip(sph)
        self.add("Latent exploration", body)

    def page_comparison(self) -> None:
        results = self.run_dir / "results.yaml"
        if not results.exists():
            return
        from rlvae_tpu_torch.config import load_yaml

        data = load_yaml(results.read_text())
        if not isinstance(data, dict) or "comparison" not in data:
            return
        finals = {
            m: {k: v for k, v in met.items() if k.endswith("_final")}
            for m, met in data["comparison"].items()
        }
        if not finals:
            return
        # one column set for every row: the union of all models' metrics
        # (models can report different sets; per-model headers misalign)
        cols = sorted({k for f in finals.values() for k in f})
        header = "".join(f"<th>{html.escape(k)}</th>" for k in cols)
        rows = []
        for model_name, f in finals.items():
            cells = "".join(
                f"<td>{f[k]:.4g}</td>" if k in f else "<td>—</td>" for k in cols
            )
            rows.append(f"<tr><th>{html.escape(model_name)}</th>{cells}</tr>")
        table = f"<table border=1 cellpadding=4><tr><th>model</th>{header}</tr>{''.join(rows)}</table>"
        self.add("Model comparison", table)

    def page_gallery(self) -> None:
        viz_dir = self.run_dir / "visualizations"
        if not viz_dir.exists():
            return
        imgs = sorted(viz_dir.glob("epoch_*/*.png"))[-12:]
        body = "".join(
            f"<figure><figcaption>{html.escape(str(p.relative_to(viz_dir)))}</figcaption>"
            f"{_img_tag(base64.b64encode(p.read_bytes()).decode(), width=640)}</figure>"
            for p in imgs
        )
        self.add("Visualization gallery", body or "<p>no artifacts</p>")

    # -- output ----------------------------------------------------------------

    def render(self) -> str:
        nav = "".join(
            f'<a href="#{s.split(chr(34))[1]}">{s.split("</h2>")[0].split("<h2>")[1]}</a> · '
            for s in self.sections
        )
        return (
            "<!DOCTYPE html><html><head><meta charset='utf-8'>"
            "<title>rlvae_tpu report</title>"
            "<style>body{font-family:sans-serif;max-width:1150px;margin:24px auto;padding:0 16px}"
            "section{margin:28px 0;border-top:1px solid #ddd;padding-top:12px}"
            "pre{background:#f6f6f6;padding:8px;overflow-x:auto}</style></head><body>"
            f"<h1>rlvae_tpu analysis report</h1><nav>{nav}</nav>"
            + "\n".join(self.sections)
            + "</body></html>"
        )


def build_report(
    run_dir: str | Path,
    out: Optional[str | Path] = None,
    n_samples: int = 4,
    model_config: Optional[dict] = None,
    device=None,
) -> Path:
    """Generate the dashboard for a run directory; returns the HTML path.
    The model runs on ``device`` (the card by default)."""
    run_dir = Path(run_dir)
    manager = None
    sample = None
    try:
        from rlvae_tpu_torch.config import load_yaml
        from rlvae_tpu_torch.data import CyclicDataModule
        from rlvae_tpu_torch.inference import ModelManager

        cfg = model_config
        if cfg is None and (run_dir / "config.yaml").exists():
            full = load_yaml((run_dir / "config.yaml").read_text())
            cfg = full.get("model")
            data_cfg = full.get("data", {})
            # use the run's own top-level seed so the sample batch matches
            # the data the model actually validated on
            dm = CyclicDataModule(data_cfg, seed=int(full.get("seed", 42)))
            dm.setup(full.get("training", {}))
            sample = dm.get_sample_batch("val", n_samples)
        if cfg is not None and (run_dir / "checkpoints" / "best").exists():
            manager = ModelManager.from_checkpoint(run_dir, cfg, device=device)
    except Exception as e:
        print(f"[app] model backend unavailable ({e}); rendering run artifacts only")

    b = DashboardBuilder(run_dir, manager, sample)
    b.page_overview()
    b.page_training_curves()
    b.page_inference(n=n_samples)
    b.page_generation()
    b.page_latent_exploration()
    b.page_comparison()
    b.page_gallery()
    out = Path(out) if out else run_dir / "report.html"
    out.write_text(b.render())
    print(f"[app] wrote {out}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("run_dir", type=Path, nargs="?", default=Path("outputs"))
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--n-samples", type=int, default=4)
    ap.add_argument("--serve", action="store_true",
                    help="serve the live 6-page research app over this "
                         "outputs directory instead of writing a static report")
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--serve-mesh", action="store_true",
                    help="split inference batches over one replica per visible "
                         "card (data-parallel serving)")
    ap.add_argument("--device", default=None, help="device to run on (default: the card)")
    args = ap.parse_args(argv)
    if args.serve:
        from rlvae_tpu_torch.app_server import serve

        serve(args.run_dir, port=args.port, block=True, serve_mesh=args.serve_mesh,
              device=args.device)
    else:
        build_report(args.run_dir, args.out, args.n_samples, device=args.device)


if __name__ == "__main__":
    main()
