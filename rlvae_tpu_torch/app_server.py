"""Live research app server: the port of ``rlvae_tpu/app_server.py``.

The reference's 6-page Streamlit application (reference: app.py:64,
app/pages/{overview,experiment_manager,model_inference,
latent_exploration,model_comparison,visualization_gallery}.py and
app/backend/{model_manager,experiment_runner}.py) on a ``http.server`` JSON
API and a single-file vanilla-JS UI (JAX's, verbatim), over the port's
modules: runs are served by ``ModelManager.from_run`` behind
``BatchingEngine.from_manager`` (with ``serve_mesh``, over one replica per
visible card: ``serving.make_sharded_ops``), trained by the experiment
runner (``rlvae_tpu_torch.experiment``) in a thread, and exported by
``rlvae_tpu_torch.export.export_model``.  Models run on ``device`` (the
card by default); with ``device="cpu"`` the training runs it launches train
on the CPU too.

Capabilities matched:
- overview: runs on disk with their configs/results,
- experiment manager: launch a training run IN A THREAD with live metric
  streaming (the StreamlitExperimentRunner + StreamlitProgressCallback
  behavior, experiment_runner.py:32,394),
- model inference: reconstructions + prior generations from any trained run
  through the ModelManager,
- latent exploration: PCA, dependency-free t-SNE, or dependency-free
  UMAP scatter with decoded hover images (``utils/tsne.py``,
  ``utils/umap_lite.py``: the reference page's PCA/t-SNE/UMAP triple),
- model comparison: final metrics table across runs,
- visualization gallery: artifacts written by the viz suite, served inline.

Every server binds 127.0.0.1; ``serve(..., block=False)`` returns the server
and the state, and the caller stops both (``server.shutdown()``,
``state.close()``, which stops the engines).
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, List
from urllib.parse import parse_qs, urlparse

import numpy as np


def _png_b64(frame_chw: np.ndarray) -> str:
    from rlvae_tpu_torch.viz.base import png_b64  # shared figure-free renderer

    return png_b64(frame_chw)


class ExperimentBackend:
    """Threaded experiment launcher with live metric streaming (reference:
    app/backend/experiment_runner.py:32-391)."""

    def __init__(self, outputs_dir: str | Path = "outputs", device=None):
        self.outputs_dir = Path(outputs_dir)
        # a CPU app trains on the CPU: the runner otherwise asks for the card
        self.base_overrides = (["training.trainer.accelerator=cpu"]
                               if device is not None and str(device) == "cpu" else [])
        self.experiments: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()

    def start_experiment(self, overrides: List[str]) -> str:
        from rlvae_tpu_torch.config import compose

        run_id = uuid.uuid4().hex[:8]
        run_dir = self.outputs_dir / f"app_{run_id}"
        stop_event = threading.Event()
        state: Dict[str, Any] = {
            "id": run_id, "status": "running", "records": [],
            "run_dir": str(run_dir), "overrides": list(overrides),
            "started": time.time(), "error": None,
            "stop_event": stop_event, "stop_requested": False,
        }
        with self._lock:
            self.experiments[run_id] = state

        def on_log(record):
            with self._lock:
                state["records"].append(record)

        def worker():
            try:
                from rlvae_tpu_torch.experiment import CONF_DIR, ExperimentRunner

                cfg = compose(CONF_DIR, overrides=self.base_overrides + list(overrides))
                cfg.set("run.dir", str(run_dir))
                ExperimentRunner(
                    cfg, progress_callback=on_log, stop_event=stop_event
                ).run()
                state["status"] = "stopped" if stop_event.is_set() else "completed"
            except Exception as e:  # surfaced to the UI, not swallowed
                state["status"] = "failed"
                state["error"] = f"{type(e).__name__}: {e}"

        threading.Thread(target=worker, daemon=True).start()
        return run_id

    def stop_experiment(self, run_id: str) -> Dict[str, Any]:
        """Request a cooperative stop: the trainer exits at the next epoch
        boundary through its normal resumable-checkpoint path."""
        with self._lock:
            state = self.experiments.get(run_id)
        if state is None:
            return {"error": "unknown experiment"}
        state["stop_event"].set()
        state["stop_requested"] = True
        return {"id": run_id, "status": state["status"], "stop_requested": True}

    def get_progress(self, run_id: str, since: int = 0) -> Dict[str, Any]:
        with self._lock:
            state = self.experiments.get(run_id)
            if state is None:
                return {"error": "unknown experiment"}
            return {
                "id": run_id, "status": state["status"], "error": state["error"],
                "run_dir": state["run_dir"], "n_records": len(state["records"]),
                "stop_requested": state["stop_requested"],
                "records": state["records"][since:],
            }

    def list_experiments(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [
                {k: v for k, v in s.items() if k not in ("records", "stop_event")}
                for s in self.experiments.values()
            ]


class AppState:
    """Shared server state: run discovery + ModelManager cache."""

    def __init__(self, outputs_dir: str | Path = "outputs", serve_mesh: bool = False,
                 device=None, mesh_devices=None):
        from rlvae_tpu_torch.device import resolve_device

        self.outputs_dir = Path(outputs_dir)
        self.device = resolve_device(device)
        self.serve_mesh = serve_mesh
        # the replicas of serve_mesh: every visible card unless listed
        self.mesh_devices = list(mesh_devices) if mesh_devices is not None else None
        self.backend = ExperimentBackend(outputs_dir, self.device)
        self._managers: Dict[str, Any] = {}
        self._engines: Dict[str, Any] = {}
        self._data_modules: Dict[str, Any] = {}
        self._lock = threading.Lock()
        # serializes bundle writes: concurrent exports of the same run would
        # interleave into corrupt weights.npz/manifest.json
        self._export_lock = threading.Lock()

    def list_runs(self) -> List[Dict[str, Any]]:
        from rlvae_tpu_torch.config import load_yaml

        runs = []
        if not self.outputs_dir.is_dir():
            return runs
        for d in sorted(self.outputs_dir.iterdir()):
            if not (d / "config.yaml").exists():
                continue
            entry: Dict[str, Any] = {
                "name": d.name,
                "has_checkpoint": (d / "checkpoints" / "best").exists(),
                "has_results": (d / "results.yaml").exists(),
            }
            if entry["has_results"]:
                try:
                    entry["results"] = load_yaml((d / "results.yaml").read_text())
                except Exception:
                    entry["results"] = None
            runs.append(entry)
        return runs

    def manager(self, run_name: str):
        from rlvae_tpu_torch.inference import ModelManager

        with self._lock:
            m = self._managers.get(run_name)
        if m is None:
            # build OUTSIDE the lock: a checkpoint restore can take seconds,
            # and holding the shared lock that long freezes every other API
            # request; two concurrent first requests may both build,
            # setdefault publishes exactly one
            m = ModelManager.from_run(self.outputs_dir / run_name, device=self.device)
            with self._lock:
                m = self._managers.setdefault(run_name, m)
        return m

    def engine(self, run_name: str):
        """Per-run dynamic-batching engine over the cached ModelManager:
        concurrent HTTP inference requests coalesce into one device dispatch
        (rlvae_tpu_torch.serving; the reference app dispatches per click).
        With ``serve_mesh`` and more than one replica device, every batch is
        split over one model replica per device (``make_sharded_ops``)."""
        from rlvae_tpu_torch.serving import BatchingEngine, ServeConfig

        with self._lock:
            e = self._engines.get(run_name)
        if e is None:
            mgr = self.manager(run_name)
            devices = None
            if self.serve_mesh:
                import torch

                devices = self.mesh_devices or [f"cuda:{i}"
                                                for i in range(torch.cuda.device_count())]
                if len(devices) < 2:
                    devices = None
            e = BatchingEngine.from_manager(
                mgr,
                ServeConfig(buckets=(1, 2, 4, 8), max_wait_ms=3.0),
                # seeded generation batches per-request seeds; sequences have
                # the run's own n_obs
                generate_n_obs=int(self.sample_batch(run_name, 1).shape[1]),
                devices=devices,
            )
            with self._lock:
                winner = self._engines.setdefault(run_name, e)
            if winner is not e:  # concurrent first builds: keep one dispatcher
                e.stop()
                e = winner
        return e

    def engine_reconstruct(self, run_name: str, x: np.ndarray, timeout: float = 600.0):
        """Reconstruct sequences through the batching engine (one item per
        sequence; co-arriving requests share a dispatch)."""
        eng = self.engine(run_name)
        futures = [eng.submit("reconstruct", xi) for xi in np.asarray(x)]
        return np.stack([np.asarray(f.result(timeout=timeout)) for f in futures])

    def engine_generate(self, run_name: str, seeds, timeout: float = 600.0):
        """Seeded prior generations through the batching engine (one item =
        one seed; concurrent requests coalesce, outputs stay per-seed
        reproducible)."""
        eng = self.engine(run_name)
        # mask to the uint32 range: a negative seed names the same wrapped
        # bits, and np.uint32 of a negative int overflows on numpy>=2
        futures = [
            eng.submit("generate", np.uint32(int(s) & 0xFFFFFFFF)) for s in seeds
        ]
        return np.stack([np.asarray(f.result(timeout=timeout)) for f in futures])

    def sample_batch(self, run_name: str, n: int = 4) -> np.ndarray:
        from rlvae_tpu_torch.config import load_yaml
        from rlvae_tpu_torch.data import CyclicDataModule

        with self._lock:
            dm = self._data_modules.get(run_name)
        if dm is None:
            # build ONCE per run (dataset synthesis/loading is seconds of
            # work) with the run's own seed so the batch matches the data
            # the model actually validated on
            full = load_yaml((self.outputs_dir / run_name / "config.yaml").read_text())
            # the run seed is stored TOP-LEVEL in config.yaml (conf/config.yaml:21)
            dm = CyclicDataModule(
                full.get("data", {}), seed=int(full.get("seed", 42))
            )
            dm.setup(full.get("training", {}))
            with self._lock:
                # a concurrent request may have published one meanwhile;
                # keep the first so every caller shares the same module
                dm = self._data_modules.setdefault(run_name, dm)
        return dm.get_sample_batch("val", n)

    def close(self) -> None:
        """Stop every engine this state built."""
        with self._lock:
            engines, self._engines = list(self._engines.values()), {}
        for e in engines:
            e.stop()


PAGES = (
    "overview", "experiments", "inference",
    "latent_exploration", "comparison", "gallery",
)

_SHELL = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>rlvae_tpu — {page}</title>
<style>
body{{font-family:sans-serif;max-width:1200px;margin:18px auto;padding:0 14px}}
nav a{{margin-right:14px}} nav a.active{{font-weight:bold}}
table{{border-collapse:collapse}} td,th{{border:1px solid #ccc;padding:4px 8px;font-size:13px}}
img.frame{{width:96px;height:96px;image-rendering:pixelated;border:1px solid #ccc}}
pre{{background:#f6f6f6;padding:8px;overflow-x:auto}}
#status{{color:#666}} button{{padding:6px 12px}}
svg circle{{cursor:pointer}}
</style></head>
<body>
<h1>rlvae_tpu research app</h1>
<nav>{nav}</nav>
<div id="app"><p id="status">loading…</p></div>
<script>
const API = p => fetch(p).then(r => r.json());
const app = document.getElementById('app');
{script}
</script></body></html>
"""

_PAGE_SCRIPTS = {
    "overview": """
API('/api/runs').then(runs => {
  let html = '<h2>Overview</h2><table><tr><th>run</th><th>checkpoint</th><th>best val loss</th></tr>';
  for (const r of runs) {
    const bv = r.results && r.results.best_val_loss != null ? r.results.best_val_loss.toFixed(3) : '—';
    html += `<tr><td>${r.name}</td><td>${r.has_checkpoint ? 'yes' : 'no'}</td><td>${bv}</td></tr>`;
  }
  app.innerHTML = html + '</table>';
});
""",
    "experiments": """
function refresh(id, since) {
  API(`/api/experiments/${id}/progress?since=${since}`).then(p => {
    const log = document.getElementById('log');
    for (const r of p.records) {
      const keys = Object.keys(r).filter(k => !k.startsWith('_')).slice(0, 6);
      log.textContent += keys.map(k => `${k}=${typeof r[k] === 'number' ? r[k].toFixed(3) : r[k]}`).join(' ') + '\\n';
    }
    document.getElementById('state').textContent = p.status + (p.error ? ': ' + p.error : '');
    if (p.status === 'running') setTimeout(() => refresh(id, p.n_records), 1000);
  });
}
app.innerHTML = `<h2>Experiment manager</h2>
<p>Hydra-style overrides (one per line):</p>
<textarea id="ov" rows="4" cols="60">model=vanilla_vae\ntraining=quick\nvisualization=minimal</textarea><br>
<button id="go">Launch training</button> <button id="stop" disabled>Stop (checkpoint + resume later)</button> <span id="state"></span>
<pre id="log" style="height:300px;overflow-y:scroll"></pre>`;
document.getElementById('go').onclick = () => {
  const overrides = document.getElementById('ov').value.split('\\n').map(s => s.trim()).filter(Boolean);
  fetch('/api/experiments', {method: 'POST', body: JSON.stringify({overrides})})
    .then(r => r.json()).then(d => {
      document.getElementById('state').textContent = 'running ' + d.id;
      const stop = document.getElementById('stop');
      stop.disabled = false;
      stop.onclick = () => fetch(`/api/experiment/${d.id}/stop`, {method: 'POST', body: '{}'});
      refresh(d.id, 0);
    });
};
""",
    "inference": """
API('/api/runs').then(runs => {
  const opts = runs.filter(r => r.has_checkpoint).map(r => `<option>${r.name}</option>`).join('');
  app.innerHTML = `<h2>Model inference</h2><select id="run">${opts}</select>
  <button id="rec">Reconstruct</button> <button id="gen">Generate</button>
  <select id="imode"><option value="linear">linear</option>
  <option value="spherical">spherical</option>
  <option value="geodesic">true geodesic</option></select>
  <button id="interp">Interpolate</button><div id="out"></div>`;
  const show = d => {
    document.getElementById('out').innerHTML = (d.error ? `<p>${d.error}</p>` : '') +
      (d.rows || []).map(row =>
      '<div>' + row.map(b => `<img class="frame" src="data:image/png;base64,${b}">`).join('') + '</div>'
    ).join('');
  };
  document.getElementById('rec').onclick = () =>
    API('/api/model/' + document.getElementById('run').value + '/reconstruct').then(show);
  document.getElementById('gen').onclick = () =>
    API('/api/model/' + document.getElementById('run').value + '/generate').then(show);
  document.getElementById('interp').onclick = () =>
    API('/api/model/' + document.getElementById('run').value + '/interpolate?mode=' +
        document.getElementById('imode').value).then(show);
});
""",
    "latent_exploration": """
API('/api/runs').then(runs => {
  const opts = runs.filter(r => r.has_checkpoint).map(r => `<option>${r.name}</option>`).join('');
  app.innerHTML = `<h2>Latent exploration</h2><select id="run">${opts}</select>
  <select id="method"><option value="pca">PCA</option><option value="tsne">t-SNE</option><option value="umap">UMAP</option></select>
  <button id="go">Explore</button>
  <div style="display:flex;gap:20px"><svg id="plot" width="600" height="520" style="border:1px solid #aaa"></svg>
  <div><img id="img" class="frame" style="width:160px;height:160px"><p id="info"></p></div></div>`;
  document.getElementById('go').onclick = () =>
    API('/api/model/' + document.getElementById('run').value + '/latents?method=' +
        document.getElementById('method').value).then(d => {
      const svg = document.getElementById('plot'); svg.innerHTML = '';
      const xs = d.points.map(p => p.x), ys = d.points.map(p => p.y);
      const xmin = Math.min(...xs), xmax = Math.max(...xs), ymin = Math.min(...ys), ymax = Math.max(...ys);
      const X = v => 25 + (v - xmin) / (xmax - xmin + 1e-9) * 550;
      const Y = v => 495 - (v - ymin) / (ymax - ymin + 1e-9) * 470;
      const colors = ['#4c78a8','#f58518','#54a24b','#e45756','#72b7b2','#b279a2'];
      for (const p of d.points) {
        const c = document.createElementNS('http://www.w3.org/2000/svg', 'circle');
        c.setAttribute('cx', X(p.x)); c.setAttribute('cy', Y(p.y)); c.setAttribute('r', 6);
        c.setAttribute('fill', colors[p.seq % colors.length]);
        c.addEventListener('mouseenter', () => {
          document.getElementById('img').src = 'data:image/png;base64,' + p.img;
          document.getElementById('info').textContent = `seq ${p.seq}, t=${p.t}`;
        });
        svg.appendChild(c);
      }
    });
});
""",
    "comparison": """
API('/api/runs').then(runs => {
  const done = runs.filter(r => r.results && r.results.test);
  const keys = [...new Set(done.flatMap(r => Object.keys(r.results.test)))].slice(0, 8);
  let html = '<h2>Model comparison</h2><table><tr><th>run</th>' + keys.map(k => `<th>${k}</th>`).join('') + '</tr>';
  for (const r of done)
    html += `<tr><td>${r.name}</td>` + keys.map(k => { const v = r.results.test[k]; return `<td>${typeof v === 'number' ? v.toFixed(3) : (v ?? '—')}</td>`; }).join('') + '</tr>';
  app.innerHTML = html + '</table>';
});
""",
    "gallery": """
API('/api/gallery').then(d => {
  let html = '<h2>Visualization gallery</h2>';
  for (const a of d.artifacts)
    html += `<p><a href="/artifact?path=${encodeURIComponent(a)}" target="_blank">${a}</a></p>`;
  app.innerHTML = d.artifacts.length ? html : html + '<p>no artifacts yet</p>';
});
""",
}


def _render_page(page: str) -> str:
    nav = "".join(
        f'<a href="/page/{p}" class="{"active" if p == page else ""}">{p.replace("_", " ")}</a>'
        for p in PAGES
    )
    return _SHELL.format(page=page, nav=nav, script=_PAGE_SCRIPTS[page])


def make_handler(state: AppState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _html(self, text, code=200, ctype="text/html"):
            body = text.encode() if isinstance(text, str) else text
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            parts = [p for p in url.path.split("/") if p]
            try:
                if url.path in ("/", "/page", "/page/"):
                    return self._html(_render_page("overview"))
                if len(parts) == 2 and parts[0] == "page" and parts[1] in PAGES:
                    return self._html(_render_page(parts[1]))
                if url.path == "/api/runs":
                    return self._json(state.list_runs())
                if url.path == "/api/gallery":
                    arts = []
                    for d in state.outputs_dir.glob("*/visualizations/**/*"):
                        if d.is_file():
                            arts.append(str(d.relative_to(state.outputs_dir)))
                    return self._json({"artifacts": sorted(arts)[:200]})
                if url.path == "/artifact":
                    rel = q.get("path", [""])[0]
                    target = (state.outputs_dir / rel).resolve()
                    import os

                    root = state.outputs_dir.resolve()
                    if os.path.commonpath([str(target), str(root)]) != str(root):
                        return self._json({"error": "forbidden"}, 403)
                    ctype = "text/html" if target.suffix == ".html" else "image/png"
                    return self._html(target.read_bytes(), ctype=ctype)
                if len(parts) == 4 and parts[:2] == ["api", "experiments"] and parts[3] == "progress":
                    since = int(q.get("since", ["0"])[0])
                    return self._json(state.backend.get_progress(parts[2], since))
                if url.path == "/api/experiments":
                    return self._json(state.backend.list_experiments())
                if url.path == "/api/serving":
                    # serving observability: per-run engine stats (batching,
                    # padding waste, latency quantiles) for loaded engines
                    with state._lock:
                        engines = dict(state._engines)
                    return self._json(
                        {name: e.stats_snapshot() for name, e in engines.items()}
                    )
                if len(parts) == 4 and parts[:2] == ["api", "model"]:
                    return self._model_api(parts[2], parts[3], q)
                return self._json({"error": "not found"}, 404)
            except Exception as e:
                return self._json({"error": f"{type(e).__name__}: {e}"}, 500)

        def do_POST(self):
            url = urlparse(self.path)
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                if url.path == "/api/experiments":
                    run_id = state.backend.start_experiment(payload.get("overrides", []))
                    return self._json({"id": run_id})
                parts = url.path.strip("/").split("/")
                if (len(parts) == 4 and parts[:2] == ["api", "experiment"]
                        and parts[3] == "stop"):
                    out = state.backend.stop_experiment(parts[2])
                    return self._json(out, 404 if "error" in out else 200)
                if (len(parts) == 4 and parts[:2] == ["api", "model"]
                        and parts[3] == "export"):
                    # AOT deployment bundle (rlvae_tpu_torch/export.py) under
                    # the run's own directory; ops/buckets from the payload
                    from rlvae_tpu_torch.export import export_model

                    run_name = parts[2]
                    mgr = state.manager(run_name)
                    out_dir = state.outputs_dir / run_name / "export"
                    n_obs = int(state.sample_batch(run_name, 1).shape[1])
                    with state._export_lock:
                        manifest = export_model(
                            mgr, out_dir,
                            ops=tuple(payload.get("ops",
                                      ("reconstruct", "encode", "decode", "generate"))),
                            buckets=tuple(int(b) for b in payload.get("buckets", (1, 8))),
                            n_obs=n_obs,
                            quantize=payload.get("quantize"),
                        )
                    return self._json({
                        "out_dir": str(out_dir),
                        "ops": sorted(manifest["programs"]),
                        "buckets": manifest["buckets"],
                        "platforms": manifest["platforms"],
                        "quantization": manifest["quantization"],
                    })
                return self._json({"error": "not found"}, 404)
            except Exception as e:
                return self._json({"error": f"{type(e).__name__}: {e}"}, 500)

        # -- model endpoints (ModelManager) --------------------------------
        def _model_api(self, run_name: str, action: str, q):
            mm = state.manager(run_name)
            seed = int(q.get("seed", ["0"])[0])
            n = int(q.get("n", ["3"])[0])
            if action == "info":
                return self._json(mm.get_model_info())
            if action == "reconstruct":
                x = state.sample_batch(run_name, n)
                recon = state.engine_reconstruct(run_name, x)
                rows = []
                for i in range(min(n, recon.shape[0])):
                    rows.append([_png_b64(x[i, t]) for t in range(x.shape[1])])
                    rows.append([_png_b64(recon[i, t]) for t in range(recon.shape[1])])
                return self._json({"rows": rows})
            if action == "generate":
                # one engine item per sample, seeds seed..seed+n-1: co-arriving
                # requests share a dispatch, every sample stays reproducible
                gen = state.engine_generate(run_name, range(seed, seed + n))
                rows = [
                    [_png_b64(gen[i, t]) for t in range(gen.shape[1])]
                    for i in range(gen.shape[0])
                ]
                return self._json({"rows": rows})
            if action == "interpolate":
                # latent interpolation between two validation frames
                # (reference inference page: linear/spherical; 'geodesic'
                # decodes along a TRUE Riemannian geodesic of the learned
                # metric: rlvae_tpu_torch/geometry/geodesics.py)
                mode = q.get("mode", ["linear"])[0]
                steps = max(2, min(int(q.get("steps", ["8"])[0]), 32))
                x = state.sample_batch(run_name, 2)
                frames = mm.interpolate(x[0, 0], x[1, 0], n_steps=steps, mode=mode)
                row = [_png_b64(frames[i]) for i in range(frames.shape[0])]
                return self._json({"rows": [row], "mode": mode, "steps": steps})
            if action == "latents":
                x = state.sample_batch(run_name, 6)
                z = mm.embed_sequence(x, seed=seed)  # [B, T, D]
                recon = mm.reconstruct(x, seed=seed)
                flat = z.reshape(-1, z.shape[-1]).astype(np.float64)
                method = q.get("method", ["pca"])[0]
                if method == "tsne":
                    # dependency-free t-SNE (reference page offers
                    # PCA/t-SNE/UMAP, app/components/sidebar.py:109-115)
                    from rlvae_tpu_torch.utils.tsne import tsne

                    proj = tsne(flat, perplexity=8.0, n_iter=300, seed=seed)
                elif method == "umap":
                    # dependency-free UMAP (utils/umap_lite.py: the same
                    # algorithm in numpy)
                    from rlvae_tpu_torch.utils.umap_lite import umap

                    proj = umap(flat, n_neighbors=10, n_epochs=150, seed=seed)
                else:
                    mean = flat.mean(0)
                    _, _, vt = np.linalg.svd(flat - mean, full_matrices=False)
                    proj = (flat - mean) @ vt[:2].T
                points = []
                for i in range(z.shape[0]):
                    for t in range(z.shape[1]):
                        k = i * z.shape[1] + t
                        points.append(
                            {
                                "x": float(proj[k, 0]), "y": float(proj[k, 1]),
                                "seq": i, "t": t, "img": _png_b64(recon[i, t]),
                            }
                        )
                return self._json({"points": points})
            return self._json({"error": "unknown action"}, 404)

    return Handler


def serve(outputs_dir: str | Path = "outputs", port: int = 8008, block: bool = True,
          serve_mesh: bool = False, device=None):
    """Start the app server on ``device`` (the card by default); returns
    (server, state) when block=False.

    ``serve_mesh=True`` splits every inference batch over one model replica
    per visible card (data-parallel serving, serving.make_sharded_ops)."""
    state = AppState(outputs_dir, serve_mesh=serve_mesh, device=device)
    server = ThreadingHTTPServer(("127.0.0.1", port), make_handler(state))
    print(f"[app] serving http://127.0.0.1:{server.server_address[1]} (pages: {', '.join(PAGES)})")
    if block:
        try:
            server.serve_forever()
        finally:
            state.close()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, state
