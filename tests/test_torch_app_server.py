"""The port's live app server (rlvae_tpu_torch/app_server.py) over HTTP, and
its static dashboard (rlvae_tpu_torch/app.py), on the CPU.

The cases mirror tests/test_app_server.py and tests/test_app.py: every page
renders; a training run launched through the API trains in a thread of the
server with its metric records streamed live, and the inference and
exploration endpoints serve the finished run through its batching engine;
a stop request ends a run at an epoch boundary with a resumable ``last``
slot, which a resumed run continues; the export endpoint writes a bundle
that loads; a negative seed generates; the interpolation modes; the
engine over several replica devices (``serve_mesh``).  The reconstruct and
generate rows the API serves are held to the run's ModelManager bit for
bit (the same manager, engine and draws)."""

import base64
import io
import json
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

QUICK = [
    "model=vanilla_vae", "training=quick", "visualization=minimal",
    "training.trainer.log_every_n_steps=1",
    "training.n_train_samples=8", "training.n_val_samples=4",
    "data.synthetic_n_train=8", "data.synthetic_n_test=4",
    "data.image_size=[4,4]", "model.n_flows=0", "training.model.n_flows=0",
]
WAIT_S = 300


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as r:
        return r.status, r.read()


def _get_json(port, path):
    status, body = _get(port, path)
    assert status == 200, body[:200]
    return json.loads(body)


def _post_json(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _wait(port, run_id, done):
    deadline = time.time() + WAIT_S
    while time.time() < deadline:
        p = _get_json(port, f"/api/experiments/{run_id}/progress")
        if done(p):
            return p
        time.sleep(0.2)
    raise TimeoutError(p)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from rlvae_tpu_torch.app_server import serve

    outputs = tmp_path_factory.mktemp("app_outputs")
    srv, state = serve(outputs, port=0, block=False, device="cpu")
    try:
        yield srv.server_address[1], outputs, state
    finally:
        srv.shutdown()
        state.close()


@pytest.fixture(scope="module")
def trained(server):
    """One finished training run launched through the API: (run name, the
    progress it reported, whether it was seen running)."""
    port, _, _ = server
    run_id = _post_json(port, "/api/experiments",
                        {"overrides": QUICK + ["training.trainer.max_epochs=1"]})["id"]
    seen = []
    progress = _wait(port, run_id, lambda p: seen.append(p["status"]) or
                     p["status"] in ("completed", "failed"))
    assert progress["status"] == "completed", progress
    return f"app_{run_id}", run_id, progress, "running" in seen


def test_pages_render(server):
    port, _, _ = server
    from rlvae_tpu_torch.app_server import PAGES

    status, body = _get(port, "/")
    assert status == 200 and b"rlvae_tpu research app" in body
    for page in PAGES:
        status, body = _get(port, f"/page/{page}")
        assert status == 200 and b"<nav>" in body, page


def test_threaded_training_with_live_progress_and_inference(server, trained):
    port, outputs, state = server
    run_name, run_id, progress, saw_running = trained
    assert saw_running or progress["n_records"] > 0
    keys = {k for r in progress["records"] for k in r}
    assert any(k.startswith("train/") or k.startswith("val/") for k in keys)
    tail = _get_json(port, f"/api/experiments/{run_id}/progress?since={progress['n_records'] - 1}")
    assert len(tail["records"]) == 1

    entry = next(r for r in _get_json(port, "/api/runs") if r["name"] == run_name)
    assert entry["has_checkpoint"] and entry["has_results"]

    rec = _get_json(port, f"/api/model/{run_name}/reconstruct?n=2")
    assert len(rec["rows"]) == 4 and all(len(r) > 0 for r in rec["rows"])
    gen = _get_json(port, f"/api/model/{run_name}/generate?n=2&seed=5")
    assert len(gen["rows"]) == 2
    # the served rows are the run's manager's, through its engine: compare
    # the pixels of the PNGs with the manager's own rows
    from PIL import Image

    from rlvae_tpu_torch.viz.base import png_b64

    mgr = state.manager(run_name)
    want = mgr.sample_random_batched_seeds([5, 6], n_obs=gen_len(gen))
    for i, row in enumerate(gen["rows"]):
        for t, b64 in enumerate(row):
            got = np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))
            ref = np.asarray(Image.open(io.BytesIO(base64.b64decode(png_b64(want[i, t])))))
            np.testing.assert_array_equal(got, ref)

    n_points = int(np.prod(state.sample_batch(run_name, 6).shape[:2]))  # every frame
    for method in ("pca", "tsne", "umap"):
        lat = _get_json(port, f"/api/model/{run_name}/latents?method={method}")
        assert len(lat["points"]) == n_points, method
        assert {"x", "y", "seq", "t", "img"} <= set(lat["points"][0])
    info = _get_json(port, f"/api/model/{run_name}/info")
    assert info["architecture"]["latent_dim"] == 16

    assert any(e["id"] == run_id for e in _get_json(port, "/api/experiments"))
    _get_json(port, "/api/gallery")
    serving = _get_json(port, "/api/serving")
    assert serving[run_name]["requests"] >= 4 and serving[run_name]["batches"] >= 2
    assert "generate_p50_ms" in serving[run_name]


def gen_len(gen):
    return len(gen["rows"][0])


def test_artifact_path_traversal_blocked(server):
    port, _, _ = server
    try:
        status, _ = _get(port, "/artifact?path=../../etc/passwd")
    except urllib.error.HTTPError as e:
        status = e.code
    assert status in (403, 500)


def test_stop_experiment_checkpoints_resumably(server):
    """POST /api/experiment/<id>/stop ends a threaded run at the next epoch
    boundary with a ``last`` slot, and a resumed Trainer continues from it."""
    port, _, _ = server
    run_id = _post_json(port, "/api/experiments",
                        {"overrides": QUICK + ["training.trainer.max_epochs=50"]})["id"]
    _wait(port, run_id, lambda p: p["n_records"] >= 1 or p["status"] != "running")
    assert _post_json(port, f"/api/experiment/{run_id}/stop", {})["stop_requested"] is True
    p = _wait(port, run_id, lambda p: p["status"] != "running")
    assert p["status"] == "stopped" and p["stop_requested"] is True, p
    run_dir = Path(p["run_dir"])
    from rlvae_tpu_torch.config import load_yaml
    from rlvae_tpu_torch.data import CyclicDataModule
    from rlvae_tpu_torch.models import create_model
    from rlvae_tpu_torch.train import Trainer
    from rlvae_tpu_torch.train.checkpoints import CheckpointManager

    last = CheckpointManager(run_dir / "checkpoints").restore("last")
    assert last["epoch"] < 49  # far fewer epochs than asked for
    # resume the stopped run for one more epoch from its own config
    full = load_yaml((run_dir / "config.yaml").read_text())
    dm = CyclicDataModule(full["data"], seed=int(full.get("seed", 42)))
    dm.setup(full["training"])
    trainer = Trainer(create_model(full["model"]), dm, full["training"], run_dir=run_dir,
                      device="cpu")
    trainer.fit(max_epochs=last["epoch"] + 2, resume=True)
    resumed = CheckpointManager(run_dir / "checkpoints").restore("last")
    assert resumed["epoch"] == last["epoch"] + 1 and resumed["step"] > last["step"]
    with pytest.raises(urllib.error.HTTPError):
        _post_json(port, "/api/experiment/nope/stop", {})


def test_export_endpoint_writes_loadable_bundle(server, trained):
    port, _, _ = server
    run_name = trained[0]
    out = _post_json(port, f"/api/model/{run_name}/export", {"ops": ["decode"], "buckets": [2]})
    assert out["ops"] == ["decode"] and out["buckets"] == [2] and out["platforms"] == ["cpu"]
    from rlvae_tpu_torch.export import load_exported

    loaded = load_exported(out["out_dir"], device="cpu")
    y = loaded.run("decode", np.zeros((2, loaded.manifest["latent_dim"]), np.float32))
    assert y.shape[0] == 2 and np.all(np.isfinite(y))


def test_export_cli_on_the_run(server, trained, tmp_path, capsys):
    """python -m rlvae_tpu_torch.export over a trained run directory."""
    from rlvae_tpu_torch import export

    _, outputs, _ = server
    assert export.main([str(outputs / trained[0]), "--out", str(tmp_path / "b"), "--ops",
                        "encode", "decode", "--buckets", "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert any("encode" in ln and "OK" in ln for ln in lines), lines


def test_generate_accepts_negative_seed(server, trained):
    port, _, _ = server
    gen = _get_json(port, f"/api/model/{trained[0]}/generate?n=2&seed=-1")
    assert len(gen["rows"]) == 2


def test_interpolate_endpoint_modes(server, trained):
    """linear/spherical serve frames; the vanilla run has no metric, so
    'geodesic' is a clean JSON error naming it."""
    port, _, _ = server
    run_name = trained[0]
    for mode in ("linear", "spherical"):
        out = _get_json(port, f"/api/model/{run_name}/interpolate?mode={mode}&steps=5")
        assert out["mode"] == mode and out["steps"] == 5
        assert len(out["rows"]) == 1 and len(out["rows"][0]) == 5
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(port, f"/api/model/{run_name}/interpolate?mode=geodesic")
    assert "metric" in json.loads(exc.value.read())["error"]


def test_serve_mesh_engine_splits_over_replicas(tmp_path):
    """AppState(serve_mesh=True) builds its engines over one replica per
    listed device: a request's batch is split over both."""
    from rlvae_tpu_torch import ModelManager
    from rlvae_tpu_torch.app_server import AppState

    cfg = {"name": "vanilla_vae", "input_dim": [3, 8, 8], "latent_dim": 4, "n_flows": 2,
           "flow_hidden_size": 16, "encoder": {"architecture": "mlp", "hidden_dims": [16]},
           "decoder": {"architecture": "mlp", "hidden_dims": [16]}}
    state = AppState(tmp_path, serve_mesh=True, device="cpu", mesh_devices=["cpu", "cpu"])
    mgr = ModelManager.from_config(cfg, seed=0, device="cpu")
    state.manager = lambda run: mgr
    state.sample_batch = lambda run, n: np.zeros((n, 3, 3, 8, 8), np.float32)
    eng = state.engine("fake_run")
    try:
        assert len(eng.ops["generate"].mesh) == 2
        row = np.asarray(eng.run("generate", np.uint32(7), timeout=60))
        assert row.shape == (3, 3, 8, 8) and np.isfinite(row).all()
        assert eng.ops["generate"].last_out_ndev == 2
        np.testing.assert_array_equal(row, mgr.sample_random_batched_seeds([7], n_obs=3)[0])
    finally:
        state.close()


def test_dashboard_pages(server, trained, tmp_path):
    """app.py renders its pages from a port run directory (its config,
    checkpoint, metrics and summary)."""
    pytest.importorskip("matplotlib")
    from rlvae_tpu_torch.app import DashboardBuilder, build_report
    from rlvae_tpu_torch.config import load_yaml
    from rlvae_tpu_torch.data import CyclicDataModule
    from rlvae_tpu_torch.inference import ModelManager

    _, outputs, _ = server
    run_dir = outputs / trained[0]
    full = load_yaml((run_dir / "config.yaml").read_text())
    dm = CyclicDataModule(full["data"], seed=int(full.get("seed", 42)))
    dm.setup(full["training"])
    manager = ModelManager.from_checkpoint(run_dir, full["model"], device="cpu")
    b = DashboardBuilder(run_dir, manager, dm.get_sample_batch("val", 2))
    b.page_overview()
    b.page_training_curves()
    b.page_inference(n=2)
    b.page_latent_exploration()
    html = b.render()
    for page in ("Overview", "Training curves", "Model inference", "Latent exploration"):
        assert f"<h2>{page}</h2>" in html
    assert "data:image/png;base64" in html
    out = build_report(run_dir, tmp_path / "r.html", n_samples=2, device="cpu")
    assert out.stat().st_size > 10_000 and "Generation" in out.read_text()


def test_build_report_without_model(tmp_path):
    """Artifacts-only mode: no config or checkpoint, still renders."""
    pytest.importorskip("matplotlib")
    from rlvae_tpu_torch.app import build_report

    (tmp_path / "metrics.jsonl").write_text('{"_step": 1, "train/loss": 2.0}\n')
    assert "Training curves" in build_report(tmp_path, device="cpu").read_text()
