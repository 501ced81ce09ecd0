"""The port's training surface beyond the step: callbacks, the metrics
logger, step timing and tracing, the NaN checks, the trainer's device keys
and the visualization manager's dispatch, each against the JAX package's
counterpart on the same inputs.

The trainer's event sequence, step records and ``viz_hook`` calls in a real
run are held to JAX's in ``tests/test_torch_experiment.py`` (one JAX runner
run for both files' purposes).  JAX's NaN check here is its jitted,
checkify-instrumented train step (``make_train_step(nan_checks=True)``,
what ``debug_nan_checks`` turns on) on a tiny Gaussian-posterior model.
"""

import io
import json
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rlvae_tpu.train.callbacks as jax_callbacks
from rlvae_tpu.models import create_model as jax_create_model
from rlvae_tpu.train.optim import make_optimizer as jax_make_optimizer
from rlvae_tpu.train.trainer import make_train_step as jax_make_train_step
from rlvae_tpu.utils import debug as jax_debug
from rlvae_tpu.utils import logging as jax_logging
from rlvae_tpu.utils import profiling as jax_profiling
from rlvae_tpu.viz import manager as jax_viz
from rlvae_tpu_torch import create_model
from rlvae_tpu_torch.data import CYCLIC_SPRITES, CyclicDataModule
from rlvae_tpu_torch.train import TRAINING_PRESETS, Trainer, callbacks, resolve_trainer_device
from rlvae_tpu_torch.utils import debug, profiling
from rlvae_tpu_torch.utils.logging import MetricsLogger
from rlvae_tpu_torch.viz import manager as viz

NET = {"architecture": "mlp", "hidden_dims": [16], "dtype": "float32"}
# a Gaussian posterior without flows or metric: the NaN checks' model
GAUSS = {"input_dim": [3, 8, 8], "latent_dim": 4, "n_flows": 0, "encoder": NET, "decoder": NET,
         "posterior": {"type": "gaussian"}, "sampling": {"method": "standard"},
         "riemannian_beta": 0.0}


# ---------------------------------------------------------------------------
# MetricsLogger
# ---------------------------------------------------------------------------


def _drive_logger(logger, image):
    logger.log({"loss": np.float32(2.5), "note": "text", "t": torch.tensor(1.5)}, step=3)
    logger.log({"val/loss": 1.25})
    logger.log_table("table", [{"a": 1}, {"b": 2.0}])
    logger.log_image("viz/recon", image, step=3)
    logger.summary({"best_val_loss": 1.25, "steps": 3})
    logger.finish()


def _files(run_dir):
    out = {}
    for p in sorted(run_dir.iterdir()):
        text = p.read_text()
        if p.suffix == ".jsonl":
            out[p.name] = [{k: v for k, v in json.loads(line).items() if k != "_time"}
                           for line in text.splitlines()]
        else:
            out[p.name] = json.loads(text)
    return out


@pytest.mark.parametrize("mode", ["offline", "online", "disabled"])
def test_logger_without_wandb_writes_jax_files(tmp_path, monkeypatch, mode):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    seen = {"jax": [], "port": []}
    kw = {"project": "p", "run_name": "r", "config": {"a": 1}, "mode": mode}
    jax_logger = jax_logging.MetricsLogger(tmp_path / "jax", on_log=seen["jax"].append, **kw)
    port_logger = MetricsLogger(tmp_path / "port", on_log=seen["port"].append, **kw)
    assert port_logger.wandb_run is None and jax_logger.wandb_run is None
    _drive_logger(jax_logger, tmp_path / "img.png")
    _drive_logger(port_logger, tmp_path / "img.png")
    want = _files(tmp_path / "jax")
    assert sorted(want) == ["metrics.jsonl", "summary.json", "table.json"]
    assert _files(tmp_path / "port") == want
    strip = lambda recs: [{k: v for k, v in r.items() if k != "_time"} for r in recs]  # noqa: E731
    assert strip(seen["port"]) == strip(seen["jax"]) == want["metrics.jsonl"]


class _FakeWandb(types.ModuleType):
    """Records what a logger or callback asks of wandb."""

    def __init__(self):
        super().__init__("wandb")
        self.calls = []
        self.config = types.SimpleNamespace(update=lambda d: self.calls.append(("config", d)))
        fake = self

        class Run:
            summary = {}

            def log(self, data, step=None):
                fake.calls.append(("log", {k: getattr(v, "desc", v) for k, v in data.items()},
                                   step))

            def finish(self):
                fake.calls.append(("finish",))

        class Table:
            def __init__(self, columns):
                self.rows, self.desc = [], ("table", tuple(columns))

            def add_data(self, *row):
                fake.calls.append(("row", row))

        self.Run, self.Table = Run, Table

    def init(self, **kw):
        kw.pop("dir", None)
        self.calls.append(("init", kw))
        self.run = self.Run()
        self.run.summary = {}
        return self.run

    def Image(self, path):  # noqa: N802
        return types.SimpleNamespace(desc=("image", path))

    def log(self, data):
        self.calls.append(("module_log", data))

    def finish(self):
        self.calls.append(("module_finish",))


def test_logger_mirrors_to_wandb_as_jax(tmp_path, monkeypatch):
    runs = {}
    for side, cls in (("jax", jax_logging.MetricsLogger), ("port", MetricsLogger)):
        fake = _FakeWandb()
        monkeypatch.setitem(sys.modules, "wandb", fake)
        logger = cls(tmp_path / side, project="p", run_name="r", config={"a": 1}, mode="offline")
        _drive_logger(logger, "img.png")
        runs[side] = (fake.calls, fake.run.summary)
    assert runs["port"] == runs["jax"]
    calls = runs["port"][0]
    assert ("log", {"viz/recon": ("image", "img.png")}, 3) in calls and calls[-1] == ("finish",)


# ---------------------------------------------------------------------------
# callbacks
# ---------------------------------------------------------------------------


def test_callback_classes_print_as_jax(monkeypatch):
    logs = {"loss": 1.5, "val/loss": 2.25, "note": "x"}
    out = {}
    for side, mod in (("jax", jax_callbacks), ("port", callbacks)):
        console, bar = io.StringIO(), io.StringIO()
        handler = mod.CallbackHandler([mod.MetricConsoleLoggerCallback(console),
                                       mod.ProgressBarCallback(bar)])
        handler.add_callback(mod.ProgressBarCallback())  # one of each type
        assert len(handler.callbacks) == 2
        clock = iter([10.0, 12.5])
        monkeypatch.setattr(time, "time", lambda: next(clock))
        cfg = {"trainer": {"max_epochs": 3}}
        handler.on_train_begin(cfg)
        handler.on_epoch_begin(cfg, epoch=0)
        handler.on_epoch_end(cfg, epoch=0, logs=logs)
        handler.on_log(cfg, logs, step=1)
        out[side] = (console.getvalue(), bar.getvalue())
    assert out["port"] == out["jax"]
    assert out["port"] == ("[epoch 0] loss=1.5000, val/loss=2.2500\n", "epoch 1/3 done in 2.50s\n")


def test_wandb_callback_as_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    for mod in (jax_callbacks, callbacks):
        cb = mod.WandbCallback()
        assert cb.is_available is False and cb.setup({"a": 1}) is False
        cb.on_log({}, logs={"x": 1.0})
        cb.on_train_end({})
    calls = {}
    for side, mod in (("jax", jax_callbacks), ("port", callbacks)):
        fake = _FakeWandb()
        monkeypatch.setitem(sys.modules, "wandb", fake)
        cb = mod.WandbCallback()
        assert cb.setup({"a": 1}, model_config={"m": 2}, project_name="pp") is True
        cb.on_log({}, logs={"x": 1.0})
        cb.on_train_end({})
        calls[side] = fake.calls
    assert calls["port"] == calls["jax"] and calls["port"][0] == (
        "init", {"project": "pp", "config": {"a": 1}})


# ---------------------------------------------------------------------------
# StepTimer, timed, trace
# ---------------------------------------------------------------------------


def test_step_timer_matches_jax(monkeypatch):
    ticks = np.cumsum(np.random.default_rng(0).uniform(0.01, 0.2, size=2 * 1030)).tolist()
    got = {}
    for side, mod in (("jax", jax_profiling), ("port", profiling)):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer()
        assert timer.metrics() == {}
        metrics = []
        for _ in range(1030):  # past the 1000-sample window
            timer.start()
            timer.stop()
            metrics.append(timer.metrics())
        got[side] = (metrics, timer.samples)
    assert got["port"] == got["jax"]
    assert sorted(got["port"][0][-1]) == ["step_time_avg", "step_time_p50", "step_time_p99",
                                         "steps_per_sec"]


def test_timed_counts_and_trace_writes_a_chrome_trace(tmp_path):
    fn = profiling.timed(lambda x: {"y": x * 2})
    assert fn(torch.ones(3))["y"].sum() == 6 and fn(torch.ones(1))["y"].sum() == 2
    assert fn.calls == 2 and fn.total_time > 0 and fn.mean_time == fn.total_time / 2
    with profiling.trace(tmp_path / "off", enabled=False):
        torch.ones(4).sum()
    assert not (tmp_path / "off").exists()
    with profiling.trace(tmp_path / "on"):
        torch.ones(4).sum()
    (trace_file,) = (tmp_path / "on").iterdir()
    assert trace_file.name.startswith("trace_") and json.loads(trace_file.read_text())


# ---------------------------------------------------------------------------
# NaN checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tree", [
    {"a": np.ones(2), "b": {"c": np.array([1.0, np.nan]), "d": [np.inf, 1.0, np.ones(3)]}},
    {"loss": np.float32(1.0), "grad_norm": np.float32(np.nan)},
    [np.ones(2), (np.array(-np.inf), np.zeros(1))],
])
def test_assert_finite_tree_matches_jax(tree):
    with pytest.raises(FloatingPointError) as want:
        jax_debug.assert_finite_tree(tree, "metrics")
    with pytest.raises(FloatingPointError) as got:
        debug.assert_finite_tree(tree, "metrics")
    assert str(got.value) == str(want.value)
    torch_tree = jax.tree_util.tree_map(torch.as_tensor, tree)
    with pytest.raises(FloatingPointError) as got:
        debug.assert_finite_tree(torch_tree, "metrics")
    assert str(got.value) == str(want.value)
    debug.assert_finite_tree({"a": np.ones(2), "b": [torch.zeros(2), 1.0, None]})


def _nan_loss(loss, sqrt):
    """The loss plus a NaN that the step itself produces (sqrt of a negative)."""
    return loss + sqrt(-abs(loss) - 1.0)


def _tiny_data(tmp_path, cfg):
    data = CyclicDataModule({**CYCLIC_SPRITES, "train_path": str(tmp_path / "none.npz"),
                             "test_path": str(tmp_path / "none.npz"), "sequence_length": 4,
                             "image_size": [8, 8], "synthetic_n_test": 4}, seed=1)
    data.setup(cfg)
    return data


def _tiny_cfg(**trainer):
    cfg = json.loads(json.dumps(TRAINING_PRESETS["quick"]))
    cfg["trainer"].update({"max_epochs": 1, "accelerator": "cpu", **trainer})
    cfg["n_train_samples"], cfg["n_val_samples"] = 8, 4
    return cfg


def test_nan_checks_raise_on_both_sides(tmp_path):
    jm = jax_create_model(GAUSS)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0))
    forward = jm.forward

    def nan_forward(*args, **kwargs):
        out = forward(*args, **kwargs)
        out["loss"] = _nan_loss(out["loss"], jnp.sqrt)
        return out

    jm.forward = nan_forward
    opt = jax_make_optimizer(1e-3)
    step = jax_make_train_step(jm, opt, nan_checks=True)
    batch = jnp.asarray(np.random.default_rng(0).uniform(size=(4, 4, 3, 8, 8)), jnp.float32)
    with pytest.raises(Exception, match="nan generated by primitive: sqrt"):
        step(variables, opt.init(variables["params"]), batch, jax.random.PRNGKey(1))

    cfg = _tiny_cfg()
    cfg["debug_nan_checks"] = True
    pm = create_model(GAUSS, seed=0)
    trainer = Trainer(pm, _tiny_data(tmp_path, cfg), cfg, run_dir=tmp_path / "nan", seed=0)
    port_forward = pm.forward

    def port_nan_forward(*args, **kwargs):
        out = port_forward(*args, **kwargs)
        out["loss"] = _nan_loss(out["loss"], torch.sqrt)
        return out

    pm.forward = port_nan_forward
    with pytest.raises(FloatingPointError,
                       match=r"Non-finite values in loss terms: \[\"\['loss'\]\""):
        trainer.fit()


def test_nan_checks_pass_a_finite_run_and_profile_traces_epoch_0(tmp_path):
    cfg = _tiny_cfg(profile=True, max_epochs=2)
    cfg["debug_nan_checks"] = True
    trainer = Trainer(create_model(GAUSS, seed=0), _tiny_data(tmp_path, cfg), cfg,
                      run_dir=tmp_path / "run", seed=0)
    result = trainer.fit()
    assert result["epochs_run"] == 2 and np.isfinite(result["best_val_loss"])
    traces = list((tmp_path / "run" / "profile").iterdir())
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]
    grads = {k: torch.full_like(p, np.nan) for k, p in trainer.model.named_parameters()}
    for k, p in trainer.model.named_parameters():
        p.grad = grads[k]
    checked = debug.add_nan_checks(lambda: {"loss": torch.tensor(1.0)}, trainer.model)
    with pytest.raises(FloatingPointError, match="Non-finite values in gradients: "):
        checked()


# ---------------------------------------------------------------------------
# the trainer config's device keys
# ---------------------------------------------------------------------------


def test_trainer_device_keys(tmp_path):
    assert resolve_trainer_device({"accelerator": "cpu"}).type == "cpu"
    assert resolve_trainer_device({"accelerator": "auto"}, device="cpu").type == "cpu"
    assert resolve_trainer_device({"accelerator": "CPU", "devices": "auto"}).type == "cpu"
    if not torch.cuda.is_available():
        for acc in ("auto", "gpu", "cuda"):
            with pytest.raises(RuntimeError, match="CUDA"):
                resolve_trainer_device({"accelerator": acc})
    with pytest.raises(ValueError, match="TPU"):
        resolve_trainer_device({"accelerator": "tpu"})
    # outside a torch.distributed world "all" is the one device there is;
    # more than one device or model rank needs a launched world
    assert resolve_trainer_device({"accelerator": "cpu", "devices": "all"}).type == "cpu"
    for bad in ({"devices": 2}, {"model_parallel": 2}):
        with pytest.raises(ValueError, match="--world"):
            resolve_trainer_device({"accelerator": "cpu", **bad})
    cfg = _tiny_cfg(epoch_jit=True, eval_jit=True, epoch_jit_chunk_steps=2)
    trainer = Trainer(create_model(GAUSS), _tiny_data(tmp_path, cfg), cfg,
                      run_dir=tmp_path / "run", seed=0)
    assert trainer.device.type == "cpu" and trainer.fit()["steps"] == 2


# ---------------------------------------------------------------------------
# visualization manager
# ---------------------------------------------------------------------------


class _Records:
    def __init__(self):
        self.records = []

    def log(self, metrics, step=None):
        self.records.append(dict(metrics))


VIZ_CONFIGS = {
    "minimal": {"level": "minimal", "frequency": 5, "basic_frequency": 5},
    "standard": {"level": "standard", "frequency": 3, "enable_manifold": True,
                 "enable_flow_analysis": True, "basic_frequency": 2, "manifold_frequency": 3,
                 "flow_frequency": 5},
    "full": {"level": "full", "frequency": 1, "enable_manifold": True, "enable_interactive": True,
             "enable_flow_analysis": True, "basic_frequency": 1, "manifold_frequency": 5,
             "interactive_frequency": 10, "flow_frequency": 5},
    "advanced_no_basic": {"level": "advanced", "frequency": 2, "enable_basic": False,
                          "enable_interactive": True, "interactive_frequency": 4},
    "basic_level": {"level": "basic", "enable_manifold": True, "frequency": 1},
    "off": {"level": "full", "frequency": 0},
}


# a case of the full level in which one module raises at every epoch it is due
RAISES = {"full_manifold_raises": ("full", "ManifoldVisualizations")}


def _stub_runs(manager, ran, raises=None):
    """Each module's ``run`` records (epoch, class name); ``raises`` raises."""
    for module, _ in manager.modules:
        cls = type(module).__name__

        def run(epoch, *a, _n=cls):
            ran.append((epoch, _n))
            if _n == raises:
                raise RuntimeError("kaboom")
            return []

        module.run = run


@pytest.mark.parametrize("name", [*VIZ_CONFIGS, *RAISES])
def test_viz_dispatch_matches_jax(name, tmp_path, capsys):
    """The port's manager builds JAX's modules for each config and runs them
    in JAX's order at JAX's epochs, sharing one forward; a module that
    raises is reported as JAX reports it (a ``viz/error`` record and a
    printed WARNING) and the epoch's other modules still run."""
    level, raises = RAISES.get(name, (name, None))
    cfg = VIZ_CONFIGS[level]
    jax_logger, logger = _Records(), _Records()
    jax_manager = jax_viz.VisualizationManager(jax_viz.VisualizationConfig.from_mapping(cfg),
                                               tmp_path / "jax", jax_logger)
    manager = viz.VisualizationManager(viz.VisualizationConfig.from_mapping(cfg),
                                       tmp_path / "port", logger)
    assert manager.config == viz.VisualizationConfig(**{
        **jax_manager.config.__dict__, "level": viz.VisualizationLevel(jax_manager.config.level)})
    assert [type(m).__name__ for m, _ in manager.modules] == [
        type(m).__name__ for m, _ in jax_manager.modules]
    assert [f for _, f in manager.modules] == [f for _, f in jax_manager.modules]
    assert all(m._forward is manager._forward for m, _ in manager.modules)
    jax_ran, ran = [], []
    _stub_runs(jax_manager, jax_ran, raises)
    _stub_runs(manager, ran, raises)
    capsys.readouterr()
    for epoch in range(21):
        jax_manager.visualize_epoch(epoch, None, None, None)
        assert manager.visualize_epoch(epoch, None, None, None) == []
    assert ran == jax_ran
    assert logger.records == jax_logger.records
    failed = [(e, n) for e, n in ran if n == raises]
    assert [(r["epoch"], r["viz/error"]) for r in logger.records] == [
        (e, f"{n} failed at epoch {e}: kaboom") for e, n in failed]
    assert capsys.readouterr().out.count("[viz] WARNING: ") == 2 * len(failed)  # JAX's and ours
    if level == "full":
        assert [n for e, n in ran if e == 0] == [
            "BasicVisualizations", "ManifoldVisualizations", "FlowAnalysisVisualizations",
            "InteractiveVisualizations"]
    if raises:
        assert failed and len(ran) > len(failed)


def test_viz_hook_reads_the_sample_batch(tmp_path):
    assert viz.make_viz_hook({}, None, tmp_path) is None
    cfg = _tiny_cfg()
    data = _tiny_data(tmp_path, cfg)
    logger = _Records()
    hook = viz.make_viz_hook({"level": "minimal", "frequency": 2, "basic_frequency": 2,
                              "max_sequences": 3}, data,
                             tmp_path, logger)
    for epoch in range(3):
        hook(epoch=epoch, model=None, variables=None, trainer=None)
    assert [r["epoch"] for r in logger.records] == [0, 2]
    np.testing.assert_array_equal(data.get_sample_batch("val", n=3), data.val.data[:3])
