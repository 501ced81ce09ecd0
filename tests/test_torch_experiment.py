"""The port's experiment runner (``python -m rlvae_tpu_torch.experiment``)
against the JAX package's ``run_experiment.py`` on the same overrides.

- What the runner builds: with ``create_model`` and ``Trainer`` replaced on
  both sides by the same recording fakes (nothing trains), the model
  configs, the training configs, the data modules' batches (through the
  native C++ loader, the default, and through the numpy iterator with
  ``+data.use_native_loader=false``) and every file the runner writes are
  equal, for ``model=riemannian_flow_vae training=quick`` and for the
  comparison study.
- The sweep's ranking: ``run_single_experiment`` replaced on both sides by
  one table of results (NaN and missing objectives among them); the same
  ``results.yaml`` bytes.
- One tiny end-to-end run on each side (the default model at 3x8x8 frames,
  latent 4, 2 flows, a random K=8 metric ``.npz``, 2 epochs, the CPU), in a
  module-scoped fixture: the same files, ``results.yaml`` keys and metrics
  record keys; the trainer's callback events and ``viz_hook`` calls are
  recorded in the same runs and equal.
- The device rule, the comparison-study helpers and the pipelines.
"""

import copy
import datetime
import importlib
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import rlvae_tpu.models as jax_models
import rlvae_tpu.models.factory as jax_factory
import rlvae_tpu.train as jax_train
import run_experiment as jax_re
from rlvae_tpu.models import MetricsCollector as JaxCollector
from rlvae_tpu.train.pipelines import _data_module_from_arrays as jax_from_arrays
from rlvae_tpu_torch import ModelManager, experiment
from rlvae_tpu_torch.models import (
    MetricsCollector,
    apply_model_overrides,
    create_comparison_suite,
    create_model,
)
from rlvae_tpu_torch.models import factory as port_factory
from rlvae_tpu_torch.train import GenerationPipeline, TrainingPipeline, pipelines
from rlvae_tpu_torch.utils.logging import MetricsLogger

jax_compose = importlib.import_module("rlvae_tpu.config.compose")
port_compose = importlib.import_module("rlvae_tpu_torch.config.compose")
port_models = importlib.import_module("rlvae_tpu_torch.models")
port_train = importlib.import_module("rlvae_tpu_torch.train")
CONF = experiment.CONF_DIR
FROZEN = datetime.datetime(2026, 3, 4, 5, 6, 7)


class _Clock:
    class datetime:
        @staticmethod
        def now():
            return FROZEN


@pytest.fixture(autouse=True)
def frozen_now(monkeypatch):
    monkeypatch.setattr(jax_compose, "datetime", _Clock)
    monkeypatch.setattr(port_compose, "datetime", _Clock)


def _jax_runner(overrides):
    return jax_re.ExperimentRunner(jax_compose.compose(CONF, overrides=overrides))


def _records(path):
    return [{k: v for k, v in json.loads(line).items() if k != "_time"}
            for line in Path(path).read_text().splitlines()]


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*"))


# ---------------------------------------------------------------------------
# what the runner builds, with create_model and Trainer faked on both sides
# ---------------------------------------------------------------------------


class _FakeModel:
    def __init__(self, cfg):
        self.cfg = cfg

    def get_model_summary(self):
        return {"configuration": {"latent_dim": self.cfg.get("latent_dim")}}


def _fakes(log):
    def create_model(cfg, name=None, seed=None):
        log["models"].append((copy.deepcopy(cfg), name))
        return _FakeModel(cfg)

    class FakeTrainer:
        def __init__(self, model, data, training_config, run_dir=None, logger=None,
                     viz_hook=None, seed=None, stop_flag=None):
            log["trainers"].append({"training": copy.deepcopy(training_config),
                                    "run_dir": Path(run_dir).name, "seed": seed,
                                    "viz_hook": viz_hook is not None, "stop_flag": stop_flag})
            log["data"].append(data)
            self.checkpoints = type("Slots", (), {"exists": lambda self, slot: True})()
            self.history = [{"epoch": 0, "val/loss": 2.0, "val/recon_loss": 1.5},
                            {"epoch": 1, "val/loss": 1.0, "val/recon_loss": 0.5}]

        def fit(self):
            return {"best_val_loss": 1.0, "epochs_run": 2, "train_time": 0.5, "steps": 4,
                    "variables": None}

        def evaluate(self, split, **kwargs):
            return {"loss": 3.0, "recon_loss": 2.0, "split": split}

    return create_model, FakeTrainer


def _batches(dm):
    return {"train0": list(dm.train_batches(0)), "train1": list(dm.train_batches(1)),
            "val": list(dm.val_batches()), "test": list(dm.test_batches())}


CAPTURED = {
    "single": ["model=riemannian_flow_vae", "training=quick", "data.synthetic_n_test=60"],
    "comparison": ["experiment=comparison_study", "experiment.training_override.n_epochs=1",
                   "experiment.training_override.n_train_samples=16",
                   "experiment.training_override.n_val_samples=8", "data.synthetic_n_test=16"],
}


@pytest.mark.parametrize("loader", ["native", "numpy"])
@pytest.mark.parametrize("case", CAPTURED)
def test_runner_builds_what_jax_builds(case, loader, tmp_path, monkeypatch):
    overrides = CAPTURED[case] + ["training.trainer.accelerator=cpu", "run.dir=run"]
    if loader == "numpy":
        overrides.append("+data.use_native_loader=false")
    logs = {}
    for side in ("jax", "port"):
        log = logs[side] = {"models": [], "trainers": [], "data": []}
        create, trainer = _fakes(log)
        models, train = (jax_models, jax_train) if side == "jax" else (port_models, port_train)
        monkeypatch.setattr(models, "create_model", create)
        monkeypatch.setattr(train, "Trainer", trainer)
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        if side == "jax":
            _jax_runner(overrides).run()
        else:
            experiment.main(overrides)
    jax_log, port_log = logs["jax"], logs["port"]
    assert port_log["models"] == jax_log["models"]
    assert [n for _, n in port_log["models"]] == (
        ["rlvae_comparison"] if case == "single" else ["vanilla_vae", "riemannian_flow_vae"])
    assert port_log["trainers"] == jax_log["trainers"]
    for jdm, pdm in zip(jax_log["data"], port_log["data"]):
        assert pdm.batch_size == jdm.batch_size
        assert pdm.get_data_stats() == jdm.get_data_stats()
        assert pdm.train.get_sequence_info(1) == jdm.train.get_sequence_info(1)
        np.testing.assert_array_equal(pdm.get_sample_batch("val", 4),
                                      jdm.get_sample_batch("val", 4))
        want, got = _batches(jdm), _batches(pdm)
        assert (pdm._native_loader is not None) == (loader == "native")
        assert (jdm._native_loader is not None and jdm._native_loader.native) == (
            loader == "native")
        for k in want:
            assert len(got[k]) == len(want[k]) > 0, k
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(a, b)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    for p in _tree(tmp_path / "jax"):
        jp, pp = tmp_path / "jax" / p, tmp_path / "port" / p
        if p.endswith(".yaml"):
            assert pp.read_bytes() == jp.read_bytes(), p
        elif p.endswith(".jsonl"):
            assert _records(pp) == _records(jp), p


def _fake_single(self):
    beta = float(self.config.get("model.riemannian_beta"))
    method = self.config.get("model.sampling.method")
    lr = float(self.config.get("training.optimizer.lr"))
    value = float("nan") if method == "basic" else beta + 100 * lr + len(method)
    test = {} if method == "geodesic" else {"recon_loss": -value if beta > 1 else value}
    return {"best_val_loss": value, "test_metrics": test}


@pytest.mark.parametrize("objective", [("val_loss", "minimize"), ("recon_loss", "maximize"),
                                       ("recon_loss", "minimize")])
def test_sweep_ranks_as_jax(objective, tmp_path, monkeypatch):
    metric, goal = objective
    overrides = ["experiment=hyperparameter_sweep", "experiment.max_runs=12",
                 f"experiment.objective.metric={metric}", f"experiment.objective.goal={goal}",
                 "training.trainer.accelerator=cpu", "run.dir=run"]
    monkeypatch.setattr(jax_re.ExperimentRunner, "run_single_experiment", _fake_single)
    monkeypatch.setattr(experiment.ExperimentRunner, "run_single_experiment", _fake_single)
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        if side == "jax":
            _jax_runner(overrides).run()
        else:
            experiment.main(overrides)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    for p in _tree(tmp_path / "jax"):
        if p.endswith(".yaml"):
            assert (tmp_path / "port" / p).read_bytes() == (tmp_path / "jax" / p).read_bytes(), p
    runs = yaml.safe_load((tmp_path / "port" / "run" / "results.yaml").read_text())["runs"]
    assert len(runs) == 12
    key = "best_val_loss" if metric == "val_loss" else "objective_value"
    nan = [v != v for v in (r[key] for r in runs)]  # NaN (a missing objective) ranks last
    assert any(nan) and nan == sorted(nan)


# ---------------------------------------------------------------------------
# one tiny run on each side
# ---------------------------------------------------------------------------


def _summary(key, value):
    if key in ("logs", "metrics", "result"):
        return sorted(value)
    return "trainer" if key == "trainer" else value


class _Recorder:
    """A callback that records every event with its keyword names."""

    def __init__(self):
        self.events = []

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)
        return lambda cfg, **kw: self.events.append(
            (name, {k: _summary(k, v) for k, v in sorted(kw.items())}))


def _recording(base, record):
    class Recording(base):
        def __init__(self, *args, viz_hook=None, callbacks=None, **kwargs):
            recorder = _Recorder()
            record["events"] = recorder.events

            def hook(**kw):
                record["viz"].append((kw["epoch"], sorted(kw)))
                return viz_hook(**kw)

            super().__init__(*args, viz_hook=hook, callbacks=[recorder], **kwargs)

    return Recording


def _tiny_overrides(metric_path):
    return ["training=quick", "training.trainer.accelerator=cpu", "training.trainer.max_epochs=2",
            "training.trainer.epoch_jit=false", "training.trainer.eval_jit=false",
            "training.n_train_samples=8", "training.n_val_samples=4", "data.image_size=[8,8]",
            "data.sequence_length=4", "data.synthetic_n_train=16", "data.synthetic_n_test=8",
            "model.latent_dim=4", "model.n_flows=2", "model.flow_hidden_size=16",
            "model.encoder.hidden_dims=[16]", "model.decoder.hidden_dims=[16]",
            "model.pretrained.encoder_path=null", "model.pretrained.decoder_path=null",
            f"model.pretrained.metric_path={metric_path}", "visualization=minimal",
            "visualization.frequency=0"]


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """The JAX runner and the port's CLI, each once, on the same overrides,
    with the trainer's callback events and viz_hook calls recorded."""
    root = tmp_path_factory.mktemp("e2e")
    d = 4
    rng = np.random.default_rng(0)
    a = (rng.normal(size=(8, d, d)) / np.sqrt(d)).astype(np.float32)
    np.savez(root / "metric.npz", centroids=(0.5 * rng.normal(size=(8, d))).astype(np.float32),
             M_matrices=(a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(d, dtype=np.float32)),
             temperature=np.float32(1.0), regularization=np.float32(0.01))
    overrides = _tiny_overrides(root / "metric.npz")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_compose, "datetime", _Clock)
        mp.setattr(port_compose, "datetime", _Clock)
        for side, module in (("jax", jax_train), ("port", port_train)):
            record = out[side] = {"viz": [], "dir": root / side}
            mp.setattr(module, "Trainer", _recording(module.Trainer, record))
            run = overrides + [f"run.dir={root / side}"]
            if side == "jax":
                _jax_runner(run).run()
            else:
                (record["result"],) = experiment.main(run)
    return out


def test_tiny_run_writes_the_files_jax_writes(tiny_runs):
    jax_dir, port_dir = tiny_runs["jax"]["dir"], tiny_runs["port"]["dir"]
    top = sorted(os.listdir(jax_dir))
    assert top == ["checkpoints", "config.yaml", "metrics.jsonl", "results.yaml", "summary.json"]
    assert sorted(os.listdir(port_dir)) == top
    assert sorted(os.listdir(port_dir / "checkpoints")) == sorted(
        os.listdir(jax_dir / "checkpoints")) == ["best", "last", "model_config.json"]
    for name in ("model_config.json",):
        assert (json.loads((port_dir / "checkpoints" / name).read_text())
                == json.loads((jax_dir / "checkpoints" / name).read_text()))
    cfgs = [yaml.safe_load((d / "config.yaml").read_text()) for d in (jax_dir, port_dir)]
    for cfg in cfgs:
        assert cfg["model"]["input_dim"] == [3, 8, 8]  # reconciled with the data config
        cfg["run"].pop("dir")
    assert cfgs[1] == cfgs[0]
    results = [yaml.safe_load((d / "results.yaml").read_text()) for d in (jax_dir, port_dir)]
    assert list(results[1]) == list(results[0]) == ["best_val_loss", "epochs_run",
                                                   "train_time_sec", "test"]
    assert sorted(results[1]["test"]) == sorted(results[0]["test"])
    assert results[1]["epochs_run"] == results[0]["epochs_run"] == 2
    assert all(np.isfinite(v) for v in results[1]["test"].values())
    summaries = [json.loads((d / "summary.json").read_text()) for d in (jax_dir, port_dir)]
    assert sorted(summaries[1]) == sorted(summaries[0])


def test_tiny_run_records_carry_jax_keys(tiny_runs):
    want = [sorted(r) for r in _records(tiny_runs["jax"]["dir"] / "metrics.jsonl")]
    got = [sorted(r) for r in _records(tiny_runs["port"]["dir"] / "metrics.jsonl")]
    assert got == want
    steps = [r for r in got if "train/loss" in r and "epoch" not in r]
    assert len(steps) == 4  # log_every_n_steps 1, 2 steps an epoch
    for r in steps:
        assert {"step_time_avg", "step_time_p50", "step_time_p99", "steps_per_sec", "lr"} <= set(r)


def test_tiny_run_fires_jax_callback_events(tiny_runs):
    """The same events with the same keyword names; a ``best`` save follows
    each side's own improvements (the two runs draw other noise)."""
    seqs = {}
    for side in ("jax", "port"):
        events = tiny_runs[side]["events"]
        history = [r for r in _records(tiny_runs[side]["dir"] / "metrics.jsonl") if "epoch" in r
                   and "val/loss" in r]
        losses = [r["val/loss"] for r in history]
        improved = [i for i, v in enumerate(losses) if v < min([np.inf] + losses[:i])]
        best = [i for i, (name, kw) in enumerate(events)
                if name == "on_save" and kw["slot"] == "best"]
        epoch_ends = [i for i, (name, _) in enumerate(events) if name == "on_epoch_end"]
        assert best == [epoch_ends[e] + 1 for e in improved], side
        seqs[side] = [e for i, e in enumerate(events) if i not in best]
    assert seqs["port"] == seqs["jax"]
    names = [n for n, _ in seqs["port"]]
    assert names[:3] == ["on_init_end", "on_train_begin", "on_epoch_begin"]
    assert names[-4:] == ["on_eval_step_begin", "on_eval_step_end", "on_eval_step_begin",
                          "on_eval_step_end"]  # the runner's test evaluation, 2 batches


def test_tiny_run_calls_viz_hook_as_jax(tiny_runs):
    assert tiny_runs["port"]["viz"] == tiny_runs["jax"]["viz"] == [
        (0, ["epoch", "model", "trainer", "variables"]),
        (1, ["epoch", "model", "trainer", "variables"])]


def test_from_run_serves_the_port_run_and_refuses_orbax_slots(tiny_runs):
    port_dir = tiny_runs["port"]["dir"]
    manager = ModelManager.from_run(port_dir, device="cpu")
    x = np.random.default_rng(1).uniform(size=(2, 4, 3, 8, 8)).astype(np.float32)
    recon = manager.reconstruct(x)
    assert recon.shape == x.shape and np.isfinite(recon).all()
    with pytest.raises(ValueError, match="rlvae_tpu_torch.convert.checkpoint_from_jax"):
        ModelManager.from_run(tiny_runs["jax"]["dir"], device="cpu")


# ---------------------------------------------------------------------------
# the device rule
# ---------------------------------------------------------------------------


def test_cli_needs_the_card_unless_the_config_asks_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        experiment.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        experiment.main(["-m", "model=vanilla_vae,hybrid_rlvae"])
    with pytest.raises(ValueError, match="--world"):
        experiment.main(["training.trainer.accelerator=cpu", "training.trainer.devices=2"])
    with pytest.raises(ValueError, match="TPU"):
        experiment.main(["training.trainer.accelerator=tpu"])
    assert os.listdir(tmp_path) == []  # nothing written


# ---------------------------------------------------------------------------
# comparison-study helpers and pipelines
# ---------------------------------------------------------------------------


def test_metrics_collector_matches_jax(tmp_path):
    entries = [("a", {"loss": 2.0, "kl": 1.0}), ("a", {"loss": 1.0}), ("b", {"loss": 3.5}),
               ("a", {"loss": 0.5, "kl": 4.0, "new": 9.0}), ("b", {"loss": np.float32(1.25)})]
    jc, pc = JaxCollector(), MetricsCollector()
    for name, m in entries:
        jc.add_model_metrics(name, m)
        pc.add_model_metrics(name, m)
    assert pc.get_comparison_summary() == jc.get_comparison_summary()
    jc.log_comparison(MetricsLogger(tmp_path / "jax"))
    pc.log_comparison(MetricsLogger(tmp_path / "port"))
    assert ((tmp_path / "port" / "comparison_summary.json").read_text()
            == (tmp_path / "jax" / "comparison_summary.json").read_text())


@pytest.mark.parametrize("option", ["riemannian_flow_vae", "vanilla_vae", "hybrid_rlvae",
                                    "riemannian_flow_vae_fast"])
def test_model_overrides_and_comparison_suite_match_jax(option, monkeypatch):
    cfg = jax_compose.compose(CONF, overrides=[f"model={option}",
                                               "experiment=comparison_study"]).to_dict()
    for name in ("vanilla_vae", "riemannian_flow_vae", "other"):
        assert apply_model_overrides(cfg["model"], name) == jax_models.apply_model_overrides(
            cfg["model"], name)
    sparse = {"latent_dim": 4, "sampling": None}
    assert apply_model_overrides(sparse, "vanilla_vae") == jax_models.apply_model_overrides(
        sparse, "vanilla_vae")
    built = {"jax": [], "port": []}
    monkeypatch.setattr(jax_factory, "create_model",
                        lambda c, name=None: built["jax"].append((c, name)))
    monkeypatch.setattr(port_factory, "create_model",
                        lambda c, seed=0, name=None: built["port"].append((c, name)))
    for config in (cfg, {**cfg, "experiment": {}}):
        assert list(create_comparison_suite(config)) == list(
            jax_factory.create_comparison_suite(config))
    assert built["port"] == built["jax"] and len(built["port"]) == 3


def test_pipelines_data_module_matches_jax():
    rng = np.random.default_rng(0)
    cases = [(rng.uniform(size=(10, 4, 3, 8, 8)), None, 4),
             (rng.uniform(size=(6, 3, 8, 8)), rng.uniform(size=(2, 3, 8, 8)), 8),
             (rng.uniform(size=(5, 2, 1, 4, 4)), rng.uniform(size=(3, 2, 1, 4, 4)), 2)]
    for train, evald, bs in cases:
        cfg = {"data": {"batch_size": bs}}
        jdm, pdm = jax_from_arrays(train, evald, cfg), pipelines._data_module_from_arrays(
            train, evald, cfg)
        assert pdm.batch_size == jdm.batch_size
        for split in ("train", "val", "test"):
            np.testing.assert_array_equal(getattr(pdm, split).data, getattr(jdm, split).data)
    for bad in (np.zeros((2, 3, 8)), np.zeros((0, 4, 3, 8, 8))):
        with pytest.raises(ValueError):
            pipelines._data_module_from_arrays(bad, None, {})


def test_training_and_generation_pipelines(tmp_path):
    net = {"architecture": "mlp", "hidden_dims": [16], "dtype": "float32"}
    model = create_model({"input_dim": [3, 8, 8], "latent_dim": 4, "n_flows": 0,
                          "encoder": net, "decoder": net, "posterior": {"type": "gaussian"}})
    recorder = _Recorder()
    pipe = TrainingPipeline(model, {"trainer": {"max_epochs": 1, "accelerator": "cpu"},
                                    "data": {"batch_size": 4}}, output_dir=tmp_path)
    result = pipe(np.random.default_rng(0).uniform(size=(8, 4, 3, 8, 8)), callbacks=[recorder])
    final = Path(result["run_dir"]) / "final_model"
    assert sorted(os.listdir(final)) == ["model_config.json", "weights"]
    assert json.loads((final / "model_config.json").read_text()) == model.get_model_summary()
    weights = torch.load(final / "weights" / "state.pt", weights_only=True)
    assert weights["step"] == result["steps"] == 2
    assert all(torch.equal(weights["params"][k], v) for k, v in model.state_dict().items())
    assert recorder.events[-1][0] == "on_train_end"
    images = GenerationPipeline(model)(num_samples=5, batch_size=2, seed=3)
    assert images.shape == (5, 3, 8, 8) and np.isfinite(images).all()
    with pytest.raises(NotImplementedError, match="Available"):  # vamp is registered now
        GenerationPipeline(model, "no_such_sampler")
