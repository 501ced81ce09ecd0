"""Checkpoints, resume and preemption of the port's Trainer, the metrics
files, ModelManager.from_checkpoint/from_run, and the model summary against
JAX's.

The trainer tests run a tiny model (3x8x8 frames, 4-frame sequences, MLP
nets of width 16 in fp32, 2 flows of width 16, the pretrained K=50 metric) on
the CPU, each in its own ``tmp_path`` run directory.  Every comparison is
exact: restored tensors bit for bit (``torch.equal``), metrics and outputs
of the same weights on the same noise as equal floats.
"""

import copy
import json
import os
import signal
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from rlvae_tpu.models import create_model as jax_create_model
from rlvae_tpu_torch import ModelManager, PRESETS, create_model
from rlvae_tpu_torch.data import CYCLIC_SPRITES, CyclicDataModule
from rlvae_tpu_torch.train import (
    TRAINING_PRESETS,
    CheckpointManager,
    Trainer,
    adam_state,
    get_lr,
    set_lr,
)
from rlvae_tpu_torch.train.__main__ import main as train_main
from rlvae_tpu_torch.train.checkpoints import STATE_FILE
from rlvae_tpu_torch.utils.logging import MetricsLogger

NET = {"architecture": "mlp", "hidden_dims": [16], "dtype": "float32"}
TINY = {**PRESETS["riemannian_flow_vae"], "name": "tiny", "input_dim": [3, 8, 8], "n_flows": 2,
        "flow_hidden_size": 16, "encoder": NET, "decoder": NET,
        "pretrained": {"metric_path": PRESETS["riemannian_flow_vae"]["pretrained"]["metric_path"]}}
STEPS_PER_EPOCH = 3


def _data(tmp_path):
    cfg = copy.deepcopy(TRAINING_PRESETS["quick"])
    cfg["trainer"]["max_epochs"] = 3
    cfg["n_train_samples"], cfg["n_val_samples"] = 4 * STEPS_PER_EPOCH, 4
    data = CyclicDataModule({**CYCLIC_SPRITES, "train_path": str(tmp_path / "none.npz"),
                             "test_path": str(tmp_path / "none.npz"), "sequence_length": 4,
                             "image_size": [8, 8], "synthetic_n_test": 4}, seed=1)
    data.setup(cfg)
    return data, cfg


def _trainer(tmp_path, **kw):
    data, cfg = _data(tmp_path)
    return Trainer(create_model(TINY, seed=0), data, cfg, run_dir=tmp_path / "run", seed=0,
                   device="cpu", **kw)


def _state_equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _adam_equal(a, b):
    return a["lr"] == b["lr"] and a["state"].keys() == b["state"].keys() and all(
        _state_equal(a["state"][k], b["state"][k]) for k in a["state"])


def _record_first_step(trainer):
    """Wrap the train step: the Adam state and learning rate just before the
    first step of this trainer's run."""
    seen, step = [], trainer.train_step

    def recorded(x, noise):
        if not seen:
            seen.append(adam_state(trainer.model, trainer.optimizer))
        return step(x, noise)

    trainer.train_step = recorded
    return seen


# ---------------------------------------------------------------------------
# CheckpointManager and MetricsLogger
# ---------------------------------------------------------------------------


def test_checkpoint_manager_round_trip(tmp_path):
    summary = create_model(TINY).get_model_summary()
    ckpt = CheckpointManager(tmp_path / "checkpoints", summary)
    assert ckpt.load_model_config() == json.loads(json.dumps(summary))
    assert CheckpointManager(tmp_path / "other").load_model_config() is None
    assert not ckpt.exists("best")
    with pytest.raises(FileNotFoundError, match="best"):
        ckpt.restore("best")
    state = {"params": {"a.weight": torch.randn(3, 2), "b": torch.arange(4)}, "step": 7,
             "val_loss": 1.5, "optimizer": {"lr": 1e-3, "state": {}}}
    ckpt.save("best", state)
    ckpt.wait()
    assert ckpt.exists("best") and (tmp_path / "checkpoints" / "best").is_dir()
    got = ckpt.restore("best", map_location="cpu")
    assert got.keys() == state.keys() and _state_equal(got["params"], state["params"])
    assert got["step"] == 7 and got["val_loss"] == 1.5 and got["optimizer"]["lr"] == 1e-3
    # tensors, ints, floats and dicts only: loads with weights_only=True
    torch.load(ckpt.path("best"), weights_only=True)
    # a second save replaces the slot and leaves no temporary file
    ckpt.save("best", {**state, "step": 8})
    assert ckpt.restore("best")["step"] == 8
    assert os.listdir(tmp_path / "checkpoints" / "best") == [STATE_FILE]


def test_checkpoint_save_that_fails_keeps_the_old_slot(tmp_path, monkeypatch):
    ckpt = CheckpointManager(tmp_path)
    ckpt.save("last", {"step": 1})

    def broken_save(obj, f):
        with open(f, "wb") as fh:
            fh.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken_save)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save("last", {"step": 2})
    monkeypatch.undo()
    assert ckpt.restore("last") == {"step": 1}
    assert os.listdir(tmp_path / "last") == [STATE_FILE]


def test_metrics_logger_files(tmp_path, monkeypatch):
    logger = MetricsLogger(tmp_path / "run")
    logger.log({"loss": torch.tensor(2.5), "note": "text"}, step=3)
    logger.log({"val/loss": np.float32(1.25)})
    logger.log_table("table", [{"a": 1}, {"b": 2.0}])
    logger.summary({"best_val_loss": 1.25, "steps": 3})
    logger.finish()
    records = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text()
               .splitlines()]
    assert len(records) == 2 and records[0]["_step"] == 3 and "_step" not in records[1]
    assert records[0]["loss"] == 2.5 and records[0]["note"] == "text"
    assert records[1]["val/loss"] == 1.25 and all("_time" in r for r in records)
    assert json.loads((tmp_path / "run" / "table.json").read_text()) == [{"a": 1}, {"b": 2.0}]
    assert json.loads((tmp_path / "run" / "summary.json").read_text())["steps"] == 3
    # any mode: without wandb the logger keeps to the local files, as JAX's
    monkeypatch.setitem(sys.modules, "wandb", None)
    assert MetricsLogger(tmp_path / "w", mode="online").wandb_run is None


# ---------------------------------------------------------------------------
# Trainer: run directory, best weights, preemption and resume
# ---------------------------------------------------------------------------


def test_fit_writes_best_last_and_metrics(tmp_path):
    trainer = _trainer(tmp_path)
    result = trainer.fit(max_epochs=2)
    run = tmp_path / "run"
    assert result["steps"] == 2 * STEPS_PER_EPOCH and result["epochs_run"] == 2
    assert result["preempted"] is False
    for f in ("metrics.jsonl", "summary.json", "checkpoints/model_config.json"):
        assert (run / f).exists(), f
    assert (run / "checkpoints" / "best").is_dir() and (run / "checkpoints" / "last").is_dir()
    assert trainer.checkpoints.load_model_config() == trainer.model.get_model_summary()
    summary = json.loads((run / "summary.json").read_text())
    assert summary["steps"] == result["steps"] and summary["preempted"] is False
    epochs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()
              if "epoch" in line]
    assert [r["epoch"] for r in epochs] == [0, 1]

    last = trainer.checkpoints.restore("last")
    assert sorted(last) == ["epoch", "optimizer", "params", "step", "val_loss"]
    assert last["step"] == result["steps"] and last["epoch"] == 1
    assert last["val_loss"] == result["best_val_loss"]
    assert _state_equal(last["params"], trainer.model.state_dict())
    assert _adam_equal(last["optimizer"], adam_state(trainer.model, trainer.optimizer))
    assert len(last["optimizer"]["state"]) == len(list(trainer.model.parameters()))
    step_counts = {float(s["step"]) for s in last["optimizer"]["state"].values()}
    assert step_counts == {float(result["steps"])}

    best = trainer.checkpoints.restore("best")
    assert sorted(best) == ["params", "step", "val_loss"]
    losses = [h["val/loss"] for h in result["history"]]
    assert best["val_loss"] == min(losses) == result["best_val_loss"]
    assert best["step"] == STEPS_PER_EPOCH * (1 + int(np.argmin(losses)))


def test_evaluate_reads_best_and_keeps_the_live_weights(tmp_path):
    trainer = _trainer(tmp_path)
    trainer.fit(max_epochs=1)
    best = trainer.checkpoints.restore("best")["params"]
    with torch.no_grad():
        for p in trainer.model.parameters():
            p.add_(0.1)
    live = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    from_best = trainer.evaluate()
    assert _state_equal(trainer.model.state_dict(), live)
    assert trainer.evaluate(weights="live") != from_best
    trainer.model.load_state_dict(best)
    assert trainer.evaluate(weights="live") == from_best


def test_evaluate_without_best_raises(tmp_path):
    trainer = _trainer(tmp_path)
    with pytest.raises(FileNotFoundError, match="'best'"):
        trainer.evaluate()
    with pytest.raises(FileNotFoundError, match="'best'"):
        trainer.evaluate("val")


def _check_resume(tmp_path, first, result):
    """A fresh trainer resumed from ``last``: the weights, the Adam state and
    the learning rate it starts from are the saved ones, and the step count
    and best validation loss carry on."""
    saved = first.checkpoints.restore("last")
    resumed = _trainer(tmp_path)
    seen = _record_first_step(resumed)
    result2 = resumed.fit(resume=True)
    assert _adam_equal(seen[0], saved["optimizer"])
    assert result2["preempted"] is False and result2["epochs_run"] == 3
    assert [h["epoch"] for h in resumed.history] == list(range(result["epochs_run"], 3))
    assert result2["steps"] == result["steps"] + STEPS_PER_EPOCH * len(resumed.history)
    assert result2["best_val_loss"] <= result["best_val_loss"]
    assert get_lr(resumed.optimizer) == saved["optimizer"]["lr"]
    assert all(float(s["step"]) == result2["steps"]
               for s in adam_state(resumed.model, resumed.optimizer)["state"].values())


def test_stop_flag_preempts_and_resume_carries_the_state(tmp_path):
    holder = {}

    def stop():
        if holder["trainer"].history:  # after epoch 0: a learning rate of its own, then stop
            set_lr(holder["trainer"].optimizer, 3.25e-4)
            return True
        return False

    trainer = holder["trainer"] = _trainer(tmp_path, stop_flag=stop)
    result = trainer.fit()
    assert result["preempted"] is True
    assert result["epochs_run"] == 1 and result["steps"] == STEPS_PER_EPOCH
    assert trainer.checkpoints.exists("best") and trainer.checkpoints.exists("last")
    saved = trainer.checkpoints.restore("last")
    assert saved["epoch"] == 0 and saved["optimizer"]["lr"] == 3.25e-4
    assert _state_equal(saved["params"], trainer.model.state_dict())
    records = (tmp_path / "run" / "metrics.jsonl").read_text()
    assert '"preempted_at": 0' in records
    _check_resume(tmp_path, trainer, result)


def test_stop_before_the_first_epoch_runs_none(tmp_path):
    trainer = _trainer(tmp_path, stop_flag=lambda: True)
    result = trainer.fit()
    assert result["preempted"] is True and result["epochs_run"] == 0 and result["steps"] == 0
    assert not trainer.checkpoints.exists("best")
    assert trainer.checkpoints.restore("last")["epoch"] == -1
    resumed = _trainer(tmp_path)
    assert resumed.fit(max_epochs=1, resume=True)["epochs_run"] == 1


def test_sigterm_preempts_at_the_epoch_boundary_and_resumes(tmp_path):
    """SIGTERM sent to this process in the middle of epoch 0 (inside the
    train batches) stops fit at the end of that epoch; the handler that was
    installed before fit is back afterwards."""
    trainer = _trainer(tmp_path)
    batches = trainer.data.train_batches

    def evicted(epoch):
        for i, batch in enumerate(batches(epoch)):
            if epoch == 0 and i == 1:
                os.kill(os.getpid(), signal.SIGTERM)  # delivered to the trainer's handler
            yield batch

    trainer.data.train_batches = evicted
    received = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: received.append(s))
    try:
        result = trainer.fit()
        handler_after = signal.getsignal(signal.SIGTERM)
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert received == []  # the trainer's handler took it
    assert handler_after is not None and handler_after.__name__ == "<lambda>"
    assert result["preempted"] is True
    assert result["epochs_run"] == 1 and result["steps"] == STEPS_PER_EPOCH
    assert (tmp_path / "run" / "checkpoints" / "last").exists()
    trainer.data.train_batches = batches
    _check_resume(tmp_path, trainer, result)


def test_handle_preemption_off_leaves_sigterm_alone(tmp_path):
    data, cfg = _data(tmp_path)
    cfg["trainer"]["handle_preemption"] = False
    trainer = Trainer(create_model(TINY), data, cfg, run_dir=tmp_path / "run", seed=0,
                      device="cpu")
    before = signal.getsignal(signal.SIGTERM)
    assert trainer._install_preemption_handler() is None
    assert signal.getsignal(signal.SIGTERM) is before


# ---------------------------------------------------------------------------
# Model summary against JAX, ModelManager from a run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["riemannian_flow_vae", "hybrid_rlvae"])
def test_summary_and_param_count_match_jax(preset):
    cfg = PRESETS[preset]
    jm = jax_create_model(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    pm = create_model(cfg)
    assert pm.param_count() == jm.param_count(shapes)
    if preset == "riemannian_flow_vae":
        assert pm.param_count() == 14_927_392
    assert pm.get_model_summary() == jm.get_model_summary()
    assert pm.get_model_summary(include_parameter_count=True) == jm.get_model_summary(shapes)


def test_from_checkpoint_from_run_and_model_info(tmp_path):
    trainer = _trainer(tmp_path)
    trainer.fit(max_epochs=1)
    run = tmp_path / "run"
    best = trainer.checkpoints.restore("best")["params"]
    manager = ModelManager.from_checkpoint(run, TINY, device="cpu")
    assert manager.device.type == "cpu" and _state_equal(manager.model.state_dict(), best)
    by_hand = create_model(TINY)
    by_hand.load_state_dict(best)
    x = np.random.default_rng(3).uniform(size=(3, 4, 3, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(manager.reconstruct(x, seed=5),
                                  ModelManager(by_hand, device="cpu").reconstruct(x, seed=5))
    last = ModelManager.from_checkpoint(run, TINY, slot="last", device="cpu")
    assert _state_equal(last.model.state_dict(), trainer.model.state_dict())
    info = manager.get_model_info()
    assert info == {**trainer.model.get_model_summary(),
                    "parameter_count": trainer.model.param_count()}

    with pytest.raises(FileNotFoundError, match="config.yaml"):
        ModelManager.from_run(run, device="cpu")
    # the JSON text older runs of the training CLI wrote, and the YAML of a
    # JAX run or of the port's runner: the model section either way
    for text in (json.dumps({"model": TINY, "seed": 0}),
                 yaml.safe_dump({"model": TINY, "seed": 0}, sort_keys=False)):
        (run / "config.yaml").write_text(text)
        from_run = ModelManager.from_run(run, device="cpu")
        assert _state_equal(from_run.model.state_dict(), best)
    (run / "config.yaml").write_text("seed: 0\n")
    with pytest.raises(ValueError, match="no 'model' section"):
        ModelManager.from_run(run, device="cpu")
    with pytest.raises(FileNotFoundError, match="'missing'"):
        ModelManager.from_checkpoint(run, TINY, slot="missing", device="cpu")
    # a JAX run's slot is an orbax directory, not the port's state.pt
    orbax_slot = run / "checkpoints" / "orbax"
    orbax_slot.mkdir()
    (orbax_slot / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="convert.checkpoint_from_jax"):
        ModelManager.from_checkpoint(run, TINY, slot="orbax", device="cpu")


def test_cli_run_dir_and_resume(tmp_path):
    """``python -m rlvae_tpu_torch.train`` at full width on the CPU: one step
    into a run directory, then one more step resumed from it; the run's
    config.yaml (YAML, through ``save_config``) reloads the model through
    ``from_run``."""
    run = tmp_path / "cli"
    args = ["--device", "cpu", "--run-dir", str(run), "--steps", "1", "--batch-size", "2"]
    first = train_main(args)
    assert first["steps"] == 1 and first["epochs_run"] == 1
    cfg = yaml.safe_load((run / "config.yaml").read_text())
    assert cfg["model"] == PRESETS["riemannian_flow_vae"] and cfg["seed"] == 42
    assert cfg["training"]["data"]["batch_size"] == 2
    second = train_main(args + ["--resume"])
    assert second["steps"] == 2 and second["epochs_run"] == 2
    assert second["best_val_loss"] <= first["best_val_loss"]
    manager = ModelManager.from_run(run, slot="last", device="cpu")
    last = CheckpointManager(run / "checkpoints").restore("last")
    assert last["step"] == 2 and _state_equal(manager.model.state_dict(), last["params"])
