"""Training callbacks: the port of ``rlvae_tpu/train/callbacks.py``.

:class:`TrainingCallback` has the hook set of the pythae trainer stack;
:class:`CallbackHandler` dispatches one event to every callback.  The
port's :class:`~rlvae_tpu_torch.train.Trainer` fires the events of JAX's
per-step path, with the same keyword names at the same points:
``on_init_end`` at the end of ``__init__``; ``on_train_begin``;
per epoch ``on_epoch_begin``, per step ``on_train_step_begin`` and, every
``log_every_n_steps`` steps, ``on_train_step_end`` and ``on_log`` with the
step record; per evaluation batch ``on_eval_step_begin`` and
``on_eval_step_end``; ``on_evaluate``, ``on_epoch_end`` and, at an improved
validation loss, ``on_save(slot="best")``; at the end ``on_save(slot="last")``
and ``on_train_end``.  Hooks run on the host between steps.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, Iterable, List, Optional

from rlvae_tpu_torch.device import is_main_process


class TrainingCallback:
    """Base class; subclasses override any subset of the hooks.  Every hook
    receives the training config dict plus keyword context."""

    def on_init_end(self, training_config: Dict[str, Any], **kwargs):
        pass

    def on_train_begin(self, training_config: Dict[str, Any], **kwargs):
        pass

    def on_train_end(self, training_config: Dict[str, Any], **kwargs):
        pass

    def on_epoch_begin(self, training_config: Dict[str, Any], **kwargs):
        pass

    def on_epoch_end(self, training_config: Dict[str, Any], **kwargs):
        pass

    def on_train_step_begin(self, training_config: Dict[str, Any], **kwargs):
        pass

    def on_train_step_end(self, training_config: Dict[str, Any], **kwargs):
        pass

    def on_eval_step_begin(self, training_config: Dict[str, Any], **kwargs):
        pass

    def on_eval_step_end(self, training_config: Dict[str, Any], **kwargs):
        pass

    def on_evaluate(self, training_config: Dict[str, Any], **kwargs):
        pass

    def on_prediction_step(self, training_config: Dict[str, Any], **kwargs):
        pass

    def on_save(self, training_config: Dict[str, Any], **kwargs):
        pass

    def on_log(self, training_config: Dict[str, Any], logs: Dict[str, Any], **kwargs):
        pass


class CallbackHandler:
    """Dispatches one event to every registered callback."""

    def __init__(self, callbacks: Optional[Iterable[TrainingCallback]] = None):
        self.callbacks: List[TrainingCallback] = list(callbacks or [])

    def add_callback(self, callback: TrainingCallback) -> None:
        if any(type(cb) is type(callback) for cb in self.callbacks):
            return  # one callback of each type, as the reference handler
        self.callbacks.append(callback)

    def __iter__(self):
        return iter(self.callbacks)

    def call_event(self, event: str, training_config: Dict[str, Any], **kwargs):
        for cb in self.callbacks:
            getattr(cb, event)(training_config, **kwargs)

    def on_init_end(self, training_config, **kw):
        self.call_event("on_init_end", training_config, **kw)

    def on_train_begin(self, training_config, **kw):
        self.call_event("on_train_begin", training_config, **kw)

    def on_train_end(self, training_config, **kw):
        self.call_event("on_train_end", training_config, **kw)

    def on_epoch_begin(self, training_config, **kw):
        self.call_event("on_epoch_begin", training_config, **kw)

    def on_epoch_end(self, training_config, **kw):
        self.call_event("on_epoch_end", training_config, **kw)

    def on_train_step_end(self, training_config, **kw):
        self.call_event("on_train_step_end", training_config, **kw)

    def on_evaluate(self, training_config, **kw):
        self.call_event("on_evaluate", training_config, **kw)

    def on_save(self, training_config, **kw):
        self.call_event("on_save", training_config, **kw)

    def on_log(self, training_config, logs, **kw):
        self.call_event("on_log", training_config, logs=logs, **kw)


class MetricConsoleLoggerCallback(TrainingCallback):
    """One console line of metrics per epoch."""

    def __init__(self, stream=None):
        self.stream = stream or sys.stderr

    def on_epoch_end(self, training_config, **kwargs):
        epoch = kwargs.get("epoch")
        logs = kwargs.get("logs", {})
        parts = ", ".join(
            f"{k}={v:.4f}" for k, v in logs.items() if isinstance(v, (int, float))
        )
        print(f"[epoch {epoch}] {parts}", file=self.stream, flush=True)


class ProgressBarCallback(TrainingCallback):
    """Dependency-free progress reporting: one line per finished epoch."""

    def __init__(self, stream=None):
        self.stream = stream or sys.stderr
        self._epoch_start = 0.0
        self._max_epochs = 0

    def on_train_begin(self, training_config, **kwargs):
        trainer_cfg = training_config.get("trainer", {})
        self._max_epochs = int(trainer_cfg.get("max_epochs", 0))

    def on_epoch_begin(self, training_config, **kwargs):
        self._epoch_start = time.time()

    def on_epoch_end(self, training_config, **kwargs):
        epoch = kwargs.get("epoch", 0)
        dt = time.time() - self._epoch_start
        total = self._max_epochs or "?"
        print(f"epoch {epoch + 1}/{total} done in {dt:.2f}s", file=self.stream, flush=True)


class WandbCallback(TrainingCallback):
    """Weights & Biases logging; a no-op when wandb does not import
    (``setup`` then returns False)."""

    def __init__(self):
        self._wandb = None
        self._run = None
        self.is_available = False
        try:
            import wandb
        except ImportError:
            return
        self._wandb = wandb
        self.is_available = True

    def setup(self, training_config, model_config=None, project_name="rlvae_tpu"):
        """Start a run (on rank 0 of a world only, as JAX's process 0)."""
        if not self.is_available or not is_main_process():
            return False
        self._run = self._wandb.init(project=project_name, config=dict(training_config))
        if model_config is not None:
            self._wandb.config.update({"model": dict(model_config)})
        return True

    def on_log(self, training_config, logs, **kwargs):
        if self._run is not None:
            self._wandb.log(logs)

    def on_train_end(self, training_config, **kwargs):
        if self._run is not None:
            self._wandb.finish()
