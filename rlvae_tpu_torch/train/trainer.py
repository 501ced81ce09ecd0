"""Training loop on one device.

Port of the single-device per-step path of ``rlvae_tpu/train/trainer.py``:

- :func:`make_train_step` is ``_step_body`` (``trainer.py:78-111``): the
  forward with ``train=True``, ``loss.backward()``, the global gradient norm,
  and one Adam step with coupled weight decay.  Its metrics carry the keys of
  ``trainer.py:94-103``.
- :func:`make_eval_step` is ``_eval_metrics`` (``trainer.py:253-262``): the
  evaluation forward (no gradients) with ``compute_metrics=True``, so it
  returns the loss terms plus the analysis metrics of
  ``losses.additional_metrics``.
- :class:`Trainer` runs epochs of train steps, a validation pass per epoch
  (batch-size-weighted means), the plateau learning-rate schedule and early
  stopping, and keeps a run directory (``trainer.py:358-705``): the
  checkpoint slots ``best`` and ``last`` (:mod:`.checkpoints`), the metrics
  files (:class:`~rlvae_tpu_torch.utils.logging.MetricsLogger`), resume from
  ``last``, and a stop at the next epoch boundary on SIGTERM or a
  ``stop_flag``.  It fires JAX's callback events (:mod:`.callbacks`), calls
  ``viz_hook`` at every epoch end, adds ``StepTimer`` keys to every logged
  step record (the logged step waits for the card, as JAX's
  ``block_until_ready`` does), traces epoch 0 into ``run_dir/profile`` with
  ``trainer.profile`` and checks every step for NaN/Inf with
  ``debug_nan_checks`` (:mod:`rlvae_tpu_torch.utils.debug`).

The trainer config's device keys (:func:`resolve_trainer_device`):
``trainer.accelerator`` ``auto``, ``gpu`` or ``cuda`` is the card (and
raises without one), ``cpu`` the CPU; ``tpu`` raises.  ``trainer.devices``
other than 1 and ``trainer.model_parallel`` > 1 raise: data and model
parallelism are ROADMAP A5.  ``epoch_jit``, ``eval_jit`` and
``epoch_jit_chunk_steps`` are accepted and run this per-step path (a
captured epoch is ROADMAP A3).

The posterior noise (ε, and t for the ``geodesic`` posterior method; see
``RlVAE.draw_posterior_noise``) is drawn from a ``torch.Generator`` on the
model's device, seeded from the trainer's seed; the step functions take it
as an argument (the mapping, or ε alone), so tests can hand both frameworks
the same numbers.  Dropout masks come from the same generator, after each
step's noise.  A train step moves the nets' BatchNorm running statistics;
validation and ``evaluate`` run the nets in eval mode, on the running
statistics, without dropout.  The checkpoint slots' ``params`` hold the
model's whole state dict, BatchNorm buffers included.
"""

from __future__ import annotations

import math
import signal
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from rlvae_tpu_torch.data.cyclic import CyclicDataModule
from rlvae_tpu_torch.device import DeviceLike, resolve_device
from rlvae_tpu_torch.models.rlvae import RlVAE
from rlvae_tpu_torch.train.callbacks import CallbackHandler, TrainingCallback
from rlvae_tpu_torch.train.checkpoints import CheckpointManager
from rlvae_tpu_torch.train.optim import (
    EarlyStopping,
    PlateauScheduler,
    adam_state,
    get_lr,
    load_adam_state,
    make_optimizer,
    set_lr,
)
from rlvae_tpu_torch.utils.debug import add_nan_checks
from rlvae_tpu_torch.utils.logging import MetricsLogger
from rlvae_tpu_torch.utils.profiling import StepTimer, trace

Metrics = Dict[str, torch.Tensor]
Noise = Union[torch.Tensor, Mapping[str, torch.Tensor]]
LOSS_KEYS = ("loss", "recon_loss", "kld_loss", "flow_loss", "loop_penalty")
EVAL_KEYS = ("loss", "recon_loss", "kld_loss", "flow_loss")
ACCELERATORS = {"auto": "cuda", "gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}


def resolve_trainer_device(trainer_cfg: Mapping[str, Any],
                           device: DeviceLike = None) -> torch.device:
    """The device a trainer config asks for (``device``, when given, wins
    over ``trainer.accelerator``); raises for what the port does not run."""
    accelerator = str(trainer_cfg.get("accelerator", "auto")).lower()
    if accelerator not in ACCELERATORS:
        raise ValueError(f"training.trainer.accelerator {accelerator!r}: the port runs on "
                         f"{sorted(ACCELERATORS)} (a TPU is the JAX package's)")
    devices = trainer_cfg.get("devices", 1)
    if devices not in (None, "auto", 1, "1"):
        raise ValueError(f"training.trainer.devices={devices!r}: the port trains on one "
                         "device; data parallelism is ROADMAP A5")
    if int(trainer_cfg.get("model_parallel", 1)) > 1:
        raise ValueError("training.trainer.model_parallel > 1: model parallelism is not "
                         "ported (ROADMAP A5)")
    return resolve_device(ACCELERATORS[accelerator] if device is None else device)


def make_train_step(model: RlVAE, optimizer: torch.optim.Optimizer,
                    nan_checks: bool = False,
                    generator: Optional[torch.Generator] = None) -> Callable[..., Metrics]:
    """``step(batch, noise, dropout=None) -> metrics``: one
    forward/backward/Adam update.  The nets run in train mode: BatchNorm
    layers move their running statistics once per step (buffers, which the
    optimizer never sees; their scale and bias are parameters, decayed as
    in JAX), and dropout draws its masks from ``dropout`` (a
    ``DropoutMasks`` or a generator), else from ``generator``.  With
    ``nan_checks`` every step checks its loss terms, gradients and
    parameters and raises ``FloatingPointError`` at the first NaN or Inf.

    Every parameter gets a gradient tensor before the update, zeros where the
    loss does not reach it (at n_obs=8 the 8th flow is unused): the JAX
    optimizer still decays such a parameter and advances its Adam moments,
    while ``torch.optim.Adam`` would skip a parameter whose ``.grad`` is None.
    The metrics stay on the device as 0-d tensors.
    """
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: torch.Tensor, noise: Noise, dropout=None) -> Metrics:
        optimizer.zero_grad(set_to_none=True)
        out = model(batch, noise, train=True, dropout=generator if dropout is None else dropout)
        out.loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(p.grad) for p in params]))
        optimizer.step()
        metrics = {k: out[k].detach() for k in LOSS_KEYS}
        metrics["grad_norm"] = grad_norm
        return metrics

    return add_nan_checks(step, model) if nan_checks else step


def make_eval_step(model: RlVAE) -> Callable[..., Metrics]:
    """``step(batch, noise) -> metrics``: the loss terms and the analysis
    metrics of one evaluation forward."""

    @torch.no_grad()
    def step(batch: torch.Tensor, noise: Noise) -> Metrics:
        out = model(batch, noise, train=False, compute_metrics=True)
        return {**{k: out[k] for k in EVAL_KEYS}, **out["metrics"]}

    return step


class Trainer:
    """Epoch-driven trainer with validation, plateau LR, early stopping,
    checkpoints, preemption, callbacks and an epoch-end ``viz_hook``.

    ``run_dir`` receives ``checkpoints/{best,last}`` with the
    ``model_config.json`` sidecar, ``metrics.jsonl`` and ``summary.json``
    (``outputs/run`` by default, as in JAX: pass a directory of your own),
    and ``profile/`` with ``trainer.profile``.  ``best`` is written at every
    improved validation loss, ``last`` when ``fit`` returns, a stop by
    SIGTERM or ``stop_flag`` included.  With ``trainer.handle_preemption``
    (on by default) a SIGTERM received on the main thread during ``fit``
    stops training at the next epoch boundary; ``stop_flag()`` is polled
    before and after every epoch and does the same.  ``device`` overrides
    the config's ``trainer.accelerator`` (:func:`resolve_trainer_device`).
    ``viz_hook(epoch=, model=, variables=, trainer=)`` is called after every
    epoch's validation, with the model's state dict as ``variables``.
    """

    def __init__(self, model: RlVAE, data_module: CyclicDataModule,
                 training_config: Mapping[str, Any], run_dir: Union[str, Path] = "outputs/run",
                 logger: Optional[MetricsLogger] = None,
                 viz_hook: Optional[Callable[..., Any]] = None, seed: int = 42,
                 callbacks: Optional[List[TrainingCallback]] = None,
                 stop_flag: Optional[Callable[[], bool]] = None, device: DeviceLike = None):
        self.cfg = dict(training_config)
        trainer_cfg = self.cfg.get("trainer", {})
        self.device = resolve_trainer_device(trainer_cfg, device)
        self.model = model.to(self.device)
        self.data = data_module
        self.seed = seed
        self.run_dir = Path(run_dir)
        self.logger = logger or MetricsLogger(self.run_dir)
        self.viz_hook = viz_hook
        self.callbacks = CallbackHandler(callbacks)
        self.stop_flag = stop_flag

        self.max_epochs = int(trainer_cfg.get("max_epochs", 30))
        self.log_every = int(trainer_cfg.get("log_every_n_steps", 10))
        self.profile = bool(trainer_cfg.get("profile", False))
        self.handle_preemption = bool(trainer_cfg.get("handle_preemption", True))
        self._preempted = False
        opt_cfg = self.cfg.get("optimizer", {})
        self.optimizer = make_optimizer(
            self.model.parameters(), float(opt_cfg.get("lr", 1e-3)),
            float(opt_cfg.get("weight_decay", 0.0)),
        )
        self.scheduler = PlateauScheduler.from_config(self.cfg.get("scheduler", {}))
        self.early_stopping = EarlyStopping.from_config(self.cfg.get("early_stopping", {}))
        self.checkpoints = CheckpointManager(self.run_dir / "checkpoints",
                                             self.model.get_model_summary())
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.train_step = make_train_step(
            self.model, self.optimizer, nan_checks=bool(self.cfg.get("debug_nan_checks", False)),
            generator=self.generator)
        self.eval_step = make_eval_step(self.model)
        self.history: List[Dict[str, float]] = []  # one summary per epoch
        self.callbacks.on_init_end(self.cfg, trainer=self)

    def _to_device(self, batch: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- checkpoint state -------------------------------------------------------

    def _params(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    # -- preemption -------------------------------------------------------------

    def _install_preemption_handler(self):
        """SIGTERM -> stop at the next epoch boundary.  Only on the main
        thread (signal handlers are main-thread-only) and with
        ``handle_preemption``; returns the handler to put back, or None."""
        if not self.handle_preemption or threading.current_thread() is not threading.main_thread():
            return None

        def on_term(signum, frame):
            self._preempted = True

        try:
            prev = signal.signal(signal.SIGTERM, on_term)
        except ValueError:
            return None
        return signal.SIG_DFL if prev is None else prev  # None: not set from Python

    @staticmethod
    def _restore_preemption_handler(prev) -> None:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)

    def _stop_requested(self) -> bool:
        if self.stop_flag is not None and self.stop_flag():
            self._preempted = True
        return self._preempted

    # -- loop -------------------------------------------------------------------

    def fit(self, max_epochs: Optional[int] = None, max_steps: Optional[int] = None,
            resume: bool = False) -> Dict[str, Any]:
        """Train epochs ``[start, max_epochs)`` (the config's ``max_epochs``
        by default), stopping early after ``max_steps`` steps of this call,
        when validation stops improving, or at a stop request.

        ``resume=True`` with a ``last`` slot in the run directory restores
        the weights, Adam's moments and step counts and the learning rate,
        and continues at the slot's epoch + 1 with its global step count and
        best validation loss; the plateau and early-stopping state start
        afresh, as in JAX.  The noise generator is reseeded from ``seed`` at
        the start of every ``fit``, on resume too: JAX restarts its key
        stream from ``PRNGKey(seed)`` (``rlvae_tpu/train/trainer.py:506``),
        so a resumed run does not draw the noise an uninterrupted run would
        have, and the generator's state is not saved.
        """
        max_epochs = self.max_epochs if max_epochs is None else int(max_epochs)
        self.generator.manual_seed(self.seed)
        best_val, step, start_epoch = math.inf, 0, 0
        if resume and self.checkpoints.exists("last"):
            restored = self.checkpoints.restore("last", map_location=self.device)
            self.model.load_state_dict(restored["params"])
            load_adam_state(self.model, self.optimizer, restored["optimizer"])
            best_val = float(restored["val_loss"])
            step = int(restored["step"])
            start_epoch = int(restored["epoch"]) + 1
        first_step = step
        epoch = start_epoch - 1
        t_start = time.perf_counter()
        timer = StepTimer()
        prev_handler = self._install_preemption_handler()
        try:
            self.callbacks.on_train_begin(self.cfg, trainer=self)
            for epoch in range(start_epoch, max_epochs):
                if self._stop_requested():
                    self.logger.log({"preempted_at": epoch}, step=step)
                    epoch -= 1  # this epoch did not run
                    break
                t_epoch = time.perf_counter()
                self.callbacks.on_epoch_begin(self.cfg, epoch=epoch, trainer=self)
                last: Optional[Metrics] = None
                with trace(self.run_dir / "profile", enabled=self.profile and epoch == 0):
                    for batch in self.data.train_batches(epoch):
                        if max_steps is not None and step - first_step >= max_steps:
                            break
                        self.callbacks.call_event("on_train_step_begin", self.cfg, step=step)
                        x = self._to_device(batch)
                        noise = self.model.draw_posterior_noise(x.shape[0], self.generator)
                        timer.start()
                        last = self.train_step(x, noise)
                        if (step + 1) % self.log_every == 0:
                            self._sync()  # the logged step is timed to its end on the card
                        timer.stop()
                        step += 1
                        if step % self.log_every == 0:
                            host = {f"train/{k}": float(v) for k, v in last.items()}
                            host["lr"] = get_lr(self.optimizer)
                            host.update(timer.metrics())
                            self.logger.log(host, step=step)
                            self.callbacks.on_train_step_end(self.cfg, step=step, logs=host)
                            self.callbacks.on_log(self.cfg, host, step=step)

                val = self.evaluate("val", epoch, weights="live")
                val_loss = val.get("loss", float("nan"))
                lr = get_lr(self.optimizer)
                new_lr = self.scheduler.step(val_loss, lr)
                if new_lr != lr:
                    set_lr(self.optimizer, new_lr)
                summary = {"epoch": epoch, "epoch_time": time.perf_counter() - t_epoch,
                           **{f"val/{k}": v for k, v in val.items()}}
                if last is not None:
                    summary.update({f"train/{k}": float(v) for k, v in last.items()})
                self.logger.log(summary, step=step)
                self.history.append(summary)
                self.callbacks.on_evaluate(self.cfg, epoch=epoch, metrics=val)
                self.callbacks.on_epoch_end(self.cfg, epoch=epoch, logs=summary, trainer=self)
                if val_loss < best_val:
                    best_val = val_loss
                    self.checkpoints.save("best", {"params": self._params(), "step": step,
                                                   "val_loss": val_loss})
                    self.callbacks.on_save(self.cfg, slot="best", step=step)
                if self.viz_hook is not None:
                    self.viz_hook(epoch=epoch, model=self.model,
                                  variables=self.model.state_dict(), trainer=self)
                stop = self.early_stopping.update(val_loss)
                if stop:
                    self.logger.log({"early_stopped_at": epoch}, step=step)
                if self._stop_requested():
                    self.logger.log({"preempted_at": epoch}, step=step)
                    stop = True
                if stop or (max_steps is not None and step - first_step >= max_steps):
                    break
        finally:
            # an exception in fit must not leave this trainer's handler installed
            self._restore_preemption_handler(prev_handler)

        self.checkpoints.save("last", {"params": self._params(),
                                       "optimizer": adam_state(self.model, self.optimizer),
                                       "step": step, "epoch": epoch, "val_loss": best_val})
        result = {"best_val_loss": best_val, "epochs_run": epoch + 1, "steps": step,
                  "train_time": time.perf_counter() - t_start, "preempted": self._preempted,
                  "history": self.history}
        self.logger.summary({k: v for k, v in result.items() if k != "history"})
        self.callbacks.on_save(self.cfg, slot="last", step=step)
        self.callbacks.on_train_end(self.cfg, result=dict(result))
        return result

    def evaluate(self, split: str = "test", epoch: int = 0,
                 weights: str = "best") -> Dict[str, float]:
        """Batch-size-weighted means of the evaluation metrics over a split.

        ``split`` defaults to ``"test"``, as JAX's ``evaluate``.  ``weights``
        says which weights: ``"best"``, the default, evaluates the ``best``
        slot of the run directory (as JAX restores it when no variables are
        given) and leaves the live weights as they were; ``"live"`` evaluates
        the model as it stands.  Raises ``FileNotFoundError`` when there is
        no ``best`` slot.  Fires ``on_eval_step_begin``/``_end`` per batch."""
        if weights == "live":
            return self._evaluate(split, epoch)
        if weights != "best":
            raise ValueError(f"weights must be 'best' or 'live', got {weights!r}")
        best = self.checkpoints.restore("best", map_location=self.device)["params"]
        live = self._params()
        self.model.load_state_dict(best)
        try:
            return self._evaluate(split, epoch)
        finally:
            self.model.load_state_dict(live)

    def _evaluate(self, split: str, epoch: int) -> Dict[str, float]:
        batches = self.data.val_batches() if split == "val" else self.data.test_batches()
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1 + epoch)
        acc: Dict[str, List[float]] = {}
        sizes: List[int] = []
        for i, batch in enumerate(batches):
            self.callbacks.call_event("on_eval_step_begin", self.cfg, step=i)
            x = self._to_device(batch)
            metrics = self.eval_step(x, self.model.draw_posterior_noise(x.shape[0], gen))
            host = {k: float(v) for k, v in metrics.items()}
            sizes.append(x.shape[0])
            for k, v in host.items():
                acc.setdefault(k, []).append(v)
            self.callbacks.call_event("on_eval_step_end", self.cfg, step=i, logs=host)
        return {k: float(np.average(v, weights=sizes)) for k, v in acc.items()}
