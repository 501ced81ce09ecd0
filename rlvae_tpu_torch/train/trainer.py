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
  ``stop_flag``.

The posterior noise (ε, and t for the ``geodesic`` posterior method; see
``RlVAE.draw_posterior_noise``) is drawn from a ``torch.Generator`` on the
model's device, seeded from the trainer's seed; the step functions take it
as an argument (the mapping, or ε alone), so tests can hand both frameworks
the same numbers.

Not ported yet: callbacks, ``debug_nan_checks``, the compiled-epoch paths,
and data/model parallelism.
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
from rlvae_tpu_torch.utils.logging import MetricsLogger

Metrics = Dict[str, torch.Tensor]
Noise = Union[torch.Tensor, Mapping[str, torch.Tensor]]
LOSS_KEYS = ("loss", "recon_loss", "kld_loss", "flow_loss", "loop_penalty")
EVAL_KEYS = ("loss", "recon_loss", "kld_loss", "flow_loss")


def make_train_step(model: RlVAE, optimizer: torch.optim.Optimizer) -> Callable[..., Metrics]:
    """``step(batch, noise) -> metrics``: one forward/backward/Adam update.

    Every parameter gets a gradient tensor before the update, zeros where the
    loss does not reach it (at n_obs=8 the 8th flow is unused): the JAX
    optimizer still decays such a parameter and advances its Adam moments,
    while ``torch.optim.Adam`` would skip a parameter whose ``.grad`` is None.
    The metrics stay on the device as 0-d tensors.
    """
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: torch.Tensor, noise: Noise) -> Metrics:
        optimizer.zero_grad(set_to_none=True)
        out = model(batch, noise, train=True)
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

    return step


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
    checkpoints and preemption.

    ``run_dir`` receives ``checkpoints/{best,last}`` with the
    ``model_config.json`` sidecar, ``metrics.jsonl`` and ``summary.json``
    (``outputs/run`` by default, as in JAX: pass a directory of your own).
    ``best`` is written at every improved validation loss, ``last`` when
    ``fit`` returns, a stop by SIGTERM or ``stop_flag`` included.  With
    ``trainer.handle_preemption`` (on by default) a SIGTERM received on the
    main thread during ``fit`` stops training at the next epoch boundary;
    ``stop_flag()`` is polled before and after every epoch and does the same.
    """

    def __init__(self, model: RlVAE, data_module: CyclicDataModule,
                 training_config: Mapping[str, Any], run_dir: Union[str, Path] = "outputs/run",
                 logger: Optional[MetricsLogger] = None, seed: int = 42,
                 stop_flag: Optional[Callable[[], bool]] = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.data = data_module
        self.cfg = dict(training_config)
        self.seed = seed
        self.run_dir = Path(run_dir)
        self.logger = logger or MetricsLogger(self.run_dir)
        self.stop_flag = stop_flag

        trainer_cfg = self.cfg.get("trainer", {})
        self.max_epochs = int(trainer_cfg.get("max_epochs", 30))
        self.log_every = int(trainer_cfg.get("log_every_n_steps", 10))
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
        self.train_step = make_train_step(self.model, self.optimizer)
        self.eval_step = make_eval_step(self.model)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.history: List[Dict[str, float]] = []  # one summary per epoch

    def _to_device(self, batch: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(self.device)

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
        prev_handler = self._install_preemption_handler()
        try:
            for epoch in range(start_epoch, max_epochs):
                if self._stop_requested():
                    self.logger.log({"preempted_at": epoch}, step=step)
                    epoch -= 1  # this epoch did not run
                    break
                t_epoch = time.perf_counter()
                last: Optional[Metrics] = None
                for batch in self.data.train_batches(epoch):
                    if max_steps is not None and step - first_step >= max_steps:
                        break
                    x = self._to_device(batch)
                    noise = self.model.draw_posterior_noise(x.shape[0], self.generator)
                    last = self.train_step(x, noise)
                    step += 1
                    if step % self.log_every == 0:
                        self.logger.log({"lr": get_lr(self.optimizer), **{
                            f"train/{k}": float(v) for k, v in last.items()}}, step=step)

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
                if val_loss < best_val:
                    best_val = val_loss
                    self.checkpoints.save("best", {"params": self._params(), "step": step,
                                                   "val_loss": val_loss})
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
        return result

    def evaluate(self, split: str = "test", epoch: int = 0,
                 weights: str = "best") -> Dict[str, float]:
        """Batch-size-weighted means of the evaluation metrics over a split.

        ``split`` defaults to ``"test"``, as JAX's ``evaluate``.  ``weights``
        says which weights: ``"best"``, the default, evaluates the ``best``
        slot of the run directory (as JAX restores it when no variables are
        given) and leaves the live weights as they were; ``"live"`` evaluates
        the model as it stands.  Raises ``FileNotFoundError`` when there is
        no ``best`` slot."""
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
        for batch in batches:
            x = self._to_device(batch)
            metrics = self.eval_step(x, self.model.draw_posterior_noise(x.shape[0], gen))
            sizes.append(x.shape[0])
            for k, v in metrics.items():
                acc.setdefault(k, []).append(float(v))
        return {k: float(np.average(v, weights=sizes)) for k, v in acc.items()}
