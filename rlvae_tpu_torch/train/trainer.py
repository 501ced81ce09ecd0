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
  stopping.

The posterior noise (ε, and t for the ``geodesic`` posterior method; see
``RlVAE.draw_posterior_noise``) is drawn from a ``torch.Generator`` on the
model's device, seeded from the trainer's seed; the step functions take it
as an argument (the mapping, or ε alone), so tests can hand both frameworks
the same numbers.

Not ported yet: callbacks, the metrics logger's files, checkpoints,
preemption handling, the compiled-epoch paths, and data/model parallelism.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from rlvae_tpu_torch.data.cyclic import CyclicDataModule
from rlvae_tpu_torch.device import DeviceLike, resolve_device
from rlvae_tpu_torch.models.rlvae import RlVAE
from rlvae_tpu_torch.train.optim import (
    EarlyStopping,
    PlateauScheduler,
    get_lr,
    make_optimizer,
    set_lr,
)

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
    """Epoch-driven trainer with validation, plateau LR and early stopping."""

    def __init__(self, model: RlVAE, data_module: CyclicDataModule,
                 training_config: Mapping[str, Any], seed: int = 42,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.data = data_module
        self.cfg = dict(training_config)
        self.seed = seed

        trainer_cfg = self.cfg.get("trainer", {})
        self.max_epochs = int(trainer_cfg.get("max_epochs", 30))
        self.log_every = int(trainer_cfg.get("log_every_n_steps", 10))
        opt_cfg = self.cfg.get("optimizer", {})
        self.optimizer = make_optimizer(
            self.model.parameters(), float(opt_cfg.get("lr", 1e-3)),
            float(opt_cfg.get("weight_decay", 0.0)),
        )
        self.scheduler = PlateauScheduler.from_config(self.cfg.get("scheduler", {}))
        self.early_stopping = EarlyStopping.from_config(self.cfg.get("early_stopping", {}))
        self.train_step = make_train_step(self.model, self.optimizer)
        self.eval_step = make_eval_step(self.model)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.history: List[Dict[str, float]] = []  # one summary per epoch
        self.step_log: List[Dict[str, float]] = []  # every log_every steps

    def _to_device(self, batch: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(self.device)

    def fit(self, max_epochs: Optional[int] = None,
            max_steps: Optional[int] = None) -> Dict[str, Any]:
        """Train for ``max_epochs`` (the config's by default), stopping early
        after ``max_steps`` steps or when validation stops improving."""
        max_epochs = self.max_epochs if max_epochs is None else int(max_epochs)
        best_val = math.inf
        step, epoch = 0, -1
        t_start = time.perf_counter()
        for epoch in range(max_epochs):
            t_epoch = time.perf_counter()
            last: Optional[Metrics] = None
            for batch in self.data.train_batches(epoch):
                if max_steps is not None and step >= max_steps:
                    break
                x = self._to_device(batch)
                noise = self.model.draw_posterior_noise(x.shape[0], self.generator)
                last = self.train_step(x, noise)
                step += 1
                if step % self.log_every == 0:
                    self.step_log.append({"step": step, "lr": get_lr(self.optimizer),
                                          **{f"train/{k}": float(v) for k, v in last.items()}})

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
            self.history.append(summary)
            best_val = min(best_val, val_loss)
            if self.early_stopping.update(val_loss):
                break
            if max_steps is not None and step >= max_steps:
                break
        return {"best_val_loss": best_val, "epochs_run": epoch + 1, "steps": step,
                "train_time": time.perf_counter() - t_start, "history": self.history}

    def evaluate(self, split: str = "test", epoch: int = 0,
                 weights: str = "best") -> Dict[str, float]:
        """Batch-size-weighted means of the evaluation metrics over a split.

        ``split`` defaults to ``"test"``, as JAX's ``evaluate``.  ``weights``
        says which weights: ``"live"`` evaluates the model as it stands;
        ``"best"``, the default, means the best checkpoint, as JAX restores it
        when no variables are given, and raises until checkpoints are ported
        rather than evaluate other weights silently."""
        if weights == "best":
            raise NotImplementedError(
                "Trainer.evaluate(weights='best') needs the best checkpoint, and checkpoints "
                "are not ported yet (ROADMAP queue A6); pass weights='live' to evaluate the "
                "model's current weights"
            )
        if weights != "live":
            raise ValueError(f"weights must be 'best' or 'live', got {weights!r}")
        batches = self.data.val_batches() if split == "val" else self.data.test_batches()
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1 + epoch)
        acc: Dict[str, List[float]] = {}
        weights: List[int] = []
        for batch in batches:
            x = self._to_device(batch)
            metrics = self.eval_step(x, self.model.draw_posterior_noise(x.shape[0], gen))
            weights.append(x.shape[0])
            for k, v in metrics.items():
                acc.setdefault(k, []).append(float(v))
        return {k: float(np.average(v, weights=weights)) for k, v in acc.items()}
