"""Optimizer and learning-rate scheduling: the port's own copy of
``rlvae_tpu/train/optim.py:20-128``.

The JAX package's optimizer is ``add_decayed_weights(wd) -> scale_by_adam()
-> scale(-lr)``: Adam with *coupled* L2 weight decay (the decay is added to
the gradient before the moments; b1 0.9, b2 0.999, eps 1e-8).  That is the
arithmetic of ``torch.optim.Adam(weight_decay=wd)``.  The plateau scheduler
and early stopping run on the host from the epoch-end validation loss.
:func:`adam_state` and :func:`load_adam_state` carry Adam's state in and out
of checkpoints keyed by parameter name.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter], learning_rate: float,
                   weight_decay: float = 0.0) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def get_lr(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    return optimizer


def adam_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """The checkpoints' ``optimizer`` entry: ``{"lr": float, "state": {name:
    {"step", "exp_avg", "exp_avg_sq"}}}``, Adam's state of each of
    ``model``'s parameters by name (a parameter that has taken no step has
    no entry), copied."""
    state = {}
    for name, p in model.named_parameters():
        st = optimizer.state.get(p)
        if st:
            state[name] = {k: st[k].detach().clone() for k in ("step", "exp_avg", "exp_avg_sq")}
    return {"lr": get_lr(optimizer), "state": state}


def load_adam_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    state: Mapping[str, Any]) -> None:
    """Put a copy of an :func:`adam_state` dict into ``optimizer``, made over
    ``model``'s parameters.  The step counts go to the host, where
    ``torch.optim.Adam`` keeps them (one on the card would make every step
    read it back); ``load_state_dict`` moves the moments to their
    parameters' device."""
    sd = optimizer.state_dict()
    names = {id(p): name for name, p in model.named_parameters()}
    index = [names[id(p)] for g in optimizer.param_groups for p in g["params"]]
    sd["state"] = {i: {k: v.detach().to("cpu" if k == "step" else v.device, copy=True)
                       for k, v in state["state"][name].items()}
                   for i, name in enumerate(index) if name in state["state"]}
    optimizer.load_state_dict(sd)
    set_lr(optimizer, state["lr"])


class PlateauScheduler:
    """Host-side ReduceLROnPlateau (torch semantics with relative threshold)."""

    def __init__(self, mode: str = "min", factor: float = 0.5, patience: int = 10,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best: float | None = None
        self.num_bad = 0

    @classmethod
    def from_config(cls, cfg: Mapping[str, Any]) -> "PlateauScheduler":
        return cls(
            mode=str(cfg.get("mode", "min")),
            factor=float(cfg.get("factor", 0.5)),
            patience=int(cfg.get("patience", 10)),
            threshold=float(cfg.get("threshold", 1e-4)),
            min_lr=float(cfg.get("min_lr", 0.0)),
        )

    def _is_better(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best * (1.0 - self.threshold)
        return value > self.best * (1.0 + self.threshold)

    def step(self, value: float, current_lr: float) -> float:
        """Returns the (possibly reduced) learning rate."""
        if self._is_better(value):
            self.best = value
            self.num_bad = 0
            return current_lr
        self.num_bad += 1
        if self.num_bad > self.patience:
            self.num_bad = 0
            return max(current_lr * self.factor, self.min_lr)
        return current_lr


class EarlyStopping:
    """Patience-based early stopping on a monitored metric."""

    def __init__(self, patience: int = 10, min_delta: float = 0.0, mode: str = "min"):
        self.patience = patience
        self.min_delta = min_delta
        self.mode = mode
        self.best: float | None = None
        self.num_bad = 0

    @classmethod
    def from_config(cls, cfg: Mapping[str, Any]) -> "EarlyStopping":
        return cls(
            patience=int(cfg.get("patience", 10)),
            min_delta=float(cfg.get("min_delta", 0.0)),
            mode=str(cfg.get("mode", "min")),
        )

    def update(self, value: float) -> bool:
        """Returns True when training should stop."""
        improved = (
            self.best is None
            or (self.mode == "min" and value < self.best - self.min_delta)
            or (self.mode == "max" and value > self.best + self.min_delta)
        )
        if improved:
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
        return self.num_bad >= self.patience
