"""Training presets: the values of ``conf/training/default.yaml`` and
``conf/training/quick.yaml`` as plain dicts (the port reads no YAML).

The trainer reads ``trainer``, ``data``, ``optimizer``, ``scheduler``,
``early_stopping`` and the sample counts.  The ``model``, ``logging``,
``visualization`` and ``data_splits`` nodes are kept so each dict equals the
composed config node; as in the JAX pipelines, the trainer does not read
them (the model's own preset sets its shape).
"""

from __future__ import annotations

from typing import Any, Dict

_TRAINER = {
    "accelerator": "auto",
    "devices": 1,
    "strategy": "auto",
    "precision": "bf16-mixed",
    "num_sanity_val_steps": 2,
    "enable_progress_bar": True,
    "enable_model_summary": True,
    "deterministic": False,
}

DEFAULT: Dict[str, Any] = {
    "trainer": {"max_epochs": 100, **_TRAINER, "log_every_n_steps": 10,
                "val_check_interval": 1.0},
    "data": {"batch_size": 16, "num_workers": 0, "prefetch": 2},
    "model": {
        "latent_dim": 32,
        "n_flows": 8,
        "beta": 1.0,
        "riemannian_beta": 0.1,
        "posterior": {"type": "riemannian_metric"},
        "sampling": {"method": "enhanced", "use_riemannian": True},
        "loop": {"mode": "closed", "penalty": 0.1},
    },
    "optimizer": {"name": "adam", "lr": 0.001, "weight_decay": 0.0001},
    "logging": {"log_every_n_steps": 10, "save_top_k": 3, "monitor": "val_loss", "mode": "min"},
    "visualization": {"frequency": 10, "level": "standard"},
    "data_splits": {"train": 0.7, "val": 0.15, "test": 0.15},
    "scheduler": {"mode": "min", "factor": 0.5, "patience": 10, "min_lr": "1e-7"},
    "early_stopping": {"patience": 20, "monitor": "val_loss", "mode": "min"},
}

QUICK: Dict[str, Any] = {
    "trainer": {"max_epochs": 20, **_TRAINER, "log_every_n_steps": 1,
                "val_check_interval": 0.5},
    "data": {"batch_size": 4, "num_workers": 0, "prefetch": 2},
    "model": {
        "latent_dim": 16,
        "n_flows": 4,
        "beta": 1.0,
        "riemannian_beta": 0.1,
        "posterior": {"type": "riemannian_metric"},
        "sampling": {"method": "enhanced", "use_riemannian": True},
        "loop": {"mode": "open", "penalty": 0.1},
    },
    "optimizer": {"name": "adam", "lr": 0.001, "weight_decay": 0.0001},
    "logging": {"log_every_n_steps": 1, "save_top_k": 2, "monitor": "val_loss", "mode": "min"},
    "visualization": {"frequency": 5, "level": "minimal"},
    "n_train_samples": 100,
    "n_val_samples": 50,
    "scheduler": {"mode": "min", "factor": 0.8, "patience": 3, "threshold": 0.01,
                  "min_lr": "1e-7"},
    "early_stopping": {"patience": 5, "monitor": "val_loss", "mode": "min", "min_delta": 0.001},
}

TRAINING_PRESETS: Dict[str, Dict[str, Any]] = {"default": DEFAULT, "quick": QUICK}
