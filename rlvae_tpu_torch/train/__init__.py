"""Training: Adam with coupled weight decay, plateau LR, early stopping,
checkpoint slots, callbacks, a one-device trainer (``python -m
rlvae_tpu_torch.train``) and the training/generation pipelines."""

from rlvae_tpu_torch.train.callbacks import (
    CallbackHandler,
    MetricConsoleLoggerCallback,
    ProgressBarCallback,
    TrainingCallback,
    WandbCallback,
)
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
from rlvae_tpu_torch.train.pipelines import GenerationPipeline, TrainingPipeline
from rlvae_tpu_torch.train.presets import TRAINING_PRESETS
from rlvae_tpu_torch.train.trainer import (
    Trainer,
    make_eval_step,
    make_train_step,
    resolve_trainer_device,
)

__all__ = [
    "CallbackHandler", "CheckpointManager", "EarlyStopping", "GenerationPipeline",
    "MetricConsoleLoggerCallback", "PlateauScheduler", "ProgressBarCallback", "TRAINING_PRESETS",
    "Trainer", "TrainingCallback", "TrainingPipeline", "WandbCallback", "adam_state", "get_lr",
    "load_adam_state", "make_eval_step", "make_optimizer", "make_train_step",
    "resolve_trainer_device", "set_lr",
]
