"""Training: Adam with coupled weight decay, plateau LR, early stopping,
checkpoint slots and a one-device trainer (``python -m
rlvae_tpu_torch.train``)."""

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
from rlvae_tpu_torch.train.presets import TRAINING_PRESETS
from rlvae_tpu_torch.train.trainer import Trainer, make_eval_step, make_train_step

__all__ = [
    "CheckpointManager", "EarlyStopping", "PlateauScheduler", "TRAINING_PRESETS", "Trainer",
    "adam_state", "get_lr", "load_adam_state", "make_eval_step", "make_optimizer",
    "make_train_step", "set_lr",
]
