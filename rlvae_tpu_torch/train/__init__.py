"""Training: Adam with coupled weight decay, plateau LR, early stopping and
a one-device trainer (``python -m rlvae_tpu_torch.train``)."""

from rlvae_tpu_torch.train.optim import (
    EarlyStopping,
    PlateauScheduler,
    get_lr,
    make_optimizer,
    set_lr,
)
from rlvae_tpu_torch.train.presets import TRAINING_PRESETS
from rlvae_tpu_torch.train.trainer import Trainer, make_eval_step, make_train_step

__all__ = [
    "EarlyStopping", "PlateauScheduler", "TRAINING_PRESETS", "Trainer", "get_lr",
    "make_eval_step", "make_optimizer", "make_train_step", "set_lr",
]
