"""Checkpoint slots of a training run: the port's counterpart of
``rlvae_tpu/train/checkpoints.py:22-92``, in a torch-only format.

A run keeps named slots (``best`` and ``last``) under one directory, beside
a ``model_config.json`` sidecar (the model summary, ``RlVAE.get_model_summary``,
as the JAX package writes it).  A slot is a directory ``<slot>/`` holding
one ``state.pt`` written by ``torch.save``; the file holds tensors, ints,
floats and plain dicts only, so it loads with ``weights_only=True``.  A save
writes a temporary file in the slot's directory and ``os.replace``-s it
over ``state.pt``, so a reader sees the old slot or the new one, never half
of one (the counterpart of orbax's ``force=True`` overwrite).

In a ``torch.distributed`` world rank 0 alone writes (the sidecar and
every save; JAX's process 0), and every rank restores.

Writes are synchronous (JAX's ``use_async=False``); :meth:`wait` is kept as
a no-op so callers written against the JAX manager port unchanged.  Tensors
keep their device in the file: a slot saved from the card restores onto the
card unless ``map_location`` says otherwise, with the same bits.

What the trainer stores in each slot (JAX's contents, keyed for PyTorch):

- ``best``: ``{"params", "step", "val_loss"}``;
- ``last``: ``{"params", "optimizer", "step", "epoch", "val_loss"}``, where
  ``val_loss`` is the best validation loss so far.

``params`` is the model's state dict: each parameter and each BatchNorm
running statistic (``<layer>.mean``/``.var``, JAX's ``stats``) by name, so
a restore gives both back bit for bit; ``optimizer`` holds the learning
rate and Adam's ``step``, ``exp_avg`` and ``exp_avg_sq`` per parameter
name.  The metric (read from its ``.npz`` by the model's config)
and the flows' masks (recomputed) are not saved.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import torch

from rlvae_tpu_torch.device import is_main_process

STATE_FILE = "state.pt"


class CheckpointManager:
    """Named checkpoint slots under ``directory``."""

    def __init__(self, directory: str | Path, model_config: Optional[Mapping[str, Any]] = None):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        if model_config is not None and is_main_process():
            (self.directory / "model_config.json").write_text(
                json.dumps(model_config, indent=2, default=str))

    def path(self, slot: str) -> Path:
        """The file that holds ``slot``."""
        return self.directory / slot / STATE_FILE

    def save(self, slot: str, state: Mapping[str, Any]) -> None:
        """Write ``state`` to ``slot``, replacing what it held (on rank 0)."""
        if not is_main_process():
            return
        target = self.path(slot)
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f".{STATE_FILE}.{os.getpid()}.tmp")
        try:
            torch.save(dict(state), tmp)
            os.replace(tmp, target)
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise

    def restore(self, slot: str, map_location: Any = None) -> Dict[str, Any]:
        """The dict last saved to ``slot``; tensors on their saved device, or
        on ``map_location``.  A slot directory without ``state.pt`` (a JAX
        run's orbax slot) raises ``ValueError``."""
        target = self.path(slot)
        if not target.exists():
            if target.parent.is_dir() and any(target.parent.iterdir()):
                raise ValueError(
                    f"checkpoint slot {slot!r} in {self.directory} holds no {STATE_FILE}: it is "
                    "not the port's format (a JAX run's orbax slot?); restore it with orbax and "
                    "convert it with rlvae_tpu_torch.convert.checkpoint_from_jax")
            raise FileNotFoundError(f"no checkpoint slot {slot!r} in {self.directory}")
        return torch.load(target, map_location=map_location, weights_only=True)

    def exists(self, slot: str) -> bool:
        return self.path(slot).exists()

    def wait(self) -> None:
        """Writes are synchronous: nothing to wait for."""

    def load_model_config(self) -> Optional[Dict[str, Any]]:
        p = self.directory / "model_config.json"
        return json.loads(p.read_text()) if p.exists() else None
