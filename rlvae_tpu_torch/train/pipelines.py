"""Training and generation pipelines: the port of
``rlvae_tpu/train/pipelines.py`` (the pythae pipeline surface).

- ``TrainingPipeline(model, training_config)(train_data, eval_data,
  callbacks)`` trains on in-memory arrays, writes a timestamped
  ``training_*/final_model`` directory (the final weights as the checkpoint
  slot ``weights`` and ``model_config.json``) and returns the trainer's
  result with ``run_dir``.
- ``GenerationPipeline(model, sampler)(num_samples, ...)`` fits and runs a
  sampler of :data:`~rlvae_tpu_torch.samplers.generation.SAMPLER_REGISTRY`
  (``normal`` by default) and returns the decoded images.

The trainer runs where ``training_config["trainer"]["accelerator"]`` says:
the card by default, ``"cpu"`` for the CPU.  The port's models hold their
weights, so neither pipeline takes JAX's ``variables``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np

from rlvae_tpu_torch.data.cyclic import CyclicDataModule, CyclicSequenceDataset, data_shard
from rlvae_tpu_torch.samplers.generation import SAMPLER_REGISTRY, BaseGenerationSampler
from rlvae_tpu_torch.train.checkpoints import CheckpointManager
from rlvae_tpu_torch.train.trainer import Trainer

DEFAULT_TRAINING_CONFIG: Dict[str, Any] = {
    "trainer": {"max_epochs": 10, "devices": 1, "log_every_n_steps": 10},
    "data": {"batch_size": 8},
    "optimizer": {"lr": 1e-3, "weight_decay": 0.0},
    "scheduler": {"factor": 0.5, "patience": 5, "min_lr": 1e-6},
    "early_stopping": {"patience": 10, "min_delta": 0.0},
}


def _sequences(a, what: str) -> np.ndarray:
    """[N, T, C, H, W] sequences, or [N, C, H, W] frames lifted to T=1."""
    arr = np.asarray(a, np.float32)
    if arr.ndim == 4:
        arr = arr[:, None]
    if arr.ndim != 5 or arr.shape[0] == 0:
        raise ValueError(f"{what} must be a non-empty [N,T,C,H,W] or [N,C,H,W] array; "
                         f"got {arr.shape}")
    return arr


def _data_module_from_arrays(train_data, eval_data,
                             training_config: Mapping[str, Any]) -> CyclicDataModule:
    """A data module over arrays.  The batch size is at most the training
    set; without ``eval_data`` the head of the training data validates (a
    leaky signal, said so); an evaluation set smaller than a batch is tiled
    up to one."""
    train = _sequences(train_data, "train_data")
    batch_size = min(int(dict(training_config).get("data", {}).get("batch_size", 8)),
                     train.shape[0])
    if eval_data is None:
        print("[pipeline] eval_data is None: validating on the head of the "
              "training data (leaky val_loss; 'best' selection favors fit)")
        eval_arr = train[: max(batch_size, train.shape[0] // 10)]
    else:
        eval_arr = _sequences(eval_data, "eval_data")
    # in a data-parallel world each rank trains on its strided rows, as
    # CyclicDataModule.setup slices them; evaluation stays whole
    index, count = data_shard(training_config)
    if count > 1:
        per_host = train.shape[0] // count
        train = train[index::count][:per_host]
        batch_size = min(batch_size, max(1, train.shape[0]))
    if eval_arr.shape[0] < batch_size:
        reps = -(-batch_size // eval_arr.shape[0])
        eval_arr = np.tile(eval_arr, (reps, 1, 1, 1, 1))[:batch_size]
    dm = CyclicDataModule({"synthetic_fallback": False, "verify_cyclicity": False},
                          process_index=index, process_count=count)
    dm.batch_size = batch_size
    dm.train = CyclicSequenceDataset(train, verify_cyclicity=False)
    dm.val = CyclicSequenceDataset(eval_arr, verify_cyclicity=False)
    dm.test = CyclicSequenceDataset(eval_arr, verify_cyclicity=False)
    return dm


class TrainingPipeline:
    """End-to-end training over raw arrays."""

    def __init__(self, model, training_config: Optional[Mapping[str, Any]] = None,
                 output_dir: str | Path = "outputs/pipelines"):
        self.model = model
        cfg = {k: (dict(v) if isinstance(v, dict) else v)
               for k, v in DEFAULT_TRAINING_CONFIG.items()}
        for k, v in dict(training_config or {}).items():
            if isinstance(v, Mapping) and isinstance(cfg.get(k), dict):
                cfg[k].update(v)
            else:
                cfg[k] = v
        self.training_config = cfg
        self.output_dir = Path(output_dir)
        self.trainer: Optional[Trainer] = None

    def __call__(self, train_data, eval_data=None,
                 callbacks: Optional[Sequence] = None) -> Dict[str, Any]:
        dm = _data_module_from_arrays(train_data, eval_data, self.training_config)
        run_dir = self.output_dir / time.strftime("training_%Y-%m-%d_%H-%M-%S")
        self.trainer = Trainer(self.model, dm, self.training_config, run_dir=run_dir,
                               callbacks=list(callbacks or []))
        result = self.trainer.fit()
        final_dir = run_dir / "final_model"
        final_dir.mkdir(parents=True, exist_ok=True)
        (final_dir / "model_config.json").write_text(
            json.dumps(dict(self.model.get_model_summary()), default=str))
        CheckpointManager(final_dir).save("weights", {"params": self.trainer._params(),
                                                      "step": result["steps"]})
        result["run_dir"] = str(run_dir)
        return result


class GenerationPipeline:
    """Sampling from a trained model.  ``sampler`` is a registry name
    (``normal``, ``rhvae``, ``rhvae_adaptive``), a constructed
    :class:`BaseGenerationSampler`, or None for ``normal``."""

    def __init__(self, model, sampler: str | BaseGenerationSampler | None = None,
                 **sampler_kwargs):
        if isinstance(sampler, BaseGenerationSampler):
            self.sampler = sampler
        else:
            name = sampler or "normal"
            if name not in SAMPLER_REGISTRY:
                raise NotImplementedError(
                    f"Unrecognized sampler '{name}'. Available: {sorted(SAMPLER_REGISTRY)}")
            self.sampler = SAMPLER_REGISTRY[name](model, **sampler_kwargs)

    def __call__(self, num_samples: int = 1, batch_size: int = 500,
                 output_dir: Optional[str | Path] = None, return_gen: bool = True,
                 save_sampler_config: bool = False, train_data=None, eval_data=None,
                 training_config=None, seed: int = 0):
        self.sampler.fit(train_data=train_data, eval_data=eval_data,
                         training_config=training_config)
        return self.sampler.sample(num_samples=num_samples, batch_size=batch_size,
                                   output_dir=output_dir, return_gen=return_gen,
                                   save_sampler_config=save_sampler_config, seed=seed)
