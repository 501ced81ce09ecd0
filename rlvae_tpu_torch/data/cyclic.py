"""Cyclic sequence dataset and data module: the port's own copy of the
synthesize-or-load path of ``rlvae_tpu/data/cyclic.py``.

- :class:`CyclicSequenceDataset` holds [N, T, C, H, W] float32 sequences and
  checks their cyclicity (first- vs last-frame MSE against a threshold).
- :func:`batch_iterator` batches on the host with a seeded shuffle and
  drop-remainder, as the JAX package's numpy iterator does.
- :class:`CyclicDataModule` wires train/val/test from the data and training
  config nodes: files when they exist (``.npz``, ``.npy``, and ``.pt`` or
  ``.pth``: a tensor, or a dict holding one, ``{'data': ...}`` first;
  loaded with ``torch.load(weights_only=True)``), otherwise synthetic
  sequences (:mod:`rlvae_tpu_torch.data.synth`) of
  ``data.sequence_length`` frames of ``data.channels`` x
  ``data.image_size``; the validation split is the head of the test split.
  ``get_sample_batch`` and ``get_data_stats`` (with the datasets'
  ``get_sequence_info`` and ``get_dataset_stats``) serve the experiment
  runner and the visualization hook.
- The training batches go through the native C++ loader
  (:mod:`rlvae_tpu_torch.data.native_loader`), the JAX package's default
  and its batch order, unless ``data.use_native_loader`` is false, which
  takes :func:`batch_iterator` (numpy's order).  Validation and test
  batches are :func:`batch_iterator`'s in both packages.

In a data-parallel world each rank keeps its strided slice of the training
sequences, as each JAX host does: ``process_index``/``process_count``
default to the world's data index and data-axis size (the world's ranks
over ``trainer.model_parallel`` of the training config given to
``setup``), and a run outside a world keeps every sequence.  Validation
and test stay whole on every rank.  ``CYCLIC_SPRITES`` holds the values of
``conf/data/cyclic_sprites.yaml`` as a plain dict.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np

from rlvae_tpu_torch.data.synth import generate_cyclic_sequences

CYCLIC_SPRITES: Dict[str, Any] = {
    "train_path": "data/processed/Sprites_train_cyclic.npz",
    "test_path": "data/processed/Sprites_test_cyclic.npz",
    "train_meta_path": "data/processed/Sprites_train_cyclic_metadata.npz",
    "test_meta_path": "data/processed/Sprites_test_cyclic_metadata.npz",
    "sequence_length": 8,
    "image_size": [64, 64],
    "channels": 3,
    "num_workers": 0,
    "prefetch": 2,
    "drop_remainder": True,
    "max_train_samples": 5000,
    "max_test_samples": 1000,
    "verify_cyclicity": True,
    "cyclicity_threshold": 0.01,
    "synthetic_fallback": True,
    "synthetic_n_train": 1000,
    "synthetic_n_test": 200,
}


def _load_array(path: Path) -> np.ndarray:
    if path.suffix == ".npz":
        with np.load(path) as zf:
            key = "sequences" if "sequences" in zf.files else zf.files[0]
            return np.asarray(zf[key], np.float32)
    if path.suffix in (".pt", ".pth"):
        import torch

        data = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(data, dict):
            data = data["data"] if "data" in data else next(iter(data.values()))
        return data.detach().cpu().numpy().astype(np.float32)
    if path.suffix == ".npy":
        return np.load(path).astype(np.float32)
    raise ValueError(f"Unsupported dataset format: {path}")


class CyclicSequenceDataset:
    """In-memory [N, T, C, H, W] cyclic sequence dataset."""

    def __init__(self, data: np.ndarray, n_samples: Optional[int] = None,
                 verify_cyclicity: bool = True, cyclicity_threshold: float = 0.01):
        if data.ndim != 5:
            raise ValueError(f"Expected [N, T, C, H, W] data, got shape {data.shape}")
        if n_samples is not None:
            data = data[:n_samples]
        self.data = np.ascontiguousarray(data, np.float32)
        self.cyclicity_threshold = cyclicity_threshold
        self.cyclicity_report: Optional[Dict[str, Any]] = None
        if verify_cyclicity:
            self.cyclicity_report = self.verify_cyclicity()

    @classmethod
    def from_file(cls, path, **kwargs) -> "CyclicSequenceDataset":
        return cls(_load_array(Path(path)), **kwargs)

    def __len__(self) -> int:
        return self.data.shape[0]

    def verify_cyclicity(self) -> Dict[str, Any]:
        mse = np.mean((self.data[:, 0] - self.data[:, -1]) ** 2, axis=(1, 2, 3))
        n_cyclic = int((mse < self.cyclicity_threshold).sum())
        return {
            "n_sequences": len(self),
            "n_cyclic": n_cyclic,
            "fraction_cyclic": n_cyclic / max(len(self), 1),
            "mean_cycle_mse": float(mse.mean()) if len(self) else 0.0,
            "max_cycle_mse": float(mse.max()) if len(self) else 0.0,
            "first_5_mse": [float(v) for v in mse[:5]],
        }

    def get_sequence_info(self, idx: int) -> Dict[str, Any]:
        seq = self.data[idx]
        return {
            "index": idx,
            "shape": tuple(seq.shape),
            "min": float(seq.min()),
            "max": float(seq.max()),
            "mean": float(seq.mean()),
            "cycle_mse": float(np.mean((seq[0] - seq[-1]) ** 2)),
        }

    def get_dataset_stats(self) -> Dict[str, Any]:
        return {
            "n_sequences": len(self),
            "sequence_length": int(self.data.shape[1]),
            "image_shape": tuple(self.data.shape[2:]),
            "pixel_min": float(self.data.min()),
            "pixel_max": float(self.data.max()),
            "pixel_mean": float(self.data.mean()),
            "pixel_std": float(self.data.std()),
            "cyclicity": self.cyclicity_report,
        }


def batch_iterator(data: np.ndarray, batch_size: int, shuffle: bool = True, seed: int = 0,
                   drop_remainder: bool = True) -> Iterator[np.ndarray]:
    """Host-side batches; shuffled with ``default_rng(seed)`` when asked."""
    n = data.shape[0]
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    n_batches = n // batch_size if drop_remainder else -(-n // batch_size)
    for b in range(n_batches):
        yield data[idx[b * batch_size : (b + 1) * batch_size]]


def data_shard(training_config: Optional[Mapping[str, Any]] = None,
               index: Optional[int] = None, count: Optional[int] = None) -> Tuple[int, int]:
    """(data index, data-axis size) of this rank: the given values, else the
    world's (its ranks over the config's ``trainer.model_parallel``), else
    (0, 1) outside a world."""
    if index is None or count is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            mp = int(dict(training_config or {}).get("trainer", {}).get("model_parallel", 1))
            index = dist.get_rank() // mp if index is None else index
            count = dist.get_world_size() // mp if count is None else count
    return (0 if index is None else int(index)), (1 if count is None else int(count))


class CyclicDataModule:
    """Train/val/test splits from the data and training config nodes."""

    def __init__(self, data_config: Optional[Mapping[str, Any]] = None, seed: int = 42,
                 process_index: Optional[int] = None, process_count: Optional[int] = None):
        self.config = dict(CYCLIC_SPRITES if data_config is None else data_config)
        self.seed = seed
        self.train: Optional[CyclicSequenceDataset] = None
        self.val: Optional[CyclicSequenceDataset] = None
        self.test: Optional[CyclicSequenceDataset] = None
        self.batch_size = 8
        self._native_loader = None
        self.process_index = process_index
        self.process_count = process_count

    def _resolve(self, key: str) -> Optional[Path]:
        raw = self.config.get(key)
        if not raw:
            return None
        p = Path(raw)
        for cand in (p, p.with_suffix(".npz"), p.with_suffix(".npy"), p.with_suffix(".pt")):
            if cand.exists():
                return cand
        return None

    def _load_or_synthesize(self, key: str, n_default: int, seed: int,
                            n_needed: Optional[int] = None) -> np.ndarray:
        path = self._resolve(key)
        if path is not None:
            return _load_array(path)
        if not self.config.get("synthetic_fallback", True):
            raise FileNotFoundError(f"Dataset file for '{key}' not found: {self.config.get(key)}")
        # no more sequences than the run will use
        n = n_default if n_needed is None else min(n_default, int(n_needed))
        return generate_cyclic_sequences(
            n,
            n_obs=int(self.config.get("sequence_length", 8)),
            image_size=tuple(self.config.get("image_size", (64, 64))),
            channels=int(self.config.get("channels", 3)),
            seed=seed,
        )

    def setup(self, training_config: Optional[Mapping[str, Any]] = None) -> None:
        """Load or synthesize the splits; sample counts and batch size come
        from the training config."""
        tc = dict(training_config or {})
        self.batch_size = int(tc.get("data", {}).get("batch_size", 8))
        self._native_loader = None  # it holds the previous split and batch size
        n_train = tc.get("n_train_samples") or self.config.get("max_train_samples")
        n_val = tc.get("n_val_samples") or self.config.get("max_test_samples")
        verify = bool(self.config.get("verify_cyclicity", True))
        thresh = float(self.config.get("cyclicity_threshold", 0.01))

        train_raw = self._load_or_synthesize(
            "train_path", int(self.config.get("synthetic_n_train", 1000)), self.seed,
            n_needed=n_train,
        )
        test_raw = self._load_or_synthesize(
            "test_path", int(self.config.get("synthetic_n_test", 200)), self.seed + 1
        )
        if n_train is not None:
            train_raw = train_raw[: int(n_train)]
        index, count = data_shard(tc, self.process_index, self.process_count)
        self.process_index, self.process_count = index, count
        if count > 1:  # equal shard sizes keep every rank's step count in lockstep
            per_host = train_raw.shape[0] // count
            train_raw = train_raw[index::count][:per_host]
        self.train = CyclicSequenceDataset(train_raw, verify_cyclicity=verify,
                                           cyclicity_threshold=thresh)
        self.val = CyclicSequenceDataset(test_raw, n_samples=n_val, verify_cyclicity=False,
                                         cyclicity_threshold=thresh)
        self.test = CyclicSequenceDataset(test_raw, verify_cyclicity=verify,
                                          cyclicity_threshold=thresh)

    def train_batches(self, epoch: int = 0) -> Iterator[np.ndarray]:
        """The epoch's shuffled training batches: the native loader's unless
        ``use_native_loader`` is false (module docstring)."""
        if self.config.get("use_native_loader", True):
            if self._native_loader is None:
                from rlvae_tpu_torch.data.native_loader import NativeBatchLoader

                self._native_loader = NativeBatchLoader(self.train.data, self.batch_size)
            yield from self._native_loader.epoch(seed=self.seed + epoch, shuffle=True)
        else:
            yield from batch_iterator(self.train.data, self.batch_size, shuffle=True,
                                      seed=self.seed + epoch)

    def val_batches(self) -> Iterator[np.ndarray]:
        # the remainder is kept: a split smaller than a batch still evaluates
        yield from batch_iterator(self.val.data, self.batch_size, shuffle=False,
                                  drop_remainder=False)

    def test_batches(self) -> Iterator[np.ndarray]:
        yield from batch_iterator(self.test.data, self.batch_size, shuffle=False,
                                  drop_remainder=False)

    def steps_per_epoch(self) -> int:
        return len(self.train) // self.batch_size

    def get_sample_batch(self, split: str = "val", n: int = 8) -> np.ndarray:
        """The first ``n`` sequences of a split (the visualizations' fixed batch)."""
        ds = {"train": self.train, "val": self.val, "test": self.test}[split]
        return ds.data[:n]

    def get_data_stats(self) -> Dict[str, Any]:
        return {
            "train": self.train.get_dataset_stats() if self.train else None,
            "val": self.val.get_dataset_stats() if self.val else None,
            "test": self.test.get_dataset_stats() if self.test else None,
            "batch_size": self.batch_size,
        }
