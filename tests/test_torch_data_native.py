"""The port's native batch loader, ``.pt`` datasets and data converters
(``rlvae_tpu_torch.data``) against the JAX package's (``rlvae_tpu.data``)
on the CPU.

- ``NativeBatchLoader``: the same library source (``native/dataloader.cpp``,
  built by each package with g++), so the batches are JAX's bit for bit:
  two shuffled epochs and an unshuffled one, ragged and even row counts.
  A failed build, or a dataset the library cannot open, raises an error
  naming ``data.use_native_loader=false``: nothing falls back to numpy.
- ``CyclicDataModule.train_batches`` at the default loader and with
  ``use_native_loader: false``, against JAX's data module.
- ``.pt`` datasets (a tensor, and the ``{'data': ...}`` wrapper), written
  by the tests into ``tmp_path``: ``CyclicSequenceDataset.from_file`` and
  the data module (``train_path`` without its suffix) equal to JAX's.
- ``convert_dataset``, ``convert_component`` (a pythae MLP encoder's and
  decoder's state dict) and ``write_synthetic_dataset`` write the files
  JAX's write: the same keys and arrays.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from rlvae_tpu.data import convert as jax_convert
from rlvae_tpu.data.cyclic import CyclicDataModule as JaxDataModule
from rlvae_tpu.data.cyclic import CyclicSequenceDataset as JaxDataset
from rlvae_tpu.data.native_loader import NativeBatchLoader as JaxLoader
from rlvae_tpu.data.synth import write_synthetic_dataset as jax_write
from rlvae_tpu_torch.data import CyclicDataModule, CyclicSequenceDataset, write_synthetic_dataset
from rlvae_tpu_torch.data import convert, native_loader
from rlvae_tpu_torch.data.native_loader import NativeBatchLoader, NativeLoaderError

SHAPE = (2, 3, 4, 4)


def rows(n, seed=0):
    return np.random.default_rng(seed).uniform(size=(n, *SHAPE)).astype(np.float32)


def same_batches(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,batch", [(23, 4), (16, 8), (5, 5)])
def test_native_batches_are_jax_bitwise(n, batch):
    data = rows(n)
    port, ref = NativeBatchLoader(data, batch), JaxLoader(data, batch)
    assert ref.native  # JAX's library built, not its numpy fallback
    for seed in (42, 43):
        same_batches(list(port.epoch(seed)), list(ref.epoch(seed)))
    unshuffled = list(port.epoch(0, shuffle=False))
    same_batches(unshuffled, list(ref.epoch(0, shuffle=False)))
    np.testing.assert_array_equal(np.concatenate(unshuffled), data[: n // batch * batch])
    lib = native_loader.library_path()
    assert lib.parent == native_loader.BUILD_DIR and lib.exists()


def test_failures_raise_naming_the_flag(tmp_path, monkeypatch):
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(NativeLoaderError, match="data.use_native_loader=false"):
        NativeBatchLoader(rows(4), 2)
    dm = CyclicDataModule({"train_path": None, "test_path": None, "image_size": [4, 4],
                           "sequence_length": 2, "synthetic_n_train": 4, "synthetic_n_test": 2})
    dm.setup({"data": {"batch_size": 2}})
    with pytest.raises(NativeLoaderError, match="data.use_native_loader=false"):
        next(dm.train_batches(0))
    monkeypatch.undo()
    empty = tmp_path / "empty.bin"
    empty.write_bytes(b"")
    monkeypatch.setattr(native_loader, "stage_raw", lambda data, path=None: empty)
    with pytest.raises(NativeLoaderError, match="rl_loader_create failed.*use_native_loader"):
        NativeBatchLoader(rows(4), 2)


@pytest.mark.parametrize("native", [True, False])
def test_data_module_batches_are_jax(native, tmp_path):
    cfg = {"train_path": str(tmp_path / "none.npz"), "test_path": str(tmp_path / "none.npz"),
           "image_size": [8, 8], "sequence_length": 3, "synthetic_n_train": 14,
           "synthetic_n_test": 5, "use_native_loader": native}
    tc = {"data": {"batch_size": 4}, "n_train_samples": 13}
    port, ref = CyclicDataModule(cfg, seed=7), JaxDataModule(cfg, seed=7, process_index=0,
                                                             process_count=1)
    port.setup(tc)
    ref.setup(tc)
    for epoch in (0, 1):
        same_batches(list(port.train_batches(epoch)), list(ref.train_batches(epoch)))
    assert (port._native_loader is not None) == native


@pytest.mark.parametrize("wrapped", [False, True])
def test_pt_datasets_load_as_jax(wrapped, tmp_path):
    data = rows(6, seed=1)
    seqs = torch.from_numpy(np.concatenate([data, data[:, :1]], axis=1))  # [6, 3, 3, 4, 4]
    torch.save({"data": seqs, "meta": torch.zeros(2)} if wrapped else seqs,
               tmp_path / "train.pt")
    got = CyclicSequenceDataset.from_file(tmp_path / "train.pt", verify_cyclicity=False)
    want = JaxDataset.from_file(tmp_path / "train.pt", verify_cyclicity=False)
    np.testing.assert_array_equal(got.data, want.data)
    assert got.data.shape == (6, 3, 3, 4, 4)
    cfg = {"train_path": str(tmp_path / "train"), "test_path": str(tmp_path / "train.pt"),
           "synthetic_fallback": False}
    port, ref = CyclicDataModule(cfg, seed=2), JaxDataModule(cfg, seed=2, process_index=0,
                                                             process_count=1)
    port.setup({"data": {"batch_size": 2}, "n_val_samples": 3})
    ref.setup({"data": {"batch_size": 2}, "n_val_samples": 3})
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(getattr(port, split).data, getattr(ref, split).data)
    assert port.train.cyclicity_report == ref.train.cyclicity_report
    same_batches(list(port.train_batches(0)), list(ref.train_batches(0)))


def _same_npz(a: Path, b: Path):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in y.files:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


def test_converters_and_synthetic_writer_write_jax_files(tmp_path):
    seqs = torch.rand((4, 3, 1, 4, 4), generator=torch.Generator().manual_seed(0))
    torch.save({"data": seqs}, tmp_path / "seqs.pt")
    shape = convert.convert_dataset(tmp_path / "seqs.pt", tmp_path / "port" / "seqs.npz")
    assert shape == jax_convert.convert_dataset(tmp_path / "seqs.pt", tmp_path / "jax" / "seqs.npz")
    _same_npz(tmp_path / "port" / "seqs.npz", tmp_path / "jax" / "seqs.npz")

    gen = torch.Generator().manual_seed(1)
    layers = {"encoder": {"layers.0.0": (32, 48), "embedding": (6, 32), "log_var": (6, 32)},
              "decoder": {"layers.0.0": (32, 6), "layers.1.0": (48, 32)}}
    for kind, shapes in layers.items():
        sd = {}
        for name, (o, i) in shapes.items():  # under a prefix the loaders strip
            sd[f"model.{kind}.{name}.weight"] = torch.randn((o, i), generator=gen)
            sd[f"model.{kind}.{name}.bias"] = torch.randn((o,), generator=gen)
        torch.save(sd, tmp_path / f"{kind}.pt")
        convert.convert_component(tmp_path / f"{kind}.pt", tmp_path / "port" / f"{kind}.npz", kind)
        jax_convert.convert_component(tmp_path / f"{kind}.pt", tmp_path / "jax" / f"{kind}.npz",
                                      kind)
        _same_npz(tmp_path / "port" / f"{kind}.npz", tmp_path / "jax" / f"{kind}.npz")
        got = convert.load_component_npz(tmp_path / "port" / f"{kind}.npz")
        want = jax_convert.load_component_npz(tmp_path / "jax" / f"{kind}.npz")
        assert got.keys() == want.keys() == {"params"}

    kw = dict(n_obs=3, image_size=(8, 8), channels=1, seed=4)
    assert write_synthetic_dataset(tmp_path / "port" / "s.npz", 5, **kw) == jax_write(
        tmp_path / "jax" / "s.npz", 5, **kw)
    _same_npz(tmp_path / "port" / "s.npz", tmp_path / "jax" / "s.npz")
