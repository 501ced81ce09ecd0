"""The native C++ prefetching batch loader behind :mod:`ctypes`.

Port of ``rlvae_tpu/data/native_loader.py``.  ``native/dataloader.cpp``
maps a raw float32 dataset file and gathers shuffled rows into a ring of
ready batches on a background thread; an epoch's order is a Fisher-Yates
shuffle driven by ``std::mt19937_64`` seeded with the epoch's seed.  That
order is the JAX package's default batch order
(``CyclicDataModule.train_batches``), so the port trains on the same
batches only through the same library.

- The library is built at first use with the JAX package's command,
  ``g++ -O3 -std=c++17 -shared -fPIC ... -lpthread``, into
  ``build/rlvae_tpu_torch/`` under a hash of the source and the flags.
  The compiler writes to a temporary name that is then ``os.replace``-d
  into place, so that data-parallel ranks may build it at the same time.
- A dataset is staged once as a raw float32 ``.bin`` in the same
  directory, named by a digest of its contents, also written to a
  temporary name and ``os.replace``-d.  Nothing removes these copies:
  every distinct split leaves one of 4 bytes a value (a split of 10 000
  sprite sequences of 8 frames at 3x64x64 takes 3.9 GB).
- Unlike the JAX module, nothing falls back to numpy batching: a failed
  build or a failed ``rl_loader_create`` raises :class:`NativeLoaderError`,
  whose message names ``data.use_native_loader=false`` (the numpy
  iterator, which batches in another order).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "dataloader.cpp"
BUILD_DIR = REPO / "build" / "rlvae_tpu_torch"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
LINK_FLAGS = ("-lpthread",)
BUILD_TIMEOUT_S = 120.0
OFF_SWITCH = "data.use_native_loader=false"

_lock = threading.Lock()
_loaded: dict = {}  # library path -> ctypes.CDLL


class NativeLoaderError(RuntimeError):
    """The native loader could not be built or could not open a dataset."""


def library_path() -> Path:
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS, *LINK_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdataloader_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}.{threading.get_ident()}")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LINK_FLAGS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", None) or e
        raise NativeLoaderError(
            f"the native batch loader did not build ({' '.join(cmd)}): {detail}; "
            f"{OFF_SWITCH} batches with numpy instead, in another order") from e
    finally:
        tmp.unlink(missing_ok=True)


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the loader library, once per process."""
    out = library_path()
    with _lock:
        if out not in _loaded:
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            lib.rl_loader_create.restype = ctypes.c_void_p
            lib.rl_loader_create.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
            lib.rl_loader_start_epoch.restype = ctypes.c_int64
            lib.rl_loader_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.rl_loader_next.restype = ctypes.c_int32
            lib.rl_loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
            lib.rl_loader_destroy.argtypes = [ctypes.c_void_p]
            _loaded[out] = lib
        return _loaded[out]


def stage_raw(data: np.ndarray, path: Optional[Path] = None) -> Path:
    """[N, ...] float32 rows as a raw ``.bin`` (by default in the build
    directory, named by a digest of the bytes); kept when its size matches."""
    data = np.ascontiguousarray(data, np.float32)
    if path is None:
        digest = hashlib.blake2b(data.tobytes(), digest_size=12).hexdigest()
        path = BUILD_DIR / f"dataset_{digest}.bin"
    path = Path(path)
    if not (path.exists() and path.stat().st_size == data.nbytes):
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.tmp{os.getpid()}.{threading.get_ident()}")
        try:
            data.tofile(tmp)
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)
    return path


class NativeBatchLoader:
    """Prefetching batches of ``batch_size`` rows of ``data`` [N, ...]."""

    def __init__(self, data: np.ndarray, batch_size: int, raw_path: Optional[Path] = None,
                 n_prefetch: int = 2, drop_remainder: bool = True):
        self.sample_shape = tuple(data.shape[1:])
        self.batch_size = int(batch_size)
        self.drop_remainder = drop_remainder
        self._lib = load_library()
        path = stage_raw(data, raw_path)
        self._handle = self._lib.rl_loader_create(
            str(path).encode(), int(data.shape[0]), int(np.prod(self.sample_shape)), 0,
            self.batch_size, int(n_prefetch), int(drop_remainder))
        if not self._handle:
            raise NativeLoaderError(f"rl_loader_create failed on {path}; {OFF_SWITCH} "
                                    "batches with numpy instead, in another order")

    def epoch(self, seed: int = 0, shuffle: bool = True) -> Iterator[np.ndarray]:
        """The epoch's batches, each a fresh [batch_size, ...] float32 array;
        ``shuffle=False`` keeps the rows' order."""
        n_batches = self._lib.rl_loader_start_epoch(self._handle, seed if shuffle else -1)
        out = np.empty((self.batch_size, *self.sample_shape), np.float32)
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        for _ in range(n_batches):
            if not self._lib.rl_loader_next(self._handle, ptr):
                break
            yield out.copy()

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.rl_loader_destroy(self._handle)
            self._handle = None
