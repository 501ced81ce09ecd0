"""Build and load the port's CUDA kernels.

One ``nvcc`` call compiles every ``csrc/*.cu`` into one shared library with
a plain C interface, loaded with :mod:`ctypes`.  No source includes
PyTorch's headers, so the build takes seconds rather than minutes.

- The library lands in ``build/rlvae_tpu_torch/`` beside the package (a
  directory that ``.gitignore`` lists); its file name carries a hash of the
  sources and flags, so a stale library is never loaded.
- The compiler writes to a temporary name that is then ``os.replace``-d
  into place: a cut build leaves nothing that a later run waits on or loads
  half-written.  There are no lock files.
- A missing ``nvcc`` or a failed compile raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "rlvae_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers / shared memory / spills per kernel, kept in the build log
)
# Where the CUDA toolkit usually lives when ``nvcc`` is not on PATH.
NVCC_FALLBACKS = ("/usr/local/cuda/bin/nvcc",)

_C_INT, _C_FLOAT, _C_PTR = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
# extern "C" signatures of csrc/*.cu: (name, argtypes); every function
# returns the cudaError_t of its launch.
SIGNATURES = {
    # z, centroids, matrices, inv_t2, diag, L, logdet, B, K, stream
    "chol_bundle_f32": (_C_PTR, _C_PTR, _C_PTR, _C_FLOAT, _C_FLOAT, _C_PTR, _C_PTR,
                        _C_INT, _C_INT, _C_PTR),
    # z, centroids, matrices, inv_t2, lbd, log_eps, log_pi, grad, B, K, stream
    "hmc_terms_f32": (_C_PTR, _C_PTR, _C_PTR, _C_FLOAT, _C_FLOAT, _C_FLOAT, _C_PTR, _C_PTR,
                      _C_INT, _C_INT, _C_PTR),
    # z, centroids, matrices, inv_t2, lbd, G^-1, L, logdet, G, workspace,
    # B, K, n_splits, stream
    "metric_bundle_f32": (_C_PTR, _C_PTR, _C_PTR, _C_FLOAT, _C_FLOAT) + (_C_PTR,) * 5
                         + (_C_INT, _C_INT, _C_INT, _C_PTR),
    # z, centroids, matrices, inv_t2, lbd, G^-1, workspace, B, K, n_splits, stream
    "g_inv_f32": (_C_PTR, _C_PTR, _C_PTR, _C_FLOAT, _C_FLOAT, _C_PTR, _C_PTR,
                  _C_INT, _C_INT, _C_INT, _C_PTR),
    # z, centroids, matrices, inv_t2, gi_part, v, workspace, B, K, n_splits, stream
    "hmc_partials_f32": (_C_PTR, _C_PTR, _C_PTR, _C_FLOAT, _C_PTR, _C_PTR, _C_PTR,
                         _C_INT, _C_INT, _C_INT, _C_PTR),
    # z0, w0, b0, wh, bh, wo, bo, z, ld, ys (null: not written), B, D, H, NB, NH, NT, stream
    "iaf_chain_fwd_f32": (_C_PTR,) * 10 + (_C_INT,) * 6 + (_C_PTR,),
    # ys, dz, dld, w0, b0, wh, bh, wo, bo, dz0, gw0, gb0, gwh, gbh, gwo, gbo,
    # B, D, H, NB, NH, NT, stream
    "iaf_chain_bwd_f32": (_C_PTR,) * 16 + (_C_INT,) * 6 + (_C_PTR,),
    # h (bf16), w, b, x, rw, partials, loss, M, K, N, stream
    "decode_mse_fwd_f32": (_C_PTR,) * 7 + (_C_INT,) * 3 + (_C_PTR,),
    # h (bf16), w, b, x, rw, g, partials, dh, M, K, N, n_ranges, round_dh, stream
    "decode_mse_bwd_dh_f32": (_C_PTR,) * 8 + (_C_INT,) * 5 + (_C_PTR,),
    # h (bf16), w, b, x, rw, g, dw, db, M, K, N, stream
    "decode_mse_bwd_dw_f32": (_C_PTR,) * 8 + (_C_INT,) * 3 + (_C_PTR,),
}


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []) + list(NVCC_FALLBACKS):
        if os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (not on PATH, not under CUDA_HOME or /usr/local/cuda): "
        "the CUDA kernels of rlvae_tpu_torch cannot be built"
    )


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librlvae_kernels_{h.hexdigest()[:16]}.so"


def nvcc_argv(nvcc: str, out: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *map(str, sources())]


class KernelLibrary:
    """The loaded library plus what its build cost (``seconds`` is 0.0 when
    a library with the same hash was already on disk)."""

    def __init__(self, path: Path, seconds: float, log: str):
        self.path, self.seconds, self.log = path, seconds, log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self.lib, name)


def build(timeout: float = 600.0) -> tuple[Path, float, str]:
    """Compile csrc/*.cu unless the hashed library exists; return (path, seconds, log)."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(nvcc_argv(nvcc, tmp), capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out, time.perf_counter() - t0, proc.stdout + proc.stderr


_lock = threading.Lock()
_loaded: Optional[KernelLibrary] = None


def kernel_library() -> KernelLibrary:
    """Build (at first use) and load the kernel library, once per process."""
    global _loaded
    with _lock:
        if _loaded is None:
            _loaded = KernelLibrary(*build())
        return _loaded
