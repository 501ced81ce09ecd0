"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain C
interface, loaded with :mod:`ctypes`.  No source includes PyTorch's headers,
so the build takes seconds rather than minutes.

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
import signal
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "rlvae_tpu_torch"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers / shared memory / spills per kernel, kept in the build log
)
# Where the CUDA toolkit usually lives when ``nvcc`` is not on PATH.
NVCC_FALLBACKS = ("/usr/local/cuda/bin/nvcc",)

_C_INT, _C_FLOAT, _C_PTR = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
# extern "C" signatures of csrc/*.cu: (name, argtypes); every function
# returns the cudaError_t of its launch.
SIGNATURES = {
    # The centroid-bank kernels take z [B, d] and the bank padded to d's
    # compiled width (metric_kernels.pad_bank); d = the real latent width.
    # z, centroids, matrices, inv_t2, diag, L, logdet, B, K, d, stream
    "chol_bundle_f32": (_C_PTR, _C_PTR, _C_PTR, _C_FLOAT, _C_FLOAT, _C_PTR, _C_PTR)
                       + (_C_INT,) * 3 + (_C_PTR,),
    # ... B, K, d, rows per CTA, warps per CTA, CTAs per cluster, stream: a given geometry
    "chol_bundle_at_f32": (_C_PTR, _C_PTR, _C_PTR, _C_FLOAT, _C_FLOAT, _C_PTR, _C_PTR)
                          + (_C_INT,) * 6 + (_C_PTR,),
    # z, centroids, matrices, inv_t2, lbd, log_eps, log_pi, grad, B, K, d, stream
    "hmc_terms_f32": (_C_PTR, _C_PTR, _C_PTR, _C_FLOAT, _C_FLOAT, _C_FLOAT, _C_PTR, _C_PTR)
                     + (_C_INT,) * 3 + (_C_PTR,),
    # z, centroids, matrices, inv_t2, lbd, G^-1, L, logdet, G, B, K, d, stream
    "metric_bundle_f32": (_C_PTR, _C_PTR, _C_PTR, _C_FLOAT, _C_FLOAT) + (_C_PTR,) * 4
                         + (_C_INT,) * 3 + (_C_PTR,),
    # ... B, K, d, rows per CTA, warps per CTA, CTAs per cluster, stream: a given geometry
    "metric_bundle_at_f32": (_C_PTR, _C_PTR, _C_PTR, _C_FLOAT, _C_FLOAT) + (_C_PTR,) * 4
                            + (_C_INT,) * 6 + (_C_PTR,),
    # z, centroids, matrices, inv_t2, lbd, G^-1, B, K, d, stream
    "g_inv_f32": (_C_PTR, _C_PTR, _C_PTR, _C_FLOAT, _C_FLOAT, _C_PTR) + (_C_INT,) * 3
                 + (_C_PTR,),
    # ... B, K, d, rows, warps, ctas, stream: a given geometry
    "g_inv_at_f32": (_C_PTR, _C_PTR, _C_PTR, _C_FLOAT, _C_FLOAT, _C_PTR) + (_C_INT,) * 6
                    + (_C_PTR,),
    # z, centroids, matrices, inv_t2, gi_part, v, B, K, d, stream
    "hmc_partials_f32": (_C_PTR, _C_PTR, _C_PTR, _C_FLOAT, _C_PTR, _C_PTR) + (_C_INT,) * 3
                        + (_C_PTR,),
    # ... B, K, d, rows per CTA, warps per CTA, CTAs per cluster, stream: a given geometry
    "hmc_partials_at_f32": (_C_PTR, _C_PTR, _C_PTR, _C_FLOAT, _C_PTR, _C_PTR) + (_C_INT,) * 6
                           + (_C_PTR,),
    # z, centroids, matrices, inv_t2, lbd, log_eps, log_pi, grad, B, K, d, rows, warps,
    # ctas, stream
    "hmc_terms_at_f32": (_C_PTR,) * 3 + (_C_FLOAT,) * 3 + (_C_PTR,) * 2 + (_C_INT,) * 6
                        + (_C_PTR,),
    # B, K, SM count, kernel (metric_kernels.BANK_KERNELS), compiled width (16, 32),
    # out int[4]: rows per CTA, warps per CTA, CTAs per cluster, clusters
    "hmc_geometry": (_C_INT,) * 5 + (_C_PTR,),
    # rows, warps, ctas, kernel, compiled width, out int[1]: how many such
    # clusters the card holds at once
    "hmc_cluster_slots": (_C_INT,) * 5 + (_C_PTR,),
    # rows, warps, ctas, compiled width (16, 32), out int[1]: the same for B1's
    # and B6's own kernels
    "chol_bundle_cluster_slots": (_C_INT,) * 4 + (_C_PTR,),
    "metric_bundle_cluster_slots": (_C_INT,) * 4 + (_C_PTR,),
    # z0, w0, b0, wh, bh, wo, bo, z, ld, ys (null: not written), B, D, H, NB, NH, NT,
    # K (Jacobi iterations per block; 0: the sequential update), stream
    "iaf_chain_fwd_f32": (_C_PTR,) * 10 + (_C_INT,) * 7 + (_C_PTR,),
    # ... B, D, H, NB, NH, NT, K, R, stream_weights, stream: a given R, or streamed weights
    "iaf_chain_fwd_at_f32": (_C_PTR,) * 10 + (_C_INT,) * 9 + (_C_PTR,),
    # ys, dz, dld, z0 (the sequential mode's; null otherwise), w0, b0, wh, bh, wo,
    # bo, dz0, gw0, gb0, gwh, gbh, gwo, gbo, B, D, H, NB, NH, NT, n_sweeps (0: the
    # sequential mode), n_clusters, stream
    "iaf_chain_bwd_f32": (_C_PTR,) * 17 + (_C_INT,) * 8 + (_C_PTR,),
    # ... B, D, H, NB, NH, NT, n_sweeps, R, stream_weights, stream
    "iaf_chain_bwd_at_f32": (_C_PTR,) * 17 + (_C_INT,) * 9 + (_C_PTR,),
    # B, D, H, NH (, K for the forward), out int[6]: R, C, clusters, smem
    # bytes, resident, active clusters
    "iaf_chain_fwd_geometry": (_C_INT,) * 5 + (_C_PTR,),
    "iaf_chain_bwd_geometry": (_C_INT,) * 4 + (_C_PTR,),
    # h (bf16), w, b, x, rw, partials, loss, M, K, N, ctas, row groups, stream
    "decode_mse_fwd_f32": (_C_PTR,) * 7 + (_C_INT,) * 5 + (_C_PTR,),
    # h (bf16), w, b, x, rw, g, workspace, dh, M, K, N, cluster, clusters,
    # row groups, round_dh, stream
    "decode_mse_bwd_dh_f32": (_C_PTR,) * 8 + (_C_INT,) * 7 + (_C_PTR,),
    # h (bf16), w, b, x, rw, g, dw, db, M, K, N, ctas, stream
    "decode_mse_bwd_dw_f32": (_C_PTR,) * 8 + (_C_INT,) * 4 + (_C_PTR,),
    # K, cluster, out int[1]: how many such dh clusters the card holds at once
    "decode_mse_dh_cluster_slots": (_C_INT, _C_INT, _C_PTR),
    # decode+MSE past K = 512 (csrc/decode_mse_wide.cu): h (bf16), w, b, x, rw,
    # partials, loss, M, K, N, stream
    "decode_mse_wide_fwd_f32": (_C_PTR,) * 7 + (_C_INT,) * 3 + (_C_PTR,),
    # h (bf16), w, b, x, rw, g, dp workspace (left holding dp), dh partials
    # (slices x M x K; null with one slice), dh, M, K, N, slices, round_dh, stream
    "decode_mse_wide_bwd_dh_f32": (_C_PTR,) * 9 + (_C_INT,) * 5 + (_C_PTR,),
    # h (bf16), w, b, x, rw, g, dp workspace, dw, db, M, K, N, dp_ready (the
    # workspace already holds dp), stream
    "decode_mse_wide_bwd_dw_f32": (_C_PTR,) * 9 + (_C_INT,) * 4 + (_C_PTR,),
}


# The defines of the profile build (rlvae_tpu_torch.ops.iaf_sweep,
# hmc_sweep and decode_sweep; one library with all three), and the entries
# only that build has: a launch plus clock64 sums per phase of one thread
# (int64[8] IAF forward, int64[10] IAF backward, int64[12] each kernel of
# csrc/hmc_bank.cuh's front half, int64[9] each decode+MSE kernel).
PROFILES = ("IAF_PROFILE", "HMC_PROFILE", "DECODE_PROFILE")
PROFILE_SIGNATURES = {
    # ... as iaf_chain_fwd_f32 up to K, then prof, stream
    "iaf_chain_fwd_profile_f32": (_C_PTR,) * 10 + (_C_INT,) * 7 + (_C_PTR,) * 2,
    # ... as iaf_chain_bwd_f32 up to n_sweeps, then prof, stream
    "iaf_chain_bwd_profile_f32": (_C_PTR,) * 17 + (_C_INT,) * 7 + (_C_PTR,) * 2,
    # ... as hmc_terms_at_f32 up to ctas, then prof, stream
    "hmc_terms_profile_f32": (_C_PTR,) * 3 + (_C_FLOAT,) * 3 + (_C_PTR,) * 2 + (_C_INT,) * 6
                             + (_C_PTR,) * 2,
    # ... as hmc_partials_at_f32 up to ctas, then prof, stream
    "hmc_partials_profile_f32": (_C_PTR, _C_PTR, _C_PTR, _C_FLOAT, _C_PTR, _C_PTR)
                                + (_C_INT,) * 6 + (_C_PTR,) * 2,
    # ... as chol_bundle_at_f32 up to ctas, then prof, stream
    "chol_bundle_profile_f32": (_C_PTR, _C_PTR, _C_PTR, _C_FLOAT, _C_FLOAT, _C_PTR, _C_PTR)
                               + (_C_INT,) * 6 + (_C_PTR,) * 2,
    # ... as metric_bundle_at_f32 up to ctas, then prof, stream
    "metric_bundle_profile_f32": (_C_PTR, _C_PTR, _C_PTR, _C_FLOAT, _C_FLOAT) + (_C_PTR,) * 4
                                 + (_C_INT,) * 6 + (_C_PTR,) * 2,
    # ... as g_inv_at_f32 up to ctas, then prof, stream
    "g_inv_profile_f32": (_C_PTR, _C_PTR, _C_PTR, _C_FLOAT, _C_FLOAT, _C_PTR) + (_C_INT,) * 6
                         + (_C_PTR,) * 2,
    # ... as decode_mse_fwd_f32 up to row groups, then prof, stream
    "decode_mse_fwd_profile_f32": (_C_PTR,) * 7 + (_C_INT,) * 5 + (_C_PTR,) * 2,
    # ... as decode_mse_bwd_dh_f32 up to round_dh, then prof, stream
    "decode_mse_bwd_dh_profile_f32": (_C_PTR,) * 8 + (_C_INT,) * 7 + (_C_PTR,) * 2,
    # ... as decode_mse_bwd_dw_f32 up to ctas, then prof, stream
    "decode_mse_bwd_dw_profile_f32": (_C_PTR,) * 8 + (_C_INT,) * 4 + (_C_PTR,) * 2,
}


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


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


def library_path(defines: Tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *defines)).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librlvae_kernels_{h.hexdigest()[:16]}.so"


def compile_argv(nvcc: str, src: Path, obj: Path, defines: Tuple[str, ...] = ()) -> List[str]:
    return [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-c", str(src), "-o", str(obj)]


def link_argv(nvcc: str, objs: List[Path], out: Path) -> List[str]:
    return [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out), *map(str, objs)]


class KernelLibrary:
    """The loaded library plus what its build cost (``seconds`` is 0.0 when
    a library with the same hash was already on disk)."""

    def __init__(self, path: Path, seconds: float, log: str, signatures: dict = SIGNATURES):
        self.path, self.seconds, self.log = path, seconds, log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in signatures.items():
            fn = getattr(self.lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self.lib, name)


def build(timeout: float = 600.0, defines: Tuple[str, ...] = ()) -> tuple[Path, float, str]:
    """Compile csrc/*.cu unless the hashed library exists; return (path, seconds, log).

    One ``nvcc -c`` per source, all running at once, then one link.  A
    failure, or the timeout, kills every compiler still running, with the
    processes it started."""
    out = library_path(defines)
    if out.exists():
        return out, 0.0, ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    tmp = out.with_name(f"{out.name}.{tag}")
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    t0 = time.perf_counter()
    procs = []
    log = []
    try:
        for src, obj in zip(sources(), objs):
            procs.append(subprocess.Popen(compile_argv(nvcc, src, obj, defines), stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True,
                                          start_new_session=True))
        for src, proc in zip(sources(), procs):
            stdout, _ = proc.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
            log.append(stdout)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} (exit {proc.returncode}):\n{stdout}")
        link = subprocess.run(link_argv(nvcc, objs, tmp), capture_output=True, text=True,
                              timeout=max(1.0, timeout - (time.perf_counter() - t0)))
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        log.append(link.stdout + link.stderr)
        os.replace(tmp, out)
    finally:
        for proc in procs:  # each nvcc leads its own group, with its cicc and ptxas
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        for path in (tmp, *objs):
            if path.exists():
                path.unlink()
    return out, time.perf_counter() - t0, "".join(log)


_lock = threading.Lock()
_loaded: Dict[bool, KernelLibrary] = {}


def kernel_library(profile: bool = False) -> KernelLibrary:
    """Build (at first use) and load the kernel library, once per process.
    ``profile`` gives the profile build instead (the IAF-chain, centroid-bank
    (B1, B4, B6-B8) and decode+MSE kernels' clock64 laps), with the entries of
    ``PROFILE_SIGNATURES`` (a library of its own)."""
    with _lock:
        if profile not in _loaded:
            defines = PROFILES if profile else ()
            signatures = {**SIGNATURES, **PROFILE_SIGNATURES} if profile else SIGNATURES
            _loaded[profile] = KernelLibrary(*build(defines=defines), signatures)
        return _loaded[profile]
