"""Per-rank data staging of the data-parallel epoch.

Port of ``rlvae_tpu/parallel/multihost.py``.  A port world of N ranks is
JAX's N-process x 1-device layout: each rank loads its process-strided rows
(``data.cyclic.CyclicDataModule`` with the world's data index and count),
shuffles them once with ``default_rng(seed + data_index)`` at staging, and
each epoch walks its own column of the seeded shard-local index matrix of
:func:`host_epoch_perm`, which every rank computes identically without a
collective.  The resident epoch stages the rows on the rank's device once
(:func:`stage_dataset`) and gathers each batch there by its column
(:func:`epoch_perm`); the chunked epoch keeps them on the host and gathers
the same rows per chunk, so both see the same batches.  JAX's
``replicate_array`` (the epoch key on every host) has no counterpart: each
rank derives its noise seed from the seed and its data index.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rlvae_tpu_torch.parallel.mesh import Mesh


def usable_local_rows(mesh: Mesh, n_local: int, local_devices: int = 1) -> int:
    """Largest row count this process can stage evenly over its
    data-axis devices (one per process in a port world)."""
    local_devices = max(1, min(local_devices, mesh.dp))
    return (n_local // local_devices) * local_devices


def host_epoch_perm(seed: int, epoch: int, n_steps: int, local_bs: int, shard_len: int,
                    n_dev: int) -> np.ndarray:
    """The seeded [n_steps, n_dev, local_bs] shard-local index matrix: the
    single source of the epoch shuffle for the resident and the chunked
    epoch."""
    rng = np.random.default_rng(seed + epoch)
    return np.stack(
        [rng.permutation(shard_len)[: n_steps * local_bs].reshape(n_steps, local_bs)
         for _ in range(n_dev)],
        axis=1,
    ).astype(np.int32)


def staging_perm(seed: int, data_index: int, n_rows: int) -> np.ndarray:
    """The once-per-run shuffle of a rank's rows at staging (JAX seeds it
    with ``seed + process_index``)."""
    return np.random.default_rng(seed + data_index).permutation(n_rows)


def epoch_perm(mesh: Mesh, seed: int, epoch: int, n_steps: int, local_bs: int, shard_len: int,
               n_dev: Optional[int] = None, device=None) -> torch.Tensor:
    """This rank's [n_steps, local_bs] column of :func:`host_epoch_perm`."""
    n_dev = mesh.dp if n_dev is None else n_dev
    perm = host_epoch_perm(seed, epoch, n_steps, local_bs, shard_len, n_dev)
    return torch.from_numpy(np.ascontiguousarray(perm[:, mesh.data_index])).to(device)


def stage_dataset(local_rows: np.ndarray, device) -> torch.Tensor:
    """A rank's rows as one float32 tensor on its device."""
    return torch.from_numpy(np.ascontiguousarray(local_rows, np.float32)).to(device)

