"""The process layout of the centroid-sharded paths: a data x model grid.

Port of ``rlvae_tpu/parallel/mesh.py:27-38``.  JAX reshapes its device list
row-major into a (data, model) mesh; here each process of an initialised
``torch.distributed`` world of size n is one cell of that grid, so rank r
sits at data index ``r // model_parallel`` and model index
``r % model_parallel``.  The ranks that share a data index form one model
group (they hold the slices of one centroid bank and sum their partials
over it); the ranks that share a model index form one data group (they hold
the slices of the batch).

With no process group initialised the layout is the trivial 1 x 1 one with
no groups: one process on one card needs no ``init_process_group``, and
every collective is the identity.

:func:`resolve_num_devices` maps the trainer config's ``devices`` onto the
size of the data axis, as ``rlvae_tpu/parallel/mesh.py:40-51`` maps it onto
a device count; :func:`is_main_process` is the rank that writes a run's
files (JAX's ``process_index() == 0``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Union

import torch.distributed as dist

from rlvae_tpu_torch.device import is_main_process, world_initialized

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "create_mesh", "is_main_process",
           "resolve_num_devices", "world_initialized"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """This process's cell of the (data, model) grid and its two groups."""

    dp: int  # size of the data axis
    ep: int  # size of the model axis: the shards of the centroid bank
    data_index: int
    model_index: int
    model_group: Optional[dist.ProcessGroup] = None  # same data index, every model index
    data_group: Optional[dist.ProcessGroup] = None  # same model index, every data index

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.ep}

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        if axis == MODEL_AXIS:
            return self.model_group
        if axis == DATA_AXIS:
            return self.data_group
        raise ValueError(f"unknown mesh axis {axis!r}")


def create_mesh(model_parallel: int = 1) -> Mesh:
    """The data x model layout of the initialised world (1 x 1 without one).

    Every rank must call it, in the same order as its other group creations:
    ``new_group`` is collective over the whole world."""
    if not (dist.is_available() and dist.is_initialized()):
        if model_parallel != 1:
            raise ValueError(
                f"model_parallel={model_parallel} needs an initialised torch.distributed "
                "world of that many processes (or a multiple)"
            )
        return Mesh(dp=1, ep=1, data_index=0, model_index=0)
    n, rank = dist.get_world_size(), dist.get_rank()
    if model_parallel < 1 or n % model_parallel != 0:
        raise ValueError(f"{n} processes not divisible by model_parallel={model_parallel}")
    dp, ep = n // model_parallel, model_parallel
    model_group = data_group = None
    for d in range(dp):  # the model groups, then the data groups, on every rank
        g = dist.new_group([d * ep + m for m in range(ep)])
        if d == rank // ep:
            model_group = g
    for m in range(ep):
        g = dist.new_group([d * ep + m for d in range(dp)])
        if m == rank % ep:
            data_group = g
    return Mesh(dp=dp, ep=ep, data_index=rank // ep, model_index=rank % ep,
                model_group=model_group, data_group=data_group)


def resolve_num_devices(devices_config: Union[int, str, None],
                        mesh: Optional[Mesh] = None) -> int:
    """The size of the data axis that the trainer config's ``devices`` asks
    for: ``None``/``"auto"`` is 1 (the reference's single device),
    ``"all"`` the data axis of ``mesh`` (1 without one), and an int is
    clamped to that axis, as JAX clamps it to the devices that exist.
    Without a mesh an int above 1 is returned as asked: nothing here
    starts processes, so the caller refuses it (one process drives one
    device; a data-parallel run is launched as a world)."""
    if devices_config in (None, "auto"):
        return 1
    available = 1 if mesh is None else mesh.dp
    if devices_config == "all":
        return available
    n = max(1, int(devices_config))
    return n if mesh is None else min(n, available)
