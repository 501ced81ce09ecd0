"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller names another device.
There is no quiet CPU fallback: asking for the card on a machine without
one is an error, so a run never reports CPU numbers as device numbers.
In a ``torch.distributed`` world (one process per device) rank 0 is the
process that writes a run's files (:func:`is_main_process`).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed as dist

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card; raise if the requested card is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rlvae_tpu_torch: a CUDA device was requested (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev


def world_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def is_main_process() -> bool:
    """Rank 0 of an initialised world, or the only process."""
    return not world_initialized() or dist.get_rank() == 0
