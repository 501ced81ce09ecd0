"""The port's collectives, counted.

Every collective of the data- and model-parallel paths is a call of one of
these wrappers, and each call adds one to its kind's count and its payload
to its kind's bytes in a :class:`CommTally` (the process-wide ``TALLY``
unless the caller passes another), so a step's communication plan is
observable without a trace (:mod:`rlvae_tpu_torch.parallel.comm_audit`).
The payload is what JAX's HLO audit counts: the reduced tensor for an
all-reduce, the gathered (output) tensor for an all-gather, the scattered
(output) shard for a reduce-scatter, and the broadcast tensor.

A call over a group is made and counted even when the group holds one
rank (one NCCL rank reduces onto itself); with ``group`` None (no
initialised world) the wrapper is the identity and counts nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "broadcast")


class CommTally:
    """Counts and payload bytes per collective kind."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.counts: Dict[str, Dict[str, int]] = {k: {"count": 0, "bytes": 0} for k in KINDS}

    def add(self, kind: str, nbytes: int) -> None:
        self.counts[kind]["count"] += 1
        self.counts[kind]["bytes"] += int(nbytes)

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        return {k: dict(v) for k, v in self.counts.items()}


TALLY = CommTally()


def _bytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def group_size(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(x: torch.Tensor, group: Optional[dist.ProcessGroup], op: str = "sum",
               tally: CommTally = TALLY) -> torch.Tensor:
    """``x`` reduced (``sum`` or ``max``) over ``group``, in place."""
    if group is not None:
        tally.add("all-reduce", _bytes(x))
        dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                        group=group)
    return x


def all_gather(x: torch.Tensor, group: Optional[dist.ProcessGroup], dim: int = 0,
               tally: CommTally = TALLY) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order."""
    if group is None:
        return x
    parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    out = torch.cat(parts, dim=dim)
    tally.add("all-gather", _bytes(out))
    return out


def broadcast(x: torch.Tensor, src: int = 0, group: Optional[dist.ProcessGroup] = None,
              tally: CommTally = TALLY) -> torch.Tensor:
    """``x`` overwritten with global rank ``src``'s, in place, over ``group``
    (the whole world when None and a world exists)."""
    if dist.is_available() and dist.is_initialized():
        tally.add("broadcast", _bytes(x))
        dist.broadcast(x, src=src, group=group)
    return x
