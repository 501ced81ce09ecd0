"""Start and join a ``torch.distributed`` world of ranks on this machine.

The port runs one process per device.  :func:`spawn_ranks` starts ``world``
subprocesses of a module, each with ``--rank r`` appended to its arguments,
writes each one's output to ``OUT/rank{r}.log``, and waits for all of them
within one deadline; a rank that fails or times out stops the others (they
may be waiting on it in a collective).  :func:`init_world` is the rank's
side: it joins the group through a ``file://`` store under ``OUT`` (no
network), on ``cuda:(rank % device_count)`` for the card or the CPU, with
a bounded collective timeout.

NCCL refuses two ranks on one device, so a ``nccl`` world larger than the
cards of this machine raises and names ``--backend gloo``, which takes
all-reduce, all-gather and broadcast on CUDA tensors through the host.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path
from typing import List, Sequence

REPO_ROOT = Path(__file__).resolve().parents[2]
GROUP_TIMEOUT_S = 120


def default_backend(device: str) -> str:
    return "gloo" if device == "cpu" else "nccl"


def check_backend(backend: str, world: int, device: str) -> None:
    """Raise for a world the backend cannot run on this machine."""
    if backend == "nccl" and device == "cpu":
        raise ValueError("the nccl backend needs CUDA devices; use --backend gloo on the CPU")
    if backend == "nccl":
        import torch

        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"NCCL refuses two ranks on one device: a world of {world} ranks on "
                f"{cards} card(s) needs --backend gloo")


def init_world(backend: str, world: int, rank: int, out: Path, device: str):
    """Join the world as ``rank``; returns this rank's torch device."""
    import torch
    import torch.distributed as dist

    check_backend(backend, world, device)
    if device == "cpu":
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{Path(out).resolve() / 'store'}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    return dev


def spawn_ranks(module: str, argv: Sequence[str], world: int, out: Path,
                timeout: float) -> List[str]:
    """Run ``python -m module *argv --rank r`` for every rank; the failures
    (empty when every rank exited 0 in time)."""
    out = Path(out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    (out / "store").unlink(missing_ok=True)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join(
        [str(REPO_ROOT), *filter(None, [os.environ.get("PYTHONPATH")])])}
    procs = []
    for r in range(world):
        with open(out / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *argv, "--rank", str(r)], env=env,
                stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    failed: List[str] = []
    try:
        for r, p in enumerate(procs):
            try:
                p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                failed.append(f"rank {r} timed out after {timeout} s")
                break
            if p.returncode != 0:
                failed.append(f"rank {r} exited {p.returncode}")
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return failed


def rank_logs(out: Path, world: int, tail: int = 2000) -> str:
    return "\n".join(f"--- rank {r} log ---\n{(Path(out) / f'rank{r}.log').read_text()[-tail:]}"
                     for r in range(world) if (Path(out) / f"rank{r}.log").exists())

