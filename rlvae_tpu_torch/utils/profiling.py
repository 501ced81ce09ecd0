"""Step timing and tracing: the port of ``rlvae_tpu/utils/profiling.py:1-97``.

- :func:`trace` records a ``torch.profiler`` trace (host activity, and the
  card's kernels when one is there) and writes it as a Chrome trace under
  ``log_dir``; the trainer enables it for epoch 0 with
  ``training.trainer.profile: true``.  It is the counterpart of
  ``jax.profiler.start_trace``/``stop_trace``.
- :class:`StepTimer` keeps per-step host wall-clock times with an EMA and
  percentiles; its :meth:`~StepTimer.metrics` keys go into the trainer's
  step records.
- :class:`timed` counts calls and sums their wall-clock time; ``sync=True``
  waits for the card (``torch.cuda.synchronize``) when the output holds a
  CUDA tensor.

JAX's ``scan_slope_time``, ``fori_slope_time`` and ``auto_slope_time``
time ``lax.scan``/``fori_loop`` programs and are not ported (ROADMAP A3).
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str | Path, enabled: bool = True):
    """Profile the body and write ``log_dir/trace_<pid>.json`` (Chrome trace
    format) when it exits; CUDA activity is recorded when a card is there."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(log_dir / f"trace_{os.getpid()}.json"))


class StepTimer:
    """Wall-clock accounting for training steps."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg: Optional[float] = None
        self.samples: list[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.avg = dt if self.avg is None else self.ema * self.avg + (1 - self.ema) * dt
        self.samples.append(dt)
        if len(self.samples) > 1000:
            self.samples = self.samples[-1000:]
        return dt

    def metrics(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        arr = np.asarray(self.samples)
        return {
            "step_time_avg": float(self.avg),
            "step_time_p50": float(np.percentile(arr, 50)),
            "step_time_p99": float(np.percentile(arr, 99)),
            "steps_per_sec": float(1.0 / max(self.avg, 1e-9)),
        }


def _holds_cuda_tensor(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        return any(_holds_cuda_tensor(v) for v in out.values())
    if isinstance(out, (list, tuple)):
        return any(_holds_cuda_tensor(v) for v in out)
    return False


class timed:
    """Call-count and cumulative-time wrapper of ``fn``."""

    def __init__(self, fn, sync: bool = True):
        self.fn = fn
        self.sync = sync
        self.calls = 0
        self.total_time = 0.0

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        if self.sync and _holds_cuda_tensor(out):
            torch.cuda.synchronize()
        self.total_time += time.perf_counter() - t0
        self.calls += 1
        return out

    @property
    def mean_time(self) -> float:
        return self.total_time / max(self.calls, 1)
