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

- :func:`scan_slope_time`, :func:`fori_slope_time` and
  :func:`auto_slope_time` time a function per call by the slope of wall
  clock against iteration count, which cancels the per-program launch
  cost.  On CUDA tensors each program is a captured CUDA graph (JAX's is
  one compiled ``lax.scan`` or ``fori_loop``); on CPU tensors an eager
  loop takes the graph's place.  The device is the inputs'.
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


# ---------------------------------------------------------------------------
# Slope timers
# ---------------------------------------------------------------------------


def _leaves(tree):
    """The tensors of a tensor, or a (nested) list, tuple or dict of them."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return []


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _min_wall(run, device: torch.device, reps: int) -> float:
    """The least wall-clock seconds of ``run()`` over ``reps`` runs, after one
    run that settles it, each timed from a synchronized device to a
    synchronized device (additive noise: the minimum is the estimator)."""
    run()
    _sync(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return float(np.min(ts))


def _captured(fn, device: torch.device):
    """``fn`` captured once in a CUDA graph (after an eager warm-up on a side
    stream) and returned as its replay; on the CPU, ``fn`` itself."""
    if device.type != "cuda":
        return fn
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream(device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def scan_slope_time(fn, batches, m_small: int = 8, reps: int = 5):
    """Per-call device time of ``fn`` over a stack of distinct inputs.

    ``batches``: a tensor, or a list, tuple or dict of tensors, whose leaves
    share a leading axis M (M distinct argument sets).  ``fn`` maps one
    slice (leading axis dropped) to a tensor or a tree of them; the outputs
    are summed into one fp32 scalar inside the program, so nothing is
    dropped and live memory stays flat.  Two programs run the first
    ``m_small`` and all M slices (on the card each is one captured CUDA
    graph; on the CPU an eager loop); the slope of their times cancels the
    per-program cost.

    Returns ``(seconds_per_call, diagnostics)``: ``t_small_s``, ``t_big_s``,
    ``m_small``, ``m_big`` and the inferred ``dispatch_overhead_s``.
    """
    leaves = _leaves(batches)
    m_total = int(leaves[0].shape[0])
    if m_total <= m_small:
        raise ValueError(f"need more than m_small={m_small} input sets, got {m_total}")
    device = leaves[0].device
    acc = torch.zeros((), dtype=torch.float32, device=device)

    def program(m: int):
        def run():
            acc.zero_()
            for i in range(m):
                out = fn(_tree_map(lambda a, i=i: a[i], batches))
                for leaf in _leaves(out):
                    acc.add_(leaf.sum().float())
        return run

    t_small = _min_wall(_captured(program(m_small), device), device, reps)
    t_big = _min_wall(_captured(program(m_total), device), device, reps)
    per_call = max((t_big - t_small) / (m_total - m_small), 1e-12)
    return per_call, {
        "t_small_s": t_small,
        "t_big_s": t_big,
        "m_small": m_small,
        "m_big": m_total,
        "dispatch_overhead_s": max(t_small - m_small * per_call, 0.0),
    }


def fori_slope_time(body, carry0, n_small: int = 4, n_big: int = 16, reps: int = 5):
    """Per-iteration device time of ``body(i, carry) -> carry``, from one
    program run at two trip counts.

    ``i`` is an int64 scalar tensor on the carry's device and ``carry0`` a
    tensor or a tree of them; the body should make its work depend on ``i``.
    On the card the body is captured once in a CUDA graph that also writes
    its result back into the carry and advances ``i``, and a run of n
    iterations replays it n times; on the CPU an eager loop runs it.  Each
    run starts from ``carry0``.

    Returns ``(seconds_per_iteration, diagnostics)``: ``t_small_s``,
    ``t_big_s``, ``n_small``, ``n_big`` and ``dispatch_overhead_s``.
    """
    device = _leaves(carry0)[0].device
    carry = _tree_map(lambda a: a.clone(), carry0)
    i = torch.zeros((), dtype=torch.int64, device=device)

    def step():
        out = body(i, carry)
        for dst, src in zip(_leaves(carry), _leaves(out)):
            dst.copy_(src)
        i.add_(1)

    replay = _captured(step, device)

    def program(n: int):
        def run():
            for dst, src in zip(_leaves(carry), _leaves(carry0)):
                dst.copy_(src)
            i.zero_()
            for _ in range(n):
                replay()
        return run

    t_small = _min_wall(program(n_small), device, reps)
    t_big = _min_wall(program(n_big), device, reps)
    per_iter = max((t_big - t_small) / (n_big - n_small), 1e-12)
    return per_iter, {
        "t_small_s": t_small,
        "t_big_s": t_big,
        "n_small": n_small,
        "n_big": n_big,
        "dispatch_overhead_s": max(t_small - n_small * per_iter, 0.0),
    }


def auto_slope_time(body, carry0, target_delta_s: float = 0.25, n_small: int = 2,
                    n_cap: int = 32768, reps: int = 5):
    """:func:`fori_slope_time` with the trip count sized from a pilot run.

    A pilot at (``n_small``, 16); then ``n_big`` chosen so the extra
    iterations take about ``target_delta_s`` (at most ``n_cap``).  Where
    the measured delta still falls under 20% of the target, the trip count
    doubles and the measurement runs again, twice at most.
    """
    pilot, _ = fori_slope_time(body, carry0, n_small=n_small, n_big=16, reps=max(2, reps // 2))
    if pilot * 14 >= target_delta_s:  # a slow body: the pilot's delta is ample
        return fori_slope_time(body, carry0, n_small=n_small, n_big=16, reps=reps)
    n_big = int(min(n_cap, max(32, target_delta_s / max(pilot, 1e-9))))
    for _ in range(3):
        t, diag = fori_slope_time(body, carry0, n_small=n_small, n_big=n_big, reps=reps)
        if t * (n_big - n_small) >= 0.2 * target_delta_s or n_big >= n_cap:
            return t, diag
        n_big = min(n_cap, n_big * 2)
    return t, diag
