"""Dynamic-batching inference engine.

Port of ``rlvae_tpu/serving.py:41-409`` (ops ``reconstruct``, ``encode``,
``decode`` and ``generate``):

- **Bucketed shapes**: every micro-batch is padded (by repeating its last
  row) up to one of a few power-of-two sizes, so the device sees a bounded
  set of batch shapes.
- **Dynamic batching**: concurrent requests for the same op coalesce into
  one device call, up to ``max_batch`` or ``max_wait_ms``.
- **Single device owner**: one dispatcher thread makes every device call;
  request threads enqueue and wait on futures.

- **Data-parallel serving** (:func:`make_sharded_ops`): one process holds
  one model replica per listed device; each padded batch is split over the
  replicas, every replica is launched before any result is read back, and
  the rows come back in order.

Every wait is bounded: :meth:`BatchingEngine.run` takes a timeout, an op
that raises fails the futures of its batch (never the dispatcher), and a
dispatcher that exits for any reason fails whatever is still queued.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ServeConfig", "BatchingEngine", "EngineStats", "make_sharded_ops"]


@dataclass(frozen=True)
class ServeConfig:
    """``buckets`` ascending, the largest is the max batch; ``max_wait_ms``
    trades tail latency for batching (0 = per-request dispatch)."""

    buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)
    max_wait_ms: float = 2.0
    queue_capacity: int = 4096

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]


@dataclass
class EngineStats:
    requests: int = 0
    batches: int = 0
    rows_padded: int = 0
    rows_real: int = 0
    batch_sizes: collections.Counter = field(default_factory=collections.Counter)
    latencies_ms: Dict[str, collections.deque] = field(default_factory=dict)

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "requests": self.requests,
            "batches": self.batches,
            "avg_batch": (self.rows_real / self.batches) if self.batches else 0.0,
            "padding_waste": (
                self.rows_padded / (self.rows_padded + self.rows_real)
                if (self.rows_padded + self.rows_real) else 0.0
            ),
            "batch_size_hist": dict(self.batch_sizes),
        }
        for op, lat in self.latencies_ms.items():
            arr = np.asarray(lat, dtype=np.float64)
            if arr.size:
                out[f"{op}_p50_ms"] = float(np.percentile(arr, 50))
                out[f"{op}_p99_ms"] = float(np.percentile(arr, 99))
        return out


class _Request:
    __slots__ = ("op", "payload", "future", "t_enqueue")

    def __init__(self, op: str, payload: np.ndarray):
        self.op = op
        self.payload = payload
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter()


def make_sharded_ops(manager, devices: Sequence[Any], generate_n_obs: int = 8,
                     generate_method: str = "geodesic") -> Dict[str, Callable[[np.ndarray],
                                                                             np.ndarray]]:
    """The op table of ``manager`` dispatched over one replica per entry of
    ``devices`` (``rlvae_tpu/serving.py:99-170``, with a device list in
    place of JAX's mesh; a device may repeat, and the manager's own device
    is the manager itself: ``[manager.device]`` is the one-device table).

    A batch whose length the replica count does not divide is padded up by
    repeating its last row and cut back after the gather, so any bucket
    works.  Each replica gets a contiguous slice; all are launched before
    any output is copied back.  ``encode`` and ``decode`` are row-wise;
    ``reconstruct`` draws its posterior noise for the batch it is given
    from a generator on the manager's device seeded 0 (what
    ``manager.reconstruct(x, seed=0)`` draws), pads it as the rows and
    splits it with them; ``generate`` draws each row from its own seed, so
    padding never changes a row.  ``op.mesh`` is the device list and
    ``op.last_out_ndev`` the number of replicas the last dispatch ran on."""
    import torch

    replicas = [manager.replica(d) for d in devices]
    if not replicas:
        raise ValueError("make_sharded_ops needs at least one device")
    ndev = len(replicas)

    def generate(rep, seeds, _):
        if generate_method == "adaptive":  # every replica runs the manager's plan
            rep._adaptive_plan = manager.adaptive_plan()
        return rep.generate_rows(seeds, generate_method, generate_n_obs)

    def posterior_noise(n):
        gen = torch.Generator(device=manager.device).manual_seed(0)
        return manager.model.draw_posterior_noise(n, gen)

    def sharded(run, dtype, draw=None):
        def op(batch):
            batch = np.asarray(batch, dtype)
            n = batch.shape[0]
            m = -(-n // ndev) * ndev
            noise = draw(n) if draw is not None else None
            if m > n:
                batch = np.concatenate([batch, np.broadcast_to(batch[-1:],
                                                               (m - n, *batch.shape[1:]))])
                if noise is not None:
                    noise = {k: torch.cat([v, v[-1:].expand(m - n, *v.shape[1:])])
                             for k, v in noise.items()}
            per = m // ndev
            outs = [run(rep, batch[i * per:(i + 1) * per],
                        None if noise is None else {k: v[i * per:(i + 1) * per]
                                                    for k, v in noise.items()})
                    for i, rep in enumerate(replicas)]
            op.last_out_ndev = ndev
            return torch.cat([o.float().cpu() for o in outs]).numpy()[:n]

        op.mesh = tuple(r.device for r in replicas)
        op.last_out_ndev = 0
        return op

    return {"reconstruct": sharded(lambda rep, x, noise: rep.reconstruct_rows(x, noise=noise),
                                   np.float32, posterior_noise),
            "encode": sharded(lambda rep, x, _: rep.encode_rows(x)["embedding"], np.float32),
            "decode": sharded(lambda rep, z, _: rep.decode_rows(z), np.float32),
            "generate": sharded(generate, np.uint32)}


def _fail(reqs, exc: BaseException) -> None:
    for r in reqs:
        if not r.future.done():
            r.future.set_exception(exc)


class BatchingEngine:
    """Coalesce per-item requests into bucket-padded device batches.

    ``ops`` maps an op name to a callable taking a stacked ``[B, ...]``
    numpy array and returning a ``[B, ...]`` array-like whose row i answers
    input row i.
    """

    def __init__(self, ops: Dict[str, Callable[[np.ndarray], Any]],
                 config: ServeConfig = ServeConfig()):
        if not ops:
            raise ValueError("BatchingEngine needs at least one op")
        self.ops = dict(ops)
        self.config = config
        self._item_shapes: Dict[str, Optional[Tuple[int, ...]]] = {op: None for op in ops}
        self.stats = EngineStats(latencies_ms={op: collections.deque(maxlen=2048) for op in ops})
        self._queues: Dict[str, queue.Queue] = {
            op: queue.Queue(maxsize=config.queue_capacity) for op in ops
        }
        self._wakeup = threading.Event()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, name="serve-dispatch", daemon=True)
        self._thread.start()

    @classmethod
    def from_manager(cls, manager, config: ServeConfig = ServeConfig(),
                     generate_n_obs: int = 8, generate_method: str = "geodesic",
                     devices: Optional[Sequence[Any]] = None) -> "BatchingEngine":
        """The op table of a :class:`rlvae_tpu_torch.inference.ModelManager`:
        ``reconstruct`` (sequences), ``encode`` (frames -> embedding),
        ``decode`` (latents -> frames) and ``generate`` (one uint32 seed per
        item -> one sequence of ``generate_n_obs`` frames by
        ``generate_method``).  Requests with different seeds share a dispatch
        without changing any request's output
        (``ModelManager.sample_random_batched_seeds``).  The posterior noise
        of ``reconstruct`` is seeded with 0 for every batch, as the JAX
        engine's fixed key.

        The ops are :func:`make_sharded_ops` over ``devices``, the
        manager's own device by default; with more than one, every dispatch
        is split over one replica per device: data-parallel serving, the
        counterpart of JAX's ``mesh=``."""
        return cls(make_sharded_ops(manager, devices or [manager.device],
                                    generate_n_obs=generate_n_obs,
                                    generate_method=generate_method), config)

    # -- client side --------------------------------------------------------

    def submit(self, op: str, item: np.ndarray) -> Future:
        """Enqueue ONE item (no batch dim); the future resolves to its row."""
        if op not in self.ops:
            raise KeyError(f"unknown op {op!r}; have {sorted(self.ops)}")
        req = _Request(op, np.asarray(item))
        known = self._item_shapes.get(op)
        if known is not None and req.payload.shape != known:
            raise ValueError(
                f"item shape {req.payload.shape} != expected {known} for op {op!r}"
            )
        # the stop check and the enqueue are one atomic section against the
        # drain, so no request slips into a dead queue and strands its waiter
        with self._lock:
            if self._stop.is_set():
                raise RuntimeError("BatchingEngine is stopped")
            try:
                self._queues[op].put_nowait(req)
            except queue.Full:
                raise RuntimeError(
                    f"serving queue for {op!r} is full ({self.config.queue_capacity} pending)"
                ) from None
        self._wakeup.set()
        return req.future

    def run(self, op: str, item: np.ndarray, timeout: Optional[float] = 30.0):
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(op, item).result(timeout=timeout)

    def stats_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return self.stats.snapshot()

    def warmup(self, example_items: Dict[str, np.ndarray],
               buckets: Optional[Sequence[int]] = None) -> None:
        """Run every (op, bucket) once up front; ``example_items`` maps op ->
        one example item."""
        for op, item in example_items.items():
            fn = self.ops[op]
            self._item_shapes[op] = tuple(np.shape(item))
            for b in buckets or self.config.buckets:
                batch = np.broadcast_to(np.asarray(item)[None], (b, *np.shape(item))).copy()
                np.asarray(fn(batch))

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the dispatcher; requests still queued fail with RuntimeError."""
        self._stop.set()
        self._wakeup.set()
        self._thread.join(timeout=timeout)
        self._fail_queued(RuntimeError("BatchingEngine stopped before dispatch"))

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    # -- dispatcher ---------------------------------------------------------

    def _fail_queued(self, exc: BaseException) -> None:
        with self._lock:
            for op in self._queues:
                _fail(self._drain(op, self.config.queue_capacity), exc)

    def _bucket(self, n: int) -> int:
        for b in self.config.buckets:
            if b >= n:
                return b
        return self.config.max_batch

    def _drain(self, op: str, limit: int) -> List[_Request]:
        out: List[_Request] = []
        q = self._queues[op]
        while len(out) < limit:
            try:
                out.append(q.get_nowait())
            except queue.Empty:
                break
        return out

    def _oldest_op(self) -> Optional[str]:
        best, best_t = None, None
        for op, q in self._queues.items():
            with q.mutex:
                head = q.queue[0] if q.queue else None
            if head is not None and (best_t is None or head.t_enqueue < best_t):
                best, best_t = op, head.t_enqueue
        return best

    def _loop(self) -> None:
        cfg = self.config
        try:
            while not self._stop.is_set():
                op = self._oldest_op()
                if op is None:
                    self._wakeup.wait(timeout=0.05)
                    self._wakeup.clear()
                    continue
                if cfg.max_wait_ms > 0:
                    deadline = time.perf_counter() + cfg.max_wait_ms / 1e3
                    while (
                        time.perf_counter() < deadline
                        and self._queues[op].qsize() < cfg.max_batch
                        and not self._stop.is_set()
                    ):
                        time.sleep(min(0.0002, cfg.max_wait_ms / 1e3 / 4))
                reqs = self._drain(op, cfg.max_batch)
                if reqs:
                    self._dispatch(op, reqs)
        finally:
            # whatever ends the loop, no waiter is left behind: refuse new
            # requests and fail the queued ones
            with self._lock:
                self._stop.set()
            self._fail_queued(RuntimeError("BatchingEngine dispatcher exited"))

    def _dispatch(self, op: str, reqs: List[_Request]) -> None:
        shape0 = self._item_shapes.get(op) or reqs[0].payload.shape
        bad = [r for r in reqs if r.payload.shape != shape0]
        if bad:
            reqs = [r for r in reqs if r.payload.shape == shape0]
            for r in bad:
                _fail([r], ValueError(
                    f"item shape {r.payload.shape} != expected {shape0} for op {op!r}"
                ))
            if not reqs:
                return
        n = len(reqs)
        bucket = self._bucket(n)
        try:
            batch = np.stack([r.payload for r in reqs])
            if bucket > n:
                pad = np.broadcast_to(batch[-1:], (bucket - n, *batch.shape[1:]))
                batch = np.concatenate([batch, pad])
            t0 = time.perf_counter()
            out = np.asarray(self.ops[op](batch))
            dt_ms = (time.perf_counter() - t0) * 1e3
        except Exception as exc:  # the op's failure belongs to this batch's waiters
            _fail(reqs, exc)
            return
        if self._item_shapes.get(op) is None:
            self._item_shapes[op] = tuple(shape0)
        with self._lock:
            self.stats.requests += n
            self.stats.batches += 1
            self.stats.rows_real += n
            self.stats.rows_padded += bucket - n
            self.stats.batch_sizes[bucket] += 1
            self.stats.latencies_ms[op].append(dt_ms)
        for i, r in enumerate(reqs):
            if not r.future.done():
                r.future.set_result(out[i])
