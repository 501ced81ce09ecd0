"""ModelManager + BatchingEngine of the port on the CPU, at a small width
(8x8 frames, two narrow flows, the shipped K=50 metric)."""

import threading
from pathlib import Path

import numpy as np
import pytest

from rlvae_tpu_torch import BatchingEngine, ModelManager, PRESETS, ServeConfig

DATA = Path(__file__).resolve().parents[1] / "data" / "pretrained"
SMALL = {
    **PRESETS["riemannian_flow_vae"],
    "input_dim": [3, 8, 8], "n_flows": 2, "flow_hidden_size": 32,
    "pretrained": {"metric_path": str(DATA / "metric_T0.7_scaled.npz")},
}
T = 4


@pytest.fixture(scope="module")
def manager():
    return ModelManager.from_config(SMALL, seed=0, device="cpu")


def _seqs(n, seed=0):
    return np.random.default_rng(seed).uniform(size=(n, T, 3, 8, 8)).astype(np.float32)


def test_manager_ops(manager):
    x = _seqs(3)
    rec = manager.reconstruct(x)
    assert rec.shape == x.shape and np.all(np.isfinite(rec))
    np.testing.assert_array_equal(rec, manager.reconstruct(x))  # seeded noise
    z = manager.embed_sequence(x)
    assert z.shape == (3, T, 16) and np.all(np.isfinite(z))
    enc = manager.encode(x[:, 0])
    assert enc.embedding.shape == (3, 16) and enc.log_covariance.shape == (3, 16)
    assert manager.decode(enc.embedding).shape == (3, 3, 8, 8)


def test_engine_result_equals_manager(manager):
    """A full bucket coalesced into one dispatch answers each row as
    ModelManager.reconstruct on the same batch."""
    x = _seqs(4, seed=1)
    engine = BatchingEngine.from_manager(manager, ServeConfig(buckets=(4,), max_wait_ms=2000))
    try:
        futs = [engine.submit("reconstruct", x[i]) for i in range(4)]
        rows = np.stack([f.result(timeout=30) for f in futs])
        assert engine.stats_snapshot()["batches"] == 1
    finally:
        engine.stop()
    np.testing.assert_array_equal(rows, manager.reconstruct(x))


def test_engine_concurrent_requests_buckets_and_stats(manager):
    engine = BatchingEngine.from_manager(manager, ServeConfig(buckets=(1, 2, 4, 8), max_wait_ms=5))
    x = _seqs(16, seed=2)
    results, errors = {}, []

    def client(tid):
        try:
            for j in range(2):
                i = 2 * tid + j
                results[i] = engine.submit("reconstruct", x[i]).result(timeout=60)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
        for t in threads:
            t.start()
        enc = [engine.submit("encode", x[i, 0]) for i in range(3)]
        dec = [engine.submit("decode", np.zeros(16, np.float32)) for _ in range(3)]
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and not errors
        assert all(f.result(timeout=30).shape == (16,) for f in enc)
        assert all(f.result(timeout=30).shape == (3, 8, 8) for f in dec)
        assert sorted(results) == list(range(16))
        assert all(r.shape == (T, 3, 8, 8) and np.all(np.isfinite(r)) for r in results.values())
        snap = engine.stats_snapshot()
        assert snap["requests"] == 22
        assert set(snap["batch_size_hist"]) <= {1, 2, 4, 8}
        padded_rows = sum(b * c for b, c in snap["batch_size_hist"].items())
        assert engine.stats.rows_real == 22
        assert engine.stats.rows_real + engine.stats.rows_padded == padded_rows
        assert "reconstruct_p50_ms" in snap
        with pytest.raises(KeyError):
            engine.submit("interpolate", np.zeros((), np.uint32))
        with pytest.raises(ValueError):
            engine.submit("reconstruct", np.zeros((T + 1, 3, 8, 8), np.float32))
    finally:
        engine.stop()
    assert not engine.alive
    with pytest.raises(RuntimeError):
        engine.submit("encode", x[0, 0])


def test_dispatcher_error_reaches_future():
    def boom(batch):
        raise FloatingPointError("kernel failed")

    engine = BatchingEngine({"boom": boom, "echo": lambda b: b * 2},
                            ServeConfig(buckets=(1, 2), max_wait_ms=0))
    try:
        with pytest.raises(FloatingPointError):
            engine.submit("boom", np.ones(3, np.float32)).result(timeout=10)
        # the dispatcher survives its op's failure and keeps serving
        np.testing.assert_array_equal(engine.run("echo", np.ones(3, np.float32), timeout=10),
                                      np.full(3, 2.0, np.float32))
    finally:
        engine.stop()


def test_queued_requests_fail_when_stopped():
    """stop() while a dispatch is running: that batch completes, and every
    request still queued resolves (served or RuntimeError) instead of hanging."""
    started, gate = threading.Event(), threading.Event()

    def slow(batch):
        started.set()
        gate.wait(timeout=10)
        return batch

    engine = BatchingEngine({"slow": slow}, ServeConfig(buckets=(1,), max_wait_ms=0))
    first = engine.submit("slow", np.zeros(1))
    assert started.wait(timeout=10)
    queued = [engine.submit("slow", np.zeros(1)) for _ in range(3)]
    stopper = threading.Thread(target=engine.stop, kwargs={"timeout": 10})
    stopper.start()
    gate.set()
    stopper.join(timeout=20)
    assert not stopper.is_alive() and not engine.alive
    first.result(timeout=10)
    for f in queued:
        exc = f.exception(timeout=10)
        assert exc is None or isinstance(exc, RuntimeError)
