"""Standalone serving host for exported bundles: the deployment endpoint.

Port of ``rlvae_tpu/bundle_server.py``.  A host with torch, the port's
registered kernel ops (:mod:`rlvae_tpu_torch.ops.export_ops`, which the
bundle's programs call) and an exported bundle (:mod:`rlvae_tpu_torch.export`)
serves the model over HTTP with dynamic batching.  It imports no model class
and reads no checkpoint: the programs are loaded from disk and fed to the
:class:`~rlvae_tpu_torch.serving.BatchingEngine` through
:meth:`~rlvae_tpu_torch.export.ExportedModel.as_ops`.

API (JSON over stdlib HTTP):

- ``GET  /ops``      ops, buckets, shapes from the manifest
- ``GET  /stats``    engine batching/latency stats
- ``POST /v1/<op>``  ``{"items": [<nested-list item>, ...]}`` ->
  ``{"outputs": [...]}``; items are submitted one by one, so concurrent
  clients coalesce into shared device calls.

Run: ``python -m rlvae_tpu_torch.bundle_server <bundle_dir> [--port N]
[--device cpu]`` (the card by default).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from rlvae_tpu_torch.device import DeviceLike
from rlvae_tpu_torch.export import ExportedModel, load_exported
from rlvae_tpu_torch.serving import BatchingEngine, ServeConfig

__all__ = ["serve_bundle"]

REQUEST_TIMEOUT_S = 600.0  # the longest a request waits on its row


def _make_handler(exported, engine):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, obj, status=200):
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/ops":
                return self._json({
                    "ops": {op: list(exported.buckets(op)) for op in exported.ops},
                    "manifest": {k: v for k, v in exported.manifest.items() if k != "programs"},
                })
            if self.path == "/stats":
                return self._json(engine.stats_snapshot())
            return self._json({"error": "not found"}, 404)

        def do_POST(self):
            try:
                if not self.path.startswith("/v1/"):
                    return self._json({"error": "not found"}, 404)
                op = self.path[len("/v1/"):]
                if op not in exported.ops:
                    return self._json({"error": f"unknown op {op!r}", "ops": list(exported.ops)},
                                      404)
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                items = payload.get("items")
                if not isinstance(items, list) or not items:
                    return self._json({"error": "'items' must be a non-empty list"}, 400)
                dtype = np.dtype(
                    next(iter(exported.manifest["programs"][op].values()))["in_dtype"])
                futures = [engine.submit(op, np.asarray(item, dtype=dtype)) for item in items]
                outs = [np.asarray(f.result(timeout=REQUEST_TIMEOUT_S)).tolist()
                        for f in futures]
                return self._json({"outputs": outs})
            except Exception as e:
                return self._json({"error": f"{type(e).__name__}: {e}"}, 500)

    return Handler


def serve_bundle(bundle_dir: str | Path | ExportedModel, port: int = 0, block: bool = False,
                 max_wait_ms: float = 2.0, device: DeviceLike = None):
    """Serve an exported bundle (a directory, loaded on ``device``, the card
    by default; or an already loaded :class:`ExportedModel`).  Returns
    ``(httpd, engine)`` when ``block=False``; the caller stops both
    (``httpd.shutdown()``, ``engine.stop()``).  The engine's buckets are the
    bundle's."""
    exported = (bundle_dir if isinstance(bundle_dir, ExportedModel)
                else load_exported(bundle_dir, device=device))
    buckets = tuple(sorted({b for op in exported.ops for b in exported.buckets(op)}))
    engine = BatchingEngine(exported.as_ops(), ServeConfig(buckets=buckets,
                                                           max_wait_ms=max_wait_ms))
    try:
        httpd = ThreadingHTTPServer(("127.0.0.1", port), _make_handler(exported, engine))
    except BaseException:
        engine.stop()
        raise
    if block:
        print(f"[bundle] serving {bundle_dir} on http://127.0.0.1:{httpd.server_address[1]}")
        try:
            httpd.serve_forever()
        finally:
            engine.stop()
    else:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, engine


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Serve an exported bundle over HTTP.")
    ap.add_argument("bundle_dir")
    ap.add_argument("--port", type=int, default=8018)
    ap.add_argument("--device", default=None, help="device to serve on (default: the card)")
    args = ap.parse_args(argv)
    serve_bundle(args.bundle_dir, port=args.port, block=True, device=args.device)


if __name__ == "__main__":
    main()
