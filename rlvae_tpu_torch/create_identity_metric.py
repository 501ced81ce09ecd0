"""An identity-matrices metric from an existing metric's centroids.

Port of ``scripts/create_identity_metric_temp_0_7.py``: the centroids of
``src`` kept (the first ``--n-centroids`` of them when given), every M_k
the identity, the temperature set to ``--temperature`` (0.7 by default)
and the regularization kept.  Reads ``.npz`` or the reference's ``.pt``
(:func:`~rlvae_tpu_torch.geometry.loader.load_metric`), writes the
canonical ``.npz`` (:func:`~rlvae_tpu_torch.geometry.loader.save_metric`).

Run: ``python -m rlvae_tpu_torch.create_identity_metric SRC OUT
[--temperature 0.7] [--n-centroids K]``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from rlvae_tpu_torch.geometry.loader import load_metric, save_metric
from rlvae_tpu_torch.geometry.metric import CentroidMetric


def identity_metric(src: CentroidMetric, temperature: float = 0.7,
                    n_centroids: int | None = None) -> CentroidMetric:
    """``src``'s centroids (the head ``n_centroids``) with identity M_k at
    ``temperature``, ``src``'s regularization."""
    centroids = src.centroids.detach().cpu().numpy()
    if n_centroids:
        centroids = centroids[:n_centroids]
    k, d = centroids.shape
    identity = np.broadcast_to(np.eye(d, dtype=np.float32), (k, d, d)).copy()
    return CentroidMetric.create(centroids, identity, temperature=temperature,
                                 regularization=float(src.regularization))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Identity-matrices metric from a metric's centroids.")
    ap.add_argument("src", type=Path, help="source metric (.npz/.pt)")
    ap.add_argument("out", type=Path)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--n-centroids", type=int, default=None,
                    help="subsample this many centroids (head)")
    args = ap.parse_args(argv)
    metric = identity_metric(load_metric(args.src), args.temperature, args.n_centroids)
    save_metric(metric, args.out)
    print(f"wrote {args.out}: {metric.n_centroids} centroids, identity M, T={args.temperature}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
