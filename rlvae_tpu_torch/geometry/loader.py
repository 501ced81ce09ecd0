"""Pretrained-metric loading from ``.npz`` and ``.pt`` artifacts.

Port of ``rlvae_tpu/geometry/loader.py``: the same key
aliases, overrides, defaults, validation report, save and conversion (in
the canonical keys, so each package reads the other's files), and the
reference's ``.pt`` artifacts through torch (:func:`read_raw`).
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from rlvae_tpu_torch.geometry.metric import CentroidMetric

CENTROID_KEYS = ("centroids", "metric_centroids", "centers", "mu")
MATRIX_KEYS = ("M_matrices", "metric_vars", "M_tens")
DIAG_MATRIX_KEYS = ("M_i_flat",)
TEMPERATURE_KEYS = ("temperature", "metric_temperature", "temp", "T", "beta")
REGULARIZATION_KEYS = ("regularization", "metric_regularization", "reg", "lambda", "lbd")

DEFAULT_TEMPERATURE = 0.1
DEFAULT_REGULARIZATION = 0.01


def read_raw(path: str | Path) -> Dict[str, np.ndarray]:
    """Read a metric ``.npz``, or a reference ``.pt`` (a dict of tensors and
    numbers, read with ``torch.load(weights_only=True)``), into a dict of
    arrays.  A name that does not exist resolves to its ``.npz`` sibling,
    then its ``.pt`` one, as the JAX package's ``read_raw``."""
    path = Path(path)
    if not path.exists() or path.suffix not in (".npz", ".pt"):
        for alt in (path.with_suffix(".npz"), path.with_suffix(".pt")):
            if alt.exists():
                path = alt
                break
        else:
            raise FileNotFoundError(f"Metric file not found: {path.with_suffix('.npz')}")
    if path.suffix == ".pt":
        import torch

        data = torch.load(path, map_location="cpu", weights_only=True)
        if not isinstance(data, dict):
            raise ValueError(f"Expected a dict in {path}, got {type(data)}")
        return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                for k, v in data.items()}
    with np.load(path, allow_pickle=False) as zf:
        return {k: zf[k] for k in zf.files}


def extract_components(
    data: Dict[str, Any],
    temperature_override: Optional[float] = None,
    regularization_override: Optional[float] = None,
) -> Dict[str, Any]:
    """(centroids, matrices, temperature, regularization) from a raw dict."""
    centroids = None
    for key in CENTROID_KEYS:
        if key in data:
            centroids = np.asarray(data[key], np.float32)
            break
    if centroids is None:
        raise ValueError(f"No centroids found. Expected one of: {list(CENTROID_KEYS)}")
    n_centroids, latent_dim = centroids.shape

    matrices = None
    for key in MATRIX_KEYS:
        if key in data:
            matrices = np.asarray(data[key], np.float32)
            break
    if matrices is None:
        for key in DIAG_MATRIX_KEYS:
            if key in data:
                flat = np.asarray(data[key], np.float32)
                matrices = np.zeros((n_centroids, latent_dim, latent_dim), np.float32)
                idx = np.arange(latent_dim)
                matrices[:, idx, idx] = flat
                break
    if matrices is None:
        warnings.warn("No metric matrices found, using identity matrices")
        matrices = np.broadcast_to(
            np.eye(latent_dim, dtype=np.float32), (n_centroids, latent_dim, latent_dim)
        ).copy()
    if matrices.shape != (n_centroids, latent_dim, latent_dim):
        raise ValueError(
            f"Metric matrices shape {matrices.shape} != expected "
            f"{(n_centroids, latent_dim, latent_dim)}"
        )

    def scalar(keys, override, default, label):
        if override is not None:
            return float(override)
        for key in keys:
            if key in data:
                return float(np.asarray(data[key]))
        warnings.warn(f"No {label} found, using default: {default}")
        return default

    return {
        "centroids": centroids,
        "matrices": matrices,
        "temperature": scalar(
            TEMPERATURE_KEYS, temperature_override, DEFAULT_TEMPERATURE, "temperature"
        ),
        "regularization": scalar(
            REGULARIZATION_KEYS, regularization_override, DEFAULT_REGULARIZATION,
            "regularization",
        ),
    }


def validate_components(centroids: np.ndarray, matrices: np.ndarray) -> Dict[str, Any]:
    """Consistency / NaN checks (raise) and a PSD check (warn), as the JAX
    loader, with its report dict."""
    report: Dict[str, Any] = {
        "n_centroids": int(centroids.shape[0]),
        "latent_dim": int(centroids.shape[1]),
        "shapes_consistent": matrices.shape
        == (centroids.shape[0], centroids.shape[1], centroids.shape[1]),
        "centroids_finite": bool(np.isfinite(centroids).all()),
        "matrices_finite": bool(np.isfinite(matrices).all()),
    }
    if not report["shapes_consistent"]:
        raise ValueError(
            f"Inconsistent shapes: centroids {centroids.shape}, matrices {matrices.shape}"
        )
    if not (report["centroids_finite"] and report["matrices_finite"]):
        raise ValueError("Metric data contains NaN or inf values")
    min_eig = float(np.linalg.eigvalsh(matrices.astype(np.float64)).min())
    report["min_eigenvalue"] = min_eig
    report["all_psd"] = bool(min_eig >= -1e-6)
    if not report["all_psd"]:
        warnings.warn(
            f"Some metric matrices are not positive semidefinite (min eigval {min_eig:.3e})"
        )
    report["valid"] = (report["shapes_consistent"] and report["centroids_finite"]
                       and report["matrices_finite"])
    return report


def load_metric(
    path: str | Path,
    temperature_override: Optional[float] = None,
    regularization_override: Optional[float] = None,
    validate: bool = True,
) -> CentroidMetric:
    """Load a :class:`CentroidMetric` from a ``.npz`` artifact."""
    comp = extract_components(read_raw(path), temperature_override, regularization_override)
    if validate:
        validate_components(comp["centroids"], comp["matrices"])
    return CentroidMetric.create(
        comp["centroids"], comp["matrices"], comp["temperature"],
        comp["regularization"],
    )


def validate_metric_file(path: str | Path) -> Dict[str, Any]:
    """Standalone validation report for a metric file."""
    comp = extract_components(read_raw(path))
    report = validate_components(comp["centroids"], comp["matrices"])
    report["temperature"] = comp["temperature"]
    report["regularization"] = comp["regularization"]
    return report


def save_metric(metric: CentroidMetric, path: str | Path) -> None:
    """Save in the canonical ``.npz`` format, with the JAX package's key
    names and dtypes, so each package loads the other's files."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(
        path,
        centroids=metric.centroids.detach().float().cpu().numpy(),
        M_matrices=metric.matrices.detach().float().cpu().numpy(),
        temperature=np.float32(metric.temperature),
        regularization=np.float32(metric.regularization),
        latent_dim=np.int32(metric.latent_dim),
        n_centroids=np.int32(metric.n_centroids),
    )


def convert_metric_file(src: str | Path, dst: str | Path, **overrides) -> Dict[str, Any]:
    """Convert a metric artifact (any key aliases) to canonical ``.npz``;
    returns the report of the written file."""
    save_metric(load_metric(src, **overrides), dst)
    return validate_metric_file(dst)
