"""Centroid Riemannian metric, its loader, geodesics and curvature: the
exports of ``rlvae_tpu/geometry/__init__.py``."""

from rlvae_tpu_torch.geometry.geodesics import (
    christoffel,
    dg_inv,
    energy_path,
    exp_map,
    geodesic_interpolate,
    log_map,
    path_length,
)
from rlvae_tpu_torch.geometry.loader import (
    convert_metric_file,
    load_metric,
    save_metric,
    validate_metric_file,
)
from rlvae_tpu_torch.geometry.metric import (
    CentroidMetric,
    chol_g,
    chol_g_inv,
    diagnostics,
    dist2,
    g,
    g_inv,
    grad_log_sqrt_det_g_inv,
    log_sqrt_det_g_inv,
    logdet_g,
    logdet_g_inv,
    quadratic_form,
    weights,
)

__all__ = [
    "CentroidMetric",
    "weights",
    "g_inv",
    "g",
    "chol_g",
    "chol_g_inv",
    "logdet_g",
    "logdet_g_inv",
    "log_sqrt_det_g_inv",
    "grad_log_sqrt_det_g_inv",
    "dist2",
    "quadratic_form",
    "diagnostics",
    "load_metric",
    "save_metric",
    "validate_metric_file",
    "convert_metric_file",
    "christoffel",
    "dg_inv",
    "energy_path",
    "exp_map",
    "geodesic_interpolate",
    "log_map",
    "path_length",
]
