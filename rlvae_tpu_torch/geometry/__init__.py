"""Centroid Riemannian metric and its loader."""

from rlvae_tpu_torch.geometry.loader import load_metric
from rlvae_tpu_torch.geometry.metric import CentroidMetric

__all__ = ["CentroidMetric", "load_metric"]
