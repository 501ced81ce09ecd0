"""Visualization levels, frequencies and the trainer's epoch-end hook; the
plotting modules are ``basic``, ``manifold``, ``flow_analysis`` and
``interactive``."""

from rlvae_tpu_torch.viz.manager import (
    VisualizationConfig,
    VisualizationLevel,
    VisualizationManager,
    make_viz_hook,
)

__all__ = ["VisualizationConfig", "VisualizationLevel", "VisualizationManager", "make_viz_hook"]
