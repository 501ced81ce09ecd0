"""Canonical data and pretrained-artifact paths, and ``validate_paths``:
the port's counterpart of ``rlvae_tpu/config/paths.py``.

The paths are not a table of their own: they are the data preset's
(``data.cyclic.CYCLIC_SPRITES``) and the model presets' pretrained paths
(``models.factory``), against the repository root that
``models.factory.resolve_artifact`` also resolves relative paths against.
"""

from __future__ import annotations

from typing import Dict

from rlvae_tpu_torch.data.cyclic import CYCLIC_SPRITES
from rlvae_tpu_torch.models.factory import HYBRID_RLVAE, REPO_ROOT, RIEMANNIAN_FLOW_VAE

PROJECT_ROOT = REPO_ROOT
TRAIN_DATA_PATH = PROJECT_ROOT / CYCLIC_SPRITES["train_path"]
TEST_DATA_PATH = PROJECT_ROOT / CYCLIC_SPRITES["test_path"]
ENCODER_PATH = PROJECT_ROOT / RIEMANNIAN_FLOW_VAE["pretrained"]["encoder_path"]
DECODER_PATH = PROJECT_ROOT / RIEMANNIAN_FLOW_VAE["pretrained"]["decoder_path"]
METRIC_PATH = PROJECT_ROOT / HYBRID_RLVAE["pretrained"]["metric_path"]
METRIC_T07_PATH = PROJECT_ROOT / RIEMANNIAN_FLOW_VAE["pretrained"]["metric_path"]


def validate_paths(require_pretrained: bool = False) -> Dict[str, bool]:
    """Which canonical artifacts exist.  Returns the status dict (callers
    fall back to synthetic data); with ``require_pretrained`` a missing one
    raises ``FileNotFoundError``."""
    status = {
        "train_data": TRAIN_DATA_PATH.exists(),
        "test_data": TEST_DATA_PATH.exists(),
        "encoder": ENCODER_PATH.exists(),
        "decoder": DECODER_PATH.exists(),
        "metric": METRIC_PATH.exists(),
        "metric_T0.7": METRIC_T07_PATH.exists(),
    }
    if require_pretrained and not all(status.values()):
        missing = [k for k, v in status.items() if not v]
        raise FileNotFoundError(f"Missing required data artifacts: {missing}")
    return status
