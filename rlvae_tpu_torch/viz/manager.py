"""Visualization manager: levels and per-category frequencies; the port of
``rlvae_tpu/viz/manager.py:20-145``.

Five levels MINIMAL..FULL and per-category toggles (basic, manifold,
interactive, flow analysis) with their own epoch frequencies, dispatched at
each epoch end by the hook :func:`make_viz_hook` builds for the trainer.
The frequency rules are JAX's: nothing runs unless ``epoch % frequency ==
0``; then each enabled category runs when ``epoch % <category>_frequency ==
0``; manifold and flow analysis need level STANDARD or above, interactive
ADVANCED or above.  The category modules (``basic.py``, ``manifold.py``,
``flow_analysis.py``, ``interactive.py``) are imported when the manager is
built, as JAX's are, and share one forward per epoch.  A module that raises
is reported as JAX reports it, with a ``viz/error`` record through the
logger and a printed WARNING, without stopping training.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from pathlib import Path
from typing import Any, List, Mapping

from rlvae_tpu_torch.viz.base import SharedForward


class VisualizationLevel(enum.IntEnum):
    MINIMAL = 0
    BASIC = 1
    STANDARD = 2
    ADVANCED = 3
    FULL = 4

    @classmethod
    def from_name(cls, name: str) -> "VisualizationLevel":
        return cls[str(name).upper()]


@dataclass
class VisualizationConfig:
    level: VisualizationLevel = VisualizationLevel.STANDARD
    frequency: int = 5
    enable_basic: bool = True
    enable_manifold: bool = False
    enable_interactive: bool = False
    enable_flow_analysis: bool = False
    basic_frequency: int = 5
    manifold_frequency: int = 10
    interactive_frequency: int = 20
    flow_frequency: int = 10
    max_sequences: int = 8
    disable_curvature: bool = True
    enable_fancy_plots: bool = False
    save_local: bool = True
    log_to_wandb: bool = True

    @classmethod
    def from_mapping(cls, cfg: Mapping[str, Any]) -> "VisualizationConfig":
        level = VisualizationLevel.from_name(cfg.get("level", "standard"))
        kwargs = {k: cfg[k] for k in cls.__dataclass_fields__ if k in cfg and k != "level"}
        return cls(level=level, **kwargs)


class VisualizationManager:
    """Dispatches category modules per epoch by level and frequencies."""

    def __init__(self, config: VisualizationConfig, output_dir: str | Path, logger=None):
        self.config = config
        self.output_dir = Path(output_dir)
        self.logger = logger
        self.modules: List[Any] = []
        self._forward = SharedForward()  # one forward per epoch for every module
        self._build_modules()
        for module, _ in self.modules:
            module._forward = self._forward

    def _build_modules(self) -> None:
        cfg, lvl = self.config, self.config.level
        args = (cfg, self.output_dir, self.logger)
        if cfg.enable_basic:
            from rlvae_tpu_torch.viz.basic import BasicVisualizations

            self.modules.append((BasicVisualizations(*args), cfg.basic_frequency))
        if cfg.enable_manifold and lvl >= VisualizationLevel.STANDARD:
            from rlvae_tpu_torch.viz.manifold import ManifoldVisualizations

            self.modules.append((ManifoldVisualizations(*args), cfg.manifold_frequency))
        if cfg.enable_flow_analysis and lvl >= VisualizationLevel.STANDARD:
            from rlvae_tpu_torch.viz.flow_analysis import FlowAnalysisVisualizations

            self.modules.append((FlowAnalysisVisualizations(*args), cfg.flow_frequency))
        if cfg.enable_interactive and lvl >= VisualizationLevel.ADVANCED:
            from rlvae_tpu_torch.viz.interactive import InteractiveVisualizations

            self.modules.append((InteractiveVisualizations(*args), cfg.interactive_frequency))

    def visualize_epoch(self, epoch: int, model, variables, sample_batch) -> List[Path]:
        """Run the modules due this epoch; returns the files they wrote."""
        if self.config.frequency <= 0 or epoch % self.config.frequency != 0:
            return []
        self._forward.reset()
        written: List[Path] = []
        for module, freq in self.modules:
            if freq > 0 and epoch % freq == 0:
                try:
                    written.extend(module.run(epoch, model, variables, sample_batch) or [])
                except Exception as e:  # a plot must not stop training, nor fail unseen
                    msg = f"{type(module).__name__} failed at epoch {epoch}: {e}"
                    if self.logger is not None:
                        self.logger.log({"viz/error": msg, "epoch": epoch})
                    print(f"[viz] WARNING: {msg}")
        return written


def make_viz_hook(viz_config: Mapping[str, Any], data_module, run_dir: str | Path, logger=None):
    """The trainer's epoch-end hook, or None for an empty config."""
    if not viz_config:
        return None
    config = VisualizationConfig.from_mapping(viz_config)
    manager = VisualizationManager(config, Path(run_dir) / "visualizations", logger)

    def hook(epoch: int, model, variables, trainer=None):
        sample = data_module.get_sample_batch("val", n=config.max_sequences)
        manager.visualize_epoch(epoch, model, variables, sample)

    return hook
