"""MetricsCollector: cross-model metric aggregation for comparison studies;
the port of ``rlvae_tpu/models/metrics.py``."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping


class MetricsCollector:
    def __init__(self):
        self.model_metrics: Dict[str, List[Dict[str, float]]] = {}

    def add_model_metrics(self, model_name: str, metrics: Mapping[str, float]) -> None:
        self.model_metrics.setdefault(model_name, []).append(
            {k: float(v) for k, v in metrics.items()}
        )

    def get_comparison_summary(self) -> Dict[str, Any]:
        """Per model and metric: ``<key>_mean``, ``<key>_std`` (population)
        and ``<key>_final`` over the recorded entries."""
        summary: Dict[str, Any] = {}
        for model_name, metrics_list in self.model_metrics.items():
            if not metrics_list:
                continue
            aggregated: Dict[str, float] = {}
            for key in metrics_list[0]:
                values = [m[key] for m in metrics_list if key in m]
                if not values:
                    continue
                mean = sum(values) / len(values)
                aggregated[f"{key}_mean"] = mean
                aggregated[f"{key}_std"] = math.sqrt(
                    sum((x - mean) ** 2 for x in values) / len(values)
                )
                aggregated[f"{key}_final"] = values[-1]
            summary[model_name] = aggregated
        return summary

    def log_comparison(self, logger) -> None:
        """Log the comparison table through a metrics logger."""
        summary = self.get_comparison_summary()
        rows = [{"model": name, **metrics} for name, metrics in summary.items()]
        if rows and logger is not None:
            logger.log_table("comparison_summary", rows)
