"""Metrics files of a training run: the file part of
``rlvae_tpu/utils/logging.py:29-111``.

``log`` appends one JSON record per call to ``run_dir/metrics.jsonl``
(``_time``, ``_step`` when given, then the values as floats where they
convert), ``log_table`` writes ``run_dir/<name>.json`` and ``summary``
writes ``run_dir/summary.json``.  Each write opens, writes and closes its
file, so the logger holds nothing open and :meth:`finish` has nothing to
release.  ``float(v)`` of a tensor on the card waits for the card: callers
log only values they already read.  Weights & Biases is not ported: any
``mode`` other than ``"disabled"`` raises.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Mapping, Optional, Sequence


class MetricsLogger:
    def __init__(self, run_dir: str | Path, mode: str = "disabled"):
        if mode != "disabled":
            raise NotImplementedError(
                f"MetricsLogger(mode={mode!r}): only the local files are ported; "
                "pass mode='disabled'")
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)

    def log(self, metrics: Mapping[str, Any], step: Optional[int] = None) -> None:
        record: dict = {"_time": time.time()}
        if step is not None:
            record["_step"] = int(step)
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = v
        with open(self.run_dir / "metrics.jsonl", "a") as f:
            f.write(json.dumps(record) + "\n")

    def log_table(self, name: str, rows: Sequence[Mapping[str, Any]]) -> None:
        (self.run_dir / f"{name}.json").write_text(json.dumps(list(rows), indent=2, default=str))

    def summary(self, values: Mapping[str, Any]) -> None:
        (self.run_dir / "summary.json").write_text(json.dumps(dict(values), indent=2, default=str))

    def finish(self) -> None:
        """Every write is closed when it returns: nothing to release."""
