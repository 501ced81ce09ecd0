"""Metrics logging: local files, a live ``on_log`` hook and optional
Weights & Biases; the port of ``rlvae_tpu/utils/logging.py:29-111``.

``log`` appends one JSON record per call to ``run_dir/metrics.jsonl``
(``_time``, ``_step`` when given, then the values as floats where they
convert) and hands the record to ``on_log``; ``log_table`` writes
``run_dir/<name>.json`` and ``summary`` writes ``run_dir/summary.json``.
Each write opens, writes and closes its file.  ``float(v)`` of a tensor on
the card waits for the card: callers log only values they already read.

``mode`` is ``"online"``, ``"offline"`` or ``"disabled"``.  Any mode but
``disabled`` starts a wandb run when ``wandb`` imports and mirrors every
``log``, ``log_table``, ``log_image`` and ``summary`` to it; without wandb
the logger keeps to the local files, as JAX's does.  In a
``torch.distributed`` world only rank 0 writes and logs (JAX's process 0):
on every other rank each method does nothing.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Callable, Mapping, Optional, Sequence

from rlvae_tpu_torch.device import is_main_process


def _wandb():
    try:
        import wandb
    except ImportError:
        return None
    return wandb


class MetricsLogger:
    def __init__(self, run_dir: str | Path, project: Optional[str] = None,
                 run_name: Optional[str] = None, config: Optional[Mapping[str, Any]] = None,
                 mode: str = "disabled", on_log: Optional[Callable[[dict], Any]] = None):
        self.run_dir = Path(run_dir)
        # a live-progress consumer (an app's progress bar): gets every record
        self.on_log = on_log
        self.wandb_run = None
        self.is_main = is_main_process()
        if not self.is_main:
            return
        self.run_dir.mkdir(parents=True, exist_ok=True)
        (self.run_dir / "metrics.jsonl").touch()  # present from the start, as JAX's
        wandb = _wandb() if mode != "disabled" else None
        if wandb is not None:
            self.wandb_run = wandb.init(project=project, name=run_name,
                                        config=dict(config or {}), mode=mode,
                                        dir=str(self.run_dir))

    def log(self, metrics: Mapping[str, Any], step: Optional[int] = None) -> None:
        if not self.is_main:
            return
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
        if self.on_log is not None:
            try:
                self.on_log(record)
            except Exception as e:  # a broken progress consumer must not stop training
                print(f"[rlvae] WARNING: on_log failed: {type(e).__name__}: {e}")
        if self.wandb_run is not None:
            self.wandb_run.log(dict(metrics), step=step)

    def log_table(self, name: str, rows: Sequence[Mapping[str, Any]]) -> None:
        if not self.is_main:
            return
        (self.run_dir / f"{name}.json").write_text(json.dumps(list(rows), indent=2, default=str))
        if self.wandb_run is not None:
            import wandb

            cols = sorted({k for r in rows for k in r})
            table = wandb.Table(columns=cols)
            for r in rows:
                table.add_data(*[r.get(c) for c in cols])
            self.wandb_run.log({name: table})

    def log_image(self, name: str, path: str | Path, step: Optional[int] = None) -> None:
        """An image file, to the wandb run (there is no local record of it:
        the file is already in the run directory)."""
        if self.wandb_run is not None:
            import wandb

            self.wandb_run.log({name: wandb.Image(str(path))}, step=step)

    def summary(self, values: Mapping[str, Any]) -> None:
        if not self.is_main:
            return
        (self.run_dir / "summary.json").write_text(json.dumps(dict(values), indent=2, default=str))
        if self.wandb_run is not None:
            for k, v in values.items():
                self.wandb_run.summary[k] = v

    def finish(self) -> None:
        """Close the wandb run; the local files are closed after every write."""
        if self.wandb_run is not None:
            self.wandb_run.finish()
            self.wandb_run = None
