"""Experiment CLI: Hydra-style runs of the port, the counterpart of the
repository's ``run_experiment.py``.

    python -m rlvae_tpu_torch.experiment model=vanilla_vae training=quick visualization=minimal
    python -m rlvae_tpu_torch.experiment experiment=comparison_study
    python -m rlvae_tpu_torch.experiment -m model.riemannian_beta=0.5,8.0 training=quick

The config is composed from the repository's ``conf/`` directory
(:func:`rlvae_tpu_torch.config.compose`) with the overrides given.  The
experiment types are ``single``, ``comparison`` (one model per
``experiment.models`` entry, ``vanilla_vae`` through
``apply_model_overrides``) and ``sweep`` (the grid of
``experiment.sweep.parameters``, ranked by ``experiment.objective``; a run
whose objective is NaN or missing ranks last); ``-m``/``--multirun`` runs
one job per combination of comma-separated override values, job ``i`` in
``<sweep.dir>/<i>``.  A run directory (``run.dir``) receives
``config.yaml`` (the composed config, as YAML), ``metrics.jsonl``,
``summary.json``, ``checkpoints/{best,last}`` and ``results.yaml``: the
files the JAX runner writes.  ``ModelManager.from_run`` serves a run from
its directory.

Runs go to the CUDA card unless the composed config asks for the CPU
(``training.trainer.accelerator=cpu``); without a card the runner raises
before it writes anything.  JAX's persistent XLA compilation cache has no
counterpart here: the port's kernels are built once per process
(``rlvae_tpu_torch.ops.build``).
"""

from __future__ import annotations

import itertools
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from rlvae_tpu_torch.config import (
    Config,
    assert_valid,
    coerce_scalar,
    compose,
    expand_multirun,
    save_config,
)
from rlvae_tpu_torch.config.compose import dump_yaml
from rlvae_tpu_torch.models.factory import REPO_ROOT
from rlvae_tpu_torch.train.trainer import resolve_trainer_device

CONF_DIR = REPO_ROOT / "conf"


class ExperimentRunner:
    """Runs single experiments, comparison studies and sweeps from a
    composed config.  ``progress_callback`` receives every metrics record;
    ``stop_event`` (anything with ``is_set()``) stops training at the next
    epoch boundary, resumably."""

    def __init__(self, config: Config, progress_callback=None, stop_event=None):
        assert_valid(config.to_dict())
        # fail on a missing card or an unported device setting before any file is written
        resolve_trainer_device(config.get("training.trainer") or {})
        self.config = config
        self.progress_callback = progress_callback
        self.stop_event = stop_event
        self.run_dir = Path(config.get("run.dir", "outputs/run"))
        self.run_dir.mkdir(parents=True, exist_ok=True)
        save_config(config, self.run_dir / "config.yaml")

    def run(self):
        etype = self.config.get("experiment.type", "single")
        if etype == "single":
            return self.run_single_experiment()
        if etype == "comparison":
            return self.run_comparison_study()
        if etype == "sweep":
            return self.run_hyperparameter_sweep()
        raise ValueError(f"Unknown experiment type: {etype}")

    def _build(self, model_cfg: dict, run_dir: Path, run_name: str):
        from rlvae_tpu_torch.data import CyclicDataModule
        from rlvae_tpu_torch.models import create_model
        from rlvae_tpu_torch.train import Trainer
        from rlvae_tpu_torch.utils.logging import MetricsLogger
        from rlvae_tpu_torch.viz import make_viz_hook

        seed = int(self.config.get("seed", 42))
        data_module = CyclicDataModule(self.config.data.to_dict(), seed=seed)
        data_module.setup(self.config.training.to_dict())

        # model.input_dim follows the dataset's geometry
        data_dim = [
            int(self.config.get("data.channels", 3)),
            *[int(v) for v in self.config.get("data.image_size", [64, 64])],
        ]
        if list(model_cfg.get("input_dim", data_dim)) != data_dim:
            print(f"[rlvae] overriding model.input_dim {model_cfg['input_dim']} -> {data_dim} "
                  "(from data config)")
            model_cfg = {**model_cfg, "input_dim": data_dim}
            # the saved config must rebuild the model the checkpoints belong to
            self.config.set("model.input_dim", data_dim)
            save_config(self.config, run_dir / "config.yaml")

        model = create_model(model_cfg, seed=seed, name=run_name)
        logger = MetricsLogger(
            run_dir,
            project=self.config.get("wandb.project"),
            run_name=run_name,
            config=self.config.to_dict(),
            mode=self.config.get("wandb.mode", "disabled"),
            on_log=self.progress_callback,
        )
        viz = self.config.get("visualization")
        viz_hook = make_viz_hook(viz.to_dict() if viz is not None else {}, data_module,
                                 run_dir, logger)
        trainer = Trainer(
            model,
            data_module,
            self.config.training.to_dict(),
            run_dir=run_dir,
            logger=logger,
            viz_hook=viz_hook,
            seed=seed,
            stop_flag=self.stop_event.is_set if self.stop_event is not None else None,
        )
        return model, data_module, trainer, logger

    @staticmethod
    def _test_metrics(trainer) -> Dict[str, float]:
        """The test split on the best validation weights, or on the final
        ones when no ``best`` slot was written."""
        if trainer.checkpoints.exists("best"):
            return trainer.evaluate("test")
        return trainer.evaluate("test", weights="live")

    def run_single_experiment(self):
        name = self.config.get("experiment_name", "experiment")
        model, data, trainer, logger = self._build(self.config.model.to_dict(), self.run_dir, name)
        print(f"[rlvae] single run -> {self.run_dir}")
        print(f"[rlvae] model: {model.get_model_summary()['configuration']}")
        print(f"[rlvae] data: train={len(data.train)} val={len(data.val)} test={len(data.test)}")
        result = trainer.fit()
        test_metrics = self._test_metrics(trainer)
        logger.log({f"test/{k}": v for k, v in test_metrics.items()})
        self._save_results(
            self.run_dir,
            {
                "best_val_loss": result["best_val_loss"],
                "epochs_run": result["epochs_run"],
                "train_time_sec": result["train_time"],
                "test": test_metrics,
            },
        )
        logger.finish()
        result["test_metrics"] = test_metrics  # the sweep's objective reads it
        return result

    def run_comparison_study(self):
        from rlvae_tpu_torch.models import MetricsCollector, apply_model_overrides

        experiment = self.config.experiment
        names = list(experiment.get("models", []) or [])
        collector = MetricsCollector()
        overrides = experiment.get("training_override") or {}
        if overrides:
            if "n_epochs" in overrides:
                self.config.set("training.trainer.max_epochs", int(overrides["n_epochs"]))
            for k in ("n_train_samples", "n_val_samples"):
                if k in overrides:
                    self.config.set(f"training.{k}", int(overrides[k]))

        results = {}
        for model_name in names:
            sub_dir = self.run_dir / model_name
            model_cfg = apply_model_overrides(self.config.model.to_dict(), model_name)
            model, data, trainer, logger = self._build(model_cfg, sub_dir, model_name)
            print(f"[rlvae] comparison: training {model_name}")
            result = trainer.fit()
            test_metrics = self._test_metrics(trainer)
            for entry in trainer.history:
                collector.add_model_metrics(
                    model_name,
                    {k.replace("val/", ""): v for k, v in entry.items() if k.startswith("val/")},
                )
            results[model_name] = {"best_val_loss": result["best_val_loss"], "test": test_metrics}
            logger.finish()

        summary = collector.get_comparison_summary()
        self._save_results(self.run_dir, {"models": results, "comparison": summary})
        print("[rlvae] comparison summary:")
        for name, metrics in summary.items():
            keys = [k for k in metrics if k.endswith("_final")][:4]
            print(f"  {name}: " + ", ".join(f"{k}={metrics[k]:.4f}" for k in keys))
        return results

    def run_hyperparameter_sweep(self):
        """The grid of ``experiment.sweep.parameters`` (at most
        ``experiment.max_runs`` runs), each a single run in ``run_<i>``,
        ranked in ``results.yaml`` by ``experiment.objective``."""
        sweep = self.config.experiment.get("sweep") or {}
        params = sweep.get("parameters") or {}
        axes = {k: [coerce_scalar(x) for x in v["values"]] for k, v in params.items()}
        max_runs = int(self.config.get("experiment.max_runs", 50))
        combos = list(itertools.product(*axes.values()))[:max_runs]
        print(f"[rlvae] sweep: {len(combos)} runs over {list(axes)}")

        objective = self.config.get("experiment.objective.metric", "val_loss")
        results = []
        for i, combo in enumerate(combos):
            run_cfg = self.config.copy()
            for key, value in zip(axes.keys(), combo):
                run_cfg.set(key, value)
            tov = self.config.experiment.get("training_override") or {}
            if "n_epochs" in tov:
                run_cfg.set("training.trainer.max_epochs", int(tov["n_epochs"]))
            for k in ("n_train_samples", "n_val_samples"):
                if k in tov:
                    run_cfg.set(f"training.{k}", int(tov[k]))
            if self.stop_event is not None and self.stop_event.is_set():
                print(f"[rlvae] sweep cancelled before run {i}")
                break
            sub = ExperimentRunner.__new__(ExperimentRunner)
            sub.config = run_cfg
            sub.progress_callback = self.progress_callback
            sub.stop_event = self.stop_event
            sub.run_dir = self.run_dir / f"run_{i}"
            sub.run_dir.mkdir(parents=True, exist_ok=True)
            save_config(run_cfg, sub.run_dir / "config.yaml")
            result = sub.run_single_experiment()
            entry = {"run": i, "params": dict(zip(axes.keys(), combo)),
                     "best_val_loss": result["best_val_loss"]}
            if objective != "val_loss":
                entry["objective_value"] = float(
                    result.get("test_metrics", {}).get(objective, float("nan")))
            results.append(entry)
        results = rank_sweep(results, objective,
                             self.config.get("experiment.objective.goal", "minimize"))
        self._save_results(self.run_dir, {"objective": objective, "runs": results})
        if results:
            print(f"[rlvae] best sweep run: {results[0]}")
        return results

    @staticmethod
    def _save_results(run_dir: Path, results: dict) -> None:
        (run_dir / "results.yaml").write_text(dump_yaml(results, sort_keys=False))


def rank_sweep(results: List[Dict[str, Any]], objective: str,
               goal: str = "minimize") -> List[Dict[str, Any]]:
    """Sweep entries best first by the objective (``best_val_loss`` for
    ``val_loss``, else ``objective_value``) and goal; a NaN or missing
    value ranks last (a NaN key would leave Python's sort order arbitrary)."""
    key = "objective_value" if objective != "val_loss" else "best_val_loss"
    worst = float("-inf") if goal == "maximize" else float("inf")

    def rank_of(r):
        v = r.get(key, worst)
        return worst if v != v else v

    if any(rank_of(r) == worst for r in results):
        print(f"[rlvae] WARNING: objective '{objective}' missing from some "
              "runs' test metrics; those runs rank last")
    return sorted(results, key=rank_of, reverse=(goal == "maximize"))


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Compose and run; returns each job's result (one without ``-m``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    multirun = False
    for flag in ("-m", "--multirun"):
        if flag in argv:
            argv.remove(flag)
            multirun = True
    if not multirun:
        return [ExperimentRunner(compose(CONF_DIR, overrides=argv)).run()]
    results = []
    for i, run_overrides in enumerate(expand_multirun(argv)):
        print(f"[rlvae] multirun job {i}: {run_overrides}")
        cfg = compose(CONF_DIR, overrides=run_overrides)
        cfg.set("run.dir", str(Path(cfg.get("sweep.dir", "outputs/sweep")) / str(i)))
        results.append(ExperimentRunner(cfg).run())
    return results


if __name__ == "__main__":
    main()
