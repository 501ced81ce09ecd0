"""Config schema validation: the port's copy of
``rlvae_tpu/config/schema.py``.

:func:`validate_config` checks a composed config tree and returns one
message per problem, in JAX's words and order; :func:`assert_valid` raises
``ValueError`` with all of them.  The valid posterior types, loop modes and
sampling methods are the port model's and samplers' own
(``models.rlvae.POSTERIOR_TYPES``, ``LOOP_MODES``,
``samplers.POSTERIOR_METHODS``), which hold JAX's values.
"""

from __future__ import annotations

from typing import Any, List, Mapping

from rlvae_tpu_torch.models.rlvae import LOOP_MODES, POSTERIOR_TYPES
from rlvae_tpu_torch.samplers.riemannian import POSTERIOR_METHODS

VALID_SAMPLING = set(POSTERIOR_METHODS) | {"enhanced_riemannian"}
VALID_ARCHS = {"mlp", "cnn", "resnet", "custom"}
VALID_EXPERIMENTS = {"single", "comparison", "sweep"}
VALID_VIZ_LEVELS = {"minimal", "basic", "standard", "advanced", "full"}


def validate_config(cfg: Mapping[str, Any]) -> List[str]:
    """Returns a list of problems (empty = valid)."""
    problems: List[str] = []

    def check(cond: bool, msg: str):
        if not cond:
            problems.append(msg)

    model = cfg.get("model", {}) or {}
    check(int(model.get("latent_dim", 16)) > 0, "model.latent_dim must be positive")
    check(int(model.get("n_flows", 0)) >= 0, "model.n_flows must be >= 0")
    input_dim = list(model.get("input_dim", [3, 64, 64]))
    check(len(input_dim) == 3, f"model.input_dim must be [C, H, W], got {input_dim}")
    ptype = (model.get("posterior") or {}).get("type", "gaussian")
    check(ptype in POSTERIOR_TYPES, f"model.posterior.type '{ptype}' not in {POSTERIOR_TYPES}")
    method = (model.get("sampling") or {}).get("method", "standard")
    check(
        method in VALID_SAMPLING,
        f"model.sampling.method '{method}' not in {sorted(VALID_SAMPLING)}",
    )
    loop_mode = (model.get("loop") or {}).get("mode", "open")
    check(loop_mode in LOOP_MODES, f"model.loop.mode '{loop_mode}' not in {LOOP_MODES}")
    flow_loss_mode = model.get("flow_loss_mode", "reference")
    check(
        flow_loss_mode in ("reference", "volume"),
        f"model.flow_loss_mode '{flow_loss_mode}' must be 'reference' or 'volume'",
    )
    for side in ("encoder", "decoder"):
        arch = (model.get(side) or {}).get("architecture", "mlp")
        check(arch in VALID_ARCHS,
              f"model.{side}.architecture '{arch}' not in {sorted(VALID_ARCHS)}")

    training = cfg.get("training", {}) or {}
    trainer = training.get("trainer", {}) or {}
    check(int(trainer.get("max_epochs", 1)) > 0, "training.trainer.max_epochs must be positive")
    check(
        int((training.get("data") or {}).get("batch_size", 1)) > 0,
        "training.data.batch_size must be positive",
    )
    lr = (training.get("optimizer") or {}).get("lr", 1e-3)
    check(float(lr) > 0, f"training.optimizer.lr must be positive, got {lr}")

    experiment = cfg.get("experiment", {}) or {}
    etype = experiment.get("type", "single")
    check(etype in VALID_EXPERIMENTS,
          f"experiment.type '{etype}' not in {sorted(VALID_EXPERIMENTS)}")
    if etype == "comparison":
        check(bool(experiment.get("models")), "comparison experiments need experiment.models")
    if etype == "sweep":
        check(
            bool((experiment.get("sweep") or {}).get("parameters")),
            "sweep experiments need experiment.sweep.parameters",
        )

    viz = cfg.get("visualization", {}) or {}
    level = str(viz.get("level", "standard")).lower()
    check(level in VALID_VIZ_LEVELS,
          f"visualization.level '{level}' not in {sorted(VALID_VIZ_LEVELS)}")

    return problems


def assert_valid(cfg: Mapping[str, Any]) -> None:
    problems = validate_config(cfg)
    if problems:
        raise ValueError(
            "Invalid configuration:\n" + "\n".join(f"  - {p}" for p in problems)
        )
