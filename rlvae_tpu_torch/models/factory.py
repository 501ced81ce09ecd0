"""Model factory: builds an :class:`RlVAE` from a plain config dict.

Port of ``rlvae_tpu/models/factory.py``.  The config is a plain dict with
the keys of a ``conf/model/*.yaml`` node, as :mod:`rlvae_tpu_torch.config`
composes it; :func:`apply_model_overrides` and
:func:`create_comparison_suite` build a comparison study's models.  Each
preset holds the values that the JAX factory ends up using for
the YAML of its name:

- ``riemannian_flow_vae``: the reference model (density-direction flows,
  metric-aware posterior, K=50 metric at T=3.0).
- ``riemannian_flow_vae_stable``: the same with the bounded volume flow
  loss, near-identity flow init (log-sigma bias 0.0) and sampling-direction
  flows.
- ``riemannian_flow_vae_fast``: the stable preset plus the fused decode+MSE
  loss in training (``fused_decode_mse``) and a bf16 decoder output.
- ``hybrid_rlvae``: a Gaussian posterior sampled by ``sampling.method``
  (``enhanced``; one of ``standard``, ``basic``, ``enhanced``,
  ``geodesic``, ``official``) with the K=200 metric at T=0.7.

Relative artifact paths resolve against the working directory first, then
against the repository root.  A configured but missing encoder or decoder
artifact is a loud warning and a seeded random init, as on the JAX side;
so is an artifact that does not fit its net, which leaves both nets at
their init (:func:`load_pretrained_nets`).  The ``cnn_rlvae`` and
``resnet_rlvae`` configs name the MLP artifacts, so they start from their
seeded init, as in JAX.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

from rlvae_tpu_torch.convert import load_pretrained_net
from rlvae_tpu_torch.geometry.loader import load_metric
from rlvae_tpu_torch.models.rlvae import RlVAE

REPO_ROOT = Path(__file__).resolve().parents[2]

RIEMANNIAN_FLOW_VAE: Dict[str, Any] = {
    "name": "riemannian_flow_vae",
    "input_dim": [3, 64, 64],
    "latent_dim": 16,
    "n_flows": 8,
    "flow_hidden_size": 256,
    "flow_n_blocks": 2,
    # the YAML says 1, but the factory forces 3 (pythae's IAFConfig default)
    "flow_n_hidden": 3,
    "flow_direction": "density",
    "flow_fixedpoint_iters": 0,
    "flow_loss_mode": "reference",
    "flow_log_var_bias_init": -2.0,
    # MLP nets, bf16 activations and fp32 params (the registry's defaults)
    "encoder": {"architecture": "mlp"},
    "decoder": {"architecture": "mlp"},
    "beta": 1.0,
    "riemannian_beta": 8.0,
    "posterior": {"type": "riemannian_metric"},
    "sampling": {"method": "geodesic", "use_riemannian": True},
    "loop": {"mode": "open", "penalty": 5.0},
    "metric": {
        "path": "metric_T0.7_scaled.npz",
        "temperature_override": 3.0,
        "regularization_override": None,
    },
    "pretrained": {
        "encoder_path": "data/pretrained/encoder.npz",
        "decoder_path": "data/pretrained/decoder.npz",
        "metric_path": "data/pretrained/metric_T0.7_scaled.npz",
    },
}

RIEMANNIAN_FLOW_VAE_STABLE: Dict[str, Any] = {
    **RIEMANNIAN_FLOW_VAE,
    "name": "riemannian_flow_vae_stable",
    "flow_loss_mode": "volume",
    "flow_log_var_bias_init": 0.0,
    "flow_direction": "sampling",
}

RIEMANNIAN_FLOW_VAE_FAST: Dict[str, Any] = {
    **RIEMANNIAN_FLOW_VAE_STABLE,
    "name": "riemannian_flow_vae_fast",
    "fused_decode_mse": True,
    "decoder": {"architecture": "mlp", "out_dtype": "bfloat16"},
}

HYBRID_RLVAE: Dict[str, Any] = {
    **RIEMANNIAN_FLOW_VAE,
    "name": "hybrid_rlvae",
    "riemannian_beta": 1.0,
    "posterior": {"type": "gaussian"},
    "sampling": {"method": "enhanced", "use_riemannian": True},
    "loop": {"mode": "open", "penalty": 1.0},
    "metric": {
        "path": "metric.npz",
        "temperature_override": 0.7,
        "regularization_override": None,
        "enable_diagnostics": True,
        "performance_tracking": True,
    },
    "pretrained": {
        "encoder_path": "data/pretrained/encoder.npz",
        "decoder_path": "data/pretrained/decoder.npz",
        "metric_path": "data/pretrained/metric.npz",
    },
}

PRESETS: Dict[str, Dict[str, Any]] = {
    "riemannian_flow_vae": RIEMANNIAN_FLOW_VAE,
    "riemannian_flow_vae_stable": RIEMANNIAN_FLOW_VAE_STABLE,
    "riemannian_flow_vae_fast": RIEMANNIAN_FLOW_VAE_FAST,
    "hybrid_rlvae": HYBRID_RLVAE,
}


def _node(config: Optional[Mapping[str, Any]], key: str) -> Dict[str, Any]:
    node = config.get(key) if config else None
    return dict(node) if node else {}


def resolve_artifact(path: Optional[str], kind: str = "artifact") -> Optional[Path]:
    """The ``.npz`` artifact at ``path`` (CWD, then repo root), or None with a warning."""
    if not path:
        return None
    p = Path(path)
    cands = [p] if p.is_absolute() else [p, REPO_ROOT / p]
    for cand in cands:
        for c in (cand, cand.with_suffix(".npz")):
            if c.exists():
                return c
    warnings.warn(f"pretrained {kind} not found: {path} -> random init")
    return None


def create_model(config: Mapping[str, Any], seed: int = 0, name: Optional[str] = None) -> RlVAE:
    """Build a model (on the CPU) from a ``model`` config dict."""
    posterior = _node(config, "posterior")
    sampling = _node(config, "sampling")
    loop = _node(config, "loop")
    metric_cfg = _node(config, "metric")
    pretrained = _node(config, "pretrained")

    metric = None
    metric_path = resolve_artifact(pretrained.get("metric_path"), "metric")
    if metric_path:
        metric = load_metric(
            metric_path,
            temperature_override=metric_cfg.get("temperature_override"),
            regularization_override=metric_cfg.get("regularization_override"),
        )

    model = RlVAE(
        input_dim=tuple(config.get("input_dim", (3, 64, 64))),
        latent_dim=int(config.get("latent_dim", 16)),
        n_flows=int(config.get("n_flows", 8)),
        flow_hidden_size=int(config.get("flow_hidden_size", 256)),
        flow_n_blocks=int(config.get("flow_n_blocks", 2)),
        # the reference passes flow_n_hidden=1 but pythae's IAFConfig silently
        # drops it and uses n_hidden_in_made=3; the JAX factory forces 3 too
        flow_n_hidden=3,
        beta=float(config.get("beta", 1.0)),
        riemannian_beta=float(config.get("riemannian_beta", 1.0)),
        posterior_type=str(posterior.get("type", "gaussian")),
        sampling_method={"enhanced_riemannian": "enhanced"}.get(
            str(sampling.get("method", "standard")), str(sampling.get("method", "standard"))
        ),
        use_riemannian=bool(sampling.get("use_riemannian", False)),
        loop_mode=str(loop.get("mode", "open")),
        loop_penalty=float(loop.get("penalty", 0.0)),
        flow_direction=str(config.get("flow_direction", "density")),
        flow_fixedpoint_iters=int(config.get("flow_fixedpoint_iters", 0)),
        flow_loss_mode=str(config.get("flow_loss_mode", "reference")),
        remat_decode=bool(config.get("remat_decode", False)),
        fused_decode_mse=bool(config.get("fused_decode_mse", False)),
        flow_log_var_bias_init=float(config.get("flow_log_var_bias_init", -2.0)),
        encoder_config=_node(config, "encoder"),
        decoder_config=_node(config, "decoder"),
        metric=metric,
        seed=seed,
        name=name or str(config.get("name", "rlvae")),
    )
    load_pretrained_nets(model, {kind: resolve_artifact(pretrained.get(f"{kind}_path"), kind)
                                 for kind in ("encoder", "decoder")})
    return model


def load_pretrained_nets(model: RlVAE, paths: Mapping[str, Optional[Path]]) -> None:
    """Load the encoder and decoder artifacts named in ``paths`` (None: keep
    the net's init), both or neither: an artifact whose layers or shapes are
    not the net's (a cnn or resnet config pointing at the MLP artifacts) is
    a warning, and both nets keep their seeded init, as JAX's
    ``RlVAE.init`` does (``rlvae_tpu/models/rlvae.py:151-164``)."""
    saved = {kind: {k: v.clone() for k, v in getattr(model, kind).state_dict().items()}
             for kind in paths}
    try:
        for kind, path in paths.items():
            if path:
                load_pretrained_net(getattr(model, kind), path)
    except (ValueError, OSError) as e:
        for kind, state in saved.items():
            getattr(model, kind).load_state_dict(state)
        warnings.warn(f"pretrained components not loaded: {e}")


def create_hybrid_model(config: Mapping[str, Any], seed: int = 0,
                        name: Optional[str] = None) -> RlVAE:
    """``create_model`` under the name ``hybrid_rlvae``, as the JAX factory's
    ``create_hybrid_model``."""
    return create_model(config, seed=seed, name=name or "hybrid_rlvae")


VANILLA_OVERRIDES = {
    "n_flows": 0,
    "riemannian_beta": 0.0,
    "posterior": {"type": "gaussian"},
    "sampling": {"use_riemannian": False, "method": "standard"},
    "loop": {"mode": "open", "penalty": 0.0},
    "pretrained": {"metric_path": None},
}


def apply_model_overrides(model_config: Mapping[str, Any], model_name: str) -> Dict[str, Any]:
    """The model config a comparison study trains under ``model_name``:
    ``vanilla_vae`` switches the flows, the Riemannian KL, the metric and
    the loop penalty off (:data:`VANILLA_OVERRIDES`); any other name keeps
    the config.  A copy, one level deep, as JAX's."""
    cfg = {k: (dict(v) if isinstance(v, Mapping) else v) for k, v in model_config.items()}
    if model_name == "vanilla_vae":
        for k, v in VANILLA_OVERRIDES.items():
            if isinstance(v, Mapping):
                # an empty YAML section ('sampling:') reads as None
                if not isinstance(cfg.get(k), Mapping):
                    cfg[k] = {}
                cfg[k] = {**cfg[k], **v}
            else:
                cfg[k] = v
    return cfg


def create_comparison_suite(config: Mapping[str, Any], seed: int = 0) -> Dict[str, RlVAE]:
    """One model per ``experiment.models`` entry of a composed config, or
    ``{"main": model}`` when it names none."""
    experiment = config.get("experiment", {}) or {}
    model_cfg = dict(config.get("model", config))
    names = list(experiment.get("models", []) or [])
    if not names:
        return {"main": create_model(model_cfg, seed=seed)}
    return {nm: create_model(apply_model_overrides(model_cfg, nm), seed=seed, name=nm)
            for nm in names}

