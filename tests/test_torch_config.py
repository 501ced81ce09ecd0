"""The port's config composition, schema and paths against the JAX
package's (``rlvae_tpu.config``) on the repository's ``conf/`` directory.

Both sides compose with ``${now:...}`` frozen at the same instant.  Every
comparison is exact: the composed trees as plain dicts (YAML 1.1's string
reading of ``1e-6`` included), ``save_config``'s bytes, the multirun
expansion and the validation messages.  Importing the port's config package
loads neither PyYAML nor anything of ``rlvae_tpu``
(``tests/test_torch_isolation.py``).
"""

import datetime
import importlib

import pytest

from rlvae_tpu.config import validate_config as jax_validate
from rlvae_tpu_torch.config import validate_config as port_validate
from rlvae_tpu_torch.experiment import CONF_DIR

# the packages export a function named ``compose``: take the modules themselves
jax_compose = importlib.import_module("rlvae_tpu.config.compose")
jax_paths = importlib.import_module("rlvae_tpu.config.paths")
port_compose_module = importlib.import_module("rlvae_tpu_torch.config.compose")
port_paths = importlib.import_module("rlvae_tpu_torch.config.paths")

GROUPS = {g.name: sorted(p.stem for p in g.glob("*.yaml"))
          for g in sorted(CONF_DIR.iterdir()) if g.is_dir()}
OPTIONS = [f"{g}={o}" for g, opts in GROUPS.items() for o in opts]
FROZEN = datetime.datetime(2026, 3, 4, 5, 6, 7)


class _Clock:
    """Stands in for the ``datetime`` module inside both compose modules."""

    class datetime:
        @staticmethod
        def now():
            return FROZEN


@pytest.fixture(autouse=True)
def frozen_now(monkeypatch):
    monkeypatch.setattr(jax_compose, "datetime", _Clock)
    monkeypatch.setattr(port_compose_module, "datetime", _Clock)


def _both(overrides):
    jax_cfg = jax_compose.compose(CONF_DIR, overrides=overrides)
    port_cfg = port_compose_module.compose(CONF_DIR, overrides=overrides)
    return jax_cfg, port_cfg


def test_every_group_has_options():
    assert set(GROUPS) == {"data", "experiment", "model", "training", "visualization"}
    assert len(OPTIONS) == 18


@pytest.mark.parametrize("override", [None] + OPTIONS)
def test_compose_every_option_matches_jax(override, tmp_path):
    jax_cfg, port_cfg = _both([] if override is None else [override])
    assert type(port_cfg).__name__ == "Config"
    assert port_cfg.to_dict() == jax_cfg.to_dict()
    assert port_cfg.run.dir == "outputs/rlvae_comparison/2026-03-04_05-06-07"
    jax_compose.save_config(jax_cfg, tmp_path / "jax.yaml")
    port_compose_module.save_config(port_cfg, tmp_path / "port.yaml")
    assert (tmp_path / "port.yaml").read_bytes() == (tmp_path / "jax.yaml").read_bytes()


def test_yaml_11_floats_stay_strings():
    """PyYAML reads ``1e-6`` (no dot) as a string; only overrides are coerced."""
    _, cfg = _both(["training=quick"])
    assert cfg.model.epsilon == "1e-6" and cfg.training.scheduler.min_lr == "1e-7"
    _, cfg = _both(["training.scheduler.min_lr=1e-7", "training.optimizer.lr=3e-4"])
    assert cfg.training.scheduler.min_lr == 1e-7 and cfg.training.optimizer.lr == 3e-4


OVERRIDE_SETS = [
    ["model=vanilla_vae", "training=quick", "visualization=minimal"],
    ["model=hybrid_rlvae", "model.sampling.method=geodesic", "training.data.batch_size=2"],
    ["+new.key=3", "~model.metric", "model.encoder.hidden_dims=[256,128]",
     "training.optimizer.lr=3e-4", "+training.extra={a: 1, b: [2, 3]}", "seed=7",
     "model.sampling.method=null", "+copy.dim=${model.latent_dim}", "+copy.name=z_${seed}",
     "experiment=comparison_study", "experiment.training_override.n_epochs=1",
     "wandb.mode=offline", "run.dir=/tmp/x", "data.image_size=[8,8]", "~experiment.models"],
    ["experiment=hyperparameter_sweep", "experiment.max_runs=3", "+training.trainer.profile=true",
     "training.trainer.accelerator=cpu", "model.riemannian_beta=1e-2", "model.loop.penalty=.5"],
    ["+visualization=standard", "~wandb", "model.latent_dim=-1"],
]


@pytest.mark.parametrize("overrides", OVERRIDE_SETS, ids=lambda o: o[0])
def test_overrides_match_jax(overrides):
    jax_cfg, port_cfg = _both(overrides)
    assert port_cfg.to_dict() == jax_cfg.to_dict()


def test_interpolation_keeps_types():
    _, cfg = _both(["+copy.dim=${model.latent_dim}", "+copy.name=z_${seed}"])
    assert cfg.get("copy.dim") == 16 and cfg.get("copy.name") == "z_42"
    assert cfg.wandb.project == "riemannian-vae-study"


@pytest.mark.parametrize("overrides", [
    ["model.riemannian_beta=0.5,8.0", "training=quick"],
    ["model=vanilla_vae,hybrid_rlvae", "model.sampling.method=enhanced,geodesic",
     "+x=[1,2],[3]", "~model.loop", "model.encoder.hidden_dims=[8,8]"],
    ["training.optimizer.lr=1e-4,3e-4", "+y={a: 1},null"],
])
def test_expand_multirun_matches_jax(overrides):
    want = list(jax_compose.expand_multirun(overrides))
    got = list(port_compose_module.expand_multirun(overrides))
    assert got == want and len(got) > 1
    for run in got:
        jax_cfg, port_cfg = _both(run)
        assert port_cfg.to_dict() == jax_cfg.to_dict()


@pytest.mark.parametrize("bad", ["novalue", "a.b=1,2"])
def test_malformed_and_sweep_overrides_raise_as_jax(bad):
    with pytest.raises(ValueError) as want:
        jax_compose.compose(CONF_DIR, overrides=[bad])
    with pytest.raises(ValueError) as got:
        port_compose_module.compose(CONF_DIR, overrides=[bad])
    assert str(got.value) == str(want.value)


def test_config_node_api():
    cfg = port_compose_module.Config({"a": {"b": [{"c": 1}]}, "d": 2})
    cfg.set("a.x.y", 3)
    assert cfg.get("a.x.y") == 3 and cfg.get("a.nope", "dflt") == "dflt"
    assert cfg.a.b[0].c == 1 and isinstance(cfg.a.b[0], port_compose_module.Config)
    copy = cfg.copy()
    copy.set("d", 5)
    assert cfg.d == 2 and copy.to_dict() == {"a": {"b": [{"c": 1}], "x": {"y": 3}}, "d": 5}
    with pytest.raises(AttributeError):
        cfg.missing


INVALID = {
    "model": {"latent_dim": 0, "n_flows": -1, "input_dim": [3, 64], "posterior": {"type": "x"},
              "sampling": {"method": "nope"}, "loop": {"mode": "spiral"},
              "flow_loss_mode": "other", "encoder": {"architecture": "transformer"},
              "decoder": None},
    "training": {"trainer": {"max_epochs": 0}, "data": {"batch_size": 0},
                 "optimizer": {"lr": -1.0}},
    "visualization": {"level": "loud"},
}


@pytest.mark.parametrize("case", ["composed", "invalid", "comparison", "sweep", "bad_type"])
def test_validate_config_matches_jax(case):
    cfg = _both([])[0].to_dict()
    if case == "invalid":
        cfg = INVALID
    elif case == "comparison":
        cfg = {**cfg, "experiment": {"type": "comparison", "models": []}}
    elif case == "sweep":
        cfg = {**cfg, "experiment": {"type": "sweep", "sweep": {}}}
    elif case == "bad_type":
        cfg = {**cfg, "experiment": {"type": "grid"}}
    want = jax_validate(cfg)
    assert port_validate(cfg) == want
    assert bool(want) == (case != "composed")


def test_paths_match_jax():
    for name in ("PROJECT_ROOT", "TRAIN_DATA_PATH", "TEST_DATA_PATH", "ENCODER_PATH",
                 "DECODER_PATH", "METRIC_PATH", "METRIC_T07_PATH"):
        assert getattr(port_paths, name) == getattr(jax_paths, name), name
    assert port_paths.validate_paths() == jax_paths.validate_paths()
    with pytest.raises(FileNotFoundError) as want:
        jax_paths.validate_paths(require_pretrained=True)
    with pytest.raises(FileNotFoundError) as got:
        port_paths.validate_paths(require_pretrained=True)
    assert str(got.value) == str(want.value)
