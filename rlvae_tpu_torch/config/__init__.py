"""Experiment configuration: Hydra-style composition over ``conf/``
(:func:`compose`, overrides, multirun), schema validation and the
canonical paths.  PyYAML is imported only where YAML is read or written."""

from rlvae_tpu_torch.config.compose import (
    Config,
    OverrideSpec,
    coerce_scalar,
    compose,
    expand_multirun,
    load_yaml,
    save_config,
)
from rlvae_tpu_torch.config.paths import (
    DECODER_PATH,
    ENCODER_PATH,
    METRIC_PATH,
    METRIC_T07_PATH,
    PROJECT_ROOT,
    TEST_DATA_PATH,
    TRAIN_DATA_PATH,
    validate_paths,
)
from rlvae_tpu_torch.config.schema import assert_valid, validate_config

__all__ = [
    "Config", "DECODER_PATH", "ENCODER_PATH", "METRIC_PATH", "METRIC_T07_PATH", "OverrideSpec",
    "PROJECT_ROOT", "TEST_DATA_PATH", "TRAIN_DATA_PATH", "assert_valid", "coerce_scalar",
    "compose", "expand_multirun", "load_yaml", "save_config", "validate_config",
    "validate_paths",
]
