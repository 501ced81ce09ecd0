"""The evaluation step's analysis metrics against JAX's ``_eval_metrics``.

JAX's evaluation step always asks ``forward`` for ``compute_metrics=True``
(``rlvae_tpu/train/trainer.py:253-262``), which adds
``losses.additional_metrics``: ``cyclicity_error``, ``latent_norm``,
``latent_variance`` and, with a metric, ``metric_conditioning``,
``manifold_regularity`` and ``metric_determinant``.

- ``additional_metrics`` against JAX's on the same inputs (population
  variance and standard deviation; the eigenvalues on the first 32 rows).
- The default model at full width (composed ``riemannian_flow_vae``, fp32
  nets), JAX's variables carried across and JAX's posterior noise passed
  in: every key of ``make_eval_step`` equals JAX's ``_eval_metrics``,
  rtol 1e-4 (``metric_conditioning`` 1e-3: a ratio of G^{-1}'s extreme
  eigenvalues at z0, whose smallest carries the relative rounding of the
  whole matrix), and the key sets are equal.
- ``Trainer.fit``'s validation and ``Trainer.evaluate`` report the six keys.
"""

import copy
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.config import compose
from rlvae_tpu.geometry import load_metric as jax_load_metric
from rlvae_tpu.models import create_model as jax_create_model
from rlvae_tpu.models import losses as jlosses
from rlvae_tpu.train.trainer import _eval_metrics
from rlvae_tpu_torch.convert import from_jax_variables
from rlvae_tpu_torch.data import CYCLIC_SPRITES, CyclicDataModule
from rlvae_tpu_torch.geometry import load_metric
from rlvae_tpu_torch.models import create_model
from rlvae_tpu_torch.models import losses as tlosses
from rlvae_tpu_torch.models.rlvae import RlVAE
from rlvae_tpu_torch.train import TRAINING_PRESETS, Trainer, make_eval_step

CONF = Path(__file__).resolve().parents[1] / "conf"
DATA = Path(__file__).resolve().parents[1] / "data" / "pretrained"
METRIC_KEYS = ("metric_conditioning", "manifold_regularity", "metric_determinant")
PLAIN_KEYS = ("cyclicity_error", "latent_norm", "latent_variance")


def _rtol(key):
    return 1e-3 if key == "metric_conditioning" else 1e-4


@pytest.mark.parametrize("with_metric", [True, False])
def test_additional_metrics_match_jax(with_metric):
    rng = np.random.default_rng(0)
    jm = jax_load_metric(DATA / "metric_T0.7_scaled.npz", temperature_override=3.0)
    tm = load_metric(DATA / "metric_T0.7_scaled.npz", temperature_override=3.0)
    c = np.asarray(jm.centroids)
    b = 40  # more than the 32 rows the eigenvalues are taken on
    z_seq = (c[rng.integers(0, 50, size=(b, 1))] + rng.normal(scale=0.3, size=(b, 4, 16)))
    z_seq = z_seq.astype(np.float32)
    x = rng.uniform(size=(b, 4, 3, 4, 4)).astype(np.float32)
    recon = rng.uniform(size=x.shape).astype(np.float32)
    want = jax.jit(jlosses.additional_metrics)(*map(jnp.asarray, (x, recon, z_seq)),
                                               jm if with_metric else None)
    got = tlosses.additional_metrics(*map(torch.from_numpy, (x, recon, z_seq)),
                                     tm if with_metric else None)
    assert set(got) == set(want) == set(PLAIN_KEYS + (METRIC_KEYS if with_metric else ()))
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=_rtol(k), err_msg=k)


def test_default_model_eval_step_matches_jax():
    cfg = compose(CONF).model.to_dict()
    cfg["encoder"] = {"architecture": "mlp", "dtype": "float32"}
    cfg["decoder"] = {"architecture": "mlp", "dtype": "float32"}
    jm = jax_create_model(cfg)
    jv = jm.init(jax.random.PRNGKey(0))
    pm = create_model(cfg)
    pm.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray, jv)))
    x = np.random.default_rng(1).uniform(size=(3, 8, 3, 64, 64)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jax.jit(functools.partial(_eval_metrics, jm))(jv, jnp.asarray(x), key)
    # JAX: k_sample = split(key)[0]; eps = normal(k_sample, mu.shape)
    eps = np.array(jax.random.normal(jax.random.split(key)[0], (3, 16)))
    got = make_eval_step(pm)(torch.from_numpy(x), torch.from_numpy(eps))
    assert set(got) == set(want)
    assert set(want) == {"loss", "recon_loss", "kld_loss", "flow_loss", *PLAIN_KEYS,
                         *METRIC_KEYS}
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=_rtol(k), err_msg=k)


def test_trainer_reports_the_metrics(tmp_path):
    """fit's validation summaries and evaluate() carry the six keys, finite."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(8, 16, 16)).astype(np.float32) / 4
    from rlvae_tpu_torch.geometry.metric import CentroidMetric

    metric = CentroidMetric.create(rng.normal(size=(8, 16)), a @ np.swapaxes(a, -1, -2)
                                   + 0.1 * np.eye(16, dtype=np.float32), 2.0, 0.01)
    net = {"architecture": "mlp", "hidden_dims": [16], "dtype": "float32"}
    model = RlVAE(input_dim=(3, 8, 8), latent_dim=16, n_flows=1, flow_hidden_size=16,
                  posterior_type="gaussian", sampling_method="geodesic",
                  encoder_config=net, decoder_config=net, metric=metric,
                  flow_log_var_bias_init=0.0)
    cfg = copy.deepcopy(TRAINING_PRESETS["quick"])
    cfg["n_train_samples"], cfg["n_val_samples"] = 8, 4
    data = CyclicDataModule({**CYCLIC_SPRITES, "train_path": str(tmp_path / "none.npz"),
                             "test_path": str(tmp_path / "none.npz"), "sequence_length": 3,
                             "image_size": [8, 8], "synthetic_n_test": 4}, seed=1)
    data.setup(cfg)
    trainer = Trainer(model, data, cfg, run_dir=tmp_path / "run", seed=0, device="cpu")
    history = trainer.fit(max_epochs=1, max_steps=2)["history"]
    for k in PLAIN_KEYS + METRIC_KEYS:
        assert np.isfinite(history[0][f"val/{k}"]), k
    test = trainer.evaluate("test", weights="live")
    assert set(test) >= set(PLAIN_KEYS + METRIC_KEYS) and all(np.isfinite(list(test.values())))
