"""The port's full-width RlVAE.forward(train=False) against the JAX
RlVAE.forward, on identical weights (the JAX model's variables carried
across by rlvae_tpu_torch.convert.from_jax_variables) and identical
posterior noise (drawn the way JAX draws it, then passed in).

Tolerances (fp32 nets): mu, log_var atol 1e-5; losses rtol 1e-5; z within
1e-5 of each time step's largest |z| (the reference-init flows scale the
latent to ~1e8, so its rounding is relative); recon_x atol 5e-4 (those
large latents move the decoder's pre-activations by their own rounding).
With the default bf16 nets only the encoder outputs and the KL are compared,
at rtol/atol 1e-2 (bf16 rounds at other places in the two frameworks)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.config import compose
from rlvae_tpu.models import create_model as jax_create_model
from rlvae_tpu_torch.convert import from_jax_variables
from rlvae_tpu_torch.models import PRESETS, create_model

CONF = Path(__file__).resolve().parents[1] / "conf"
PRESET = PRESETS["riemannian_flow_vae"]
LOSSES = ("loss", "recon_loss", "kld_loss", "flow_loss", "loop_penalty")


def _composed():
    return compose(CONF).model.to_dict()


def _pair(dtype):
    cfg = _composed()
    cfg["encoder"] = {"architecture": "mlp", "dtype": dtype}
    cfg["decoder"] = {"architecture": "mlp", "dtype": dtype}
    jm = jax_create_model(cfg)
    jv = jm.init(jax.random.PRNGKey(0))
    pm = create_model(cfg)
    pm.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray, jv)))
    return jm, jv, pm.eval()


@pytest.fixture(scope="module")
def pair_f32():
    return _pair("float32")


def _run_both(jm, jv, pm, x, seed):
    key = jax.random.PRNGKey(seed)
    jo = jax.tree_util.tree_map(np.asarray, dict(jm.forward(jv, jnp.asarray(x), key)))
    # JAX: k_sample = split(key)[0]; eps = normal(k_sample, mu.shape)
    eps = np.asarray(jax.random.normal(jax.random.split(key)[0], (x.shape[0], 16)))
    with torch.no_grad():  # forward builds an autograd graph otherwise
        po = pm(torch.from_numpy(x), eps=torch.from_numpy(eps))
    return jo, {k: v.float().numpy() for k, v in po.items()}


@pytest.mark.parametrize("loop_mode,flow_loss_mode", [("open", "reference"), ("closed", "volume")])
def test_forward_matches_jax(pair_f32, loop_mode, flow_loss_mode):
    jm, jv, pm = pair_f32
    for m in (jm, pm):
        m.loop_mode, m.flow_loss_mode = loop_mode, flow_loss_mode
    x = np.random.default_rng(0).uniform(size=(2, 8, 3, 64, 64)).astype(np.float32)
    jo, po = _run_both(jm, jv, pm, x, seed=7)
    assert po["recon_x"].shape == x.shape and po["z"].shape == (2, 8, 16)
    for k in ("mu", "log_var"):
        np.testing.assert_allclose(po[k], jo[k], rtol=0, atol=1e-5)
    z_scale = np.abs(jo["z"]).max(axis=(0, 2), keepdims=True)
    np.testing.assert_array_less(np.abs(po["z"] - jo["z"]),
                                 np.broadcast_to(1e-5 * z_scale + 1e-6, jo["z"].shape))
    np.testing.assert_allclose(po["recon_x"], jo["recon_x"], rtol=0, atol=5e-4)
    for k in LOSSES:
        np.testing.assert_allclose(po[k], jo[k], rtol=1e-5, atol=1e-6, err_msg=k)
    if loop_mode == "closed":
        np.testing.assert_array_equal(po["z"][:, -1], po["z"][:, 0])
        assert po["loop_penalty"] > 0


def test_forward_bf16_default_nets():
    jm, jv, pm = _pair("bfloat16")
    x = np.random.default_rng(1).uniform(size=(2, 8, 3, 64, 64)).astype(np.float32)
    jo, po = _run_both(jm, jv, pm, x, seed=3)
    for k in ("mu", "log_var", "kld_loss"):
        np.testing.assert_allclose(po[k], jo[k], rtol=1e-2, atol=1e-2, err_msg=k)
    for k in LOSSES + ("recon_x", "z"):
        assert np.all(np.isfinite(po[k])), k


def test_preset_matches_composed_config():
    composed = _composed()
    for key, value in composed.items():
        if key in ("_target_", "epsilon", "flow_n_hidden"):
            continue  # factory-only keys; flow_n_hidden is forced to 3 on both sides
        assert PRESET[key] == value, key
    assert PRESET["flow_n_hidden"] == 3
    jm = jax_create_model(composed)
    pm = create_model(PRESET)
    for attr in ("input_dim", "latent_dim", "n_flows", "beta", "riemannian_beta",
                 "posterior_type", "sampling_method", "use_riemannian", "loop_mode",
                 "loop_lambda", "flow_loss_mode"):
        assert getattr(pm, attr) == getattr(jm, attr), attr
    jf, pf = jm.flow_config, pm.flows
    for attr in ("hidden_size", "n_blocks", "n_hidden", "direction", "fixedpoint_iters"):
        assert getattr(pf, attr) == getattr(jf, attr), attr
    assert pf.n_hidden == 3
    assert pm.metric.temperature == float(jm.metric.temperature) == 3.0
    assert pm.metric.regularization == pytest.approx(float(jm.metric.regularization))
    np.testing.assert_array_equal(pm.metric.centroids.numpy(), np.asarray(jm.metric.centroids))
    assert pm.metric.n_centroids == 50
    assert pm.encoder.dtype == torch.bfloat16 and jm.encoder.dtype == jnp.bfloat16
    assert pm.decoder.out_dtype == torch.float32 and jm.decoder.out_dtype == jnp.float32
    # log_var bias of the last MADE layer: the reference init on both sides
    assert torch.all(pm.flows.flows[0].blocks[0].biases[-1][16:] == -2.0)
