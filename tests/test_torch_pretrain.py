"""RHVAE metric pre-training of the port against the JAX package on the CPU.

``rlvae_tpu_torch.geometry.pretrain`` against ``rlvae_tpu.geometry.pretrain``
at JAX's ``tiny_rhvae`` size (3x4x4 frames, latent 4, 2 leapfrog steps),
the weights carried across by ``rlvae_tpu_torch.convert`` and the noise
JAX draws (``eps0``, ``gamma`` from its keys): ``MetricMLP``, the forward's
loss, z, rho and every parameter group's gradient (the metric net's
included, through the G^{-1} Function's bank cotangents and the
differentiable VJP), ``train_metric`` for 2 epochs on JAX's key chain, the
ring buffer's cap, and a ``python -m rlvae_tpu_torch.components`` run at
8x8 frames whose outputs JAX's ``load_metric`` and nets read.

Tolerances, fixed here (measured in brackets):
- ``MetricMLP``: rtol 1e-6, atol 1e-6 of the largest |L| (fp32 products).
- forward at the fp32 policy (``dtype: float32``): loss rtol 1e-6 [1e-7];
  z, z0, rho, mu, log_var, M within 1e-5 of each one's largest entry
  [4e-7]; every gradient within 1e-5 of its largest entry [5e-7].
- forward at the default bf16 policy: the loss rtol 1e-3 (bf16 activations,
  which the two packages round at other places).
- ``train_metric`` (fp32 policy, 8 Adam steps): the loss history rtol 1e-5,
  the consolidated centroids and matrices within 1e-4 of their largest entry
  (torch's and optax's Adam round differently, and each step's update is
  lr-sized where the gradient's sign is at rounding level).
- the components run: JAX's nets on the written ``.npz`` against the port's
  nets within 1e-5 (fp32 activations); the metric files equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.data.convert import load_component_npz as jax_load_component_npz
from rlvae_tpu.geometry import load_metric as jax_load_metric
from rlvae_tpu.geometry import validate_metric_file as jax_validate_metric_file
from rlvae_tpu.geometry.pretrain import RHVAE as JaxRHVAE
from rlvae_tpu.geometry.pretrain import MetricMLP as JaxMetricMLP
from rlvae_tpu.geometry.pretrain import train_metric as jax_train_metric
from rlvae_tpu.nets import MLPDecoder as JaxMLPDecoder
from rlvae_tpu.nets import MLPEncoder as JaxMLPEncoder
from rlvae_tpu_torch import components
from rlvae_tpu_torch.convert import (
    load_pretrained_net,
    net_state_from_flax,
    rhvae_params_to_numpy,
    rhvae_state_from_jax,
)
from rlvae_tpu_torch.geometry import convert_metric_file, load_metric, save_metric
from rlvae_tpu_torch.geometry import validate_metric_file
from rlvae_tpu_torch.geometry.pretrain import RHVAE, MetricMLP, train_metric
from rlvae_tpu_torch.nets import MLPDecoder, MLPEncoder

INPUT = (3, 4, 4)
LATENT = 4
FP32 = {"dtype": "float32"}


def _rhvaes(config=None):
    kwargs = dict(input_dim=INPUT, latent_dim=LATENT, n_lf=2, eps_lf=1e-3,
                  encoder_config=config, decoder_config=config)
    return JaxRHVAE(**kwargs), RHVAE(**kwargs)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, frac):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=frac * max(float(np.abs(want).max()), 1e-30))


def _draws(key, b):
    """JAX's forward draws from its step key: eps0 then gamma."""
    k_eps, k_gamma = jax.random.split(key)
    return {"eps0": torch.tensor(np.asarray(jax.random.normal(k_eps, (b, LATENT)))),
            "gamma": torch.tensor(np.asarray(jax.random.normal(k_gamma, (b, LATENT))))}


def test_metric_mlp_matches_jax():
    net = JaxMetricMLP(input_dim=INPUT, latent_dim=6)
    x = np.random.default_rng(0).uniform(size=(3, *INPUT)).astype(np.float32)
    variables = net.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(net.apply(variables, jnp.asarray(x)))
    port = MetricMLP(INPUT, 6)
    port.load_state_dict(net_state_from_flax(_numpy(variables["params"])))
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * float(np.abs(want).max()))
    assert np.all(np.triu(got, 1) == 0) and np.all(np.diagonal(got, axis1=1, axis2=2) > 0)


@pytest.fixture(scope="module")
def fp32_case():
    """JAX's fp32-policy RHVAE, its init, a batch, the forward's outputs and
    gradients (one jitted value_and_grad), and the port's RHVAE on the same
    weights."""
    jr, tr = _rhvaes(FP32)
    params = _numpy(jr.init(jax.random.PRNGKey(0))["params"])
    x = np.random.default_rng(0).uniform(size=(4, *INPUT)).astype(np.float32)
    key = jax.random.PRNGKey(1)

    def loss_fn(p):
        out = jr.forward(p, jnp.asarray(x), key)
        return out.loss, {k: out[k] for k in ("z0", "z", "rho", "mu", "log_var", "m_mats")}

    (loss, outs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tr.load_state_dict(rhvae_state_from_jax(params))
    return tr, x, _draws(key, 4), float(loss), _numpy(outs), _numpy(grads)


def test_forward_and_gradients_match_jax(fp32_case):
    tr, x, noise, loss, outs, grads = fp32_case
    from rlvae_tpu_torch.ops.metric_kernels import g_inv

    tr.zero_grad(set_to_none=True)
    launches = g_inv.launches
    out = tr(torch.from_numpy(x), noise)
    assert g_inv.launches == launches  # CPU tensors: the plain version
    np.testing.assert_allclose(float(out["loss"].detach()), loss, rtol=1e-6)
    for k, want in outs.items():
        _close(out[k].detach().numpy(), want, 1e-5)
    assert not np.allclose(out["z"].detach().numpy(), out["z0"].detach().numpy())
    out["loss"].backward()
    got = rhvae_params_to_numpy(_grads_as_params(tr))
    flat_want = jax.tree_util.tree_leaves_with_path(grads)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_want) == len(flat_got) == 16
    for path, want in flat_want:
        _close(flat_got[path], want, 1e-5)
    # the metric net's gradient reaches it only through the batch metric
    assert max(float(np.abs(v).max()) for v in jax.tree_util.tree_leaves(got["metric"])) > 0


def _grads_as_params(module):
    """A copy of ``module`` whose parameters hold its gradients."""
    import copy

    out = copy.deepcopy(module)
    for p, q in zip(module.parameters(), out.parameters()):
        q.data = p.grad.detach().clone()
    return out


def test_bf16_forward_loss_matches_jax():
    """The default policy (bf16 activations in the encoder and decoder)."""
    jr, tr = _rhvaes()
    params = _numpy(jr.init(jax.random.PRNGKey(2))["params"])
    tr.load_state_dict(rhvae_state_from_jax(params))
    x = np.random.default_rng(3).uniform(size=(4, *INPUT)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = float(jax.jit(lambda p: jr.forward(p, jnp.asarray(x), key).loss)(params))
    with torch.no_grad():
        got = float(tr(torch.from_numpy(x), _draws(key, 4))["loss"])
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_train_metric_matches_jax():
    """2 epochs x 4 batches of 8 on JAX's key chain: JAX's init carried
    across, each step's eps0 and gamma from its step key, the same
    ``default_rng(seed + epoch)`` permutations."""
    jr, tr = _rhvaes(FP32)
    data = np.random.default_rng(1).uniform(size=(32, *INPUT)).astype(np.float32)
    seed, epochs, bs = 0, 2, 8
    metric, info = jax_train_metric(jr, data, n_epochs=epochs, batch_size=bs,
                                    learning_rate=1e-3, seed=seed)
    key = jax.random.PRNGKey(seed)
    key, k_init = jax.random.split(key)
    tr.load_state_dict(rhvae_state_from_jax(_numpy(jr.init(k_init)["params"])))
    noise = []
    for _ in range(epochs * (data.shape[0] // bs)):
        key, k_step = jax.random.split(key)
        noise.append(_draws(k_step, bs))
    got, got_info = train_metric(tr, data, n_epochs=epochs, batch_size=bs, learning_rate=1e-3,
                                 seed=seed, noise=noise)
    np.testing.assert_allclose(got_info["loss_history"], info["loss_history"], rtol=1e-5)
    assert got.n_centroids == metric.n_centroids == 64
    _close(got.centroids.numpy(), metric.centroids, 1e-4)
    _close(got.matrices.numpy(), metric.matrices, 1e-4)
    assert (got.temperature, got.regularization) == (1.5, 0.01)


def test_ring_buffer_cap():
    rhvae = RHVAE(input_dim=(1, 2, 2), latent_dim=2, n_lf=1)
    rhvae.buffer_maxlen = 3
    for i in range(5):
        rhvae.record_batch(np.eye(2)[None], np.zeros((1, 2)) + i)
    assert len(rhvae.buffer_m) == 3
    metric = rhvae.consolidate_metric()
    assert metric.n_centroids == 3
    np.testing.assert_array_equal(metric.centroids.numpy()[:, 0], [2, 3, 4])
    with pytest.raises(RuntimeError, match="No batches"):
        RHVAE(input_dim=(1, 2, 2), latent_dim=2).consolidate_metric()


def test_components_run_is_read_by_jax(tmp_path):
    out = tmp_path / "components"
    summary = components.main([
        "--out-dir", str(out), "--device", "cpu", "--synthetic", "4", "--image-size", "8",
        "--epochs", "1", "--metric-epochs", "1", "--latent-dim", "4", "--batch-size", "8",
        "--metric-centroids", "12"])
    assert summary["frames"] == 32 and summary["n_centroids"] == 12
    assert sorted(p.name for p in out.iterdir()) == ["decoder.npz", "encoder.npz", "metric.npz"]
    # the metric: JAX's loader and report read the port's file
    jm = jax_load_metric(out / "metric.npz")
    tm = load_metric(out / "metric.npz")
    np.testing.assert_array_equal(np.asarray(jm.centroids), tm.centroids.numpy())
    np.testing.assert_array_equal(np.asarray(jm.matrices), tm.matrices.numpy())
    assert (float(jm.temperature), float(jm.regularization)) == (1.5, np.float32(0.01))
    assert validate_metric_file(out / "metric.npz") == jax_validate_metric_file(out / "metric.npz")
    report = convert_metric_file(out / "metric.npz", tmp_path / "copy.npz",
                                 temperature_override=0.5)
    assert report["temperature"] == 0.5 and report["valid"] and report["n_centroids"] == 12
    # the nets: JAX's modules on the port's .npz against the port's nets
    x = np.random.default_rng(5).uniform(size=(3, 3, 8, 8)).astype(np.float32)
    z = np.random.default_rng(6).normal(size=(3, 4)).astype(np.float32)
    jenc = JaxMLPEncoder(input_dim=(3, 8, 8), latent_dim=4, dtype=jnp.float32)
    jdec = JaxMLPDecoder(input_dim=(3, 8, 8), latent_dim=4, dtype=jnp.float32)
    enc = MLPEncoder((3, 8, 8), 4, dtype=torch.float32)
    dec = MLPDecoder((3, 8, 8), 4, dtype=torch.float32)
    load_pretrained_net(enc, out / "encoder.npz")
    load_pretrained_net(dec, out / "decoder.npz")
    want_mu = jenc.apply(jax_load_component_npz(out / "encoder.npz"), jnp.asarray(x)).embedding
    want_x = jdec.apply(jax_load_component_npz(out / "decoder.npz"), jnp.asarray(z)).reconstruction
    with torch.no_grad():
        got_mu = enc(torch.from_numpy(x))["embedding"].numpy()
        got_x = dec(torch.from_numpy(z))["reconstruction"].numpy()
    np.testing.assert_allclose(got_mu, np.asarray(want_mu), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_x, np.asarray(want_x), rtol=1e-5, atol=1e-5)
    # a metric saved by the port round-trips, and the out dir is required
    save_metric(tm, tmp_path / "again.npz")
    assert np.array_equal(np.load(tmp_path / "again.npz")["M_matrices"], tm.matrices.numpy())
    with pytest.raises(SystemExit):
        components.main(["--device", "cpu"])
