"""The Gaussian posterior's sampling methods and the hybrid model against JAX.

- ``sample_posterior`` with ``basic``, ``enhanced``, ``geodesic`` and
  ``official`` against JAX's ``sample_posterior`` on JAX's own draws: ε =
  normal(key) and, for ``geodesic``, the split JAX makes there
  (``k_eps, k_t = split(key)``: ε = normal(k_eps), t = uniform(k_t)), passed
  in.  Banks: the K=50 metric at T=3.0 and the K=200 metric at T=0.7.
  Tolerance 1e-5 of max(1, |z|) per entry, 1e-4 for ``geodesic``, whose
  G = (G^{-1})^{-1} comes back with G^{-1}'s rounding amplified by its
  condition number before its Cholesky.
- ``_top2_centroids`` breaks ties as ``jax.lax.top_k`` does (lower index
  first), and keeps the single-centroid case.
- ``PRESETS["hybrid_rlvae"]`` against the composed ``model=hybrid_rlvae``.
- Whole models at a small size (input 3x16x16, MLP nets 768->32->16 in fp32,
  2 flows of 2 MADE blocks 16->32->32->32->32, the K=200 metric, B=3): the
  hybrid model (``enhanced``) and its ``geodesic`` variant, forward with the
  analysis metrics, against JAX's ``RlVAE.forward(compute_metrics=True)`` on
  carried-across weights; losses and metrics rtol 1e-4 (``metric_conditioning``
  1e-3: a ratio of eigenvalues of G^{-1} at z0), z within 1e-5 of each time
  step's largest |z| (plus 1e-6).  Three ``make_train_step`` steps of the
  ``geodesic`` variant against JAX's ``make_train_step``: every step's losses
  and grad_norm rtol 1e-4, parameters after 3 steps atol 2e-5 (the
  tolerances of ``tests/test_torch_train.py`` at the near-identity flow init).
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.config import compose
from rlvae_tpu.geometry import load_metric as jax_load_metric
from rlvae_tpu.models.factory import create_hybrid_model as jax_create_hybrid_model
from rlvae_tpu.models.rlvae import RlVAE as JaxRlVAE
from rlvae_tpu.samplers import riemannian as jsr
from rlvae_tpu.train import optim as jopt
from rlvae_tpu.train.trainer import make_train_step as jax_make_train_step
from rlvae_tpu_torch.convert import from_jax_variables, params_to_numpy
from rlvae_tpu_torch.geometry import load_metric
from rlvae_tpu_torch.geometry.metric import CentroidMetric
from rlvae_tpu_torch.models import PRESETS, create_hybrid_model, create_model
from rlvae_tpu_torch.models.rlvae import RlVAE
from rlvae_tpu_torch.ops.metric_kernels import chol_bundle, g_inv, metric_bundle
from rlvae_tpu_torch.samplers import riemannian as tsr
from rlvae_tpu_torch.train import make_eval_step, make_optimizer, make_train_step

CONF = Path(__file__).resolve().parents[1] / "conf"
DATA = Path(__file__).resolve().parents[1] / "data" / "pretrained"
METHODS = ("basic", "enhanced", "geodesic", "official")
LOSSES = ("loss", "recon_loss", "kld_loss", "flow_loss", "loop_penalty")


def _metrics(name):
    t_over = {"metric_T0.7_scaled.npz": 3.0, "metric.npz": 0.7}[name]
    return (jax_load_metric(DATA / name, temperature_override=t_over),
            load_metric(DATA / name, temperature_override=t_over))


def jax_posterior_noise(key, method, b, d=16):
    """JAX's draws inside sample_posterior(key, ...) for ``method``."""
    if method == "geodesic":
        k_eps, k_t = jax.random.split(key)
        return {"eps": np.asarray(jax.random.normal(k_eps, (b, d))),
                "t": np.asarray(jax.random.uniform(k_t, (b, 1)))}
    return {"eps": np.asarray(jax.random.normal(key, (b, d)))}


def _torch_noise(noise):
    return {k: torch.from_numpy(np.array(v)) for k, v in noise.items()}


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", ["metric_T0.7_scaled.npz", "metric.npz"])
def test_sample_posterior_matches_jax(name, method):
    jm, tm = _metrics(name)
    rng = np.random.default_rng(0)
    b = 9
    c = np.asarray(jm.centroids)
    mu = (c[rng.integers(0, c.shape[0], size=b)] + 0.2 * rng.normal(size=(b, 16))).astype(np.float32)
    log_var = rng.normal(scale=0.5, size=(b, 16)).astype(np.float32) - 1.0
    key = jax.random.PRNGKey(11)
    want = np.asarray(jsr.sample_posterior(jm, key, jnp.asarray(mu), jnp.asarray(log_var),
                                           method))
    noise = jax_posterior_noise(key, method, b)
    got = tsr.sample_posterior(tm, torch.from_numpy(mu), torch.from_numpy(log_var), method,
                               _torch_noise(noise)).numpy()
    rtol = 1e-4 if method == "geodesic" else 1e-5
    assert np.all(np.abs(got - want) <= rtol * np.maximum(1.0, np.abs(want))), (
        float(np.abs(got - want).max()))


def test_standard_and_missing_metric_are_reparameterization():
    _, tm = _metrics("metric_T0.7_scaled.npz")
    mu, log_var, eps = (torch.randn(4, 16, generator=torch.Generator().manual_seed(i))
                        for i in range(3))
    want = mu + eps * torch.exp(0.5 * log_var)
    for metric, method in ((tm, "standard"), (None, "geodesic"), (None, "hmc")):
        got = tsr.sample_posterior(metric, mu, log_var, method, {"eps": eps})
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_posterior_hmc_raises_naming_its_queue():
    """The posterior HMC is ported; what still raises is its gradient
    through the HMC terms kernel, which has no backward: tensors off the
    CPU that autograd would differentiate (meta tensors stand in for the
    card's here)."""
    _, tm = _metrics("metric_T0.7_scaled.npz")
    mu = torch.zeros(2, 16, device="meta", requires_grad=True)
    gammas = torch.zeros(20, 2, 16, device="meta")
    with pytest.raises(NotImplementedError, match="A1"):
        tsr.sample_posterior(tm, mu, mu, "hmc", {"eps": mu.detach(), "gammas": gammas})
    with pytest.raises(ValueError, match="Unknown posterior"):
        tsr.sample_posterior(tm, mu, mu, "nope", {"eps": mu})


def test_top2_ties_break_as_jax_top_k():
    """Equidistant centroids: the lower index comes first, as in top_k."""
    d = 16
    e = np.eye(d, dtype=np.float32)
    # rows 1, 2 and 3 at distance 1 from the origin, row 0 at distance 2
    c = np.stack([2 * e[0], e[1], -e[1], e[2], 3 * e[3]]).astype(np.float32)
    m = np.broadcast_to(np.eye(d, dtype=np.float32), (5, d, d)).copy()
    mu = np.zeros((3, d), np.float32)
    mu[2] = 0.5 * (c[3] + c[4])  # no tie: 3 is nearer than 4
    from rlvae_tpu.geometry.metric import CentroidMetric as JaxMetric

    jm = JaxMetric.create(c, m, 1.0, 0.01)
    tm = CentroidMetric.create(c, m, 1.0, 0.01)
    jd, ji = jsr._top2_centroids(jm, jnp.asarray(mu))
    td, ti = tsr._top2_centroids(tm, torch.from_numpy(mu))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy()[0], [1, 2])
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    # one centroid: both slots point at it
    jm1, tm1 = JaxMetric.create(c[:1], m[:1], 1.0, 0.01), CentroidMetric.create(c[:1], m[:1], 1.0, 0.01)
    jd, ji = jsr._top2_centroids(jm1, jnp.asarray(mu))
    td, ti = tsr._top2_centroids(tm1, torch.from_numpy(mu))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)


def test_draw_posterior_noise_draws_what_the_method_reads():
    _, tm = _metrics("metric_T0.7_scaled.npz")
    g = torch.Generator().manual_seed(3)
    noise = tsr.draw_posterior_noise(tm, "geodesic", 5, 16, g)
    assert sorted(noise) == ["eps", "t"] and noise["t"].shape == (5, 1)
    g = torch.Generator().manual_seed(3)
    again = tsr.draw_posterior_noise(tm, "geodesic", 5, 16, g)
    assert all(torch.equal(noise[k], again[k]) for k in noise)
    for metric, method in ((tm, "enhanced"), (None, "geodesic")):
        assert sorted(tsr.draw_posterior_noise(metric, method, 5, 16, None)) == ["eps"]


# ---------------------------------------------------------------------------
# the hybrid preset
# ---------------------------------------------------------------------------


def test_hybrid_preset_matches_composed_config():
    composed = compose(CONF, overrides=["model=hybrid_rlvae"]).model.to_dict()
    preset = PRESETS["hybrid_rlvae"]
    for key, value in composed.items():
        if key in ("_target_", "epsilon", "flow_n_hidden"):
            continue  # factory-only keys; flow_n_hidden is forced to 3 on both sides
        assert preset[key] == value, key
    jm = jax_create_hybrid_model(composed)
    pm = create_hybrid_model(preset)
    assert pm.name == "hybrid_rlvae" == jm.name
    for attr in ("input_dim", "latent_dim", "n_flows", "beta", "riemannian_beta",
                 "posterior_type", "sampling_method", "use_riemannian", "loop_mode",
                 "loop_lambda", "flow_loss_mode"):
        assert getattr(pm, attr) == getattr(jm, attr), attr
    assert pm.posterior_type == "gaussian" and pm.sampling_method == "enhanced"
    assert pm.metric.n_centroids == 200 and pm.metric.temperature == pytest.approx(0.7)
    np.testing.assert_array_equal(pm.metric.matrices.numpy(), np.asarray(jm.metric.matrices))


# ---------------------------------------------------------------------------
# whole models at a small size
# ---------------------------------------------------------------------------

B = 3


def _model_kwargs(method):
    net = {"architecture": "mlp", "hidden_dims": [32], "dtype": "float32"}
    return dict(input_dim=(3, 16, 16), latent_dim=16, n_flows=2, flow_hidden_size=32,
                flow_n_blocks=2, flow_n_hidden=3, beta=1.0, riemannian_beta=1.0,
                posterior_type="gaussian", sampling_method=method, use_riemannian=True,
                loop_mode="open", loop_penalty=1.0, flow_log_var_bias_init=0.0,
                encoder_config=net, decoder_config=net)


@functools.lru_cache(maxsize=None)
def _jax_variables():
    """JAX's initial variables as numpy, made once for every whole-model test
    (the posterior method changes no variable)."""
    jm = JaxRlVAE(metric=_metrics("metric.npz")[0], **_model_kwargs("enhanced"))
    return jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _pair(method):
    """(JAX model, fresh JAX variables, port model with those weights)."""
    jmet, tmet = _metrics("metric.npz")
    jm = JaxRlVAE(metric=jmet, **_model_kwargs(method))
    pm = RlVAE(metric=tmet, **_model_kwargs(method))
    variables = _jax_variables()
    pm.load_state_dict(from_jax_variables(variables))
    # fresh device arrays each time: JAX's train step donates its variables
    return jm, jax.tree_util.tree_map(jnp.asarray, variables), pm


def _x(n_obs=4, seed=1):
    return np.random.default_rng(seed).uniform(size=(B, n_obs, 3, 16, 16)).astype(np.float32)


def _z_close(got, want):
    scale = np.abs(want).max(axis=(0, 2), keepdims=True)
    np.testing.assert_array_less(np.abs(got - want),
                                 np.broadcast_to(1e-5 * scale + 1e-6, want.shape))


FORWARD_KEY = 7


@functools.lru_cache(maxsize=None)
def _jax_forward_and_eval(method):
    """JAX's ``RlVAE.forward(compute_metrics=True)`` and ``_eval_metrics`` on
    :func:`_x` with key FORWARD_KEY, in one compile (XLA merges the shared
    forward), for the forward and eval-step tests to read."""
    from rlvae_tpu.train.trainer import _eval_metrics

    jm, jv, _ = _pair(method)

    def both(v, x, key):
        return jm.forward(v, x, key, compute_metrics=True), _eval_metrics(jm, v, x, key)

    return jax.jit(both)(jv, jnp.asarray(_x()), jax.random.PRNGKey(FORWARD_KEY))


@pytest.mark.parametrize("method", ["enhanced", "geodesic"])
def test_hybrid_forward_with_metrics_matches_jax(method):
    _, _, pm = _pair(method)
    x = _x()
    jo = _jax_forward_and_eval(method)[0]
    noise = jax_posterior_noise(jax.random.split(jax.random.PRNGKey(FORWARD_KEY))[0], method, B)
    counts = (chol_bundle.launches, metric_bundle.launches, g_inv.launches)
    with torch.no_grad():
        po = pm(torch.from_numpy(x), _torch_noise(noise), compute_metrics=True)
    assert (chol_bundle.launches, metric_bundle.launches, g_inv.launches) == counts  # CPU
    _z_close(po.z.numpy(), np.asarray(jo.z))
    for k in LOSSES:
        np.testing.assert_allclose(float(po[k]), float(jo[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    assert set(po.metrics) == set(jo.metrics)
    for k, v in jo.metrics.items():
        rtol = 1e-3 if k == "metric_conditioning" else 1e-4
        np.testing.assert_allclose(float(po.metrics[k]), float(v), rtol=rtol, err_msg=k)


def test_three_geodesic_train_steps_match_jax():
    jm, jv, pm = _pair("geodesic")
    x = _x()
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    lr, wd = 1e-3, 1e-4
    jax_opt = jopt.make_optimizer(lr, wd)
    opt_state = jax_opt.init(jv["params"])
    jstep = jax_make_train_step(jm, jax_opt)
    pstep = make_train_step(pm, make_optimizer(pm.parameters(), lr, wd))
    for i in range(3):
        key = jax.random.PRNGKey(100 + i)
        jv, opt_state, jmet = jstep(jv, opt_state, xj, key)
        noise = jax_posterior_noise(jax.random.split(key)[0], "geodesic", B)
        pmet = pstep(xt, _torch_noise(noise))
        for k in LOSSES + ("grad_norm",):
            np.testing.assert_allclose(float(pmet[k]), float(jmet[k]), rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {i + 1} {k}")
    jparams = jax.tree_util.tree_map(np.asarray, jv["params"])
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(pm)),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)


def test_eval_step_of_the_hybrid_model_has_jax_keys():
    _, _, pm = _pair("geodesic")
    x = _x()
    want = _jax_forward_and_eval("geodesic")[1]
    noise = jax_posterior_noise(jax.random.split(jax.random.PRNGKey(FORWARD_KEY))[0],
                                "geodesic", B)
    got = make_eval_step(pm)(torch.from_numpy(x), _torch_noise(noise))
    assert set(got) == set(want)
    for k, v in want.items():
        rtol = 1e-3 if k == "metric_conditioning" else 1e-4
        np.testing.assert_allclose(float(got[k]), float(v), rtol=rtol, atol=1e-6, err_msg=k)


def test_geodesic_model_draws_eps_then_t():
    _, _, pm = _pair("geodesic")
    g = torch.Generator().manual_seed(5)
    noise = pm.draw_posterior_noise(B, g)
    g = torch.Generator().manual_seed(5)
    assert torch.equal(noise["eps"], torch.randn((B, 16), generator=g))
    assert torch.equal(noise["t"], torch.rand((B, 1), generator=g))
    # the same forward from a generator and from the drawn mapping
    x = torch.from_numpy(_x())
    with torch.no_grad():
        a = pm(x, generator=torch.Generator().manual_seed(5))
        b = pm(x, noise)
    assert torch.equal(a.z, b.z)
    default = create_model({**PRESETS["riemannian_flow_vae"], "pretrained": {}})
    assert sorted(default.draw_posterior_noise(2, None)) == ["eps"]
