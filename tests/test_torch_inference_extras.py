"""The rest of inference against the JAX package on the CPU: ``slerp`` and
``ModelManager.interpolate`` (linear, spherical, geodesic),
``RlVAE.estimate_nll`` for the ``riemannian_metric`` and a Gaussian
posterior, the posterior HMC chain and ``refine_for_training``, and the
hybrid model's eval forward with ``sampling.method: hmc``; and the refusal of
a gradient through the HMC terms kernel, which has no backward.

Sizes: MLP nets of hidden 32 in fp32, 2 flows of hidden 32, latent 16, the
K=50 metric at T=3.0 (the K=200 metric at T=0.7 for the hybrid model), B=3
or 4.  Weights are JAX's, carried across by ``convert.from_jax_variables``;
every draw is JAX's, passed in.

Tolerances, each with its reason:
- slerp and interpolate: latents atol 1e-6 (``jnp.linspace`` and
  ``torch.linspace`` may round ``t`` one ulp apart), frames atol 1e-6; the
  geodesic interpolation by its energy and points (see its test).
- estimate_nll: log w and the NLL rtol 1e-5 (sums over T*C*H*W squared
  fp32 residuals and one logsumexp).
- the posterior HMC chain (20 x 5 leapfrog steps, two terms calls each, no
  accept test): z within 1e-5 of max(1, |z|), the official chain's
  whole-chain bound; refine_for_training (3 gradient steps) likewise.
- the hybrid model's eval forward: z within 1e-5 of each time step's
  largest |z| (plus 1e-6), losses rtol 1e-4, as tests/test_torch_posterior.py.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.geometry import load_metric as jax_load_metric
from rlvae_tpu.inference import ModelManager as JaxManager
from rlvae_tpu.inference import slerp as jax_slerp
from rlvae_tpu.models.rlvae import RlVAE as JaxRlVAE
from rlvae_tpu.samplers import hmc as jhmc
from rlvae_tpu_torch import ModelManager, slerp
from rlvae_tpu_torch.convert import from_jax_variables
from rlvae_tpu_torch.geometry import load_metric
from rlvae_tpu_torch.models import RlVAE
from rlvae_tpu_torch.ops.metric_kernels import chol_bundle, hmc_terms
from rlvae_tpu_torch.samplers import hmc as thmc

DATA = Path(__file__).resolve().parents[1] / "data" / "pretrained"
CHAIN_TOL = 1e-5
NLL_RTOL = 1e-5
GEODESIC_ENERGY_RTOL = 2e-3
GEODESIC_PATH_ATOL = 1e-2


@pytest.fixture(scope="module", autouse=True)
def jax_jitted_terms():
    """JAX's samplers evaluate their own XLA terms (``_terms_fn``) as one
    compiled program per shape instead of op by op: the arithmetic their
    scans compile anyway, at a fraction of the tracing time."""
    inner, cache = jhmc._terms_fn, {}

    def jitted(metric, backend):
        key = (id(metric), backend)
        if key not in cache:
            cache[key] = (metric, jax.jit(inner(metric, backend)))
        return cache[key][1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhmc, "_terms_fn", jitted)
        yield


def _metrics(name="metric_T0.7_scaled.npz", t_override=3.0):
    return (jax_load_metric(DATA / name, temperature_override=t_override),
            load_metric(DATA / name, temperature_override=t_override))


def _kwargs(posterior_type="riemannian_metric", sampling_method="geodesic", input_dim=(3, 8, 8)):
    net = {"architecture": "mlp", "hidden_dims": [32], "dtype": "float32"}
    return dict(input_dim=input_dim, latent_dim=16, n_flows=2, flow_hidden_size=32,
                flow_n_blocks=2, flow_n_hidden=3, posterior_type=posterior_type,
                sampling_method=sampling_method, encoder_config=net, decoder_config=net)


def _pair(metrics=None, **kwargs):
    """(JAX model, its variables, the port's model with those weights)."""
    jmetric, tmetric = metrics or _metrics()
    jm = JaxRlVAE(metric=jmetric, **_kwargs(**kwargs))
    jv = jm.init(jax.random.PRNGKey(0))
    pm = RlVAE(metric=tmetric, **_kwargs(**kwargs))
    pm.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray, jv)))
    return jm, jv, pm.eval()


@pytest.fixture(scope="module")
def default_pair():
    return _pair()


def _frames(seed, shape):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# slerp and interpolate
# ---------------------------------------------------------------------------


def test_slerp_matches_jax():
    """Scalar and column t, near-parallel and near-opposite pairs (the
    clip), a zero vector (the +1e-8 guard)."""
    rng = np.random.default_rng(0)
    z1 = rng.normal(size=(5, 16)).astype(np.float32)
    z2 = rng.normal(size=(5, 16)).astype(np.float32)
    z2[1] = z1[1] * 1.5
    z2[2] = -z1[2]
    z2[3] = 0.0
    for t in (0.0, 0.3, 1.0):
        want = np.asarray(jax_slerp(t, jnp.asarray(z1), jnp.asarray(z2)))
        got = slerp(t, torch.from_numpy(z1), torch.from_numpy(z2)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=str(t))
    ts = np.linspace(0, 1, 7, dtype=np.float32)[:, None]
    want = np.asarray(jax.vmap(lambda t: jax_slerp(t, jnp.asarray(z1[0]), jnp.asarray(z2[0])))(
        jnp.asarray(ts[:, 0])))
    got = slerp(torch.from_numpy(ts), torch.from_numpy(z1[0]), torch.from_numpy(z2[0])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["linear", "spherical"])
def test_interpolate_matches_jax(default_pair, mode):
    jm, jv, pm = default_pair
    x1, x2 = _frames(1, (3, 8, 8)), _frames(2, (3, 8, 8))
    want = np.asarray(JaxManager(jm, jv).interpolate(x1, x2, n_steps=10, mode=mode))
    got = ModelManager(pm, device="cpu").interpolate(x1, x2, n_steps=10, mode=mode)
    assert got.shape == want.shape == (10, 3, 8, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_interpolate_geodesic_raises_naming_its_queue(default_pair, monkeypatch):
    """``geodesic`` was refused until the geodesic solver was ported; now it
    is held to JAX's: the energy-minimized path (10 points, 200 Adam steps)
    between the two embeddings under the K=50 metric, decoded.  Both
    packages' latent paths are recorded.  The embeddings lie where the
    metric barely curves, so the energy gradient across the line is at
    rounding level and Adam's first steps normalize it to lr-sized moves
    (two paths 3e-8 apart after step 1 are 5e-3 apart after step 3), and
    Adam at lr 0.05 does not settle in 200 steps: its iterates circle the
    optimum and spike now and then.  The last iterate's points move by up
    to 4.2e-3 and its energy by up to 8.7e-4 relative with the last bits
    of the embeddings (measured here, with and without the tests that run
    before this one: 7.3e-4 / 6.5e-5, 4.2e-3 / 8.7e-4).  So the path is
    held by its energy (rtol GEODESIC_ENERGY_RTOL), its points only to
    the optimum's neighbourhood (GEODESIC_PATH_ATOL of max(1, |z|)), and
    the frames as the decoded points: JAX's frames are the port's decoder
    on JAX's path, and the port's the decoder on its own.  Between
    centroids, where the gradient is well above rounding, whole paths
    agree to 7.5e-6 (tests/test_torch_geodesics.py holds them at 1e-4)."""
    from rlvae_tpu.geometry import geodesics as jgeo
    from rlvae_tpu_torch import inference as tinf
    from rlvae_tpu_torch.geometry import geodesics as tgeo

    paths = {}

    def recording(name, fn):
        def wrapped(*args, **kwargs):
            paths[name] = fn(*args, **kwargs)
            return paths[name]
        return wrapped

    monkeypatch.setattr(jgeo, "geodesic_interpolate", recording("jax", jgeo.geodesic_interpolate))
    monkeypatch.setattr(tinf, "geodesic_interpolate", recording("port", tinf.geodesic_interpolate))
    jm, jv, pm = default_pair
    x1, x2 = _frames(1, (3, 8, 8)), _frames(2, (3, 8, 8))
    want = np.asarray(JaxManager(jm, jv).interpolate(x1, x2, n_steps=10, mode="geodesic"))
    manager = ModelManager(pm, device="cpu")
    got = manager.interpolate(x1, x2, n_steps=10, mode="geodesic")
    assert got.shape == want.shape == (10, 3, 8, 8)
    jpath, tpath = np.asarray(paths["jax"]), paths["port"]
    assert tpath.shape == (10, 16)
    np.testing.assert_allclose(float(tgeo._segment_energy(pm.metric, tpath[None])[0]),
                               float(jgeo._segment_energy(jm.metric, jnp.asarray(jpath))),
                               rtol=GEODESIC_ENERGY_RTOL)
    np.testing.assert_allclose(tpath.numpy(), jpath, rtol=0,
                               atol=GEODESIC_PATH_ATOL * max(1.0, float(np.abs(jpath).max())))
    np.testing.assert_allclose(manager.decode(jpath), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got, manager.decode(tpath))


# ---------------------------------------------------------------------------
# estimate_nll
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("posterior_type", ["riemannian_metric", "gaussian"])
def test_estimate_nll_matches_jax(monkeypatch, posterior_type):
    """The importance-sampled NLL on JAX's ε (S=8 samples, B=3 sequences of
    4 frames): every sample's log w and the NLL; the riemannian posterior's
    proposal takes one chol-bundle call, the flows one IAF-chain call per
    sample."""
    from rlvae_tpu_torch.ops import iaf_kernels

    jm, jv, pm = _pair(posterior_type=posterior_type)
    x = _frames(3, (3, 4, 3, 8, 8))
    key, s = jax.random.PRNGKey(4), 8
    seen = {}
    lax_map = jax.lax.map

    def recording_map(f, xs, **kwargs):
        seen["jax"] = np.asarray(lax_map(f, xs, **kwargs))
        return seen["jax"]

    monkeypatch.setattr(jax.lax, "map", recording_map)
    want = np.asarray(jm.estimate_nll(jv, jnp.asarray(x), key, n_samples=s))
    eps = torch.stack([torch.tensor(np.asarray(jax.random.normal(k, (3, 16))))
                       for k in jax.random.split(key, s)])
    logsumexp = torch.logsumexp

    def recording_logsumexp(t, dim):
        seen["port"] = t.detach().numpy()
        return logsumexp(t, dim)

    monkeypatch.setattr(torch, "logsumexp", recording_logsumexp)
    calls = {"chol": [], "chain": []}
    for name, module, attr in (("chol", "rlvae_tpu_torch.ops.metric_kernels", "chol_bundle"),
                               ("chain", "rlvae_tpu_torch.ops.iaf_kernels", "iaf_chain_fwd")):
        inner = chol_bundle if name == "chol" else iaf_kernels.iaf_chain_fwd

        def counting(*args, _inner=inner, _name=name, **kwargs):
            calls[_name].append(1)
            return _inner(*args, **kwargs)

        monkeypatch.setattr(f"{module}.{attr}", counting)
    with torch.no_grad():
        got = pm.estimate_nll(torch.from_numpy(x), n_samples=s, noise=eps).numpy()
    assert seen["port"].shape == seen["jax"].shape == (s, 3)
    np.testing.assert_allclose(seen["port"], seen["jax"], rtol=NLL_RTOL)
    np.testing.assert_allclose(got, want, rtol=NLL_RTOL)
    assert len(calls["chol"]) == (1 if posterior_type == "riemannian_metric" else 0)
    assert len(calls["chain"]) == s
    # drawn from a generator, one sample's [B, D] at a time
    a = pm.estimate_nll(torch.from_numpy(x), n_samples=s,
                        generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(1)
    drawn = torch.stack([torch.randn((3, 16), generator=g) for _ in range(s)])
    torch.testing.assert_close(a, pm.estimate_nll(torch.from_numpy(x), n_samples=s, noise=drawn),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the posterior HMC chain, the training refinement, the hybrid model
# ---------------------------------------------------------------------------


def _posterior_inputs(jm, b=4, seed=0):
    rng = np.random.default_rng(seed)
    c = np.asarray(jm.centroids)
    mu = c[rng.integers(0, c.shape[0], size=b)] + 0.2 * rng.normal(size=(b, 16))
    mu = mu.astype(np.float32)
    log_var = (rng.normal(scale=0.5, size=(b, 16)) - 1.0).astype(np.float32)
    return mu, log_var


def jax_posterior_hmc_noise(key, b, n_steps=20, d=16):
    """The draws of JAX's sample_posterior_hmc(key, ...): ε, then one
    momentum per step."""
    k_init, k_chain = jax.random.split(key)
    return {"eps": torch.tensor(np.asarray(jax.random.normal(k_init, (b, d)))),
            "gammas": torch.stack([torch.tensor(np.asarray(jax.random.normal(k, (b, d))))
                                   for k in jax.random.split(k_chain, n_steps)])}


def _assert_chain_close(got, want):
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= CHAIN_TOL, err.max()


def test_sample_posterior_hmc_matches_jax(monkeypatch):
    """20 steps x 5 leapfrog steps at eps 0.01 on JAX's draws; 200 terms
    calls."""
    jm, tm = _metrics()
    mu, log_var = _posterior_inputs(jm)
    key = jax.random.PRNGKey(6)
    want = np.asarray(jhmc.sample_posterior_hmc(jm, key, jnp.asarray(mu), jnp.asarray(log_var)))
    noise = jax_posterior_hmc_noise(key, 4)
    calls = []

    def counting(*args):
        calls.append(1)
        return hmc_terms(*args)

    monkeypatch.setattr(thmc, "hmc_terms", counting)
    got = thmc.sample_posterior_hmc(tm, torch.from_numpy(mu), torch.from_numpy(log_var),
                                    noise["eps"], noise["gammas"]).numpy()
    assert len(calls) == 200
    _assert_chain_close(got, want)
    # sample_posterior(..., "hmc") is the same chain on draw_posterior_noise's draws
    from rlvae_tpu_torch.samplers import riemannian as tsr

    drawn = tsr.draw_posterior_noise(tm, "hmc", 4, 16, torch.Generator().manual_seed(2))
    assert sorted(drawn) == ["eps", "gammas"] and drawn["gammas"].shape == (20, 4, 16)
    np.testing.assert_array_equal(
        tsr.sample_posterior(tm, torch.from_numpy(mu), torch.from_numpy(log_var), "hmc",
                             noise).numpy(), got)


def test_refine_for_training_matches_jax():
    jm, tm = _metrics()
    mu, log_var = _posterior_inputs(jm, seed=1)
    key = jax.random.PRNGKey(8)
    want = np.asarray(jhmc.refine_for_training(jm, key, jnp.asarray(mu), jnp.asarray(log_var)))
    eps = torch.tensor(np.asarray(jax.random.normal(key, mu.shape)))
    got = thmc.refine_for_training(tm, torch.from_numpy(mu), torch.from_numpy(log_var), eps)
    _assert_chain_close(got.numpy(), want)


def test_hybrid_eval_forward_with_posterior_hmc_matches_jax():
    """The Gaussian-posterior model with ``sampling.method: hmc`` (the K=200
    metric at T=0.7): eval forward on JAX's draws inside its forward key."""
    jm, jv, pm = _pair(_metrics("metric.npz", 0.7), posterior_type="gaussian",
                       sampling_method="hmc", input_dim=(3, 16, 16))
    x = _frames(5, (3, 4, 3, 16, 16))
    key = jax.random.PRNGKey(7)
    jo = jax.jit(lambda v, xx, k: jm.forward(v, xx, k))(jv, jnp.asarray(x), key)
    noise = jax_posterior_hmc_noise(jax.random.split(key)[0], 3)
    drawn = pm.draw_posterior_noise(3, torch.Generator().manual_seed(0))
    assert sorted(drawn) == ["eps", "gammas"] and drawn["gammas"].shape == (20, 3, 16)
    with torch.no_grad():
        po = pm(torch.from_numpy(x), noise)
    want_z = np.asarray(jo.z)
    scale = np.abs(want_z).max(axis=(0, 2), keepdims=True)
    np.testing.assert_array_less(np.abs(po.z.numpy() - want_z),
                                 np.broadcast_to(1e-5 * scale + 1e-6, want_z.shape))
    for k in ("loss", "recon_loss", "kld_loss", "flow_loss"):
        np.testing.assert_allclose(float(po[k]), float(jo[k]), rtol=1e-4, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# no gradient through the HMC terms kernel
# ---------------------------------------------------------------------------


def test_gradient_through_the_terms_kernel_is_refused():
    """A chain that autograd would differentiate raises on tensors off the
    CPU (meta tensors stand in for the card's), naming the missing
    backward; under no_grad, or on the CPU (the plain terms are
    differentiable, as JAX's XLA terms are), it does not."""
    _, tm = _metrics()
    meta = torch.zeros((2, 16), device="meta", requires_grad=True)
    for fn in (lambda: thmc.sample_posterior_hmc(tm, meta, meta, meta.detach(),
                                                 torch.zeros((1, 2, 16), device="meta")),
               lambda: thmc.refine_for_training(tm, meta, meta, meta.detach())):
        with pytest.raises(NotImplementedError, match="backward"):
            fn()
    with torch.no_grad():
        thmc.refuse_grad_through_terms(tm, meta)
    thmc.refuse_grad_through_terms(tm, meta.detach())
    mu = torch.zeros((2, 16), requires_grad=True)
    z = thmc.refine_for_training(tm, mu, torch.zeros((2, 16)), torch.ones((2, 16)), n_steps=1)
    (grad,) = torch.autograd.grad(z.sum(), mu)
    assert torch.isfinite(grad).all()

