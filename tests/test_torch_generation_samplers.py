"""The generation-sampler zoo of the port against the JAX package's
(``rlvae_tpu/samplers/generation.py``) on the CPU: each sampler's latents on
JAX's draws (``NormalSampler``, ``RHVAEGenerationSampler``,
``AdaptiveRHVAEGenerationSampler`` without and with the persistent pool),
the decode, ``fit``, ``sample``'s batching and files, and the registry.

Sizes: a model of the default preset's kind at 3x8x8, MLP nets of hidden
32 in fp32, the K=50 metric at T=3.0; a 10 x 5 official chain; a plan of
the calibration's form with a 16-entry pool made from a seed (the
calibration is held to JAX in test_torch_adaptive_hmc.py), 4 generation
steps.  Tolerances: latents within 1e-5 of max(1, |z|) (the official
chain's whole-chain bound, tests/test_torch_hmc.py), decoded frames atol
1e-6 (the same fp32 decoder on the same latents).
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rlvae_tpu.geometry import load_metric as jax_load_metric
from rlvae_tpu.models.rlvae import RlVAE as JaxRlVAE
from rlvae_tpu.samplers import generation as jgen
from rlvae_tpu.samplers import hmc as jhmc
from rlvae_tpu_torch.convert import from_jax_variables, plan_from_jax
from rlvae_tpu_torch.geometry import load_metric
from rlvae_tpu_torch.models import RlVAE
from rlvae_tpu_torch.samplers import generation as tgen
from rlvae_tpu_torch.samplers import hmc as thmc

METRIC = Path(__file__).resolve().parents[1] / "data" / "pretrained" / "metric_T0.7_scaled.npz"
Z_TOL = 1e-5
POOL, GEN_STEPS, N = 16, 4, 5


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


@pytest.fixture(scope="module")
def model_pair():
    jmetric = jax_load_metric(METRIC, temperature_override=3.0)
    tmetric = load_metric(METRIC, temperature_override=3.0)
    net = {"architecture": "mlp", "hidden_dims": [32], "dtype": "float32"}
    kw = dict(input_dim=(3, 8, 8), latent_dim=16, n_flows=1, flow_hidden_size=16,
              encoder_config=net, decoder_config=net)
    jm = JaxRlVAE(metric=jmetric, **kw)
    jv = jm.init(jax.random.PRNGKey(0))
    pm = RlVAE(metric=tmetric, **kw)
    pm.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray, jv)))
    return jm, jv, pm.eval().requires_grad_(False)


def _t(a):
    return torch.tensor(np.asarray(a))


def _assert_latents(got, want):
    err = np.abs(np.asarray(got) - np.asarray(want)) / np.maximum(1.0, np.abs(np.asarray(want)))
    assert err.max() <= Z_TOL, err.max()


def _jax_plan(jm):
    rng = np.random.default_rng(0)
    eps = rng.uniform(0.004, 0.012, size=jm.n_centroids).astype(np.float32)
    cidx = rng.integers(0, jm.n_centroids, size=POOL)
    return {"eps": eps, "n_lf": 8, "accept_rate": 0.65, "path_length": 0.45,
            "calibration_lf": 0, "chains": jm.n_centroids,
            "pool": (np.asarray(jm.centroids)[cidx]
                     + 0.02 * rng.normal(size=(POOL, 16))).astype(np.float32),
            "pool_eps": eps[cidx]}


def _planned_draws(key, n, steps):
    """The draws of JAX's planned chain and of its persistent sampler."""
    k_init, k_s, k_j = jax.random.split(key, 3)
    g_s, u_s = jhmc.draw_chain_noise(k_s, steps, n, 16)
    return {"idx": _t(jax.random.permutation(k_init, POOL)[:n]), "gammas": _t(g_s),
            "unifs": _t(u_s),
            "jitters": _t(1.0 + 0.2 * (2.0 * jax.random.uniform(k_j, (steps, n)) - 1.0))}


def test_registry_and_decode(model_pair):
    """The registry holds every one of JAX's samplers (``vamp`` since its
    research model is ported); a sampler decodes latents as the JAX sampler
    does."""
    jm, jv, pm = model_pair
    assert set(tgen.SAMPLER_REGISTRY) == set(jgen.SAMPLER_REGISTRY)
    assert tgen.SAMPLER_REGISTRY["rhvae_adaptive"] is tgen.AdaptiveRHVAEGenerationSampler
    for name, cls in tgen.SAMPLER_REGISTRY.items():
        assert cls.name == jgen.SAMPLER_REGISTRY[name].name
    z = np.random.default_rng(1).normal(size=(N, 16)).astype(np.float32)
    want = jgen.NormalSampler(jm, jv)._decode(jax.numpy.asarray(z))
    got = tgen.NormalSampler(pm)._decode(torch.from_numpy(z))
    assert got.shape == want.shape == (N, 3, 8, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_normal_sampler_matches_jax(model_pair):
    jm, jv, pm = model_pair
    key = jax.random.PRNGKey(3)
    want = np.asarray(jgen.NormalSampler(jm, jv).sample_latents(key, N))
    got = tgen.NormalSampler(pm).sample_latents(
        N, noise={"eps": _t(jax.random.normal(key, (N, 16)))})
    np.testing.assert_array_equal(got.numpy(), want)


def test_rhvae_sampler_matches_jax(model_pair):
    """The official chain (centroid starts, tempering, the unguarded accept)
    at 10 x 5 on JAX's draws."""
    jm, jv, pm = model_pair
    jcfg = jhmc.HMCConfig(mcmc_steps=10, n_lf=5, init="centroids", backend="xla")
    key = jax.random.PRNGKey(4)
    want = jgen.RHVAEGenerationSampler(jm, jv, hmc_config=jcfg).sample_latents(key, N)
    k_init, k_chain = jax.random.split(key)
    gammas, unifs = jhmc.draw_chain_noise(k_chain, 10, N, 16)
    noise = {"z0": _t(jm.metric.centroids[jax.random.randint(k_init, (N,), 0, 50)]),
             "gammas": _t(gammas), "unifs": _t(unifs)}
    sampler = tgen.RHVAEGenerationSampler(pm, hmc_config=thmc.HMCConfig(mcmc_steps=10, n_lf=5))
    _assert_latents(sampler.sample_latents(N, noise=noise), want)
    with pytest.raises(ValueError, match="metric"):
        tgen.RHVAEGenerationSampler(RlVAE(input_dim=(3, 8, 8), n_flows=1, flow_hidden_size=8))


@pytest.mark.parametrize("persistent", [False, True])
def test_adaptive_sampler_matches_jax(model_pair, persistent):
    """The adaptive sampler on a plan (JAX's, carried across): the planned
    chain's latents; with ``persistent`` the pool after two calls, each
    call's final states written into the slots it started from (their eps
    unchanged), against JAX's pool."""
    jm, jv, pm = model_pair
    jplan = _jax_plan(jm.metric)
    js = jgen.AdaptiveRHVAEGenerationSampler(
        jm, jv, hmc_config=jhmc.HMCConfig(init="centroids", backend="xla"), pool_size=POOL,
        gen_steps=GEN_STEPS, persistent=persistent)
    js.plan = {k: np.array(v) if np.ndim(v) else v for k, v in jplan.items()}
    ts = tgen.AdaptiveRHVAEGenerationSampler(pm, pool_size=POOL, gen_steps=GEN_STEPS,
                                             persistent=persistent)
    ts.plan = plan_from_jax(jplan)
    for seed in (5, 6):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(js.sample_latents(key, N))
        noise = _planned_draws(key, N, GEN_STEPS)
        got = ts.sample_latents(N, noise=noise)
        _assert_latents(got, want)
        pool = ts.plan["pool"].numpy()
        if persistent:
            np.testing.assert_array_equal(pool[noise["idx"].numpy()], got.numpy())
        _assert_latents(pool, np.asarray(js.plan["pool"]))
    np.testing.assert_array_equal(ts.plan["pool_eps"].numpy(), jplan["pool_eps"])
    if not persistent:
        np.testing.assert_array_equal(ts.plan["pool"].numpy(), jplan["pool"])


def test_adaptive_fit_is_the_calibration(model_pair, monkeypatch):
    """fit() calibrates with the sampler's pool size and a generator seeded
    with the calibration seed on the metric's device; sample_latents fits
    once when no plan is there."""
    _, _, pm = model_pair
    seen = []

    def calibrate(metric, config, pool_size, generator):
        seen.append((pool_size, generator.initial_seed(), generator.device.type, config.init))
        return plan_from_jax(_jax_plan(metric))

    monkeypatch.setattr(tgen, "calibrate_adaptive_plan", calibrate)
    sampler = tgen.AdaptiveRHVAEGenerationSampler(pm, pool_size=POOL, gen_steps=2)
    z = sampler.sample_latents(3, torch.Generator().manual_seed(0))
    sampler.sample_latents(3, torch.Generator().manual_seed(1))
    assert seen == [(POOL, 12, "cpu", "centroids")]
    assert z.shape == (3, 16) and torch.isfinite(z).all()


def test_sample_batches_and_files(model_pair, tmp_path):
    """sample() draws the latents batch by batch from one generator seeded
    with ``seed``, decodes each batch, and writes generated.npz and
    sampler_config.json; return_gen=False returns None."""
    _, _, pm = model_pair
    sampler = tgen.NormalSampler(pm)
    out = sampler.sample(num_samples=N, batch_size=2, output_dir=tmp_path / "gen",
                         save_sampler_config=True, seed=7)
    g = torch.Generator().manual_seed(7)
    batches = [sampler._decode(torch.randn((b, 16), generator=g)) for b in (2, 2, 1)]
    assert out.shape == (N, 3, 8, 8)
    np.testing.assert_array_equal(out, np.concatenate(batches))
    with np.load(tmp_path / "gen" / "generated.npz") as f:
        np.testing.assert_array_equal(f["images"], out)
    cfg = json.loads((tmp_path / "gen" / "sampler_config.json").read_text())
    assert cfg == {"name": "NormalSampler", "num_samples": N}
    assert sampler.sample(num_samples=3, batch_size=500, return_gen=False) is None
    np.testing.assert_array_equal(sampler.sample(num_samples=N, batch_size=2, seed=7), out)
    sampler.fit()  # a no-op
