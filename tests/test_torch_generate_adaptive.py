"""Adaptive generation of the port against the JAX package on the CPU:
``RlVAE.generate(method="adaptive")`` on a plan (with and without a
warm-start pool) and without one (the budgeted sampler) against JAX's
``model.generate`` on the same weights and draws; the manager's cached
``adaptive_plan``, the batched-seeds contract on it and the engine's
``generate`` op with ``generate_method="adaptive"``.

Sizes: the K=50 metric at T=3.0, 16x16 frames (8x8 for the manager), MLP
nets of hidden 32, 8 flows of hidden 32 at the reference init.  The plans
compared with JAX are of the calibration's form made from a seed (the
calibration itself is held to JAX in test_torch_adaptive_hmc.py); the
manager's is its own calibration with a 16-entry pool.

Tolerances, each with its reason:
- latents of the planned chain: within 1e-5 of max(1, |z|), the official
  chain's whole-chain bound (tests/test_torch_hmc.py; measured ~2e-7 over
  12 steps in test_torch_adaptive_hmc.py); of the budget sampler: within
  1e-3, its whole-chain bound there (the dual averaging moves the tuned eps
  by the acceptance probabilities' rounding; measured ~1e-4 over 112
  steps);
- frames: atol 5e-4, as test_torch_generate.py (the reference-init flows
  scale the latent many times over per transition);
- batched-seed rows vs one-row calls: 5.0e-5, the official chain's bound
  there (the same draws; only the batch size of the CPU's products differs).
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rlvae_tpu.geometry import load_metric as jax_load_metric
from rlvae_tpu.models.rlvae import RlVAE as JaxRlVAE
from rlvae_tpu.samplers import hmc as jhmc
from rlvae_tpu_torch import BatchingEngine, ModelManager, PRESETS, ServeConfig
from rlvae_tpu_torch import inference as tinf
from rlvae_tpu_torch.convert import from_jax_variables, plan_from_jax
from rlvae_tpu_torch.geometry import load_metric
from rlvae_tpu_torch.models import RlVAE
from rlvae_tpu_torch.ops.metric_kernels import hmc_terms

METRIC = Path(__file__).resolve().parents[1] / "data" / "pretrained" / "metric_T0.7_scaled.npz"
Z_TOL = {"planned": 1e-5, "budget": 1e-3}
X_ATOL = 5e-4
ROW_ATOL = 5.0e-5
POOL = 16
CALIBRATED = [(POOL, 12, "cpu")]  # the manager's one calibration: pool, seed, device


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


def _t(a):
    return torch.tensor(np.asarray(a))


def _jax_plan(jm, pool=True, n_lf=8, seed=0):
    """A plan of ``calibrate_adaptive_plan``'s form (numpy, as JAX's)."""
    rng = np.random.default_rng(seed)
    eps = rng.uniform(0.004, 0.012, size=jm.n_centroids).astype(np.float32)
    plan = {"eps": eps, "n_lf": n_lf, "accept_rate": 0.65, "path_length": 0.45,
            "calibration_lf": 0, "chains": jm.n_centroids}
    if pool:
        cidx = rng.integers(0, jm.n_centroids, size=POOL)
        plan["pool"] = (np.asarray(jm.centroids)[cidx]
                        + 0.02 * rng.normal(size=(POOL, 16))).astype(np.float32)
        plan["pool_eps"] = eps[cidx]
    return plan


@pytest.fixture(scope="module")
def model_pair():
    """The default preset's architecture at a small width, fp32 nets, the
    K=50 metric; JAX's variables carried across."""
    jmetric = jax_load_metric(METRIC, temperature_override=3.0)
    tmetric = load_metric(METRIC, temperature_override=3.0)
    net = {"architecture": "mlp", "hidden_dims": [32], "dtype": "float32"}
    kw = dict(input_dim=(3, 16, 16), latent_dim=16, n_flows=8, flow_hidden_size=32,
              flow_n_blocks=2, flow_n_hidden=3, encoder_config=net, decoder_config=net)
    jm = JaxRlVAE(metric=jmetric, **kw)
    jv = jm.init(jax.random.PRNGKey(0))
    pm = RlVAE(metric=tmetric, **kw)
    pm.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray, jv)))
    return jm, jv, pm.eval().requires_grad_(False)


def _planned_draws(jm, key, n, plan, steps=12):
    """The draws of JAX's sample_prior_hmc_planned from ``key``."""
    k_init, k_s, k_j = jax.random.split(key, 3)
    if "pool" in plan:
        idx = jax.random.permutation(k_init, plan["pool"].shape[0])[:n]
    else:
        idx = jax.random.randint(k_init, (n,), 0, jm.n_centroids)
    g_s, u_s = jhmc.draw_chain_noise(k_s, steps, n, 16)
    jit = 1.0 + 0.2 * (2.0 * jax.random.uniform(k_j, (steps, n)) - 1.0)
    return {"idx": _t(idx), "gammas": _t(g_s), "unifs": _t(u_s), "jitters": _t(jit)}


def _budget_draws(jm, key, n, steps_s=None):
    """The draws of JAX's budget sampler from ``key``; without ``steps_s``
    those before its n_lf decision."""
    k_init, k_w, k_s, k_j = jax.random.split(key, 4)
    g_a, u_a = jhmc.draw_chain_noise(k_w, 40, n, 16)
    g_b, u_b = jhmc.draw_chain_noise(jax.random.fold_in(k_w, 1), 13, n, 16)
    noise = {"z0": jm.centroids[jax.random.randint(k_init, (n,), 0, jm.n_centroids)],
             "gammas_a": g_a, "unifs_a": u_a, "gammas_b": g_b, "unifs_b": u_b}
    if steps_s is not None:
        noise["gammas_s"], noise["unifs_s"] = jhmc.draw_chain_noise(k_s, steps_s, n, 16)
        noise["jitters"] = 1.0 + 0.2 * (2.0 * jax.random.uniform(k_j, (steps_s, n)) - 1.0)
    return {k: _t(v) for k, v in noise.items()}


def _assert_latents(got, want, sampler):
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= Z_TOL[sampler], (sampler, err.max())


def _jax_generate(monkeypatch, jm, jv, key, n, n_obs, plan=None):
    """JAX's generate(method="adaptive"), with the latents its sampler
    returned inside it (and, without a plan, the budget sampler's
    diagnostics): (frames, z, diagnostics)."""
    import rlvae_tpu.samplers as jsamplers

    name = "sample_prior_hmc_planned" if plan is not None else "sample_prior_hmc_adaptive_budget"
    inner, seen = getattr(jsamplers, name), {}

    def recording(*args, **kwargs):
        zs, diag = inner(*args, **kwargs, return_chain=True)
        seen.update(z=np.asarray(zs[-1]), diag=diag)
        return zs[-1]

    monkeypatch.setattr(jsamplers, name, recording)
    x = np.asarray(jm.generate(jv, key, n, n_obs=n_obs, method="adaptive", plan=plan))
    return x, seen["z"], seen["diag"]


def _assert_generate(pm, got_z, got_x, want_z, want_x, n_obs, sampler):
    """The port's frames are its latents through its flows and decoder; its
    latents are JAX's (Z_TOL); JAX's latents through the port's flows and
    decoder are JAX's frames (X_ATOL)."""
    from rlvae_tpu_torch.flows.temporal import apply_temporal_flows

    _assert_latents(got_z, want_z, sampler)

    def frames(z):
        with torch.no_grad():
            z_seq, _ = apply_temporal_flows(pm.flows, torch.tensor(z), n_obs)
            x = pm.decode(z_seq.reshape(-1, 16))["reconstruction"]
        return x.reshape(z.shape[0], n_obs, *pm.input_dim).numpy()

    assert got_x.shape == want_x.shape == (got_z.shape[0], n_obs, *pm.input_dim)
    np.testing.assert_array_equal(got_x, frames(got_z))
    np.testing.assert_allclose(frames(want_z), want_x, rtol=0, atol=X_ATOL)


@pytest.mark.parametrize("pool", [True, False], ids=["pool", "centroid-starts"])
def test_generate_on_a_plan_matches_jax(model_pair, monkeypatch, pool):
    """generate(method="adaptive", plan=...) against JAX's generate on the
    same plan (carried across by plan_from_jax) and draws: the planned
    chain from pool slots, or from centroids with their eps; 1 + 12 (n_lf +
    1) terms calls."""
    from rlvae_tpu_torch.samplers import hmc as thmc

    jm, jv, pm = model_pair
    key, n, n_obs = jax.random.PRNGKey(5), 3, 4
    jplan = _jax_plan(jm.metric, pool=pool)
    noise = _planned_draws(jm.metric, key, n, jplan)
    want_x, want_z, _ = _jax_generate(monkeypatch, jm, jv, key, n, n_obs, jplan)
    calls, terms = [], hmc_terms

    def counting(*args):
        calls.append(1)
        return terms(*args)

    seen, planned = {}, thmc.sample_prior_hmc_planned

    def recording(*args, **kwargs):
        seen["z"] = planned(*args, **kwargs).numpy()
        return torch.from_numpy(seen["z"])

    monkeypatch.setattr(thmc, "hmc_terms", counting)
    monkeypatch.setattr("rlvae_tpu_torch.models.rlvae.sample_prior_hmc_planned", recording)
    with torch.no_grad():
        got_x = pm.generate(n, n_obs, "adaptive", noise=noise, plan=plan_from_jax(jplan)).numpy()
    assert len(calls) == 1 + 12 * (jplan["n_lf"] + 1)
    _assert_generate(pm, seen["z"], got_x, want_z, want_x, n_obs, "planned")


def test_generate_without_a_plan_is_the_budget_sampler(model_pair, monkeypatch):
    """generate(method="adaptive") without a plan runs the budgeted sampler
    (as JAX's sample_random does), on JAX's draws: the same n_lf, steps and
    leapfrog count as JAX's, its latents and frames."""
    from rlvae_tpu_torch.samplers import hmc as thmc

    jm, jv, pm = model_pair
    key, n, n_obs = jax.random.PRNGKey(8), 3, 4
    want_x, want_z, jdiag = _jax_generate(monkeypatch, jm, jv, key, n, n_obs)
    noise = _budget_draws(jm.metric, key, n, jdiag["steps_sampling"])
    seen = {}
    budget = thmc.sample_prior_hmc_adaptive_budget

    def recording(*args, **kwargs):
        zs, diag = budget(*args, **kwargs, return_chain=True)
        seen.update(diag, z=zs[-1].numpy())
        return zs[-1]

    monkeypatch.setattr("rlvae_tpu_torch.models.rlvae.sample_prior_hmc_adaptive_budget", recording)
    with torch.no_grad():
        got_x = pm.generate(n, n_obs, "adaptive", noise=noise).numpy()
    for k in ("n_lf_sampling", "steps_sampling", "leapfrog_spent"):
        assert seen[k] == jdiag[k], (k, seen[k], jdiag[k])
    _assert_generate(pm, seen["z"], got_x, want_z, want_x, n_obs, "budget")
    with pytest.raises(ValueError, match="plan"):  # its draws cannot be made per row
        pm.draw_generation_noise(1, "adaptive", torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# the manager's plan, batched seeds and the engine
# ---------------------------------------------------------------------------

SMALL = {
    **PRESETS["riemannian_flow_vae"],
    "input_dim": [3, 8, 8], "n_flows": 2, "flow_hidden_size": 32,
    "pretrained": {"metric_path": str(METRIC)},
}


@pytest.fixture(scope="module")
def manager():
    """A small manager whose cached plan has a 16-entry pool spread 4 steps
    after phases of 8 steps (the defaults, 4096 entries spread 128 steps
    after 40 + 13, would take minutes of plain terms on the CPU; the
    calibration itself is held to JAX in test_torch_adaptive_hmc.py); the
    calibrations made are recorded in ``manager.calibrations``."""
    mgr = ModelManager.from_config(SMALL, seed=0, device="cpu")
    calibrate = tinf.calibrate_adaptive_plan
    mgr.calibrations = []

    def counting(*args, **kwargs):
        gen = kwargs["generator"]
        mgr.calibrations.append((kwargs["pool_size"], gen.initial_seed(), gen.device.type))
        return calibrate(*args, **kwargs, warmup=8, spread_steps=4)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tinf, "calibrate_adaptive_plan", counting)
        plan = mgr.adaptive_plan(pool_size=POOL)
        assert plan is mgr.adaptive_plan() and mgr.calibrations == CALIBRATED
        yield mgr


def test_adaptive_plan_is_built_once_on_seed_12(manager):
    """The plan is cached: later calls (any pool size) return the same
    object; it is the calibration of a generator seeded 12 on the
    manager's device; a model without a metric has none."""
    plan = manager.adaptive_plan()
    assert manager.adaptive_plan(pool_size=8) is plan
    assert manager.calibrations == CALIBRATED
    assert sorted(plan) == ["accept_rate", "calibration_lf", "chains", "eps", "n_lf",
                            "path_length", "pool", "pool_eps"]
    assert plan["pool"].shape == (POOL, 16) and plan["eps"].shape == (50,)
    assert 2 <= plan["n_lf"] <= 128 and 0.0 < plan["accept_rate"] <= 1.0
    no_metric = ModelManager(RlVAE(input_dim=(3, 8, 8), n_flows=1, flow_hidden_size=8),
                             device="cpu")
    with pytest.raises(ValueError, match="metric"):
        no_metric.adaptive_plan()


def _single(manager, seed, n_obs=8):
    """The one-row generate of ``seed`` on the manager's plan, with the
    generator sample_random would seed."""
    with torch.no_grad():
        x = manager.model.generate(1, n_obs, "adaptive", plan=manager.adaptive_plan(),
                                   generator=torch.Generator().manual_seed(seed))
    return x[0].numpy()


def test_batched_seeds_rows_equal_single_seed_calls_on_the_plan(manager):
    """Row i of sample_random_batched_seeds(method="adaptive") is the one-row
    generate of seeds[i] on the manager's plan; duplicate seeds give
    identical rows; sample_random runs the budget sampler."""
    seeds = [3, 11, 3]
    rows = manager.sample_random_batched_seeds(seeds, method="adaptive", n_obs=4)
    assert rows.shape == (3, 4, 3, 8, 8) and np.isfinite(rows).all()
    for i, s in enumerate(seeds):
        np.testing.assert_allclose(rows[i], _single(manager, s, n_obs=4), rtol=0, atol=ROW_ATOL)
    np.testing.assert_array_equal(rows[0], rows[2])
    assert not np.array_equal(rows[0], rows[1])
    budget = manager.sample_random(2, "adaptive", seed=3, n_obs=4)
    assert budget.shape == (2, 4, 3, 8, 8) and np.isfinite(budget).all()
    assert manager.calibrations == CALIBRATED


def test_engine_generate_adaptive(manager):
    """An engine with generate_method="adaptive" coalesces concurrent seeds
    into one dispatch on the cached plan; each row is its seed's one-row
    generate on that plan, and the duplicate seeds' rows are identical."""
    seeds = [7, 123, 7, 999]
    single = {s: _single(manager, s) for s in set(seeds)}
    engine = BatchingEngine.from_manager(manager, ServeConfig(buckets=(4,), max_wait_ms=2000),
                                         generate_method="adaptive")
    try:
        futs = [engine.submit("generate", np.uint32(s)) for s in seeds]
        rows = [f.result(timeout=120) for f in futs]
        snap = engine.stats_snapshot()
    finally:
        engine.stop()
    assert snap["batches"] == 1 and snap["requests"] == 4
    for s, row in zip(seeds, rows):
        assert row.shape == (8, 3, 8, 8)
        np.testing.assert_allclose(row, single[s], rtol=0, atol=ROW_ATOL)
    np.testing.assert_array_equal(rows[0], rows[2])
    assert manager.calibrations == CALIBRATED
