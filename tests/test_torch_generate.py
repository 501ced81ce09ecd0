"""Prior generation of the port against the JAX package on the CPU: each
prior method on JAX's own draws, ``RlVAE.generate`` against JAX's
``model.generate`` on the same weights (carried across by
``rlvae_tpu_torch.convert``) and the same draws, the batched-seeds contract
of ``ModelManager`` and the engine's ``generate`` op; and the repaired
``Trainer.evaluate`` defaults.

Sizes: the shipped K=50 metric at T=3.0 (the model's), 16x16 or 8x8 frames,
narrow nets (hidden 32), flows of hidden 32.  Tolerances, each with its
reason:
- prior latents: atol 1e-5 (fp32; the eigh-based square root and the
  chol-bundle agree to ~1e-6 on these matrices; ``basic`` takes 10 gradient
  steps of size <= 0.01).
- generate: prior latents as above; decoded frames atol 5e-4, as
  in test_torch_model.py: the reference-init flows scale the latent many
  times over per transition, and those large latents move the decoder's
  pre-activations by their own fp32 rounding.
- batched seeds: each row against ``sample_random(1, seed)`` at atol 1e-6
  for the prior methods (the same draws; only the batch size of the
  products differs, which the CPU's matrix products may round
  differently); for the official chain that rounding goes through 1601
  evaluations of the target and then through the flows, so its frames are
  held to the generate tolerance above (measured: 5.0e-5).  On the card
  the kernel and the chain are per row, and chip_smoke.py holds duplicate
  seeds in one batch to bit equality.
"""

import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.geometry import load_metric as jax_load_metric
from rlvae_tpu.models.rlvae import RlVAE as JaxRlVAE
from rlvae_tpu.samplers import hmc as jhmc
from rlvae_tpu.samplers import riemannian as jsr
from rlvae_tpu_torch import BatchingEngine, ModelManager, PRESETS, ServeConfig
from rlvae_tpu_torch.convert import from_jax_variables
from rlvae_tpu_torch.geometry import load_metric
from rlvae_tpu_torch.models import RlVAE
from rlvae_tpu_torch.ops.metric_kernels import chol_bundle, hmc_terms
from rlvae_tpu_torch.samplers import sample_prior
from rlvae_tpu_torch.train import Trainer

DATA = Path(__file__).resolve().parents[1] / "data" / "pretrained"
METRIC = DATA / "metric_T0.7_scaled.npz"
Z_ATOL = 1e-5
GEODESIC_EXACT_ATOL = 1e-4
X_ATOL = 5e-4
ROW_ATOL = 1e-6


def _metrics():
    return (jax_load_metric(METRIC, temperature_override=3.0),
            load_metric(METRIC, temperature_override=3.0))


def _jax_prior_draws(jm, method, key, n):
    """The draws JAX's sample_prior makes from ``key``, as numpy."""
    kc, d = jm.n_centroids, 16
    if method == "geodesic":
        k1, k2, k3, k4 = jax.random.split(key, 4)
        return {"i1": jax.random.randint(k1, (n,), 0, kc), "i2": jax.random.randint(k2, (n,), 0, kc),
                "t": jax.random.uniform(k3, (n, 1)), "eps": jax.random.normal(k4, (n, d))}
    if method == "geodesic_exact":
        k1, k2, k3, k4 = jax.random.split(key, 4)
        return {"i1": jax.random.randint(k1, (n,), 0, kc), "i2": jax.random.randint(k2, (n,), 0, kc),
                "s": jax.random.uniform(k3, (n,)), "eps": jax.random.normal(k4, (n, d))}
    if method == "basic":
        return {"eps": jax.random.normal(key, (n, d))}
    k1, k2 = jax.random.split(key)
    if method == "centroid_aware":
        idx = jax.random.randint(k1, (n,), 0, kc)
    else:
        logits = -jnp.linalg.norm(jm.centroids, axis=-1) / 2.0
        idx = jax.random.categorical(k1, logits, shape=(n,))
    return {"idx": idx, "eps": jax.random.normal(k2, (n, d))}


def _jax_hmc_draws(jm, key, n, init="centroids"):
    """The draws of JAX's sample_prior_hmc from ``key``."""
    k_init, k_chain = jax.random.split(key)
    if init == "centroids":
        z0 = jm.centroids[jax.random.randint(k_init, (n,), 0, jm.n_centroids)]
    else:
        z0 = jax.random.normal(k_init, (n, 16))
    gammas, unifs = jhmc.draw_chain_noise(k_chain, 100, n, 16)
    return {"z0": z0, "gammas": gammas, "unifs": unifs}


def _torch(noise):
    return {k: torch.tensor(np.asarray(v)) for k, v in noise.items()}


@pytest.mark.parametrize("method", ["geodesic", "centroid_aware", "weighted_mixture", "basic"])
def test_prior_method_matches_jax(method):
    jm, tm = _metrics()
    key, n = jax.random.PRNGKey(3), 6
    want = np.asarray(jsr.sample_prior(jm, key, n, 16, method))
    noise = _torch(_jax_prior_draws(jm, method, key, n))
    got = sample_prior(tm, n, 16, method, noise=noise).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=Z_ATOL)
    # the same method with draws from a generator: the same shapes, finite
    drawn = sample_prior(tm, n, 16, method, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (n, 16) and torch.isfinite(drawn).all()


def test_prior_methods_launch_nothing_on_the_cpu():
    """The weighted-mixture and basic priors call the chol-bundle; on CPU
    tensors that is the plain version."""
    _, tm = _metrics()
    before = chol_bundle.launches
    for method in ("weighted_mixture", "basic"):
        sample_prior(tm, 3, 16, method, generator=torch.Generator().manual_seed(1))
    assert chol_bundle.launches == before


def test_unported_and_unknown_methods_raise():
    """``geodesic_exact`` was refused until the geodesic solver was ported;
    now the same call is held to JAX's prior on JAX's draws (the point on
    the 12-point energy path of 80 Adam steps: within GEODESIC_EXACT_ATOL,
    as whole energy paths in tests/test_torch_geodesics.py; measured
    1.7e-6)."""
    jm, tm = _metrics()
    model = RlVAE(input_dim=(3, 8, 8), n_flows=1, flow_hidden_size=32, metric=tm,
                  encoder_config={"architecture": "mlp", "hidden_dims": [32]},
                  decoder_config={"architecture": "mlp", "hidden_dims": [32]})
    key = jax.random.PRNGKey(3)
    want = np.asarray(jsr.sample_prior(jm, key, 2, 16, "geodesic_exact"))
    noise = _torch(_jax_prior_draws(jm, "geodesic_exact", key, 2))
    assert bool((noise["i1"] != noise["i2"]).all())  # no zero-length path among the draws
    got = model.sample_riemannian_prior(2, "geodesic_exact", noise=noise).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=GEODESIC_EXACT_ATOL)
    # adaptive is ported; without a plan its draws depend on the whole batch
    with pytest.raises(ValueError, match="plan"):
        model.draw_generation_noise(2, "adaptive")
    with pytest.raises(ValueError, match="Unknown prior"):
        model.sample_riemannian_prior(2, "nope")
    # without a metric every method is the standard normal draw
    model.set_metric(None)
    eps = torch.randn(3, 16)
    for method in ("geodesic", "official"):
        assert torch.equal(model.sample_riemannian_prior(3, method, noise={"eps": eps}), eps)


# ---------------------------------------------------------------------------
# generate against JAX's model.generate
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_pair():
    """The preset's architecture at a small width (16x16 frames, hidden 32,
    flows of hidden 32 at the reference init), fp32 nets, the K=50 metric."""
    jmetric, tmetric = _metrics()
    net = {"architecture": "mlp", "hidden_dims": [32], "dtype": "float32"}
    kw = dict(input_dim=(3, 16, 16), latent_dim=16, n_flows=8, flow_hidden_size=32,
              flow_n_blocks=2, flow_n_hidden=3, encoder_config=net, decoder_config=net)
    jm = JaxRlVAE(metric=jmetric, **kw)
    jv = jm.init(jax.random.PRNGKey(0))
    pm = RlVAE(metric=tmetric, **kw)
    pm.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray, jv)))
    return jm, jv, pm.eval().requires_grad_(False)


@pytest.mark.parametrize("method", ["geodesic", "official"])
def test_generate_matches_jax(model_pair, method):
    """The official chain's latents alone are held to JAX's in
    test_torch_hmc.py; here the whole op, chain included, is compared on
    its frames."""
    jm, jv, pm = model_pair
    key, n, n_obs = jax.random.PRNGKey(5), 3, 4
    if method == "official":
        noise = _torch(_jax_hmc_draws(jm.metric, key, n))
    else:
        noise = _torch(_jax_prior_draws(jm.metric, method, key, n))
        want_z = np.asarray(jm.sample_riemannian_prior(key, n, method))
        with torch.no_grad():
            got_z = pm.sample_riemannian_prior(n, method, noise=noise).numpy()
        np.testing.assert_allclose(got_z, want_z, rtol=0, atol=Z_ATOL)
    want_x = np.asarray(jm.generate(jv, key, n, n_obs=n_obs, method=method))
    before = (hmc_terms.launches, chol_bundle.launches)
    with torch.no_grad():
        got_x = pm.generate(n, n_obs, method, noise=noise).numpy()
    assert (hmc_terms.launches, chol_bundle.launches) == before
    assert got_x.shape == want_x.shape == (n, n_obs, 3, 16, 16)
    np.testing.assert_allclose(got_x, want_x, rtol=0, atol=X_ATOL)


# ---------------------------------------------------------------------------
# the batched-seeds contract and the engine's generate op
# ---------------------------------------------------------------------------

SMALL = {
    **PRESETS["riemannian_flow_vae"],
    "input_dim": [3, 8, 8], "n_flows": 2, "flow_hidden_size": 32,
    "pretrained": {"metric_path": str(METRIC)},
}


@pytest.fixture(scope="module")
def manager():
    return ModelManager.from_config(SMALL, seed=0, device="cpu")


@pytest.mark.parametrize("method", ["geodesic", "centroid_aware", "weighted_mixture", "basic"])
def test_batched_seeds_rows_equal_single_seed_calls(manager, method):
    seeds = [3, 11, 3]
    rows = manager.sample_random_batched_seeds(seeds, method=method, n_obs=4)
    assert rows.shape == (3, 4, 3, 8, 8) and np.isfinite(rows).all()
    for i, s in enumerate(seeds):
        np.testing.assert_allclose(rows[i], manager.sample_random(1, method, seed=s, n_obs=4)[0],
                                   rtol=0, atol=ROW_ATOL)
    np.testing.assert_array_equal(rows[0], rows[2])
    assert not np.array_equal(rows[0], rows[1])
    # sample_random and sample_latent with n > 1 draw from one generator
    x = manager.sample_random(4, method, seed=5, n_obs=2)
    z = manager.sample_latent(4, method, seed=5)
    assert x.shape == (4, 2, 3, 8, 8) and z.shape == (4, 16) and np.isfinite(z).all()
    np.testing.assert_array_equal(z, manager.sample_latent(4, method, seed=5))


def test_engine_generate_official_rows_equal_single_seed_calls(manager):
    """Concurrent seeds [7, 123, 7, 999] coalesce into one dispatch of the
    official chain; each row is the one sample_random(1, seed) gives, the two
    7s are identical, and a lone request padded to the bucket returns its
    seed's row."""
    seeds = [7, 123, 7, 999]
    single = {s: manager.sample_random(1, "official", seed=s)[0] for s in set(seeds)}
    engine = BatchingEngine.from_manager(manager, ServeConfig(buckets=(4,), max_wait_ms=2000),
                                         generate_method="official")
    try:
        futs = [engine.submit("generate", np.uint32(s)) for s in seeds]
        rows = [f.result(timeout=120) for f in futs]
        assert engine.stats_snapshot()["batches"] == 1
        lone = engine.run("generate", np.uint32(123), timeout=120)
        snap = engine.stats_snapshot()
    finally:
        engine.stop()
    for s, row in zip(seeds, rows):
        assert row.shape == (8, 3, 8, 8)
        np.testing.assert_allclose(row, single[s], rtol=0, atol=X_ATOL)
    np.testing.assert_array_equal(rows[0], rows[2])
    np.testing.assert_allclose(lone, single[123], rtol=0, atol=X_ATOL)
    assert snap["batches"] == 2 and snap["requests"] == 5
    assert engine.stats.rows_padded == 3


# ---------------------------------------------------------------------------
# Trainer.evaluate: JAX's default split and the best checkpoint's weights
# ---------------------------------------------------------------------------


def test_evaluate_defaults_to_test_split_and_refuses_best_weights(manager, tmp_path):
    """evaluate() defaults to the test split and to the run's ``best`` slot:
    it refuses (FileNotFoundError naming the slot) while there is none, then
    evaluates the slot's weights and leaves the live weights as they were."""
    from rlvae_tpu_torch.data import CYCLIC_SPRITES, CyclicDataModule
    from rlvae_tpu_torch.train import TRAINING_PRESETS

    params = inspect.signature(Trainer.evaluate).parameters
    assert params["split"].default == "test" and params["weights"].default == "best"
    cfg = {**TRAINING_PRESETS["quick"], "n_train_samples": 4, "n_val_samples": 2}
    data = CyclicDataModule({**CYCLIC_SPRITES, "train_path": str(tmp_path / "none.npz"),
                             "test_path": str(tmp_path / "none.npz"), "sequence_length": 4,
                             "image_size": [8, 8], "synthetic_n_test": 3}, seed=1)
    data.setup(cfg)
    trainer = Trainer(manager.model, data, cfg, run_dir=tmp_path / "run", seed=0, device="cpu")
    with pytest.raises(FileNotFoundError, match="best"):
        trainer.evaluate()
    with pytest.raises(ValueError, match="weights"):
        trainer.evaluate(weights="last")
    seen = []
    test_batches, val_batches = data.test_batches, data.val_batches
    data.test_batches = lambda: seen.append("test") or test_batches()
    data.val_batches = lambda: seen.append("val") or val_batches()
    metrics = trainer.evaluate(weights="live")
    assert seen == ["test"] and np.isfinite(metrics["loss"])
    trainer.evaluate("val", weights="live")
    assert seen == ["test", "val"]

    live = {k: v.clone() for k, v in manager.model.state_dict().items()}
    best = {k: v * 1.05 for k, v in live.items()}
    trainer.checkpoints.save("best", {"params": best, "step": 0, "val_loss": 0.0})
    from_best = trainer.evaluate()
    assert seen == ["test", "val", "test"]
    assert all(torch.equal(v, manager.model.state_dict()[k]) for k, v in live.items())
    assert from_best["loss"] != metrics["loss"]
    manager.model.load_state_dict(best)
    try:
        assert trainer.evaluate(weights="live") == from_best
    finally:
        manager.model.load_state_dict(live)
