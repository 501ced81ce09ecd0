"""The port's evaluation utilities against JAX's, on the CPU: evaluation
(rlvae_tpu_torch/utils/evaluation.py) and its CLI, FID, ESS, t-SNE, UMAP
and png_b64.

Tolerances: the numpy copies (Fréchet distance, pixel features, ESS,
t-SNE, UMAP) are held to JAX's functions exactly on the same inputs and
seeds; the fp32 nets' evaluation metrics and encoder features at 1e-5
relative (a reduction in another order); png_b64's pixels exactly with
matplotlib (JAX's path), and within one level of 255 through the
standard-library writer the port takes where matplotlib is absent."""

import base64
import io
import json
import sys

import jax
import numpy as np
import pytest
import torch

from rlvae_tpu_torch.utils.evaluation import (
    _forward_recon,
    evaluate_missing,
    evaluate_reconstruction,
)
from rlvae_tpu_torch.utils.fid import (
    compute_statistics,
    encoder_features,
    fid_score,
    frechet_distance,
    pixel_features,
)

# tests/test_evaluation.py's model as a config, fp32 nets, built on both sides
CFG = {
    "input_dim": [3, 8, 8], "latent_dim": 8, "n_flows": 2, "flow_hidden_size": 16,
    "posterior": {"type": "gaussian"},
    "sampling": {"method": "standard", "use_riemannian": False},
    "encoder": {"architecture": "mlp", "hidden_dims": [16], "dtype": "float32"},
    "decoder": {"architecture": "mlp", "hidden_dims": [16], "dtype": "float32"},
}


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX variables, port ModelManager) on the same weights."""
    from rlvae_tpu.models.factory import create_model as jax_create_model
    from rlvae_tpu_torch import ModelManager
    from rlvae_tpu_torch.convert import from_jax_variables
    from rlvae_tpu_torch.models import create_model

    jm = jax_create_model(CFG)
    jv = jm.init(jax.random.PRNGKey(0), n_obs=4)
    pm = create_model(CFG)
    pm.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray, jv)))
    return jm, jv, ModelManager(pm, "cpu")


def _data(n=8, seed=0):
    return np.random.default_rng(seed).uniform(size=(n, 4, 3, 8, 8)).astype(np.float32)


def _jax_noise(key):
    """JAX's posterior draws of evaluate_*: per (run, batch) the key
    fold_in(fold_in(key, r), i), and its forward's eps = normal(split(k)[0])."""
    def noise(r, i, rows):
        k = jax.random.fold_in(jax.random.fold_in(key, r), i)
        eps = jax.random.normal(jax.random.split(k)[0], (rows, CFG["latent_dim"]))
        return {"eps": torch.from_numpy(np.array(eps))}

    return noise


def test_frechet_distance_identical_is_zero():
    f = np.random.default_rng(0).normal(size=(200, 8))
    mu, s = compute_statistics(f)
    assert frechet_distance(mu, s, mu, s) == pytest.approx(0.0, abs=1e-6)
    assert fid_score(f, f.copy()) == pytest.approx(0.0, abs=1e-6)


def test_frechet_distance_analytic():
    """Diagonal Gaussians: d^2 = |dmu|^2 + sum (sqrt(s1) - sqrt(s2))^2."""
    mu1, mu2 = np.zeros(3), np.array([1.0, 0.0, 2.0])
    s1, s2 = np.diag([1.0, 4.0, 9.0]), np.diag([4.0, 1.0, 9.0])
    assert frechet_distance(mu1, s1, mu2, s2) == pytest.approx(7.0, rel=1e-4)


def test_fid_orders_similarity_and_matches_jax():
    from rlvae_tpu.utils import fid as jax_fid

    rng = np.random.default_rng(1)
    real = rng.normal(size=(300, 6))
    near = real + 0.05 * rng.normal(size=real.shape)
    far = rng.normal(loc=3.0, size=(300, 6))
    assert fid_score(real, near) < fid_score(real, far)
    for other in (near, far):
        assert fid_score(real, other) == jax_fid.fid_score(real, other)
    mu1, s1 = compute_statistics(real)
    mu2, s2 = compute_statistics(far)
    assert frechet_distance(mu1, s1, mu2, s2) == jax_fid.frechet_distance(mu1, s1, mu2, s2)


def test_pixel_features_pooling_and_match_jax():
    from rlvae_tpu.utils.fid import pixel_features as jax_pixel_features

    imgs = np.ones((4, 3, 32, 32), np.float32)
    f = pixel_features(imgs, size=8)
    assert f.shape == (4, 3 * 8 * 8)
    np.testing.assert_allclose(f, 1.0)
    seq = np.random.default_rng(0).uniform(size=(2, 5, 3, 32, 32)).astype(np.float32)
    assert pixel_features(seq, size=8).shape == (10, 3 * 8 * 8)
    np.testing.assert_array_equal(pixel_features(seq, size=8), jax_pixel_features(seq, size=8))


def test_encoder_features_match_jax(pair):
    from rlvae_tpu.inference import ModelManager as JaxManager

    jm, jv, pm = pair
    imgs = np.random.default_rng(0).uniform(size=(6, 3, 8, 8)).astype(np.float32)
    f = encoder_features(lambda x: pm.encode(x).embedding, imgs, batch_size=4)
    assert f.shape == (6, 8)
    jmm = JaxManager(jm, jv)
    want = encoder_features(lambda x: np.asarray(jmm.encode(x).embedding), imgs, batch_size=4)
    np.testing.assert_allclose(f, want, rtol=1e-5, atol=1e-6)


def test_evaluate_reconstruction_matches_jax(pair):
    from rlvae_tpu.utils.evaluation import evaluate_reconstruction as jax_eval

    jm, jv, pm = pair
    data = _data()
    key = jax.random.PRNGKey(3)
    res = evaluate_reconstruction(pm.model, data, n_runs=2, batch_size=4,
                                  noise=_jax_noise(key))
    want = jax_eval(jm, jv, data, key, batch_size=4, n_runs=2)
    assert res["n_runs"] == 2 and res["recon_mse"] > 0
    assert res["recon_mse"] == pytest.approx(want["recon_mse"], rel=1e-5)
    assert res["recon_mse_std"] == pytest.approx(want["recon_mse_std"], rel=1e-3, abs=1e-6)
    # the port's own draws: finite, and seeded
    own = evaluate_reconstruction(pm.model, data, seed=1, n_runs=2, batch_size=4)
    assert np.isfinite(own["recon_mse"])
    assert own == evaluate_reconstruction(pm.model, data, seed=1, n_runs=2, batch_size=4)


def test_evaluate_missing_matches_jax(pair):
    from rlvae_tpu.utils.evaluation import evaluate_missing as jax_missing
    from rlvae_tpu_torch.data.masks import make_batched_masks, make_pixel_masks

    jm, jv, pm = pair
    data = _data()
    seq_mask = make_batched_masks(data.shape, 0.4, batch_size=4, seed=0)
    pix_mask = make_pixel_masks(data.shape, 0.2, seed=1)
    key = jax.random.PRNGKey(5)
    res = evaluate_missing(pm.model, data, seq_mask, pix_mask, n_runs=2, batch_size=4,
                           noise=_jax_noise(key))
    want = jax_missing(jm, jv, data, seq_mask, pix_mask, key, batch_size=4, n_runs=2)
    for k in ("missing_pixel_mse", "missing_frame_mse"):
        assert np.isfinite(res[k]) and res[k] > 0
        assert res[k] == pytest.approx(want[k], rel=1e-5), k
    # all-observed masks zero out both metrics
    res0 = evaluate_missing(pm.model, data, np.ones(data.shape[:2], np.float32),
                            np.ones_like(data), n_runs=1, batch_size=4)
    assert res0["missing_pixel_mse"] == 0.0 and res0["missing_frame_mse"] == 0.0


def test_forward_recon_masks_input_for_maskless_models(pair):
    """A model without mask arguments (RlVAE) sees the masked-out content
    zeroed, so the imputation metrics do not leak."""
    _, _, pm = pair
    x = torch.from_numpy(_data(4))
    eps = {"eps": torch.randn((4, 8), generator=torch.Generator().manual_seed(3))}
    sm = torch.ones(x.shape[:2])
    with torch.inference_mode():
        masked = _forward_recon(pm.model, x, noise=eps, seq_mask=sm, pix_mask=torch.zeros_like(x))
        from_zeros = _forward_recon(pm.model, torch.zeros_like(x), noise=eps)
        unmasked = _forward_recon(pm.model, x, noise=eps, seq_mask=sm, pix_mask=torch.ones_like(x))
        plain = _forward_recon(pm.model, x, noise=eps)
    torch.testing.assert_close(masked, from_zeros, rtol=0, atol=1e-6)
    torch.testing.assert_close(unmasked, plain, rtol=0, atol=1e-6)


def test_evaluation_cli(pair, tmp_path, capsys):
    """The CLI over a port run directory (checkpoint slot + config.yaml)."""
    from rlvae_tpu_torch import evaluation_cli
    from rlvae_tpu_torch.config.compose import dump_yaml
    from rlvae_tpu_torch.train.checkpoints import CheckpointManager

    _, _, pm = pair
    CheckpointManager(tmp_path / "checkpoints").save(
        "best", {"params": pm.model.state_dict(), "step": 0, "val_loss": 1.0})
    (tmp_path / "config.yaml").write_text(dump_yaml({"model": CFG}))
    rc = evaluation_cli.main([
        "--run_dir", str(tmp_path), "--n_test", "8", "--n_obs", "4", "--batch_size", "4",
        "--n_runs", "1", "--fid_samples", "8", "--sample_method", "standard",
        "--prob_missing_data", "0.25", "--prob_missing_pixels", "0.1", "--device", "cpu",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("recon_mse", "missing_pixel_mse", "missing_frame_mse", "fid_pixel", "fid_encoder"):
        assert np.isfinite(out[k]), k


def test_effective_sample_size_matches_jax():
    from rlvae_tpu.utils.mcmc import effective_sample_size as jax_ess
    from rlvae_tpu_torch.utils.mcmc import effective_sample_size, ess_1d

    rng = np.random.default_rng(0)
    s, b = 512, 8
    iid = rng.normal(size=(s, b))
    ar = np.empty((s, b))
    ar[0] = rng.normal(size=b)
    for t in range(1, s):
        ar[t] = 0.95 * ar[t - 1] + rng.normal(size=b) * np.sqrt(1 - 0.95**2)
    three = rng.normal(size=(s, b, 3))
    ess_iid, ess_ar = effective_sample_size(iid), effective_sample_size(ar)
    assert ess_iid > 0.5 * s * b and ess_ar < 0.15 * s * b and ess_ar < ess_iid / 4
    assert effective_sample_size(three) > 0.3 * s * b
    assert ess_1d(np.zeros(64)) >= 1.0
    for chains in (iid, ar, three):
        assert effective_sample_size(chains) == jax_ess(chains)


@pytest.mark.parametrize("method", ["tsne", "umap"])
def test_embeddings_separate_clusters_and_match_jax(method):
    """Two separated clusters stay apart, and a seed gives JAX's embedding
    (the app's latent page)."""
    import importlib

    mod = {"tsne": "tsne", "umap": "umap_lite"}[method]
    port = getattr(importlib.import_module(f"rlvae_tpu_torch.utils.{mod}"), method)
    ref = getattr(importlib.import_module(f"rlvae_tpu.utils.{mod}"), method)
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=(20, 16)) * 0.1, rng.normal(size=(20, 16)) * 0.1 + 4.0])
    kw = {"perplexity": 8.0, "n_iter": 250} if method == "tsne" else {"n_neighbors": 8,
                                                                      "n_epochs": 150}
    y = port(x, seed=1, **kw)
    assert y.shape == (40, 2) and np.isfinite(y).all()
    spread = max(y[:20].std(), y[20:].std())
    assert np.linalg.norm(y[:20].mean(0) - y[20:].mean(0)) > 2.0 * spread
    np.testing.assert_array_equal(y, ref(x, seed=1, **kw))
    assert port(np.zeros((2, 4))).shape == (2, 2)  # too few points
    assert np.isfinite(port(np.ones((10, 4)), **({"n_iter": 50} if method == "tsne"
                                                 else {"n_epochs": 30}))).all()


def _pixels(b64):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


@pytest.mark.parametrize("channels", [3, 1])
def test_png_b64_matches_jax(channels, monkeypatch):
    from rlvae_tpu.viz.base import png_b64 as jax_png_b64
    from rlvae_tpu_torch.viz.base import png_b64

    frame = np.random.default_rng(channels).uniform(-0.1, 1.1,
                                                     size=(channels, 8, 8)).astype(np.float32)
    want = _pixels(jax_png_b64(frame))
    np.testing.assert_array_equal(_pixels(png_b64(frame)), want)
    # without matplotlib: the standard-library writer
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    got = _pixels(png_b64(frame)).astype(int)
    if channels == 3:
        assert got.shape == (8, 8, 3)
        assert np.abs(got - want[..., :3].astype(int)).max() <= 1
    else:  # grey, where matplotlib applies its colormap
        assert got.shape == (8, 8)
        want_grey = (np.clip(frame[0], 0, 1) * 255).astype(np.uint8)
        assert np.abs(got - want_grey.astype(int)).max() <= 1
