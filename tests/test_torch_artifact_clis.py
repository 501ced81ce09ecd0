"""The port's artifact CLIs against the JAX package's library functions
that scripts/create_identity_metric_temp_0_7.py and
scripts/convert_reference_artifacts.py call, on the same inputs: ``.pt``
artifacts this test writes itself (a sequence tensor, pythae MLP encoder
and decoder state dicts, a metric dict under the reference's aliases)."""

import json

import numpy as np
import pytest
import torch

import rlvae_tpu_torch.convert_reference_artifacts as convert_reference_artifacts
import rlvae_tpu_torch.create_identity_metric as create_identity_metric

K, D = 6, 4


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_same_npz(a, b):
    za, zb = _npz(a), _npz(b)
    assert sorted(za) == sorted(zb)
    for k in za:
        assert za[k].dtype == zb[k].dtype, k
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


@pytest.fixture
def artifacts(tmp_path):
    """The reference's four kinds of ``.pt`` artifact, small."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn((K, D, D), generator=g)
    torch.save({"metric_centroids": torch.randn((K, D), generator=g),
                "metric_vars": a @ a.transpose(1, 2) + torch.eye(D),
                "metric_temperature": torch.tensor(0.7), "metric_regularization": 0.01},
               tmp_path / "metric_ref.pt")
    torch.save({"data": torch.rand((3, 2, 3, 4, 4), generator=g)}, tmp_path / "seqs.pt")
    n_in, hidden = 3 * 4 * 4, 8
    enc = {"layers.0.0.weight": torch.randn((hidden, n_in), generator=g),
           "layers.0.0.bias": torch.randn((hidden,), generator=g),
           "embedding.weight": torch.randn((D, hidden), generator=g),
           "embedding.bias": torch.randn((D,), generator=g),
           "log_var.weight": torch.randn((D, hidden), generator=g),
           "log_var.bias": torch.randn((D,), generator=g)}
    dec = {"decoder.layers.0.0.weight": torch.randn((hidden, D), generator=g),
           "decoder.layers.0.0.bias": torch.randn((hidden,), generator=g),
           "decoder.layers.1.0.weight": torch.randn((n_in, hidden), generator=g),
           "decoder.layers.1.0.bias": torch.randn((n_in,), generator=g)}
    torch.save(enc, tmp_path / "encoder.pt")
    torch.save(dec, tmp_path / "decoder.pt")
    return tmp_path


@pytest.mark.parametrize("n_centroids", [None, 4])
def test_identity_metric_matches_jax(artifacts, n_centroids, capsys):
    from rlvae_tpu.geometry import load_metric, save_metric
    from rlvae_tpu.geometry.metric import CentroidMetric

    src = artifacts / "metric_ref.pt"
    argv = [str(src), str(artifacts / "port.npz"), "--temperature", "0.7"]
    if n_centroids:
        argv += ["--n-centroids", str(n_centroids)]
    assert create_identity_metric.main(argv) == 0
    assert "identity M, T=0.7" in capsys.readouterr().out

    # what the JAX script does with its library
    jsrc = load_metric(src)
    centroids = np.asarray(jsrc.centroids)[:n_centroids]
    k, d = centroids.shape
    identity = np.broadcast_to(np.eye(d, dtype=np.float32), (k, d, d)).copy()
    save_metric(CentroidMetric.create(centroids, identity, temperature=0.7,
                                      regularization=float(jsrc.regularization)),
                artifacts / "jax.npz")
    _assert_same_npz(artifacts / "port.npz", artifacts / "jax.npz")


def test_convert_reference_artifacts_matches_jax(artifacts, capsys):
    from rlvae_tpu.data import convert as jcv
    from rlvae_tpu.geometry import load_metric, save_metric
    from rlvae_tpu.geometry.loader import validate_metric_file

    names = {"dataset": "seqs.pt", "encoder": "encoder.pt", "decoder": "decoder.pt",
             "metric": "metric_ref.pt"}
    argv = [f"--{k}={artifacts / v}" for k, v in names.items()]
    assert convert_reference_artifacts.main(argv + [f"--out-dir={artifacts / 'port'}"]) == 0
    report = json.loads(capsys.readouterr().out)

    jax_dir = artifacts / "jax"
    jax_dir.mkdir()
    shape = jcv.convert_dataset(artifacts / "seqs.pt", jax_dir / "seqs.npz")
    for kind in ("encoder", "decoder"):
        jcv.convert_component(artifacts / names[kind], jax_dir / f"{kind}.npz", kind)
    jmetric = load_metric(artifacts / "metric_ref.pt")
    save_metric(jmetric, jax_dir / "metric_ref.npz")

    for stem in ("seqs", "encoder", "decoder", "metric_ref"):
        _assert_same_npz(artifacts / "port" / f"{stem}.npz", jax_dir / f"{stem}.npz")
    assert report["dataset"]["shape"] == list(shape) == [3, 2, 3, 4, 4]
    for kind in ("encoder", "decoder"):
        params = jcv.load_component_npz(jax_dir / f"{kind}.npz")["params"]
        n = sum(leaf.size for layer in params.values() for leaf in layer.values())
        assert report[kind]["param_count"] == n
    assert report["metric"]["n_centroids"] == K and report["metric"]["latent_dim"] == D
    want = json.loads(json.dumps(validate_metric_file(jax_dir / "metric_ref.npz"), default=str))
    assert report["metric"]["validation"] == want


def test_convert_reference_artifacts_needs_an_input(tmp_path):
    with pytest.raises(SystemExit):
        convert_reference_artifacts.main([f"--out-dir={tmp_path}"])
