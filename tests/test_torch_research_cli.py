"""The port's research CLI (``python -m rlvae_tpu_torch.research_cli``) and
masks (``rlvae_tpu_torch.data.masks``) against the JAX package's
(``scripts/research_cli.py``, ``rlvae_tpu/data/masks.py``) on the CPU.

- ``--make_masks``: the same file name and the six masks of the JAX CLI's
  file, bit for bit (host numpy from the same seeds), and the mask makers
  alone at several shapes and probabilities.
- One tiny epoch per model (``lvae_iaf``, ``vamp``, ``gpvae``, ``riem``,
  ``gugus``, ``lldm``) on ``--device cpu``: 1x16x16 frames from a
  ``--data_path`` ``.npy`` file (synthetic cyclic sequences), latent 4, 4
  visits, 8 training sequences in batches of 4 with missing visits and
  pixels: finite losses, the result line's keys those of the JAX CLI (its
  training keys read from a JAX run without evaluation, which would cost
  ~130 eager JAX compiles; then its evaluation's ``eval_mse``, and
  ``eval_nll`` where the model has ``estimate_nll``, in both packages,
  ``scripts/research_cli.py:239-247``), and the files it writes.
- The default device is the card, which the CPU does not have.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from rlvae_tpu.data import masks as jax_masks
from rlvae_tpu_torch import research_cli
from rlvae_tpu_torch.data import masks

REPO = Path(__file__).resolve().parents[1]
TINY = ["--dataset", "starmen", "--n_train", "8", "--n_eval", "4", "--batch_size", "4",
        "--latent_dim", "4", "--n_obs", "4", "--vamp_number_components", "5", "--warmup", "1",
        "--nll_n_samples", "2", "--compute_nll", "1", "--seed", "3"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """TINY on 12 synthetic cyclic sequences of 4 1x16x16 frames, read
    from a ``.npy`` file (``--data_path``)."""
    from rlvae_tpu_torch.data import generate_cyclic_sequences

    path = tmp_path_factory.mktemp("data") / "seqs.npy"
    np.save(path, generate_cyclic_sequences(12, n_obs=4, image_size=(16, 16), channels=1,
                                            seed=0))
    return [*TINY, "--data_path", str(path)]


@pytest.fixture(scope="module")
def jax_cli():
    spec = importlib.util.spec_from_file_location("jax_research_cli",
                                                  REPO / "scripts" / "research_cli.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_make_masks_equals_the_jax_file(jax_cli, tmp_path, capsys):
    argv = ["--make_masks", "--prob_missing_data", "0.3", "--prob_missing_pixels", "0.2",
            "--n_train", "12", "--n_eval", "5", "--batch_size", "5", "--dataset", "starmen",
            "--seed", "7"]
    port = _run(research_cli.main, argv + ["--output_dir", str(tmp_path / "port")], capsys)
    jax_out = _run(jax_cli.main, argv + ["--output_dir", str(tmp_path / "jax")], capsys)
    assert Path(port["masks"]).name == Path(jax_out["masks"]).name
    got, want = masks.load_masks(port["masks"]), jax_masks.load_masks(jax_out["masks"])
    assert sorted(got) == sorted(want) and len(got) == 6
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    with np.load(port["masks"]) as a, np.load(jax_out["masks"]) as b:  # as saved
        for k in b.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("shape,p_data,p_pix,batch", [
    ((10, 8, 1, 4, 4), 0.0, 0.0, 4), ((7, 2, 1, 3, 3), 0.5, 0.3, 3),
    ((33, 8, 3, 4, 4), 0.3, 0.1, 8), ((5, 6, 1, 2, 2), 1.0, 1.0, 2)])
def test_mask_makers_are_bitwise_jax(shape, p_data, p_pix, batch):
    for seed in (0, 11):
        assert np.array_equal(masks.make_batched_masks(shape, p_data, batch, seed),
                              jax_masks.make_batched_masks(shape, p_data, batch, seed))
        assert np.array_equal(masks.make_pixel_masks(shape, p_pix, seed),
                              jax_masks.make_pixel_masks(shape, p_pix, seed))
    seq = masks.make_batched_masks(shape, p_data, batch, 1)
    assert (seq.sum(1) >= min(2, shape[1])).all()  # at least 2 observed visits


@pytest.fixture(scope="module")
def jax_result_keys(jax_cli, tiny, tmp_path_factory):
    """The keys of the JAX CLI's result line before its evaluation (no
    training epoch, no evaluation)."""
    out = tmp_path_factory.mktemp("jax_keys")
    jax_cli.main(["--model", "vamp", "--num_epochs", "0", *tiny, "--compute_mse", "0",
                  "--compute_nll", "0", "--output_dir", str(out)])
    return set(json.loads((out / "vamp_starmen" / "results.json").read_text())) - {"history"}


@pytest.mark.parametrize("model", ["lvae_iaf", "vamp", "gpvae", "riem", "gugus", "lldm"])
def test_one_tiny_epoch_per_model(model, jax_cli, jax_result_keys, tiny, tmp_path, capsys):
    argv = ["--model", model, "--num_epochs", "2", "--prob_missing_data", "0.25",
            "--prob_missing_pixels", "0.1", *tiny, "--output_dir", str(tmp_path)]
    jax_model = jax_cli.build_model(jax_cli.build_parser().parse_args(argv), (1, 16, 16))
    argv += ["--device", "cpu"]
    result = _run(research_cli.main, argv, capsys)
    port_model = research_cli.build_model(research_cli.build_parser().parse_args(argv),
                                          (1, 16, 16))
    has_nll = hasattr(jax_model, "estimate_nll")
    assert hasattr(port_model, "estimate_nll") == has_nll
    assert set(result) == jax_result_keys | {"eval_mse"} | ({"eval_nll"} if has_nll else set())
    assert result["model"] == model and result["epochs"] == 2
    for k in ("final_loss", "eval_mse", "eval_nll"):
        if k in result:
            assert np.isfinite(result[k]), (k, result[k])
    run = tmp_path / f"{model}_starmen"
    history = json.loads((run / "results.json").read_text())["history"]
    assert [h["epoch"] for h in history] == [0, 1]
    with np.load(run / "params.npz") as params:
        assert set(params.files) == set(port_model.state_dict())


def test_default_device_is_the_card(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        research_cli.main(["--model", "vamp", *TINY, "--output_dir", str(tmp_path)])
