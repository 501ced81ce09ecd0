"""Data-parallel serving of the port on the CPU: ``make_sharded_ops`` and
``BatchingEngine.from_manager(..., devices=)``.

- Over 2 and 3 replicas (the CPU listed that many times) at batch sizes the
  replica count does not divide, every op (``reconstruct``, ``encode``,
  ``decode``, ``generate`` with the geodesic prior) returns the rows of the
  one-device manager, rtol/atol 1e-5 as ``tests/test_serving.py:317``;
  ``generate``'s duplicate seeds give the same row bit for bit.
- The engine over the sharded ops answers each request with its row.
- Against JAX's ``make_sharded_ops`` over the conftest's 8 CPU devices on
  JAX's tiny model (its variables carried to the port): ``encode`` and
  ``decode`` at 5 rows, and ``reconstruct`` at 8 rows with the port handed
  JAX's posterior draw for its key 0 (eps = normal(split(PRNGKey(0))[0],
  (8, D))), rtol/atol 1e-5.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rlvae_tpu.inference import ModelManager as JaxModelManager
from rlvae_tpu.parallel import create_mesh as jax_create_mesh
from rlvae_tpu.serving import make_sharded_ops as jax_make_sharded_ops
from rlvae_tpu_torch import BatchingEngine, ModelManager, PRESETS, ServeConfig
from rlvae_tpu_torch.convert import from_jax_variables
from rlvae_tpu_torch.models import create_model
from rlvae_tpu_torch.serving import make_sharded_ops

DATA = Path(__file__).resolve().parents[1] / "data" / "pretrained"
SMALL = {**PRESETS["riemannian_flow_vae"], "input_dim": [3, 8, 8], "n_flows": 2,
         "flow_hidden_size": 32,
         "pretrained": {"metric_path": str(DATA / "metric_T0.7_scaled.npz")}}
JAX_TINY = {"name": "vanilla_vae", "input_dim": [3, 8, 8], "latent_dim": 4, "n_flows": 2,
            "flow_hidden_size": 16, "encoder": {"architecture": "mlp", "hidden_dims": [16]},
            "decoder": {"architecture": "mlp", "hidden_dims": [16]}}
TOL = {"rtol": 1e-5, "atol": 1e-5}


@pytest.fixture(scope="module")
def manager():
    return ModelManager.from_config(SMALL, seed=0, device="cpu")


@pytest.mark.parametrize("replicas,rows", [(2, 3), (3, 5)])
def test_sharded_ops_return_the_one_device_rows(manager, replicas, rows):
    ops = make_sharded_ops(manager, ["cpu"] * replicas, generate_n_obs=3)
    rng = np.random.default_rng(replicas)
    x = rng.uniform(size=(rows, 4, 3, 8, 8)).astype(np.float32)
    z = rng.normal(size=(rows, 16)).astype(np.float32)
    seeds = np.uint32([7, 123, 7, 999, 5][:rows])
    want = {"reconstruct": manager.reconstruct(x, seed=0),
            "encode": manager.encode(x[:, 0]).embedding, "decode": manager.decode(z),
            "generate": manager.sample_random_batched_seeds(seeds, n_obs=3)}
    inputs = {"reconstruct": x, "encode": x[:, 0], "decode": z, "generate": seeds}
    for op, w in want.items():
        got = ops[op](inputs[op])
        assert got.shape == w.shape, op
        np.testing.assert_allclose(got, w, err_msg=op, **TOL)
        assert ops[op].last_out_ndev == replicas and len(ops[op].mesh) == replicas
    got = ops["generate"](seeds)
    np.testing.assert_array_equal(got[0], got[2])


def test_engine_over_replicas_answers_each_request(manager):
    engine = BatchingEngine.from_manager(manager, ServeConfig(buckets=(1, 3), max_wait_ms=200),
                                         generate_n_obs=3, devices=["cpu", "cpu"])
    try:
        seeds = [3, 41, 3]
        futs = [engine.submit("generate", np.uint32(s)) for s in seeds]
        got = np.stack([f.result(timeout=120) for f in futs])
        np.testing.assert_allclose(got, manager.sample_random_batched_seeds(seeds, n_obs=3),
                                   **TOL)
        z = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
        np.testing.assert_allclose(engine.run("decode", z, timeout=60),
                                   manager.decode(z[None])[0], **TOL)
        assert engine.ops["generate"].last_out_ndev == 2
    finally:
        engine.stop()


def test_sharded_ops_match_jax(monkeypatch):
    jmgr = JaxModelManager.from_config(JAX_TINY, seed=0)
    jops = jax_make_sharded_ops(jmgr, jax_create_mesh(), generate_n_obs=3)
    model = create_model(JAX_TINY)
    model.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray,
                                                                    jmgr.variables)))
    mgr = ModelManager(model, "cpu")
    ops = make_sharded_ops(mgr, ["cpu"] * 3, generate_n_obs=3)
    rng = np.random.default_rng(0)
    frames = rng.uniform(size=(5, 3, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(ops["encode"](frames), jops["encode"](frames), **TOL)
    z = rng.normal(size=(5, 4)).astype(np.float32)
    np.testing.assert_allclose(ops["decode"](z), jops["decode"](z), **TOL)
    seqs = rng.uniform(size=(8, 4, 3, 8, 8)).astype(np.float32)
    eps = np.asarray(jax.random.normal(jax.random.split(jax.random.PRNGKey(0))[0], (8, 4)))
    monkeypatch.setattr(model, "draw_posterior_noise",
                        lambda n, gen=None: {"eps": torch.tensor(eps[:n])})
    np.testing.assert_allclose(ops["reconstruct"](seqs), jops["reconstruct"](seqs), **TOL)
